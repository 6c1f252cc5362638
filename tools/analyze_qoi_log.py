#!/usr/bin/env python
"""Analyse a binary QoI log written by MonteCarloSingleLevel(qoi_log_path=…)
with the native streaming statistics engine: per-chain tau_int, binning
cross-check, aggregate estimate.

The log is float64 of shape [n_steps, n_chains] (row per step).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mlmcpathintegral.utils.native import (  # noqa: E402
    analyze_samples, binning_analysis, native_available,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logfile")
    ap.add_argument("--n-chains", type=int, required=True)
    ap.add_argument("--k-max", type=int, default=40)
    args = ap.parse_args()

    data = np.fromfile(args.logfile, dtype=np.float64)
    if data.size % args.n_chains:
        raise SystemExit(f"log size {data.size} not divisible by "
                         f"n_chains={args.n_chains}")
    data = data.reshape(-1, args.n_chains)
    T, C = data.shape
    print(f"log: {T} steps x {C} chains "
          f"({'native' if native_available() else 'python'} engine)")

    per_chain = [analyze_samples(data[:, c], args.k_max) for c in range(C)]
    avg = np.mean([r["avg"] for r in per_chain])
    tau = np.mean([r["tau_int"] for r in per_chain])
    var = np.mean([r["variance"] for r in per_chain])
    err = np.sqrt(tau * var / (T * C))
    print(f" Q: Avg +/- Err = {avg:.6f} +/- {err:.6f}")
    print(f" Q: Var         = {var:.6f}")
    print(f" Q: tau_int     = {tau:.3f}")

    errs = binning_analysis(data[:, 0], n_levels=min(
        12, int(np.log2(max(T, 4)))))
    print(" binning cross-check (chain 0):")
    for b, e in enumerate(errs):
        print(f"   bin 2^{b:<2d}: err = {e:.6g}")


if __name__ == "__main__":
    main()
