#!/usr/bin/env python
"""Screen-bias regression of the fused two-level path at MULTIPLE
couplings.

Round 4 established that delayed acceptance is exact only for
independent coarse proposals and validated the fused t_sub floor at
8x8 beta=4 only; round 5 replaced the floor with the measured
slow-mode clock (mc/multilevel.py _update_t_sub).  This study drives
the fused 2-level MLMC at a STRONG coupling (8x8 beta=2) and at the
exact-branch edge (16x16 beta=8) to 0.1%-level statistical precision
against the analytic oracle (quenchedschwinger chit_analytical), over
3 seeds each — a bias from under-decorrelated coarse proposals of the
round-3 kind (~0.4%) would show up as a coherent multi-sigma shift.

Usage:
  python tools/screen_bias_study.py --csv docs/screen_bias.csv
"""

import argparse
import csv
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from mlmcpathintegral.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402


def run_one(M, beta, seed, *, rel_target=1e-3, n_chains=1024,
            chunk_size=256, fused="cuda"):
    from mlmcpathintegral.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.mc import MonteCarloMultiLevel
    from mlmcpathintegral.models.base import RenormalisationType
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler

    lat = Lattice2D(M, M, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(
        lat, beta=beta, renormalisation=RenormalisationType.NONPERTURBATIVE)
    oracle = act.chit_exact()
    # adaptive allocation straight to the precision target:
    # epsilon = rel_target * oracle
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=100),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=200, n_samples=0,
        epsilon=rel_target * oracle, chunk_size=chunk_size,
        n_autocorr_window=64, fused=fused)
    t0 = time.monotonic()
    stats = mc.evaluate(jax.random.PRNGKey(seed), n_chains=n_chains,
                        dtype=jnp.float32)
    wall = time.monotonic() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    flagged = [r["level"] for r in mc.reliability if r["flagged"]]
    return {
        "M": M, "beta": beta, "seed": seed,
        "chit": round(num, 6), "err": round(err, 6),
        "oracle": round(oracle, 6),
        "rel_err": round(err / oracle, 6),
        "rel_dev": round((num - oracle) / oracle, 6),
        "sigma_dev": round((num - oracle) / err, 2),
        "t_sub": "/".join(map(str, mc._t_sub)),
        "n_recorded": "/".join(
            str(mc.stats_qoi[ell].samples(stats[ell]))
            for ell in range(mc.n_level)),
        "unreliable_levels": "/".join(map(str, flagged)) or "none",
        "wall_s": round(wall, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=None)
    ap.add_argument("--configs", default="8:2.0,16:8.0",
                    help="comma list of M:beta")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--rel-target", type=float, default=1e-3)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--reference", action="store_true",
                    help="plain-JAX references of the fused kernels")
    args = ap.parse_args()

    rows = []
    for cfg in args.configs.split(","):
        M, beta = cfg.split(":")
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = run_one(int(M), float(beta), seed,
                        rel_target=args.rel_target, n_chains=args.n_chains,
                        fused="reference" if args.reference else "cuda")
            print(r, flush=True)
            rows.append(r)
    if args.csv and rows:
        with open(args.csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
