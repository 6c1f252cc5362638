#!/usr/bin/env python
"""tau_int vs lattice spacing study for the topological rotor — the data
behind the reference's README figure 3 (left): single-level HMC
autocorrelation grows as a -> 0 while the hierarchical delayed-acceptance
sampler stays flat.

Usage: python tools/tau_int_study.py [--lattices 16,32,64,128] [--csv out]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lattices", default="16,32,64")
    ap.add_argument("--n-samples", type=int, default=8000)
    ap.add_argument("--n-chains", type=int, default=64)
    ap.add_argument("--m0", type=float, default=1.0)
    ap.add_argument("--T-final", type=float, default=4.0)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="pin to CPU (f64) instead of the default device")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_default_device",
                          jax.local_devices(backend="cpu")[0])
    import jax.numpy as jnp

    from mlmcpathintegral.conditioned import make_conditioned_fine_action
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.mc import MonteCarloSingleLevel
    from mlmcpathintegral.models import RenormalisationType, RotorAction
    from mlmcpathintegral.qoi import qoi_susceptibility
    from mlmcpathintegral.samplers import (
        ClusterSampler, HierarchicalSampler, HMCSampler,
    )

    dtype = jnp.float64 if args.cpu else jnp.float32
    rows = []
    for M in [int(m) for m in args.lattices.split(",")]:
        lat = Lattice1D(M, args.T_final)
        act = RotorAction(lat, RenormalisationType.PERTURBATIVE, m0=args.m0)
        oracle = act.chit_exact()
        samplers = {
            "hmc": HMCSampler(act, nt=20, dt=0.2, n_burnin=50),
            "hierarchical": HierarchicalSampler(
                act,
                lambda a: ClusterSampler(a, n_burnin=50, n_updates=5),
                make_conditioned_fine_action,
                n_max_level=max(2, M.bit_length() - 3)),
        }
        for name, sampler in samplers.items():
            mc = MonteCarloSingleLevel(
                act, qoi_susceptibility(act), sampler,
                n_burnin=200, n_samples=args.n_samples,
                n_autocorr_window=50, chunk_size=200)
            _, st = mc.evaluate(jax.random.PRNGKey(M), args.n_chains, dtype)
            tau = mc.stats_Q.tau_int(st)
            num = mc.numerical_result(st)
            err = mc.statistical_error(st)
            dev = abs(num - oracle) / err
            rows.append((M, lat.a_lat, name, tau, num, err, dev,
                         mc.elapsed_s))
            print(f"M={M:4d} a={lat.a_lat:.4f} {name:13s}: "
                  f"tau_int={tau:7.3f}  chi_t={num:.6f}+/-{err:.6f} "
                  f"({dev:.2f} sigma)  wall={mc.elapsed_s:.1f}s",
                  flush=True)
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("M,a,sampler,tau_int,chi_t,err,sigma_dev,wall_s\n")
            for r in rows:
                fh.write(",".join(str(v) for v in r) + "\n")
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
