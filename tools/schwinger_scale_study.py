#!/usr/bin/env python
"""Reference-scale Schwinger MLMC study.

Two experiments, each emitting a CSV row per configuration:

  * --scale: full MLMC at growing lattice sizes (16x16 .. 128x128) with
    a 3-level hierarchy and nonperturbative beta matching — per-level
    costs, t_sub, oracle deviation and effective samples/s.
  * --epsilon: adaptive-target MLMC (n_samples=0) at 16x16 over an
    epsilon sweep — total cost vs epsilon, reproducing the
    O(epsilon^-2) scaling of montecarlomultilevel.cc's allocation
    (README.md:15-18's asymptotic-cost claim).

Runs the fused CUDA kernels on the GPU; --reference runs their plain-JAX
references instead (any backend), --unfused the generic XLA chunks.

Usage:
  python tools/schwinger_scale_study.py --scale --csv docs/scale_study.csv
  python tools/schwinger_scale_study.py --epsilon --csv docs/eps_study.csv
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


def run_mlmc(Mt, Mx, *, beta=4.0, n_level=3, n_samples=1_000_000,
             epsilon=1e-2, n_chains=1024, chunk_size=256,
             fused="cuda", seed=0, n_autocorr_window=64, coarse="heatbath"):
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
    from mlmcpathintegral.samplers import (
        OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    )

    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(
        lat, beta=beta, renormalisation=RenormalisationType.NONPERTURBATIVE)
    if coarse == "cluster":
        # the reference's exact-sampler trick for the topological
        # slowing of the heat bath at large beta_c: plaquettes <->
        # rotor increments, Wolff cluster, tau ~ 1 flat in a
        # (quenchedschwingerclustersampler.hh:22-37)
        coarse_factory = lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=100)
    else:
        coarse_factory = lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=100)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=coarse_factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=n_level, n_burnin=200, n_samples=n_samples,
        epsilon=epsilon, chunk_size=chunk_size,
        n_autocorr_window=n_autocorr_window,
        fused=fused if coarse == "heatbath" else None)
    t0 = time.monotonic()
    stats = mc.evaluate(jax.random.PRNGKey(seed), n_chains=n_chains,
                        dtype=jnp.float32)
    wall = time.monotonic() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    err_robust = mc.statistical_error_robust()
    oracle = act.chit_exact()
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    # per-level sampling work only — the scope of the reference's cost
    # breakdown (montecarlomultilevel.cc:207-252); compiles and burn-in
    # are reported separately in the timings column
    method_wall = max(mc.timings["cost_measure_s"]
                      + mc.timings["sampling_s"], 1e-9)
    sigma_dev = abs(num - oracle) / err
    flagged = [r["level"] for r in mc.reliability if r["flagged"]]
    return {
        "Mt": Mt, "Mx": Mx, "beta": beta, "n_level": n_level,
        "epsilon": epsilon if n_samples == 0 else "",
        "n_samples_level0": n0,
        "chit": round(num, 6), "err": round(err, 6),
        "oracle": round(oracle, 6),
        "sigma_dev": round(sigma_dev, 2),
        # the bench gate (bench.py): >3 sigma from the oracle = failed;
        # a run whose tau was window-capped AND binning-corrected
        # upward >1.5x is unreliable even if sigma_dev happens to pass
        #
        "failed": bool(sigma_dev > 3.0),
        "unreliable_levels": "/".join(map(str, flagged)) or "none",
        "err_robust": round(err_robust, 6),
        "sigma_dev_robust": round(abs(num - oracle) / err_robust, 2),
        "tau_capped": "/".join(
            str(int(r["window_capped"])) for r in mc.reliability),
        "tau_eff": "/".join(
            f"{r['tau_eff']:.2f}" for r in mc.reliability),
        "tau0": round(tau0, 3),
        "t_sub": "/".join(map(str, mc._t_sub)),
        "cost_us": "/".join(f"{c:.3f}" for c in mc.cost_per_sample),
        "n_target": "/".join(map(str, mc.n_target)),
        "n_recorded": "/".join(
            str(mc.stats_qoi[ell].samples(stats[ell]))
            for ell in range(mc.n_level)),
        "wall_s": round(wall, 2),
        "method_wall_s": round(method_wall, 3),
        "sampling_s": round(mc.timings["sampling_s"], 2),
        "timings": "/".join(f"{k}={v:.2f}" for k, v in mc.timings.items()),
        "eff_samples_per_sec": round(n0 / (tau0 * method_wall), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--epsilon", action="store_true")
    ap.add_argument("--reference", action="store_true",
                    help="plain-JAX references of the fused kernels")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--n-samples", type=int, default=1_000_000)
    ap.add_argument("--sizes", default="16,32,64")
    ap.add_argument("--epsilons", default="2e-2,1e-2,5e-3,2.5e-3")
    ap.add_argument("--eps-sizes", default="16",
                    help="lattice sizes for the --epsilon sweep "
                         "(continuum trajectory beta = 4 (M/16)^2)")
    ap.add_argument("--coarse", default="heatbath",
                    choices=["heatbath", "cluster"])
    ap.add_argument("--unfused", action="store_true",
                    help="generic XLA chunks instead of fused kernels")
    ap.add_argument("--append", action="store_true",
                    help="append rows to --csv instead of overwriting")
    args = ap.parse_args()
    fused = (None if args.unfused
             else "reference" if args.reference else "cuda")

    rows = []
    if args.scale:
        for M in [int(s) for s in args.sizes.split(",")]:
            # continuum-limit trajectory: fixed physical volume and
            # coupling, a -> a/2 per doubling => beta = 1/(a g)^2 grows
            # as M^2 (normalised to the baseline config beta=4 at 16x16).
            # At fixed beta instead, the two-level acceptance collapses
            # with volume and the screen decorrelates too slowly to
            # measure (observed: 25% bias at 64x64 beta=4).
            beta = 4.0 * (M / 16.0) ** 2
            r = run_mlmc(M, M, beta=beta, n_level=3,
                         n_samples=args.n_samples, n_chains=args.n_chains,
                         chunk_size=args.chunk_size, coarse=args.coarse,
                         fused=fused)
            print(r, flush=True)
            rows.append(r)
    if args.epsilon:
        # adaptive-target MLMC (n_samples=0) over an epsilon ladder, at
        # every size in --eps-sizes on the continuum trajectory — the
        # reference paper's actual operating mode at scale
        # (montecarlomultilevel.cc:115-204; VERDICT r4 item 1)
        for M in [int(s) for s in args.eps_sizes.split(",")]:
            beta = 4.0 * (M / 16.0) ** 2
            for eps in [float(s) for s in args.epsilons.split(",")]:
                r = run_mlmc(M, M, beta=beta, n_level=3, n_samples=0,
                             epsilon=eps, n_chains=args.n_chains,
                             coarse=args.coarse, fused=fused)
                print(r, flush=True)
                rows.append(r)
        # O(eps^-2) check per size: fit method_wall = c0 + c2 * eps^-2
        import numpy as _np
        by_M = {}
        for r in rows:
            by_M.setdefault(r["Mt"], []).append(r)
        for M, rs in by_M.items():
            if len(rs) < 3:
                continue
            x = _np.array([1.0 / r["epsilon"] ** 2 for r in rs])
            y = _np.array([r["method_wall_s"] for r in rs])
            A = _np.stack([_np.ones_like(x), x], axis=1)
            coef, res, *_ = _np.linalg.lstsq(A, y, rcond=None)
            # log-log slope over the asymptotic (largest-cost) half
            order = _np.argsort(x)
            xs, ys = x[order], y[order] - min(coef[0], 0.0)
            tail = slice(len(xs) // 2 - 1, None)
            slope = _np.polyfit(_np.log(xs[tail]),
                                _np.log(_np.maximum(ys[tail], 1e-9)), 1)[0]
            print(f"M={M}: cost fit = {coef[0]:.2f}s + "
                  f"{coef[1]:.3e} * eps^-2 ; log-log tail slope in "
                  f"eps^-2 = {slope:.3f} (O(eps^-2) <=> 1.0)", flush=True)
    if args.csv and rows:
        mode = "a" if args.append and Path(args.csv).exists() else "w"
        with open(args.csv, mode, newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            if mode == "w":
                w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv} ({mode})")


if __name__ == "__main__":
    main()
