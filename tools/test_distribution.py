#!/usr/bin/env python
"""Standalone distribution tester — the analog of the reference's
``test_distribution`` executable (src/test_distribution.cc): draw from a
chosen distribution, time per-sample cost, and write samples plus pointwise
density values to ``distribution.txt`` for offline comparison/plotting.

Usage:
  python tools/test_distribution.py --distribution=expsin2 --sigma=4.0
  python tools/test_distribution.py --distribution=expcos --beta=4.0 \
      --x-p=0.5 --x-m=-0.3
  python tools/test_distribution.py --distribution=besselproduct --beta=4.0
  python tools/test_distribution.py --distribution=approximatebesselproduct \
      --beta=16.0
  python tools/test_distribution.py --distribution=compactexp --sigma=2.0
"""

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--distribution", required=True,
                    choices=["expsin2", "expcos", "compactexp",
                             "besselproduct", "approximatebesselproduct"])
    ap.add_argument("--sigma", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--x-p", type=float, default=0.5)
    ap.add_argument("--x-m", type=float, default=-0.3)
    ap.add_argument("--n-samples", type=int, default=100000)
    ap.add_argument("--output", default="distribution.txt")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    jax.config.update("jax_enable_x64", True)
    # host-side tool: pin to CPU (f64 rejection loops are slow on a
    # device)
    try:
        jax.config.update("jax_default_device",
                          jax.local_devices(backend="cpu")[0])
    except RuntimeError:
        pass
    key = jax.random.PRNGKey(args.seed)
    n = args.n_samples

    if args.distribution == "expsin2":
        from mlmcpathintegral.distributions.expsin2 import (
            ExpSin2Distribution as D)
        draw = jax.jit(lambda k: D.draw(
            k, jnp.full((n,), args.sigma, jnp.float64)))
        dens = lambda x: D.evaluate(x, args.sigma)
        lo, hi = -math.pi, math.pi
    elif args.distribution == "expcos":
        from mlmcpathintegral.distributions.expcos import (
            ExpCosDistribution as D)
        draw = jax.jit(lambda k: D.draw(
            k, args.beta, jnp.full((n,), args.x_p, jnp.float64),
            jnp.full((n,), args.x_m, jnp.float64)))
        dens = lambda x: D.evaluate(x, args.beta, args.x_p, args.x_m)
        lo, hi = -math.pi, math.pi
    elif args.distribution == "compactexp":
        from mlmcpathintegral.distributions.compactexp import (
            CompactExpDistribution as D)
        draw = jax.jit(lambda k: D.draw(
            k, jnp.full((n,), args.sigma, jnp.float64)))
        dens = lambda x: D.evaluate(x, args.sigma)
        lo, hi = -1.0, 1.0
    elif args.distribution == "besselproduct":
        from mlmcpathintegral.distributions.besselproduct import (
            BesselProductDistribution)
        D = BesselProductDistribution(args.beta)
        draw = jax.jit(lambda k: D.draw(
            k, jnp.full((n,), args.x_p, jnp.float64),
            jnp.full((n,), args.x_m, jnp.float64)))
        dens = lambda x: D.evaluate(x, args.x_p, args.x_m)
        lo, hi = -math.pi, math.pi
    else:
        from mlmcpathintegral.distributions.approxbesselproduct import (
            ApproximateBesselProductDistribution)
        D = ApproximateBesselProductDistribution(args.beta)
        draw = jax.jit(lambda k: D.draw(
            k, jnp.full((n,), args.x_p, jnp.float64),
            jnp.full((n,), args.x_m, jnp.float64)))
        dens = lambda x: D.evaluate(x, args.x_p, args.x_m)
        lo, hi = -math.pi, math.pi

    # warm-up (compile), then time (test_distribution.cc timing report)
    x = draw(key)
    jax.block_until_ready(x)
    t0 = time.monotonic()
    x = draw(jax.random.fold_in(key, 1))
    jax.block_until_ready(x)
    dt = time.monotonic() - t0
    print(f"distribution = {args.distribution}")
    print(f"time per sample = {1e9 * dt / n:.2f} ns  "
          f"({n} samples in {dt * 1e3:.1f} ms)")

    xs = np.linspace(lo, hi, 1001)
    ps = np.asarray(dens(jnp.asarray(xs)))
    with open(args.output, "w") as fh:
        fh.write(f"# distribution = {args.distribution}\n")
        fh.write(f"# n_samples = {n}\n")
        fh.write("# === samples ===\n")
        np.savetxt(fh, np.asarray(x))
        fh.write("# === density (x p) ===\n")
        np.savetxt(fh, np.column_stack([xs, ps]))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
