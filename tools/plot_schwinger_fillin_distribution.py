#!/usr/bin/env python
"""Overlay the exact (BesselProduct-based) and Gaussian-approximation
fill-in distributions of the interior vertical-link sum — the analog of the
reference's test_schwinger_fillin_distribution + plotting script
(src/test_schwinger_fillin_distribution.cc:60-130).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--x-p", type=float, default=0.5)
    ap.add_argument("--x-m", type=float, default=-0.3)
    ap.add_argument("--n-samples", type=int, default=100000)
    ap.add_argument("--output", default="schwinger_fillin.pdf")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    try:
        jax.config.update("jax_default_device",
                          jax.local_devices(backend="cpu")[0])
    except RuntimeError:
        pass
    import jax.numpy as jnp

    from mlmcpathintegral.distributions.approxbesselproduct import (
        ApproximateBesselProductDistribution,
    )

    key = jax.random.PRNGKey(0)
    n = args.n_samples
    xp = jnp.full((n,), args.x_p, jnp.float64)
    xm = jnp.full((n,), args.x_m, jnp.float64)

    approx = ApproximateBesselProductDistribution(args.beta)
    x_approx = np.asarray(approx.draw(jax.random.fold_in(key, 1), xp, xm))
    xs = np.linspace(-np.pi, np.pi, 801)
    p_approx = np.asarray(approx.evaluate(jnp.asarray(xs), args.x_p,
                                          args.x_m))

    have_exact = args.beta <= 8.0
    if have_exact:
        from mlmcpathintegral.distributions.besselproduct import (
            BesselProductDistribution,
        )
        exact = BesselProductDistribution(args.beta)
        x_exact = np.asarray(exact.draw(jax.random.fold_in(key, 2), xp, xm))
        p_exact = np.asarray(exact.evaluate(jnp.asarray(xs), args.x_p,
                                            args.x_m))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    if have_exact:
        ax.hist(x_exact, bins=80, density=True, alpha=0.4,
                label="exact samples")
        ax.plot(xs, p_exact, "C0-", lw=2, label="exact density")
    ax.hist(x_approx, bins=80, density=True, alpha=0.4, color="C3",
            label="approx samples")
    ax.plot(xs, p_approx, "C3--", lw=2, label="approx density")
    ax.set_xlabel(r"$\tilde\theta$")
    ax.set_ylabel("p")
    ax.set_title(f"Schwinger fill-in, beta={args.beta}, "
                 f"x_p={args.x_p}, x_m={args.x_m}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
