"""Distribution tests: normalisation of evaluate, KS test of draw vs the
analytic CDF — the pytest version of the reference's test_distribution.cc.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate, stats as sstats

from mlmcpathintegral.distributions import ExpSin2Distribution


@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0, 64.0])
def test_expsin2_evaluate_normalised(sigma):
    xs = np.linspace(-math.pi, math.pi, 20001)
    p = np.asarray(ExpSin2Distribution.evaluate(jnp.asarray(xs), sigma))
    integral = np.trapezoid(p, xs)
    assert integral == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0, 64.0])
def test_expsin2_draw_ks(sigma):
    key = jax.random.PRNGKey(int(sigma * 10))
    n = 40000
    x = np.asarray(ExpSin2Distribution.draw(
        key, jnp.full((n,), sigma, jnp.float64)))
    assert np.all(np.abs(x) <= math.pi)

    xs = np.linspace(-math.pi, math.pi, 4001)
    pdf = np.asarray(ExpSin2Distribution.evaluate(jnp.asarray(xs), sigma))
    cdf_grid = integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf_grid /= cdf_grid[-1]

    def cdf(v):
        return np.interp(v, xs, cdf_grid)

    d, pval = sstats.kstest(x, cdf)
    assert pval > 1e-3, f"KS test failed: D={d}, p={pval}"


def test_expsin2_per_lane_sigmas():
    # batched draws with per-lane sigma must respect each lane's scale:
    # variance decreases with sigma
    key = jax.random.PRNGKey(0)
    sig = jnp.asarray([1.0] * 20000 + [100.0] * 20000)
    x = np.asarray(ExpSin2Distribution.draw(key, sig))
    v_small = np.var(x[:20000])
    v_large = np.var(x[20000:])
    assert v_large < 0.5 * v_small
    # large sigma limit: approximately Gaussian with var 2/sigma... (sin(x/2)
    # ~ x/2 => p ~ exp(-sigma x^2/4), var = 2/sigma)
    assert v_large == pytest.approx(2.0 / 100.0, rel=5e-2)


def test_truncated_fallback_chain_preserves_density():
    """A Gibbs chain whose ExpSin2 draw is truncated at few rejection rounds
    with keep-current fallback must still equilibrate to the exact density
    (the fallback event is independent of the current value, so the kernel
    is a state-independent mixture of the exact draw with the identity)."""
    sigma = 0.3   # small sigma: wide envelope, low acceptance -> fallback hot
    key = jax.random.PRNGKey(7)
    n = 30000
    x = jnp.zeros((n,), jnp.float64)
    for k in range(40):
        sub = jax.random.fold_in(key, k)
        x = ExpSin2Distribution.draw(sub, jnp.full((n,), sigma, jnp.float64),
                                     fallback=x, max_iter=2)
    xs = np.linspace(-math.pi, math.pi, 4001)
    pdf = np.asarray(ExpSin2Distribution.evaluate(jnp.asarray(xs), sigma))
    cdf_grid = integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf_grid /= cdf_grid[-1]
    d, pval = sstats.kstest(np.asarray(x), lambda v: np.interp(v, xs, cdf_grid))
    assert pval > 1e-3, f"KS test failed: D={d}, p={pval}"
