"""CounterRng stream-independence regression tests.

The two-lane counter RNG (ops/counter_rng.py) once combined its site and
chain lanes by XOR; at fixed counter the ensemble then held a single
random word per chain, reused by every site/step through constant XOR
masks — perfectly uniform marginals, but cross-site float correlations
of -0.9 and cross-step correlations of +0.97 that biased fused HMC
chains at the percent level.  These tests pin the fixed combiner
(fmix32 of the lane SUM): all pairwise correlations across sites,
steps and counters must sit at statistical noise.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.ops.counter_rng import CounterRng


def _streams(n_steps=6, n_ctr=3, Mc=8, C=8192):
    site = jnp.tile(jnp.arange(Mc, dtype=jnp.uint32)[:, None], (1, C))
    chain = jnp.tile(jnp.arange(C, dtype=jnp.uint32)[None, :], (Mc, 1))
    out = {}
    for t in range(n_steps):
        rng = CounterRng(jnp.uint32(12345), site, chain, jnp.uint32(99887),
                         step=t)
        for c in range(1, n_ctr + 1):
            out[(t, c)] = np.asarray(rng.uniform(jnp.float64))
    return out


def _corr(a, b):
    return np.corrcoef(a.ravel(), b.ravel())[0, 1]


def test_uniform_pairwise_independence():
    UU = _streams()
    C = UU[(0, 1)].shape[1]
    # 3-sigma band for iid streams over C samples
    tol = 4.0 / np.sqrt(C)
    # cross-site, same (step, counter) — the broken combiner gave -0.9
    assert abs(_corr(UU[(0, 1)][0], UU[(0, 1)][1])) < tol
    assert abs(_corr(UU[(0, 1)][0], UU[(0, 1)][4])) < tol
    # cross-step, same (site, counter) — the broken combiner gave +0.97
    assert abs(_corr(UU[(0, 1)][0], UU[(1, 1)][0])) < tol
    assert abs(_corr(UU[(0, 1)][0], UU[(4, 1)][0])) < tol
    # cross-counter, same (site, step)
    assert abs(_corr(UU[(0, 1)][0], UU[(0, 2)][0])) < tol
    # marginals
    u = np.concatenate([UU[(t, 1)].ravel() for t in range(6)])
    assert abs(u.mean() - 0.5) < 3e-3
    assert abs(u.var() - 1.0 / 12.0) < 1e-3


def test_normal_moments_and_cross_step():
    Mc, C = 8, 8192
    site = jnp.tile(jnp.arange(Mc, dtype=jnp.uint32)[:, None], (1, C))
    chain = jnp.tile(jnp.arange(C, dtype=jnp.uint32)[None, :], (Mc, 1))
    zs = []
    for t in range(6):
        rng = CounterRng(jnp.uint32(5), site, chain, jnp.uint32(6), step=t)
        zs.append(np.asarray(rng.normal(jnp.float64)))
    Z = np.stack(zs)
    z = Z.ravel()
    assert abs(z.mean()) < 0.01
    assert abs(z.var() - 1.0) < 0.02
    assert abs(((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0) < 0.05
    tol = 4.0 / np.sqrt(C)
    assert abs(_corr(Z[0, 0], Z[1, 0])) < tol        # momentum refresh
    assert abs(_corr(Z[0, 0], Z[0, 1])) < tol        # cross-site


def test_distinct_streams_change_with_seed():
    site = jnp.zeros((4, 16), jnp.uint32)
    chain = jnp.tile(jnp.arange(16, dtype=jnp.uint32)[None, :], (4, 1))
    a = CounterRng(jnp.uint32(1), site, chain, jnp.uint32(2)).bits()
    b = CounterRng(jnp.uint32(1), site, chain, jnp.uint32(3)).bits()
    c = CounterRng(jnp.uint32(2), site, chain, jnp.uint32(2)).bits()
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
