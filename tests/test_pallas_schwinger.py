"""Fused Schwinger sweep chain (ops/schwinger.py) through its plain-JAX
reference on the CPU; the CUDA kernel is compared with the same reference
on the card by chip_smoke.py (phase 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.ops.schwinger import schwinger_sweep_chain
from mlmcpathintegral.qoi import qoi_2d_susceptibility


def _sweep(theta, seed, **kw):
    """One reference draw (n_steps=1) returning only the new links."""
    return schwinger_sweep_chain(theta, seed, n_steps=1, reference=True,
                                 **kw)[0]


def test_overrelax_matches_xla_sweep():
    """With heat-bath off the kernel is deterministic and must reproduce
    the XLA overrelaxation sweep exactly (same group order, same math)."""
    Mt, Mx, C = 8, 8, 128
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=3.0)
    theta = jax.random.uniform(jax.random.PRNGKey(0), (C, lat.nedges),
                               jnp.float32, -np.pi, np.pi)
    ref = act.overrelaxation_sweep(theta)
    out = _sweep(theta, 0, beta=3.0, Mt=Mt, Mx=Mx, n_overrelax=1,
                 n_heatbath=0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=2e-6)


def test_heatbath_chain_matches_oracle():
    """A chain driven by the fused sweep must reproduce the analytic
    susceptibility (driver_qft.cc-style consistency check)."""
    Mt, Mx, BETA, C = 4, 4, 2.0, 1024
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=BETA)
    qoi = qoi_2d_susceptibility(act)
    theta = jax.random.uniform(jax.random.PRNGKey(1), (C, lat.nedges),
                               jnp.float32, -np.pi, np.pi)

    def step(theta, seed):
        return _sweep(theta, seed, beta=BETA, Mt=Mt, Mx=Mx)

    for k in range(60):                      # burn-in
        theta = step(theta, k)
    vals = []
    for k in range(60, 260):
        theta = step(theta, k)
        vals.append(np.asarray(qoi(theta)))
    vals = np.concatenate(vals)
    est, err = vals.mean(), vals.std() / np.sqrt(len(vals) / (2 * 25.0))
    oracle = act.chit_exact()
    assert abs(est - oracle) < 4 * err, (est, err, oracle)


def test_chain_kernel_matches_stepwise():
    """A multi-step launch must bit-match n_steps single-step launches
    with the same seed pair and step_offset = 0..n-1, and its QoI trace
    must equal the susceptibility reduction of the intermediate states."""
    from mlmcpathintegral.utils.special import mod_2pi

    Mt, Mx, BETA, C, N = 4, 4, 2.0, 128, 3
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=BETA)
    theta0 = jax.random.uniform(jax.random.PRNGKey(3), (C, lat.nedges),
                                jnp.float32, -np.pi, np.pi)
    seed = jnp.asarray([17, -5], jnp.int32)

    theta_c, qsum, esum = schwinger_sweep_chain(
        theta0, seed, beta=BETA, Mt=Mt, Mx=Mx, n_steps=N, reference=True)

    theta = theta0
    for s in range(N):
        theta = _sweep(theta, seed, beta=BETA, Mt=Mt, Mx=Mx, step_offset=s)
        plaq = mod_2pi(act.plaquette_angles(theta))
        np.testing.assert_allclose(
            np.asarray(qsum[s]), np.asarray(jnp.sum(plaq, axis=(-2, -1))),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(esum[s]),
            np.asarray(jnp.sum(jnp.cos(plaq), axis=(-2, -1))),
            rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(theta_c), np.asarray(theta))


def test_draw_chain_sampler_oracle():
    """OverrelaxedHeatBathSampler.draw_chain (scan of XLA draws)
    reproduces the analytic susceptibility from its QoI trace."""
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler

    Mt, Mx, BETA, C = 4, 4, 2.0, 512
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=BETA)
    smp = OverrelaxedHeatBathSampler(act, n_burnin=50)
    key = jax.random.PRNGKey(4)
    st = smp.prepare(key, C, jnp.float32)
    st, qsum = smp.draw_chain(jax.random.fold_in(key, 1), st, 200)
    y = np.asarray(qsum) ** 2 / (4 * np.pi ** 2)
    est = y.mean()
    err = y.std() / np.sqrt(y.size / (2 * 25.0))
    oracle = act.chit_exact()
    assert abs(est - oracle) < 4 * err, (est, err, oracle)


def _fused_sampler(fused="reference", beta=2.0, M=4, **kw):
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=beta)
    return act, OverrelaxedHeatBathSampler(act, fused=fused, **kw)


def test_sampler_fused_route_is_the_sweep_chain():
    """fused draw_chain is one launch of the sweep chain with the seed
    drawn from its key, and a fused draw is one step of it."""
    from mlmcpathintegral.samplers.heatbath import HeatBathState

    act, smp = _fused_sampler()
    x0 = jax.random.uniform(jax.random.PRNGKey(5), (64, act.lattice.nedges),
                            jnp.float32, -np.pi, np.pi)
    key = jax.random.PRNGKey(6)
    seed = jax.random.randint(key, (2,), -2**31, 2**31 - 1, jnp.int32)
    st, qsum = smp.draw_chain(key, HeatBathState(x=x0), 5)
    x5, q5, _ = schwinger_sweep_chain(x0, seed, beta=2.0, Mt=4, Mx=4,
                                      n_steps=5, reference=True)
    np.testing.assert_array_equal(np.asarray(st.x), np.asarray(x5))
    np.testing.assert_array_equal(np.asarray(qsum), np.asarray(q5))
    st1, acc = smp.draw(key, HeatBathState(x=x0))
    np.testing.assert_array_equal(np.asarray(st1.x),
                                  np.asarray(_sweep(x0, seed, beta=2.0,
                                                    Mt=4, Mx=4)))
    assert acc.shape == (64,) and bool(acc.all())


def test_sampler_fused_chain_matches_oracle():
    """A prepared sampler on the fused route (reference) reproduces the
    analytic susceptibility, as the XLA route does."""
    act, smp = _fused_sampler(n_burnin=50)
    key = jax.random.PRNGKey(7)
    st = smp.prepare(key, 512, jnp.float32)
    st, qsum = smp.draw_chain(jax.random.fold_in(key, 1), st, 200)
    y = np.asarray(qsum) ** 2 / (4 * np.pi ** 2)
    err = y.std() / np.sqrt(y.size / (2 * 25.0))
    assert abs(y.mean() - act.chit_exact()) < 4 * err


@pytest.mark.parametrize("fused,model,match", [
    ("mosaic", "schwinger", "fused must be one of"),
    ("cuda", "gff", "quenched Schwinger action only"),
    ("reference", "rotor", "quenched Schwinger action only"),
])
def test_sampler_fused_refuses_what_it_cannot_run(fused, model, match):
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.models.qft import GFFAction
    from mlmcpathintegral.models.rotor import RotorAction
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    act = {"schwinger": lambda: QuenchedSchwingerAction(
               Lattice2D(4, 4, CoarseningType.BOTH), beta=2.0),
           "gff": lambda: GFFAction(
               Lattice2D(4, 4, CoarseningType.BOTH), mass=1.0),
           "rotor": lambda: RotorAction(Lattice1D(M_lat=8, T_final=4.0),
                                        m0=0.25)}[model]()
    with pytest.raises(ValueError, match=match):
        OverrelaxedHeatBathSampler(act, fused=fused)


def test_sampler_fused_cuda_refuses_the_cpu():
    """fused="cuda" never falls back to the reference or to XLA."""
    from mlmcpathintegral.samplers.heatbath import HeatBathState
    act, smp = _fused_sampler("cuda")
    x0 = jnp.zeros((8, act.lattice.nedges), jnp.float32)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        smp.draw(jax.random.PRNGKey(0), HeatBathState(x=x0))


def test_element_capacity_guard():
    """Only configurations whose per-lane ids would wrap uint32 are
    rejected; 128x64 (8192 sites — beyond the old 4096-site packed-id
    cap) is accepted by the two-lane scheme."""
    from mlmcpathintegral.ops.counter_rng import check_element_capacity

    check_element_capacity(128 * 128, 1 << 20)      # fine now
    with pytest.raises(ValueError, match="counter RNG supports"):
        check_element_capacity(1 << 32, 1)
    with pytest.raises(ValueError, match="counter RNG supports"):
        check_element_capacity(1, 1 << 32)


def test_rng_stream_distinctness():
    """Two-lane streams: elements that collided under the old packed
    32-bit id (site + 2^20*chain mod 2^32) must now produce distinct
    bit streams; identical (site, chain) must reproduce exactly."""
    from mlmcpathintegral.ops.counter_rng import CounterRng

    # sites beyond the old 4096 cap, chains beyond 2^20, plus aliasing
    # pairs under the old packing: (site, chain) and (site + 4096, chain)
    sites = jnp.asarray([0, 1, 4095, 4096, 8191, 16383, 2**20],
                        jnp.uint32)
    chains = jnp.asarray([0, 1, 2**20, 2**21, 5, 7, 11], jnp.uint32)
    seed = jnp.uint32(12345)
    seed2 = jnp.uint32(777)

    def stream(s, c):
        rng = CounterRng(seed, s, c, seed2)
        return np.asarray(jnp.stack([rng.bits() for _ in range(4)]))

    seen = {}
    for s in np.asarray(sites):
        for c in np.asarray(chains):
            key = tuple(stream(jnp.uint32(s), jnp.uint32(c)))
            assert key not in seen, (s, c, seen[key])
            seen[key] = (int(s), int(c))

    # reproducibility: same (seed, site, chain) -> same stream
    a = stream(jnp.uint32(4096), jnp.uint32(3))
    b = stream(jnp.uint32(4096), jnp.uint32(3))
    np.testing.assert_array_equal(a, b)
