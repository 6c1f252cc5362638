"""Chain-parallel sharding tests: the analog of the reference's invariant
that the same binary under ``mpirun -n N`` reproduces sequential statistics
(SURVEY.md §4) — here the same jitted program must produce identical
results with the chain axis on one device or sharded over the 8-device CPU
mesh, with statistics reductions compiling to collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models import HarmonicOscillatorAction
from mlmcpathintegral.parallel import chain_mesh, distribute_n, shard_chains
from mlmcpathintegral.qoi import qoi_x_squared
from mlmcpathintegral.samplers import HMCSampler
from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


def _cpu_devices():
    return jax.local_devices(backend="cpu")


def test_distribute_n():
    assert distribute_n(100, 8) == 13
    assert distribute_n(96, 8) == 12
    assert distribute_n(1, 8) == 1


def test_sharded_step_matches_single_device():
    devices = _cpu_devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    lat = Lattice1D(16, 4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=8, dt=0.1)
    qoi = qoi_x_squared(lat)
    stats = Statistics("Q", 10)
    C = 64

    def make_run():
        @jax.jit
        def run(key, sstate, stats_state):
            def body(carry, k):
                ss, st = carry
                ss, acc = sampler.draw(k, ss)
                st = stats_mod.record(st, qoi(ss.x))
                return (ss, st), None
            keys = jax.random.split(key, 20)
            (ss, st), _ = jax.lax.scan(body, (sstate, stats_state), keys)
            tau = stats_mod.tau_int_device(st)
            var = stats_mod.variance_device(st)
            return ss, st, tau, var
        return run

    key = jax.random.PRNGKey(0)
    sstate = sampler.init(key, C, jnp.float64)
    stats_state = stats.init(C, jnp.float64)

    # single device
    run1 = make_run()
    ss1, st1, tau1, var1 = run1(jax.random.PRNGKey(1), sstate, stats_state)

    # sharded over the 8-device mesh
    mesh = chain_mesh(8, devices=devices)
    sstate_sh = shard_chains(mesh, sstate)
    stats_sh = shard_chains(mesh, stats_state)
    run2 = make_run()
    ss2, st2, tau2, var2 = run2(jax.random.PRNGKey(1), sstate_sh, stats_sh)

    # sharding must not change the numbers (same program, same keys)
    np.testing.assert_allclose(np.asarray(ss1.x), np.asarray(ss2.x),
                               rtol=1e-12)
    np.testing.assert_allclose(float(tau1), float(tau2), rtol=1e-12)
    np.testing.assert_allclose(float(var1), float(var2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st1.S_k), np.asarray(st2.S_k),
                               rtol=1e-12)
    # and the chain axis must really be distributed
    assert len(ss2.x.sharding.device_set) == 8


def test_sharded_full_mc_estimate():
    """End-to-end single-level MC with sharded initial states gives the
    same estimate as unsharded (host pulls aggregate transparently)."""
    devices = _cpu_devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    from mlmcpathintegral.mc import MonteCarloSingleLevel

    lat = Lattice1D(16, 4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    qoi = qoi_x_squared(lat)

    mc = MonteCarloSingleLevel(action, qoi,
                               HMCSampler(action, nt=8, dt=0.1, n_burnin=20),
                               n_burnin=50, n_samples=2000, chunk_size=100)
    _, stats = mc.evaluate(jax.random.PRNGKey(2), n_chains=64,
                           dtype=jnp.float64)
    est = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = action.Xsquared_analytical()
    assert abs(est - oracle) < 5 * err
