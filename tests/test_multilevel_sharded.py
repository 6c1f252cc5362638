"""Chain-sharded multilevel methods on the virtual device mesh
(VERDICT r1 item 6): the MLMC and two-level estimators must produce the
same statistics whether the chain carries live on one device or are
sharded over 8 — the analog of the reference's mpirun invariant
(SURVEY.md §4), applied to the one method the reference cannot
parallelise at all (driver_qm.cc:382-386)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import MonteCarloMultiLevel, MonteCarloTwoLevel
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.parallel import chain_mesh
from mlmcpathintegral.qoi import qoi_2d_susceptibility
from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler


def _cpu_devices():
    # the virtual 8-device mesh lives on the CPU backend
    # (tests/conftest.py)
    return jax.local_devices(backend="cpu")


def _need_devices(n):
    if len(_cpu_devices()) < n:
        pytest.skip(f"needs {n} CPU devices")


def _mlmc():
    lat = Lattice2D(4, 4, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=2.0)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=10),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=16, n_samples=64, chunk_size=8)


def test_mlmc_sharded_matches_single_device():
    _need_devices(8)
    key = jax.random.PRNGKey(11)

    mc1 = _mlmc()
    mc1.evaluate(key, n_chains=16, dtype=jnp.float32)
    r1, e1 = mc1.numerical_result(), mc1.statistical_error()

    mc2 = _mlmc()
    mesh = chain_mesh(8, devices=_cpu_devices())
    mc2.evaluate(key, n_chains=16, dtype=jnp.float32, mesh=mesh)
    r2, e2 = mc2.numerical_result(), mc2.statistical_error()
    # the sharded stats must actually live on all 8 devices
    st = mc2._final_stats[0]
    assert len(st.avg.sharding.device_set) == 8

    np.testing.assert_allclose(r1, r2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-6)


def test_twolevel_sharded_matches_single_device():
    _need_devices(8)
    lat = Lattice2D(4, 4, CoarseningType.BOTH)

    def build():
        act = QuenchedSchwingerAction(lat, beta=2.0)
        return MonteCarloTwoLevel(
            act, qoi_2d_susceptibility,
            lambda a: OverrelaxedHeatBathSampler(a, n_burnin=10),
            make_schwinger_conditioned_fine_action,
            n_burnin=16, n_samples=64, chunk_size=8)

    key = jax.random.PRNGKey(13)
    mc1 = build()
    s1 = mc1.evaluate_difference(key, n_chains=16, dtype=jnp.float32)
    mc2 = build()
    s2 = mc2.evaluate_difference(key, n_chains=16, dtype=jnp.float32,
                                 mesh=chain_mesh(8, devices=_cpu_devices()))
    for k in ("fine", "coarse", "diff"):
        np.testing.assert_allclose(
            mc1.stats_fine.average(s1[k]), mc1.stats_fine.average(s2[k]),
            rtol=1e-5, atol=1e-6)
    assert mc1.p_accept == mc2.p_accept
