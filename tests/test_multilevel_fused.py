"""Fused MonteCarloMultiLevel (Schwinger) vs the analytic oracle, through
the fused chunks' plain-JAX references on the CPU."""

import jax
import jax.numpy as jnp

from mlmcpathintegral.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import MonteCarloMultiLevel
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.qoi import qoi_2d_susceptibility
from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler


def test_fused_mlmc_matches_oracle():
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=50),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=200, n_samples=6000, chunk_size=25,
        fused="reference")
    mc.evaluate(jax.random.PRNGKey(7), n_chains=256, dtype=jnp.float32)
    num = mc.numerical_result()
    err = mc.statistical_error()
    oracle = act.chit_exact()
    assert abs(num - oracle) < 4 * err, (num, err, oracle)
    # the adaptive subsampling rate must have been learned (> initial 2
    # would mean a slow coarse sampler; heat bath at 4x4 decorrelates
    # fast, so it should stay small but defined)
    assert all(1 <= t <= mc.t_max for t in mc._t_sub)


def test_fused_t_sub_clocks_on_slow_mode():
    """The fused t_sub clock must run on
    max(tau_QoI, tau_slow) of the in-kernel coarse chain, not the QoI
    alone.  Feed the updater a FAST QoI series (tau ~ 1) together with a
    SLOW plaquette-energy series (AR(1), tau ~ 9): t_sub must rise above
    the FUSED_T_SUB_MIN floor.  Reverting the clock to QoI-only leaves
    t_sub pinned at the floor and fails this test."""
    import numpy as np

    from mlmcpathintegral.utils import statistics as stats_mod

    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=10),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=20, n_samples=100, chunk_size=10,
        fused="reference")

    C = 64
    st_cs = mc.stats_cs[0].init(C, jnp.float32)
    st_slow = mc.stats_slow[0].init(C, jnp.float32)
    # fast QoI series: iid -> tau ~ 1
    fast = jax.random.normal(jax.random.PRNGKey(0), (512, C))
    st_cs = stats_mod.record_many(st_cs, fast)
    # slow configuration mode: AR(1) with rho = 0.9 -> tau ~ 9.5
    rng = np.random.RandomState(1)
    x = np.zeros((512, C), np.float32)
    cur = rng.randn(C)
    for t in range(512):
        cur = 0.9 * cur + rng.randn(C) * np.sqrt(1 - 0.9 ** 2)
        x[t] = cur
    st_slow = stats_mod.record_many(st_slow, jnp.asarray(x))
    tau_slow = mc.stats_slow[0].tau_int(st_slow)
    assert tau_slow > 4.0, tau_slow    # the synthetic series IS slow

    carries = [(None, None, None, st_cs, st_slow, None)]
    mc._t_sub = [mc.FUSED_T_SUB_MIN, mc.FUSED_T_SUB_MIN]
    st_L = mc.stats_slow[1].init(C, jnp.float32)
    carry_L = (None, None, st_L, st_L, None)   # empty coarsest traces
    mc._update_t_sub(carries, carry_L)
    assert mc._t_sub[0] > mc.FUSED_T_SUB_MIN, \
        (mc._t_sub, tau_slow, "t_sub ignored the slow mode")
    assert mc._t_sub[0] >= 1 << (int(2 * tau_slow) - 1).bit_length() // 1
