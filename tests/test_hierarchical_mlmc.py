"""Hierarchical sampler + full MLMC integration tests against oracles."""

import jax
import jax.numpy as jnp
import pytest

from mlmcpathintegral.conditioned import make_conditioned_fine_action
from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.mc import (
    MonteCarloMultiLevel, MonteCarloSingleLevel,
)
from mlmcpathintegral.models import (
    HarmonicOscillatorAction, RenormalisationType, RotorAction,
)
from mlmcpathintegral.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral.samplers.cluster import ClusterSampler
from mlmcpathintegral.samplers.exact import ExactSampler
from mlmcpathintegral.samplers.hierarchical import HierarchicalSampler


def test_hierarchical_sampler_harmonic():
    lat = Lattice1D(32, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    sampler = HierarchicalSampler(
        act, coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_max_level=3)
    mc = MonteCarloSingleLevel(act, qoi_x_squared(lat), sampler,
                               n_burnin=100, n_samples=6000, chunk_size=100)
    _, stats = mc.evaluate(jax.random.PRNGKey(0), n_chains=64,
                           dtype=jnp.float64)
    num = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = act.Xsquared_analytical()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)
    # the delayed-acceptance chain should be nearly independent:
    assert mc.stats_Q.tau_int(stats) < 2.0


def test_hierarchical_sampler_rotor_tau_int_reduction():
    """README fig. 3 (left) claim: hierarchical sampling keeps tau_int flat
    where plain HMC autocorrelates — here we just check the hierarchical
    chain's tau_int on chi_t is small."""
    lat = Lattice1D(64, 4.0)
    act = RotorAction(lat, RenormalisationType.PERTURBATIVE, m0=1.0)
    sampler = HierarchicalSampler(
        act,
        coarse_sampler_factory=lambda a: ClusterSampler(a, n_burnin=50,
                                                        n_updates=5),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_max_level=4)
    mc = MonteCarloSingleLevel(act, qoi_susceptibility(lat), sampler,
                               n_burnin=100, n_samples=8000,
                               n_autocorr_window=40, chunk_size=100)
    _, stats = mc.evaluate(jax.random.PRNGKey(1), n_chains=64,
                           dtype=jnp.float64)
    num = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = act.chit_exact()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)
    assert mc.stats_Q.tau_int(stats) < 3.0


def test_mlmc_harmonic_matches_oracle():
    lat = Lattice1D(32, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    mc = MonteCarloMultiLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_level=3, n_burnin=200, n_samples=8000, chunk_size=100)
    mc.evaluate(jax.random.PRNGKey(2), n_chains=32, dtype=jnp.float64)
    num = mc.numerical_result()
    err = mc.statistical_error()
    oracle = act.Xsquared_analytical()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)


def test_mlmc_adaptive_epsilon_mode():
    lat = Lattice1D(16, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    eps = 0.01
    mc = MonteCarloMultiLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_level=2, epsilon=eps, n_burnin=100, chunk_size=100)
    mc.evaluate(jax.random.PRNGKey(3), n_chains=32, dtype=jnp.float64)
    num = mc.numerical_result()
    oracle = act.Xsquared_analytical()
    assert mc.statistical_error() < eps
    assert abs(num - oracle) < 4 * max(mc.statistical_error(), 1e-4)


def test_mlmc_self_flags_window_capped_tau():
    """VERDICT r3 item 3: a slowly-decorrelating level whose tau_int
    saturates the autocorrelation window must flag itself (reliability
    report + robust error) instead of quoting a tight wrong error bar —
    the failure mode of the r3 64x64 fixed-beta scale study."""
    import jax
    import jax.numpy as jnp

    from mlmcpathintegral.conditioned import make_conditioned_fine_action
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.mc import MonteCarloMultiLevel
    from mlmcpathintegral.models import HarmonicOscillatorAction
    from mlmcpathintegral.qoi import qoi_x_squared
    from mlmcpathintegral.samplers import HMCSampler

    act = HarmonicOscillatorAction(Lattice1D(M_lat=16, T_final=4.0),
                                   m0=1.0, mu2=1.0)
    # nt*dt = 0.08: tiny HMC moves => tau ~30 >> window 4 (and the
    # series is long enough for the binning plateau to resolve it)
    mc = MonteCarloMultiLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=1, dt=0.08,
                                                    n_burnin=20),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_level=2, n_burnin=50, n_samples=128000, chunk_size=200,
        n_autocorr_window=4)
    mc.evaluate(jax.random.PRNGKey(5), n_chains=64, dtype=jnp.float64)
    rel = mc.reliability
    coarsest = rel[-1]
    assert coarsest["window_capped"], rel
    assert coarsest["tau_binning"] is not None
    assert coarsest["tau_binning"] > 1.5 * coarsest["tau_int"], rel
    assert coarsest["flagged"] and not mc.reliable
    # the robust error bar must be materially wider than the naive one
    assert (mc.statistical_error_robust()
            > 1.2 * mc.statistical_error()), (
        mc.statistical_error_robust(), mc.statistical_error())
