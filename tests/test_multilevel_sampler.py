"""MultilevelSampler (tau-adaptive persistent level walk) tests."""

import jax
import jax.numpy as jnp
import pytest

from mlmcpathintegral.conditioned import make_conditioned_fine_action
from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.mc import MonteCarloSingleLevel
from mlmcpathintegral.models import (
    HarmonicOscillatorAction, RenormalisationType, RotorAction,
)
from mlmcpathintegral.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral.samplers.cluster import ClusterSampler
from mlmcpathintegral.samplers.exact import ExactSampler
from mlmcpathintegral.samplers.multilevel import MultilevelSampler


def test_multilevel_sampler_harmonic_oracle():
    lat = Lattice1D(32, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    sampler = MultilevelSampler(
        act, qoi_x_squared, ExactSampler, make_conditioned_fine_action,
        n_max_level=3)
    mc = MonteCarloSingleLevel(act, qoi_x_squared(act), sampler,
                               n_burnin=50, n_samples=4000, chunk_size=50)
    _, stats = mc.evaluate(jax.random.PRNGKey(0), n_chains=32,
                           dtype=jnp.float64)
    num = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = act.Xsquared_analytical()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)
    # tau-decorrelated promotion should give a nearly independent chain
    assert mc.stats_Q.tau_int(stats) < 2.5


def test_multilevel_sampler_rotor_oracle():
    lat = Lattice1D(32, 4.0)
    act = RotorAction(lat, RenormalisationType.PERTURBATIVE, m0=1.0)
    sampler = MultilevelSampler(
        act, qoi_susceptibility,
        lambda a: ClusterSampler(a, n_burnin=50, n_updates=5),
        make_conditioned_fine_action, n_max_level=3)
    mc = MonteCarloSingleLevel(act, qoi_susceptibility(act), sampler,
                               n_burnin=50, n_samples=4000,
                               n_autocorr_window=40, chunk_size=50)
    _, stats = mc.evaluate(jax.random.PRNGKey(1), n_chains=32,
                           dtype=jnp.float64)
    num = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = act.chit_exact()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)


def test_t_indep_bookkeeping():
    lat = Lattice1D(16, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    sampler = MultilevelSampler(
        act, qoi_x_squared, ExactSampler, make_conditioned_fine_action,
        n_max_level=2)
    state = sampler.prepare(jax.random.PRNGKey(2), 16, jnp.float64)
    for k in range(20):
        state, acc = sampler.draw(jax.random.PRNGKey(10 + k), state)
    t_indep = sampler.t_indep(state)
    assert (t_indep >= 1.0).all()
    assert int(state.n_indep[0]) == 20   # one promotion per draw at level 0
