"""Quartic double-well benchmarks (BASELINE.md config 2): single-level vs
two-level consistency, and the alternate-coarsening Schwinger MLMC (the
semi fill-in path inside the full multilevel method)."""

import jax
import jax.numpy as jnp
import pytest

from mlmcpathintegral.conditioned import make_conditioned_fine_action
from mlmcpathintegral.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import (
    MonteCarloMultiLevel, MonteCarloSingleLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral.models import (
    QuarticOscillatorAction, RenormalisationType,
)
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.qoi import qoi_2d_susceptibility, qoi_x_squared
from mlmcpathintegral.samplers import (
    HMCSampler, OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
)


def test_quartic_singlelevel_vs_twolevel():
    """No closed-form oracle for the double well: the two-level fine chain
    must agree with an independent single-level HMC estimate."""
    lat = Lattice1D(16, 4.0)
    act = QuarticOscillatorAction(lat, RenormalisationType.NONE,
                                  m0=1.0, mu2=-1.0, lam=1.0, x0=0.0)
    mc1 = MonteCarloSingleLevel(
        act, qoi_x_squared(act), HMCSampler(act, nt=20, dt=0.1, n_burnin=50),
        n_burnin=300, n_samples=12000, chunk_size=200)
    _, st1 = mc1.evaluate(jax.random.PRNGKey(0), n_chains=64,
                          dtype=jnp.float64)
    a1, e1 = mc1.numerical_result(st1), mc1.statistical_error(st1)

    mc2 = MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=20, dt=0.1,
                                                    n_burnin=50),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=300, n_samples=12000, chunk_size=100)
    st2 = mc2.evaluate_difference(jax.random.PRNGKey(1), n_chains=64,
                                  dtype=jnp.float64)
    a2 = mc2.stats_fine.average(st2["fine"])
    e2 = mc2.stats_fine.error(st2["fine"])
    assert mc2.p_accept > 0.3
    assert abs(a1 - a2) < 4 * (e1**2 + e2**2) ** 0.5, (a1, a2, e1, e2)


def test_quartic_heatbath_gaussian_proposal_not_exact():
    """The quartic heat-bath 'conditional' is the reference's Gaussian
    approximation (qmaction W-geometry); cross-check it stays close to HMC
    at weak coupling where the approximation is good."""
    lat = Lattice1D(16, 4.0)
    act = QuarticOscillatorAction(lat, RenormalisationType.NONE,
                                  m0=1.0, mu2=1.0, lam=0.1, x0=0.0)
    mc1 = MonteCarloSingleLevel(
        act, qoi_x_squared(act), HMCSampler(act, nt=20, dt=0.1, n_burnin=50),
        n_burnin=200, n_samples=8000, chunk_size=200)
    _, st1 = mc1.evaluate(jax.random.PRNGKey(2), n_chains=64,
                          dtype=jnp.float64)
    mc2 = MonteCarloSingleLevel(
        act, qoi_x_squared(act),
        OverrelaxedHeatBathSampler(act, n_burnin=100),
        n_burnin=200, n_samples=8000, chunk_size=200)
    _, st2 = mc2.evaluate(jax.random.PRNGKey(3), n_chains=64,
                          dtype=jnp.float64)
    a1, e1 = mc1.numerical_result(st1), mc1.statistical_error(st1)
    a2, e2 = mc2.numerical_result(st2), mc2.statistical_error(st2)
    # the Gaussian approximation biases at O(lambda); allow a loose band
    assert abs(a1 - a2) < max(6 * (e1**2 + e2**2) ** 0.5, 0.02 * abs(a1))


@pytest.mark.parametrize("ct", [CoarseningType.TEMPORAL,
                                CoarseningType.ALTERNATE])
def test_mlmc_schwinger_semi_coarsening(ct):
    """MLMC through the semi-coarsened fill-in path vs the chi_t oracle."""
    lat = Lattice2D(8, 8, ct)
    act = QuenchedSchwingerAction(
        lat, beta=4.0, renormalisation=RenormalisationType.NONE)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=5000, chunk_size=50)
    mc.evaluate(jax.random.PRNGKey(4), n_chains=64, dtype=jnp.float64)
    num = mc.numerical_result()
    err = mc.statistical_error()
    oracle = act.chit_exact()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)
