"""GaussianFillinDistribution + Gaussian Schwinger fill-in tests —
the pytest analog of test_schwinger_fillin_distribution.cc."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
    QuenchedSchwingerGaussianConditionedFineAction,
)
from mlmcpathintegral.distributions.gaussianfillin import (
    GaussianFillinDistribution,
)
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import MonteCarloTwoLevel
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.qoi import qoi_2d_susceptibility
from mlmcpathintegral.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)
from mlmcpathintegral.utils.special import mod_2pi


def test_draw_satisfies_plaquette_sum_constraints():
    """The four drawn thetas combined with the phis must reproduce the
    structure theta_k - theta_{k+1} - phi_{k,k+1} = plaquette residuals
    whose sum telescopes to -4 Phi + 4 Phi = ... in particular the draw's
    eta-representation must round-trip through evaluate's eta extraction to
    the sampled mixture component.  We check the weaker, sharp property
    that the density evaluates to a finite positive value at every draw."""
    beta = 16.0
    dist = GaussianFillinDistribution(beta)
    key = jax.random.PRNGKey(0)
    n = 20000
    kphi, kdraw = jax.random.split(key)
    phis = jax.random.uniform(kphi, (4, n), jnp.float64, -math.pi, math.pi)
    th = dist.draw(kdraw, *phis)
    p = np.asarray(dist.evaluate(*th, *phis))
    assert np.all(np.isfinite(p))
    assert np.all(p > 0)


def test_marginal_of_vertical_sum_close_to_besselproduct():
    """Integrating the Gaussian fill-in over the gauge directions, the sum
    theta_tilde = theta_4 - theta_2 (the two interior vertical links,
    cc:118-133 sign conventions) should approximately follow the
    BesselProduct distribution of the exact fill-in.  We compare the
    moments of (theta_4 - theta_2) mod 2pi between the Gaussian and exact
    fill-ins on identical coarse backgrounds."""
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=16.0)
    exact = QuenchedSchwingerConditionedFineAction(act)   # approx branch >8
    gauss = QuenchedSchwingerGaussianConditionedFineAction(act)
    coarse = act.coarse_action()
    key = jax.random.PRNGKey(1)
    kc, k1, k2 = jax.random.split(key, 3)
    C = 4096
    theta_c = coarse.initialise_state(kc, C, jnp.float64)
    base = act.prolongate(theta_c, jnp.zeros((C, act.ndof), jnp.float64))
    f1 = exact.fill_fine_points(k1, base)
    f2 = gauss.fill_fine_points(k2, base)
    # compare the plaquette-angle distributions of the two fills
    p1 = np.asarray(mod_2pi(act.plaquette_angles(f1))).ravel()
    p2 = np.asarray(mod_2pi(act.plaquette_angles(f2))).ravel()
    assert abs(p1.mean() - p2.mean()) < 0.02
    assert abs(p1.std() - p2.std()) < 0.05 * p1.std() + 0.02


def test_gaussian_fill_preserves_coarse_sums():
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=20.0)
    cond = QuenchedSchwingerGaussianConditionedFineAction(act)
    coarse = act.coarse_action()
    key = jax.random.PRNGKey(2)
    kc, kf = jax.random.split(key)
    theta_c = coarse.initialise_state(kc, 16, jnp.float64)
    theta_f = act.prolongate(theta_c, jnp.zeros((16, act.ndof), jnp.float64))
    theta_f = cond.fill_fine_points(kf, theta_f)
    back = np.asarray(act.restrict(theta_f))
    np.testing.assert_allclose(back, np.asarray(mod_2pi(theta_c)),
                               atol=1e-10)


def test_twolevel_with_gaussian_fillin_matches_oracle():
    """The Gaussian fill-in is only an approximation, but the two-level
    Metropolis screen corrects it exactly — the fine chain must still hit
    the analytic chi_t."""
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    mc = MonteCarloTwoLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5),
        conditioned_fine_action_factory=(
            QuenchedSchwingerGaussianConditionedFineAction),
        n_burnin=50, n_samples=6000, chunk_size=50)
    stats = mc.evaluate_difference(jax.random.PRNGKey(3), n_chains=64,
                                   dtype=jnp.float64)
    avg = mc.stats_fine.average(stats["fine"])
    err = mc.stats_fine.error(stats["fine"])
    oracle = act.chit_exact()
    assert mc.p_accept > 0.05
    assert abs(avg - oracle) < 4 * err, (avg, oracle, err, mc.p_accept)
