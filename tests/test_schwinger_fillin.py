"""Schwinger conditioned fill-in tests: BesselProduct distributions, the
three-step fill-in, and the two-level / multilevel methods against the
analytic chi_t oracle — the pytest analog of
test_schwinger_fillin_distribution.cc plus the driver_qft consistency check.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate, special as ssp, stats as sstats

from mlmcpathintegral.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
    QuenchedSchwingerSemiConditionedFineAction,
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution,
)
from mlmcpathintegral.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import MonteCarloMultiLevel, MonteCarloTwoLevel
from mlmcpathintegral.models.base import RenormalisationType
from mlmcpathintegral.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral.qoi import qoi_2d_susceptibility
from mlmcpathintegral.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)


# ---------------------------------------------------------------------------
# BesselProduct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [2.0, 4.0, 8.0])
def test_besselproduct_evaluate_normalised(beta):
    dist = BesselProductDistribution(beta)
    for xp, xm in [(0.5, -0.3), (2.0, -2.5), (0.0, 3.0)]:
        xs = np.linspace(-math.pi, math.pi, 8001)
        p = np.asarray(dist.evaluate(jnp.asarray(xs), xp, xm))
        assert np.trapezoid(p, xs) == pytest.approx(1.0, rel=1e-6), (xp, xm)


def test_besselproduct_znorm_matches_quadrature():
    beta = 4.0
    dist = BesselProductDistribution(beta)
    for phi in [0.0, 0.7, 2.0, 3.0]:
        Z, _ = integrate.quad(
            lambda x: ssp.i0(2 * beta * math.cos(0.5 * (x - phi)))
            * ssp.i0(2 * beta * math.cos(0.5 * x)), -math.pi, math.pi,
            limit=200)
        ours = float(np.exp(-np.asarray(
            dist.log_Znorm_inv(jnp.asarray(phi), rescaled=False))))
        assert ours == pytest.approx(Z, rel=1e-8), phi


@pytest.mark.parametrize("beta,xp,xm", [
    (2.0, 0.5, -0.3), (4.0, 2.0, -2.5), (8.0, 1.0, 2.0), (4.0, -3.0, 2.9),
    # small beta: both envelope pieces carry comparable weight — guards
    # the side-selection fix (erf-mass double count biased beta <= 1)
    (1.0, 0.5, -0.3), (1.0, 2.0, -2.5), (0.25, 1.0, 2.0),
])
def test_besselproduct_draw_ks(beta, xp, xm):
    dist = BesselProductDistribution(beta)
    n = 40000
    x = np.asarray(dist.draw(jax.random.PRNGKey(int(beta + xp * 10)),
                             jnp.full((n,), xp, jnp.float64),
                             jnp.full((n,), xm, jnp.float64)))
    xs = np.linspace(-math.pi, math.pi, 4001)
    pdf = np.asarray(dist.evaluate(jnp.asarray(xs), xp, xm))
    cdf = integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    d, pval = sstats.kstest(x, lambda v: np.interp(v, xs, cdf))
    assert pval > 1e-3, (d, pval)


def test_approx_besselproduct_selfconsistent_and_close_to_exact():
    beta = 8.0
    exact = BesselProductDistribution(beta)
    approx = ApproximateBesselProductDistribution(beta)
    xp, xm = 1.0, -0.5
    n = 50000
    x = np.asarray(approx.draw(jax.random.PRNGKey(0),
                               jnp.full((n,), xp, jnp.float64),
                               jnp.full((n,), xm, jnp.float64)))
    xs = np.linspace(-math.pi, math.pi, 4001)
    pdf = np.asarray(approx.evaluate(jnp.asarray(xs), xp, xm))
    # draw/evaluate self-consistency (the pair property that matters)
    cdf = integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    d, pval = sstats.kstest(x, lambda v: np.interp(v, xs, cdf))
    assert pval > 1e-3, (d, pval)
    # rough closeness to the exact density at beta = 8
    pdf_exact = np.asarray(exact.evaluate(jnp.asarray(xs), xp, xm))
    l1 = np.trapezoid(np.abs(pdf - pdf_exact), xs)
    assert l1 < 0.1, l1


# ---------------------------------------------------------------------------
# fill-in invariance: plaquette-preserving operations
# ---------------------------------------------------------------------------

def test_fill_preserves_coarse_plaquette_sums():
    """The fill-in only redistributes angles inside coarse cells: the
    restriction of the filled state must reproduce the coarse state."""
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    cond = QuenchedSchwingerConditionedFineAction(act)
    coarse = act.coarse_action()
    key = jax.random.PRNGKey(1)
    kc, kf = jax.random.split(key)
    theta_c = coarse.initialise_state(kc, 16, jnp.float64)
    theta_f = act.prolongate(theta_c, jnp.zeros((16, act.ndof), jnp.float64))
    theta_f = cond.fill_fine_points(kf, theta_f)
    back = np.asarray(act.restrict(theta_f))
    from mlmcpathintegral.utils.special import mod_2pi
    np.testing.assert_allclose(back, np.asarray(mod_2pi(theta_c)),
                               atol=1e-10)


@pytest.mark.parametrize("ct", [CoarseningType.TEMPORAL,
                                CoarseningType.SPATIAL])
def test_semi_fill_preserves_coarse_sums(ct):
    lat = Lattice2D(8, 8, ct)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    cond = QuenchedSchwingerSemiConditionedFineAction(act)
    coarse = act.coarse_action()
    key = jax.random.PRNGKey(2)
    kc, kf = jax.random.split(key)
    theta_c = coarse.initialise_state(kc, 16, jnp.float64)
    theta_f = act.prolongate(theta_c, jnp.zeros((16, act.ndof), jnp.float64))
    theta_f = cond.fill_fine_points(kf, theta_f)
    back = np.asarray(act.restrict(theta_f))
    from mlmcpathintegral.utils.special import mod_2pi
    np.testing.assert_allclose(back, np.asarray(mod_2pi(theta_c)),
                               atol=1e-10)


# ---------------------------------------------------------------------------
# two-level + multilevel Schwinger vs the chi_t oracle
# ---------------------------------------------------------------------------

def test_twolevel_schwinger_chit():
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0,
                                  renormalisation=RenormalisationType.NONE)
    mc = MonteCarloTwoLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_burnin=50, n_samples=6000, chunk_size=50)
    stats = mc.evaluate_difference(jax.random.PRNGKey(3), n_chains=64,
                                   dtype=jnp.float64)
    avg = mc.stats_fine.average(stats["fine"])
    err = mc.stats_fine.error(stats["fine"])
    oracle = act.chit_exact()
    assert mc.p_accept > 0.3
    assert abs(avg - oracle) < 4 * err, (avg, oracle, err, mc.p_accept)


def test_mlmc_schwinger_chit():
    """Full MLMC susceptibility — the north-star configuration
    (BASELINE.md config 5) on a small lattice."""
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(
        lat, beta=4.0, renormalisation=RenormalisationType.NONPERTURBATIVE)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=6000, chunk_size=50)
    mc.evaluate(jax.random.PRNGKey(4), n_chains=64, dtype=jnp.float64)
    num = mc.numerical_result()
    err = mc.statistical_error()
    oracle = act.chit_exact()
    assert abs(num - oracle) < 4 * err, (num, oracle, err)
