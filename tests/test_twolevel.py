"""Two-level Metropolis step + two-level MC tests.

The crucial invariance: the screened fine chain must target the *fine*
distribution exactly (the delayed-acceptance construction,
twolevelmetropolisstep.hh:16-45), with the conditioned action normalisation
terms consistent between fill-in and evaluate (SURVEY.md §7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.conditioned import (
    GaussianConditionedFineAction, RotorConditionedFineAction,
    make_conditioned_fine_action,
)
from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.mc import MonteCarloTwoLevel, TwoLevelMetropolisStep
from mlmcpathintegral.models import (
    HarmonicOscillatorAction, RenormalisationType, RotorAction,
)
from mlmcpathintegral.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral.samplers.exact import ExactSampler
from mlmcpathintegral.samplers.cluster import ClusterSampler


def test_gaussian_fill_matches_conditional_distribution():
    """fill_fine_points must draw from exp(-evaluate) exactly: for the
    harmonic oscillator the full path distribution with exact coarse
    marginal + conditional fill equals the fine Gibbs measure, so a
    prolong+fill from exact coarse samples followed by NO screening should
    give <X^2> = analytic when the coarse action is the exact Schur
    complement (nonperturbative renormalisation)."""
    lat = Lattice1D(16, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    cond = GaussianConditionedFineAction(act)
    coarse = act.coarse_action()
    key = jax.random.PRNGKey(0)
    kc, kf = jax.random.split(key)
    xc = coarse.exact_draw(kc, 100_000, jnp.float64)
    xf = act.prolongate(xc, jnp.zeros((100_000, 16), jnp.float64))
    xf = cond.fill_fine_points(kf, xf)
    # even sites have exact coarse stats; odd sites approximately fine stats
    # -> the two-level accept rate would be ~1; here check evaluate/fill
    # consistency via importance identity: E[exp(-(S_f - S_c - S_cond))] = Z
    # ratio, whose *variance* is tiny iff the triple is consistent.
    w = -(act.evaluate(xf) - coarse.evaluate(xc) - cond.evaluate(xf))
    w = np.asarray(w)
    assert np.std(w) < 0.05, f"log-weight spread {np.std(w)} too large"


def test_twolevel_step_preserves_fine_distribution_harmonic():
    lat = Lattice1D(16, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    coarse = act.coarse_action()
    cond = GaussianConditionedFineAction(act)
    step = TwoLevelMetropolisStep(coarse, act, cond)
    C = 4096
    key = jax.random.PRNGKey(1)
    kc, kf, krun = jax.random.split(key, 3)
    tl = step.init(act.prolongate(
        coarse.exact_draw(kc, C, jnp.float64),
        jnp.zeros((C, 16), jnp.float64)))
    # run the screened chain with fresh exact coarse proposals each step
    @jax.jit
    def run(key, tl):
        def body(carry, k):
            tl = carry
            k1, k2 = jax.random.split(k)
            xc = coarse.exact_draw(k1, C, jnp.float64)
            tl, acc = step.draw(k2, tl, xc)
            return tl, (jnp.mean(tl.theta ** 2), jnp.mean(acc))
        return jax.lax.scan(body, tl, jax.random.split(key, 200))
    tl, (x2_series, acc_series) = run(krun, tl)
    x2 = float(jnp.mean(x2_series[50:]))
    p_acc = float(jnp.mean(acc_series))
    oracle = act.Xsquared_analytical()
    assert p_acc > 0.9, f"two-level acceptance {p_acc} unexpectedly low"
    assert x2 == pytest.approx(oracle, rel=0.02), (x2, oracle, p_acc)


def test_montecarlo_twolevel_harmonic():
    lat = Lattice1D(16, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=100, n_samples=20000, chunk_size=100)
    stats = mc.evaluate_difference(jax.random.PRNGKey(2), n_chains=64,
                                   dtype=jnp.float64)
    fine_avg = mc.stats_fine.average(stats["fine"])
    fine_err = mc.stats_fine.error(stats["fine"])
    coarse_avg = mc.stats_coarse.average(stats["coarse"])
    coarse_err = mc.stats_coarse.error(stats["coarse"])
    diff_var = mc.stats_diff.variance(stats["diff"])
    oracle_f = act.Xsquared_analytical()
    oracle_c = act.coarse_action().Xsquared_analytical()
    assert abs(fine_avg - oracle_f) < 4 * fine_err
    assert abs(coarse_avg - oracle_c) < 4 * coarse_err
    # the whole point of the method: Var(Y) << Var(Q)
    assert diff_var < 0.1 * mc.stats_fine.variance(stats["fine"])


def test_montecarlo_twolevel_rotor_cluster_coarse():
    lat = Lattice1D(16, 4.0)
    act = RotorAction(lat, RenormalisationType.NONE, m0=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_susceptibility,
        coarse_sampler_factory=lambda a: ClusterSampler(a, n_burnin=50,
                                                        n_updates=5),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=100, n_samples=12000, chunk_size=100)
    stats = mc.evaluate_difference(jax.random.PRNGKey(3), n_chains=64,
                                   dtype=jnp.float64)
    fine_avg = mc.stats_fine.average(stats["fine"])
    fine_err = mc.stats_fine.error(stats["fine"])
    oracle_f = act.chit_exact()
    assert abs(fine_avg - oracle_f) < 4 * fine_err, \
        (fine_avg, oracle_f, fine_err)
    assert mc.p_accept > 0.5


def test_batched_screen_matches_sequential():
    """The batched delayed-acceptance screen (make_batched_screen) must
    target the same fine distribution as the sequential per-step path:
    run both chunk implementations on the harmonic oscillator with the
    exact coarse sampler and compare <X^2> against the analytic oracle
    and each other."""
    import math

    lat = Lattice1D(32, 4.0)
    act = HarmonicOscillatorAction(lat, RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    oracle = act.Xsquared_analytical()

    def run(force_sequential, seed):
        cond_factory = GaussianConditionedFineAction
        if force_sequential:
            class _Seq(GaussianConditionedFineAction):
                independent_fill = False
            cond_factory = _Seq
        mc = MonteCarloTwoLevel(
            act, qoi_x_squared,
            coarse_sampler_factory=ExactSampler,
            conditioned_fine_action_factory=cond_factory,
            n_burnin=200, n_samples=20000, chunk_size=50)
        assert (mc._chunk is not None)
        stats = mc.evaluate_difference(jax.random.PRNGKey(seed),
                                       n_chains=64, dtype=jnp.float64)
        avg = mc.stats_fine.average(stats["fine"])
        err = mc.stats_fine.error(stats["fine"])
        return avg, err, mc.p_accept

    a_b, e_b, p_b = run(False, 101)
    a_s, e_s, p_s = run(True, 102)
    assert abs(a_b - oracle) < 4 * e_b, (a_b, e_b, oracle)
    assert abs(a_s - oracle) < 4 * e_s, (a_s, e_s, oracle)
    assert abs(a_b - a_s) < 4 * math.hypot(e_b, e_s)
    # the two paths realise the same Markov kernel, so acceptance rates
    # must match closely as well
    assert abs(p_b - p_s) < 0.03, (p_b, p_s)
