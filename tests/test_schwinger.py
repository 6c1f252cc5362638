"""Quenched Schwinger model tests: ExpCos distribution, action/force,
link transfer, exact cluster sampler, heat-bath sweeps — all checked
against the analytic chi_t oracle (qoi2dsusceptibility.cc:30-50)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate, stats as sstats

from mlmcpathintegral.distributions.expcos import ExpCosDistribution
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.qft.schwinger import (
    QuenchedSchwingerAction, chit_analytical, chit_perturbative,
)
from mlmcpathintegral.models.base import RenormalisationType
from mlmcpathintegral.qoi import qoi_2d_susceptibility, qoi_avg_plaquette
from mlmcpathintegral.samplers.heatbath import OverrelaxedHeatBathSampler
from mlmcpathintegral.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)
from mlmcpathintegral.utils.statistics import Statistics
from mlmcpathintegral.utils import statistics as stats_mod


# ---------------------------------------------------------------------------
# ExpCos distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta,xp,xm", [
    (2.0, 0.5, -0.3), (4.0, 2.8, -2.9), (1.0, 0.0, 3.0), (8.0, 1.0, 1.5),
])
def test_expcos_evaluate_normalised(beta, xp, xm):
    xs = np.linspace(-math.pi, math.pi, 20001)
    p = np.asarray(ExpCosDistribution.evaluate(jnp.asarray(xs), beta, xp, xm))
    assert np.trapezoid(p, xs) == pytest.approx(1.0, rel=1e-8)


@pytest.mark.parametrize("beta,xp,xm", [
    (2.0, 0.5, -0.3), (4.0, 2.8, -2.9), (6.0, 1.0, 1.5),
])
def test_expcos_draw_ks(beta, xp, xm):
    n = 40000
    x = np.asarray(ExpCosDistribution.draw(
        jax.random.PRNGKey(int(beta * 7)), beta,
        jnp.full((n,), xp, jnp.float64), jnp.full((n,), xm, jnp.float64)))
    assert np.all(np.abs(x) <= math.pi + 1e-12)
    xs = np.linspace(-math.pi, math.pi, 4001)
    pdf = np.asarray(ExpCosDistribution.evaluate(jnp.asarray(xs), beta,
                                                 xp, xm))
    cdf = integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    d, pval = sstats.kstest(x, lambda v: np.interp(v, xs, cdf))
    assert pval > 1e-3, (d, pval)


# ---------------------------------------------------------------------------
# Schwinger action
# ---------------------------------------------------------------------------

LAT = Lattice2D(4, 4, CoarseningType.BOTH)
ACT = QuenchedSchwingerAction(LAT, beta=4.0)


def test_force_equals_grad():
    theta = jax.random.uniform(jax.random.PRNGKey(0), (3, ACT.ndof),
                               jnp.float64, -math.pi, math.pi)
    f = ACT.force(theta)
    g = jax.grad(lambda t: jnp.sum(ACT.evaluate(t)))(theta)
    np.testing.assert_allclose(np.asarray(f), np.asarray(g), atol=1e-12)


def test_action_on_pure_gauge_is_zero():
    # a pure gauge configuration has all plaquettes = 0
    Mt, Mx = LAT.Mt_lat, LAT.Mx_lat
    th = jax.random.uniform(jax.random.PRNGKey(1), (2, Mx, Mt), jnp.float64,
                            -math.pi, math.pi)
    T = th - jnp.roll(th, -1, axis=-1)
    X = th - jnp.roll(th, -1, axis=-2)
    theta = jnp.stack([T, X], axis=-1).reshape(2, ACT.ndof)
    np.testing.assert_allclose(np.asarray(ACT.evaluate(theta)), 0.0,
                               atol=1e-10)


def test_staples_consistent_with_plaquettes():
    """theta_P(i,j) must equal theta_p(link) - theta(link) for mu=1 and the
    conditional exponent beta[cos(th-tp)+cos(th-tm)] must equal the
    theta-dependent part of the action."""
    theta = jax.random.uniform(jax.random.PRNGKey(2), (1, ACT.ndof),
                               jnp.float64, -math.pi, math.pi)

    def action_of_link(t_val, flat_idx):
        th2 = theta.at[0, flat_idx].set(t_val)
        return ACT.evaluate(th2)[0]

    tp, tm = ACT.staple_angles(theta)
    tp = tp.reshape(1, -1)
    tm = tm.reshape(1, -1)
    # compare d(action)/d(link) with derivative of -beta[cos(t-tp)+cos(t-tm)]
    for flat_idx in [0, 1, 7, 12, 25, 31]:
        t0 = theta[0, flat_idx]
        g_full = jax.grad(action_of_link)(t0, flat_idx)
        # grid flat index: ell = 2*Mt*j + 2*i + mu maps to [j,i,mu] reshape
        g_local = ACT.beta * (jnp.sin(t0 - tp[0, flat_idx])
                              + jnp.sin(t0 - tm[0, flat_idx]))
        assert float(g_full) == pytest.approx(float(g_local), abs=1e-10)


@pytest.mark.parametrize("ct", [CoarseningType.BOTH, CoarseningType.TEMPORAL,
                                CoarseningType.SPATIAL])
def test_link_restrict_of_prolongate_is_identity(ct):
    lat = Lattice2D(8, 8, ct)
    act = QuenchedSchwingerAction(lat, beta=2.0)
    clat = lat.coarse_lattice()
    nc = clat.nedges
    tc = jax.random.uniform(jax.random.PRNGKey(3), (5, nc), jnp.float64,
                            -math.pi, math.pi)
    tf = jax.random.uniform(jax.random.PRNGKey(4), (5, act.ndof), jnp.float64,
                            -math.pi, math.pi)
    tf2 = act.prolongate(tc, tf)
    back = act.restrict(tf2)
    # restriction sums the two half-angles -> recovers theta_c mod 2pi
    from mlmcpathintegral.utils.special import mod_2pi
    np.testing.assert_allclose(np.asarray(back),
                               np.asarray(mod_2pi(tc)), atol=1e-10)


def test_beta_renormalisation():
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act_none = QuenchedSchwingerAction(lat, 8.0, RenormalisationType.NONE)
    assert act_none.beta_coarse() == pytest.approx(2.0)
    act_pert = QuenchedSchwingerAction(lat, 8.0,
                                       RenormalisationType.PERTURBATIVE)
    assert act_pert.beta_coarse() == pytest.approx(
        0.25 * (1 + 1.5 / 8.0) * 8.0)
    act_np = QuenchedSchwingerAction(lat, 8.0,
                                     RenormalisationType.NONPERTURBATIVE)
    beta_c = act_np.beta_coarse()
    # nonperturbative matching: chi_t equal across levels
    assert chit_analytical(beta_c, 16) == pytest.approx(
        chit_analytical(8.0, 64), rel=1e-8)


# ---------------------------------------------------------------------------
# samplers vs the chi_t oracle
# ---------------------------------------------------------------------------

def _run_sampler(sampler, action, n_steps=300, C=256, seed=0):
    qoi_chi = qoi_2d_susceptibility(action)
    qoi_pl = qoi_avg_plaquette(action)
    state = sampler.prepare(jax.random.PRNGKey(seed), C, jnp.float64)
    stats_chi = Statistics("chi", 40).init(C, jnp.float64)
    stats_pl = Statistics("pl", 40).init(C, jnp.float64)

    @jax.jit
    def run(key, state, stats_chi, stats_pl):
        def body(carry, k):
            st, sc, sp = carry
            st, _ = sampler.draw(k, st)
            x = sampler.x_of(st)
            sc = stats_mod.record(sc, qoi_chi(x))
            sp = stats_mod.record(sp, qoi_pl(x))
            return (st, sc, sp), None
        keys = jax.random.split(key, n_steps)
        (st, sc, sp), _ = jax.lax.scan(body, (state, stats_chi, stats_pl),
                                       keys)
        return st, sc, sp

    _, sc, sp = run(jax.random.PRNGKey(seed + 1), state, stats_chi, stats_pl)
    return sc, sp


def test_cluster_sampler_chit_matches_analytical():
    lat = Lattice2D(4, 4, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    sampler = QuenchedSchwingerClusterSampler(act, n_burnin=50, n_updates=10)
    sc, sp = _run_sampler(sampler, act, n_steps=200, C=512)
    stats = Statistics("chi", 40)
    avg, err = stats.average(sc), stats.error(sc)
    oracle = act.chit_exact()
    assert abs(avg - oracle) < 4 * err, (avg, oracle, err)


def test_heatbath_chit_matches_analytical():
    lat = Lattice2D(4, 4, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    sampler = OverrelaxedHeatBathSampler(act, n_sweep_heatbath=2,
                                         n_sweep_overrelax=1, n_burnin=100)
    sc, sp = _run_sampler(sampler, act, n_steps=400, C=256, seed=5)
    stats = Statistics("chi", 40)
    avg, err = stats.average(sc), stats.error(sc)
    oracle = act.chit_exact()
    assert abs(avg - oracle) < 4 * err, (avg, oracle, err)


def test_cluster_and_heatbath_agree_on_plaquette():
    lat = Lattice2D(4, 4, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    s1 = QuenchedSchwingerClusterSampler(act, n_burnin=50, n_updates=10)
    s2 = OverrelaxedHeatBathSampler(act, n_sweep_heatbath=2,
                                    n_sweep_overrelax=1, n_burnin=100)
    stats = Statistics("pl", 40)
    _, sp1 = _run_sampler(s1, act, n_steps=200, C=256, seed=7)
    _, sp2 = _run_sampler(s2, act, n_steps=200, C=256, seed=11)
    a1, e1 = stats.average(sp1), stats.error(sp1)
    a2, e2 = stats.average(sp2), stats.error(sp2)
    assert abs(a1 - a2) < 4 * math.sqrt(e1**2 + e2**2), (a1, a2, e1, e2)


def test_chit_perturbative_matches_exact_large_beta():
    assert chit_perturbative(32.0, 64) == pytest.approx(
        chit_analytical(32.0, 64), rel=2e-2)


def test_hybrid_cluster_psi_roundtrip_and_clock():
    """Round-4 hybrid sampler invariants: (a) the rotor path rebuilt
    from the links' plaquettes has the same increments mod 2pi (the mix
    sweeps hand a valid path back to the next cluster update); (b) the
    slow-mode subsample observable is wired and finite; (c) the
    subsampler clocks on it instead of the QoI."""
    import numpy as np

    from mlmcpathintegral.mc.twolevel import make_coarse_subsampler
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.utils.special import mod_2pi

    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=2.0)
    s = QuenchedSchwingerClusterSampler(act, n_burnin=20, n_updates=5)
    st = s.prepare(jax.random.PRNGKey(0), 16, jnp.float64)
    st2, _ = s.draw(jax.random.PRNGKey(1), st)
    # (a) psi increments == plaquette angles of the (mixed) links
    P = np.asarray(act.plaquette_angles(st2.x))          # [C, Mx, Mt]
    d_links = np.swapaxes(P, -1, -2).reshape(16, -1)
    d_psi = np.asarray(mod_2pi(jnp.roll(st2.psi, -1, axis=-1) - st2.psi))
    assert np.max(np.abs(np.angle(np.exp(1j * (d_links - d_psi))))) < 1e-9
    # (b) slow-mode observable
    obs = np.asarray(s.subsample_observable(st2.x))
    assert obs.shape == (16,) and np.all(np.isfinite(obs))
    assert np.all(obs > -1.0) and np.all(obs < 1.0)
    # (c) the subsampler records the sampler's observable, not the QoI
    sub = make_coarse_subsampler(s, qoi_2d_susceptibility(act))
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics
    stats = Statistics("clk", 10)
    ss = stats.init(16, jnp.float64)
    ta = (jnp.zeros(()), jnp.zeros(()))
    _, ss, _ = sub(jax.random.PRNGKey(2), st2, ss, ta)
    # energy values are O(0.5); chi_t values are O(1) positives with
    # var >> energy var — check the recorded mean is in the energy range
    rec = float(stats.average(ss))
    direct = float(np.mean(obs))
    assert abs(rec - direct) < 0.2, (rec, direct)


def test_fused_t_sub_floor():
    """Fused levels must never subsample below FUSED_T_SUB_MIN (the
    correlated-proposal bias floor, round 4) — including via the
    shrink branch of the ratchet."""
    from mlmcpathintegral.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral.mc import MonteCarloMultiLevel
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler

    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=4.0)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_burnin=10),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=20, n_samples=200, chunk_size=20,
        fused="reference")
    assert all(t >= mc.FUSED_T_SUB_MIN for t in mc._t_sub)
    mc.evaluate(jax.random.PRNGKey(5), n_chains=64, dtype=jnp.float32)
    assert all(t >= mc.FUSED_T_SUB_MIN for t in mc._t_sub), mc._t_sub
