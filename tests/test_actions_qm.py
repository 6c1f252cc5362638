"""QM action tests: autodiff-vs-hand force, conditioned-site geometry,
exact sampler covariance, analytic oracles.

The force == grad(evaluate) identity is the free invariant the reference
maintains by hand (SURVEY.md §4b); here the hand expression *is* the test.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction, RenormalisationType,
    RotorAction,
)

LAT = Lattice1D(M_lat=16, T_final=4.0)


def _actions():
    return [
        HarmonicOscillatorAction(LAT, m0=1.0, mu2=1.0),
        HarmonicOscillatorAction(LAT, m0=0.5, mu2=2.3),
        QuarticOscillatorAction(LAT, m0=1.0, mu2=-1.0, lam=1.0, x0=0.0),
        QuarticOscillatorAction(LAT, m0=0.7, mu2=0.5, lam=2.0, x0=0.3),
        RotorAction(LAT, m0=1.2),
    ]


@pytest.mark.parametrize("action", _actions(),
                         ids=lambda a: a.info_string())
def test_force_equals_grad(action):
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (3, LAT.M_lat), jnp.float64)
    f_hand = action.force(x)
    f_auto = jax.grad(lambda y: jnp.sum(action.evaluate(y)))(x)
    np.testing.assert_allclose(np.asarray(f_hand), np.asarray(f_auto),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("action", _actions()[:4],
                         ids=lambda a: a.info_string())
def test_Wminimum_is_stationary_point(action):
    """W(x) = conditioned single-site action: S with only site j varying.
    The returned Wminimum must be a stationary point of that restriction
    (for the quartic it is the reference's 4-step fixed point, approximate)."""
    key = jax.random.PRNGKey(1)
    x_m = jax.random.normal(key, (8,), jnp.float64)
    x_p = jax.random.normal(jax.random.fold_in(key, 1), (8,), jnp.float64)
    x0 = action.getWminimum(x_m, x_p)

    # dW/dx at x0: from the nearest-neighbour form of all QM actions,
    # W(x) = m0/(2a) [(x-x_m)^2 + (x_p-x)^2] + a V(x)
    a = action.a_lat

    def dW(x):
        grad_V = jax.grad(lambda y: _potential(action, y))
        return (action.m0 / a) * (2 * x - x_m - x_p) \
            + a * jax.vmap(grad_V)(x)

    resid = np.asarray(dW(x0))
    tol = 1e-8 if isinstance(action, HarmonicOscillatorAction) else 5e-2
    assert np.max(np.abs(resid)) < tol


def _potential(action, x):
    if isinstance(action, HarmonicOscillatorAction):
        return 0.5 * action.m0 * action.mu2 * x * x
    return (0.5 * action.m0 * action.mu2 * x * x
            + 0.25 * action.lam * (x - action.x0) ** 4)


def test_rotor_Wgeometry():
    act = RotorAction(LAT, m0=1.5)
    # conditional p(x) ~ exp(I/a [cos(x-x_m) + cos(x-x_p)]): max at atan2 mean
    x_m, x_p = jnp.asarray(0.3), jnp.asarray(1.1)
    x0 = act.getWminimum(x_m, x_p)

    def neg_logp(x):
        return -(act.m0 / act.a_lat) * (jnp.cos(x - x_m) + jnp.cos(x - x_p))
    g = jax.grad(neg_logp)(x0)
    assert abs(float(g)) < 1e-12
    # curvature of neg_logp at min equals Wcurvature
    h = jax.grad(jax.grad(neg_logp))(x0)
    assert float(act.getWcurvature(x_m, x_p)) == pytest.approx(float(h),
                                                               rel=1e-12)


def test_harmonic_exact_sampler_matches_analytics():
    act = HarmonicOscillatorAction(Lattice1D(32, 8.0), m0=1.0, mu2=1.0)
    key = jax.random.PRNGKey(42)
    x = act.exact_draw(key, 200_000, jnp.float64)
    x2 = float(jnp.mean(x * x))
    assert x2 == pytest.approx(act.Xsquared_analytical(), rel=5e-3)


def test_harmonic_exact_sampler_covariance_is_inverse_precision():
    M = 8
    act = HarmonicOscillatorAction(Lattice1D(M, 2.0), m0=0.9, mu2=1.7)
    # dense precision matrix from evaluate's Hessian
    H = jax.hessian(lambda y: act.evaluate(y))(jnp.zeros(M, jnp.float64))
    cov_expect = np.linalg.inv(np.asarray(H))
    x = act.exact_draw(jax.random.PRNGKey(7), 400_000, jnp.float64)
    cov_emp = np.cov(np.asarray(x).T)
    np.testing.assert_allclose(cov_emp, cov_expect, atol=5e-3)


def test_harmonic_analytical_continuum_limit():
    # finite-a formula must approach continuum as a -> 0
    act_fine = HarmonicOscillatorAction(Lattice1D(1024, 8.0), m0=1.0, mu2=1.0)
    assert act_fine.Xsquared_analytical() == pytest.approx(
        act_fine.Xsquared_analytical_continuum(), rel=1e-3)


def test_harmonic_renormalised_coarse_params():
    act = HarmonicOscillatorAction(
        Lattice1D(16, 4.0), RenormalisationType.NONPERTURBATIVE,
        m0=1.0, mu2=1.0)
    c = act.coarse_action()
    a2mu2 = act.a_lat**2 * act.mu2
    assert c.m0 == pytest.approx(act.m0 / (1 + 0.5 * a2mu2))
    assert c.mu2 == pytest.approx(act.mu2 * (1 + 0.25 * a2mu2))
    assert c.M_lat == act.M_lat // 2


def test_prolongate_restrict_roundtrip():
    act = HarmonicOscillatorAction(LAT)
    key = jax.random.PRNGKey(3)
    xc = jax.random.normal(key, (5, LAT.M_lat // 2), jnp.float64)
    xf = jax.random.normal(jax.random.fold_in(key, 1), (5, LAT.M_lat),
                           jnp.float64)
    xf2 = act.prolongate(xc, xf)
    np.testing.assert_array_equal(np.asarray(xf2[:, ::2]), np.asarray(xc))
    np.testing.assert_array_equal(np.asarray(xf2[:, 1::2]),
                                  np.asarray(xf[:, 1::2]))
    np.testing.assert_array_equal(np.asarray(act.restrict(xf2)),
                                  np.asarray(xc))


def test_rotor_chit_analytics_consistent():
    act = RotorAction(Lattice1D(64, 4.0), m0=1.0)
    # perturbative and exact agree at moderate coupling
    assert act.chit_exact() == pytest.approx(act.chit_perturbative(), rel=2e-2)
    # continuum value is the a->0 limit of the perturbative formula
    act_fine = RotorAction(Lattice1D(4096, 4.0), m0=1.0)
    assert act_fine.chit_perturbative() == pytest.approx(
        act_fine.chit_continuum(), rel=2e-2)
