"""Special-function unit tests against scipy golden values.

Mirrors the reference's test_fastbessel.cc (golden comparison of the fast
scaled Bessel I0 against GSL over [0, 2000)) and the analytic helpers in
src/common/auxilliary.cc.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import special as ssp

from mlmcpathintegral.utils.special import (
    Phi_chit, Phi_chit_perturbative, Sigma_hat, fast_i0_scaled,
    gff_phi_squared_analytical, mod_2pi, mod_pi,
)


def test_fast_i0_scaled_vs_scipy():
    z = np.linspace(0.0, 2000.0, 4001)
    ours = np.asarray(fast_i0_scaled(jnp.asarray(z)))
    ref = ssp.ive(0, z)
    assert np.max(np.abs(ours - ref) / ref) < 1e-10


def test_mod_2pi_range_and_identity():
    x = np.linspace(-30.0, 30.0, 1001)
    m = np.asarray(mod_2pi(jnp.asarray(x)))
    assert np.all(m >= -math.pi - 1e-12) and np.all(m < math.pi + 1e-12)
    # identity up to multiples of 2 pi
    k = (x - m) / (2.0 * math.pi)
    assert np.allclose(k, np.round(k), atol=1e-9)


def test_mod_pi_range():
    x = np.linspace(-30.0, 30.0, 1001)
    m = np.asarray(mod_pi(jnp.asarray(x)))
    assert np.all(m >= -math.pi / 2 - 1e-12) and np.all(m < math.pi / 2 + 1e-12)


def test_sigma_hat_against_direct_sum():
    for xi in [0.1, 1.0, 5.0]:
        for p in [0, 2, 4]:
            m = np.arange(-200, 201)
            w = np.exp(-0.5 * xi * m * m)
            direct = np.sum(m**p * w) / np.sum(w)
            assert Sigma_hat(xi, p) == pytest.approx(direct, rel=1e-12)
    assert Sigma_hat(1.0, 3) == 0.0


def test_phi_chit_perturbative_matches_exact_at_large_beta():
    # Phi_chit (Bessel-integral form) ~ perturbative expansion for beta >> 1
    beta, P = 64.0, 16
    exact = Phi_chit(beta, P)
    pert = Phi_chit_perturbative(beta, P)
    assert exact == pytest.approx(pert, rel=2e-3)


def test_phi_chit_small_beta_positive_finite():
    v = Phi_chit(4.0, 16)
    assert np.isfinite(v) and v > 0.0


def test_gff_phi_squared_analytical_large_mass_limit():
    # for mu^2 >> 1 the propagator -> 1/mu^2 at every site
    mass = 200.0
    Mt, Mx = 8, 8
    mu2 = mass * mass / (Mt * Mx)
    v = gff_phi_squared_analytical(mass, Mt, Mx)
    assert v == pytest.approx(1.0 / mu2, rel=2e-2)
