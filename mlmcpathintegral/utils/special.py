"""Special functions and small math helpers.

Device-side functions (jnp) are used inside jitted kernels; host-side
functions (numpy/scipy) implement the once-per-experiment analytic oracles.

Reference parity (formulas re-derived, behaviour matched):
  * mod_2pi / mod_pi            — src/common/auxilliary.hh:42-52
  * fast_i0_scaled              — src/common/fastbessel.hh:26-50 (truncated
                                  asymptotic series with a_k=((2k-1)!!)^2/(8^k k!))
  * Sigma_hat                   — src/common/auxilliary.cc:7-27
  * Phi_chit / compute_In       — src/common/auxilliary.cc:44-194 (GSL QAWO ->
                                  scipy.integrate.quad with weight='sin'/'cos')
  * Phi_chit_perturbative       — src/common/auxilliary.cc:82-94
  * gff_phi_squared_analytical  — src/common/auxilliary.cc:197-209
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Device-side (jnp) helpers
# ---------------------------------------------------------------------------

def mod_2pi(x):
    """Map x to the interval [-pi, pi) (periodic wrap)."""
    return x - TWO_PI * jnp.floor(0.5 * (x + math.pi) / math.pi)


def mod_pi(x):
    """Map x to the interval [-pi/2, pi/2) (periodic wrap)."""
    return x - math.pi * jnp.floor((x + 0.5 * math.pi) / math.pi)


def i0_scaled(z):
    """exp(-|z|) * I0(z) — scaled modified Bessel function (device)."""
    return jsp.i0e(z)


# Coefficients a_k = ((2k-1)!!)^2 / (8^k k!) of the asymptotic expansion
# I0(z) e^{-z} ~ (2 pi z)^{-1/2} sum_k a_k z^{-k}.
def _asymptotic_coeffs(n: int):
    coeffs = []
    for k in range(n):
        dfact = 1.0
        for j in range(1, 2 * k, 2):
            dfact *= j
        coeffs.append(dfact * dfact / (8.0**k * math.factorial(k)))
    return coeffs


_FASTBESSEL_COEFFS = tuple(_asymptotic_coeffs(10))
_FASTBESSEL_ZLO = 20.0


def fast_i0_scaled(z):
    """Fast exp(-z) I0(z) for z >= 0: i0e for small z, truncated asymptotic
    series for large z.  This is the analog of the reference's fastbessel
    component; ``jsp.i0e`` already vectorises, the asymptotic branch
    is cheaper (10 fused multiply-adds) for large arguments."""
    z = jnp.asarray(z)
    zi = 1.0 / jnp.maximum(z, _FASTBESSEL_ZLO)
    series = jnp.zeros_like(zi)
    for a_k in reversed(_FASTBESSEL_COEFFS):
        series = series * zi + a_k
    large = series / jnp.sqrt(TWO_PI * jnp.maximum(z, _FASTBESSEL_ZLO))
    return jnp.where(z < _FASTBESSEL_ZLO, jsp.i0e(z), large)


def log_2pi_i0_scaled(z):
    """log(2 pi e^{-z} I0(z)) — the log-normalisation used by the ExpSin2
    distribution family."""
    return math.log(TWO_PI) + jnp.log(fast_i0_scaled(z))


def log_i0(z):
    """log I0(z), stable for large z: log(i0e(z)) + |z|."""
    return jnp.log(jsp.i0e(z)) + jnp.abs(z)


# ---------------------------------------------------------------------------
# Host-side analytics (numpy / scipy) — once-per-experiment oracles
# ---------------------------------------------------------------------------

def log_factorial(n: int) -> float:
    return float(math.lgamma(n + 1))


def log_nCk(n: int, k: int) -> float:
    return log_factorial(n) - log_factorial(k) - log_factorial(n - k)


def Sigma_hat(xi: float, p: int, mmax: int = 100) -> float:
    """Theta-function ratio sum_m m^p e^{-xi m^2/2} / sum_m e^{-xi m^2/2}."""
    if p % 2 == 1:
        return 0.0
    if p == 0:
        return 1.0
    m = np.arange(1, mmax)
    expf = np.exp(-0.5 * xi * m * m)
    num = 2.0 * np.sum(m**p * expf)
    denom = 1.0 + 2.0 * np.sum(expf)
    return float(num / denom)


@lru_cache(maxsize=64)
def compute_In(x: float, nmax: int = 20):
    """Scaled Bessel-type integrals for the analytic Schwinger susceptibility.

    Returns (In, dIn, ddIn) with
      In[n]   = e^{-x} I_n(x)
      dIn[n]  = -1/(4 pi^2) \\int_{-pi}^{pi} phi e^{x(cos(phi)-1)} sin(n phi) dphi
      ddIn[n] =  1/(8 pi^3) \\int_{-pi}^{pi} phi^2 e^{x(cos(phi)-1)} cos(n phi) dphi
    """
    from scipy import integrate
    from scipy import special as ssp

    In = np.empty(nmax)
    dIn = np.empty(nmax)
    ddIn = np.empty(nmax)
    for n in range(nmax):
        In[n] = ssp.ive(n, x)
        if n == 0:
            # sin(0 * phi) == 0 identically
            dIn[n] = 0.0
        else:
            dIn[n], _ = integrate.quad(
                lambda phi: -1.0 / (4.0 * math.pi**2) * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="sin", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
        if n == 0:
            # cos(0*phi) == 1: use the plain adaptive rule with a
            # breakpoint at the peak.  QUADPACK's oscillatory rule with
            # wvar=0 silently loses the sharply-peaked integrand at
            # large x (x=256: returns ~3e-26 when the true value is
            # ~2.5e-6), which zeroed the analytic chi_t on the 128x128
            # continuum trajectory.
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, points=[0.0],
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
        else:
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="cos", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
    return In, dIn, ddIn


def Phi_chit(beta: float, n_plaq: int) -> float:
    """Analytic (finite-volume, finite-a) topological-susceptibility function
    for the compact U(1) / rotor family: chi_t * V = Phi_chit(beta, P)."""
    if beta > 2000.0:
        raise ValueError("Phi_chit unstable for beta>2000; "
                         "use Phi_chit_perturbative")
    nmax = 20
    In, dIn, ddIn = compute_In(float(beta), nmax)
    duplicity = np.where(np.arange(nmax) > 0, 2.0, 1.0)
    rho = In / In[0]
    weight = duplicity * rho**n_plaq
    weight /= weight.sum()
    phi_chit = np.sum(
        beta * weight * (ddIn / In - (n_plaq - 1) * (dIn / In) ** 2)
    )
    return float(phi_chit)


def Phi_chit_perturbative(beta: float, n_plaq: int) -> float:
    """Semiclassical expansion of Phi_chit, valid for large beta."""
    xi = n_plaq / beta
    z = 1.0 / beta
    S2 = Sigma_hat(xi, 2)
    S4 = Sigma_hat(xi, 4)
    phi_lo = 1.0 - xi * S2
    phi_nlo = 0.5 - xi * S2 + 0.25 * xi * xi * (S4 - S2 * S2)
    return (phi_lo + z * phi_nlo) / (4.0 * math.pi**2)


def gff_phi_squared_analytical(mass: float, Mt_lat: int, Mx_lat: int) -> float:
    """Spectral sum for <phi^2> of the 2-D Gaussian free field."""
    mu2 = mass * mass / (Mt_lat * Mx_lat)
    k1 = np.sin(math.pi * np.arange(Mt_lat) / Mt_lat) ** 2
    k2 = np.sin(math.pi * np.arange(Mx_lat) / Mx_lat) ** 2
    denom = 4.0 * (k1[:, None] + k2[None, :]) + mu2
    return float(np.sum(1.0 / denom) / (Mt_lat * Mx_lat))
