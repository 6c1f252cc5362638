"""BesselProduct distribution:
p(x | x_p, x_m) = Z^-1 I0(2 beta cos((x-x_p)/2)) I0(2 beta cos((x-x_m)/2)).

Reference parity: src/distribution/besselproductdistribution.{hh,cc}.  This
is the marginal of the sum of the two fine vertical links inside a coarse
Schwinger cell; valid for beta <= 8 (normalisation series truncation,
besselproductdistribution.hh:38-44).

Sampling is rejection with a two-piece Gaussian envelope: after reducing to
p(x | dx, 0) with dx >= 0, the density has peaks near x = dx/2 (right
piece, interval [-pi+dx, pi]) and x = dx/2 - pi (left piece, interval
[-pi, -pi+dx]).  Batched lanes pick a piece with probability ~ C_s (its envelope HEIGHT
constant), propose from the piece's untruncated Gaussian, and reject
out-of-interval or above-envelope proposals: the in-interval check pays
each piece's erf-mass, so the side choice must NOT include it (doing both
double-counts the mass and glues the pieces with the wrong relative
weight — invisible for beta >= 4, an ~8% chi_t bias at beta <= 1).

The normalisation 1/Z(Phi) is a Fourier-cosine series in Phi = x_p - x_m
with coefficients alpha_k computed once per beta
(besselproductdistribution.hh:60-79).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from scipy import special as ssp

from mlmcpathintegral.distributions.rejection import batched_rejection_sample
from mlmcpathintegral.utils.special import (
    log_factorial, log_i0, log_nCk, mod_2pi,
)

TWO_PI = 2.0 * math.pi


def _alpha_coefficients(beta: float, kmax: int = 16, nmax: int = 32):
    """Fourier-cosine coefficients of Z(Phi)
    (besselproductdistribution.hh:60-79): alpha_0 absolute, alpha_{k>0}
    rescaled by alpha_0."""
    alphas = []
    alpha0 = None
    for k in range(kmax + 1):
        s = 0.0
        for n in range(k, nmax + 1):
            for m in range(k, nmax + 1):
                log_comb = (log_nCk(2 * n, n - k) + log_nCk(2 * m, m - k)
                            - 2.0 * (log_factorial(n) + log_factorial(m)))
                s += (0.5 * beta) ** (2 * (n + m)) * math.exp(log_comb)
        alpha = (2.0 if k == 0 else 4.0) * math.pi * s
        if k == 0:
            alpha0 = alpha
        else:
            alpha /= alpha0
        alphas.append(alpha)
    return np.asarray(alphas)


class BesselProductDistribution:

    def __init__(self, beta: float, kmax: int = 16, nmax: int = 32):
        if beta > 8.0:
            raise ValueError("BesselProductDistribution requires beta <= 8 "
                             "(besselproductdistribution.hh:55-58)")
        self.beta = float(beta)
        self.kmax = kmax
        self.alphaZ = _alpha_coefficients(beta, kmax, nmax)
        self.log_I0_twobeta = float(np.log(ssp.i0e(2 * beta)) + 2 * beta)
        self.sigma_beta = math.pi / math.sqrt(2.0 * self.log_I0_twobeta)

    # -- normalisation ---------------------------------------------------------

    def log_Znorm_inv(self, phi, rescaled: bool = True):
        """log(1/Z(phi)); rescaled drops the alpha_0 factor (cancels in
        two-level differences) — besselproductdistribution.cc:16-27."""
        k = jnp.arange(1, self.kmax + 1)
        s = 1.0 + jnp.sum(
            jnp.asarray(self.alphaZ[1:]) * jnp.cos(k * phi[..., None]),
            axis=-1)
        log_s = jnp.log(s)
        if not rescaled:
            log_s = log_s + math.log(self.alphaZ[0])
        return -log_s

    def log_evaluate(self, x, x_p, x_m):
        """log p(x | x_p, x_m) with the exact series normalisation."""
        lp = log_i0(2.0 * self.beta * jnp.cos(0.5 * (x - x_p)))
        lm = log_i0(2.0 * self.beta * jnp.cos(0.5 * (x - x_m)))
        return (self.log_Znorm_inv(jnp.asarray(x_p - x_m), rescaled=False)
                + lp + lm)

    def evaluate(self, x, x_p, x_m):
        return jnp.exp(self.log_evaluate(x, x_p, x_m))

    # -- sampling --------------------------------------------------------------

    def draw(self, key, x_p, x_m, dtype=None):
        x_p = jnp.asarray(x_p)
        x_m = jnp.broadcast_to(jnp.asarray(x_m), x_p.shape)
        x_p = jnp.broadcast_to(x_p, x_m.shape)
        shape = x_p.shape
        if dtype is None:
            dtype = x_p.dtype
        pi = math.pi
        beta = self.beta
        sb = self.sigma_beta
        logI0 = self.log_I0_twobeta

        dx0 = (x_m - x_p).astype(dtype)
        sign = jnp.where(dx0 < 0, -1.0, 1.0)
        dx = jnp.abs(dx0)

        # envelope piece constants (besselproductdistribution.hh:100-115)
        log_C_p = 2.0 * logI0 * (1.0 - dx * dx / (4.0 * pi * pi))
        log_C_m = 2.0 * logI0 * (1.0 - (dx - TWO_PI) ** 2 / (4.0 * pi * pi))
        # side weights ~ C_s ONLY: proposals come from the UNTRUNCATED
        # piece Gaussian with out-of-interval rejection, so the interval
        # mass is already paid by the in-interval check — weighting the
        # side choice by erf-mass as well double-counts it and glues the
        # two pieces with weights mass_p:mass_m instead of 1:1.  (At
        # beta >= 4 the wrong side is e^{-2 log I0(2 beta)}-suppressed and
        # the bias is invisible; at beta <= 1 it biased the Schwinger
        # two-level screen by ~8% in chi_t — caught by the 3-level
        # 16x16 scale study, level-1 Y off by 36 sigma.)
        p_right = 1.0 / (1.0 + jnp.exp(log_C_m - log_C_p))

        sigma = sb / math.sqrt(2.0)

        if 2.0 * logI0 <= 1.0:
            # small beta: the density is nearly flat, the piece Gaussians
            # are wider than the circle and most proposals leave the
            # interval.  A uniform envelope with the global bound
            # p~(x) <= I0(2 beta)^2 accepts >= e^{-2 log I0(2 beta)}
            # (>= 0.37) per round.
            def propose_accept(k):
                kn, ku = jax.random.split(k)
                x = pi * (2.0 * jax.random.uniform(kn, shape, dtype) - 1.0)
                log_rho = (log_i0(2.0 * beta * jnp.cos(0.5 * x))
                           + log_i0(2.0 * beta * jnp.cos(0.5 * (x - dx)))
                           - 2.0 * logI0)
                xi = jax.random.uniform(ku, shape, dtype)
                return x, jnp.log(xi) <= log_rho
        else:
            def propose_accept(k):
                ks, kn, ku = jax.random.split(k, 3)
                right = jax.random.uniform(ks, shape, dtype) < p_right
                mu = jnp.where(right, 0.5 * dx, 0.5 * dx - pi)
                a_min = jnp.where(right, -pi + dx, -pi)
                a_max = jnp.where(right, pi, -pi + dx)
                log_C = jnp.where(right, log_C_p, log_C_m)
                x = mu + sigma * jax.random.normal(kn, shape, dtype)
                in_interval = jnp.logical_and(x >= a_min, x < a_max)
                u = (x - mu) / sb
                log_rho = (log_i0(2.0 * beta * jnp.cos(0.5 * x))
                           + log_i0(2.0 * beta * jnp.cos(0.5 * (x - dx)))
                           - log_C + u * u)
                xi = jax.random.uniform(ku, shape, dtype)
                ok = jnp.logical_and(in_interval, jnp.log(xi) <= log_rho)
                return x, ok

        x = batched_rejection_sample(key, propose_accept, shape, dtype,
                                     max_iter=500)
        return mod_2pi(sign * x + x_p)
