"""Approximate BesselProduct distribution for large beta (> 8).

Reference parity: src/distribution/approximatebesselproductdistribution.{hh,cc}.
Gaussian-mixture approximation of the BesselProduct density with a main
peak at x0/2 (width sigma_+^-2 = beta cos(x0/4)) and a secondary peak at
x0/2 - pi (width sigma_-^-2 = beta sin(x0/4)), mixture weight
N_+ = 1/(1+rho), rho = (sigma2p/sigma2m)^{3/2} exp(-4(sigma2p-sigma2m)).
The evaluate sums 2k+1 periodic copies so draw (direct mixture + wrap) and
evaluate are an exactly consistent pair.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from mlmcpathintegral.utils.special import mod_2pi

TWO_PI = 2.0 * math.pi


class ApproximateBesselProductDistribution:

    def __init__(self, beta: float, kmax: int = 4):
        self.beta = float(beta)
        self.kmax = int(kmax)

    def _fold(self, x_p, x_m):
        """Map to x0 in [0, pi] with sign bookkeeping
        (approximatebesselproductdistribution.cc:10-19)."""
        x0 = x_p - x_m
        sign = jnp.where(x0 < 0, -1.0, 1.0)
        x0 = jnp.abs(x0)
        flip = x0 > math.pi
        sign = jnp.where(flip, -sign, sign)
        x0 = jnp.where(flip, TWO_PI - x0, x0)
        return x0, sign

    def _N_p_sigma2inv(self, x0):
        """(N_p, sigma2_p_inv, sigma2_m_inv)
        (approximatebesselproductdistribution.cc:39-55)."""
        beta = self.beta
        eps = 0.125 * math.pi
        s2p = jnp.where(x0 < eps, beta, beta * jnp.cos(0.25 * x0))
        s2m_raw = beta * jnp.sin(0.25 * x0)
        rho = ((s2p / jnp.maximum(s2m_raw, 1e-300)) ** 1.5
               * jnp.exp(-4.0 * (s2p - s2m_raw)))
        N_p = jnp.where(x0 < eps, 1.0, 1.0 / (1.0 + rho))
        s2m = jnp.where(x0 < eps, 0.0, s2m_raw)
        return N_p, s2p, s2m

    def draw(self, key, x_p, x_m, dtype=None):
        x_p = jnp.asarray(x_p)
        x_m = jnp.broadcast_to(jnp.asarray(x_m), x_p.shape)
        x_p = jnp.broadcast_to(x_p, x_m.shape)
        if dtype is None:
            dtype = x_p.dtype
        shape = x_p.shape
        x0, sign = self._fold(x_p.astype(dtype), x_m.astype(dtype))
        N_p, s2p, s2m = self._N_p_sigma2inv(x0)
        ks, kn = jax.random.split(key)
        main = jax.random.uniform(ks, shape, dtype) <= N_p
        sigma = jnp.where(main, 1.0 / jnp.sqrt(s2p),
                          1.0 / jnp.sqrt(jnp.maximum(s2m, 1e-300)))
        xshift = jnp.where(main, 0.0, math.pi)
        x = sigma * jax.random.normal(kn, shape, dtype) + 0.5 * x0 - xshift
        return mod_2pi(sign * x + x_m)

    def log_evaluate(self, x, x_p, x_m):
        return jnp.log(jnp.maximum(self.evaluate(x, x_p, x_m), 1e-300))

    def evaluate(self, x, x_p, x_m):
        """Density with 2*kmax+1 periodic copies
        (approximatebesselproductdistribution.cc:7-36)."""
        x_p = jnp.asarray(x_p)
        x0, sign = self._fold(x_p, jnp.asarray(x_m))
        z = sign * (x - x_m)
        N_p, s2p, s2m = self._N_p_sigma2inv(x0)
        N_m = 1.0 - N_p
        s_p = jnp.zeros_like(z)
        s_m = jnp.zeros_like(z)
        for k in range(-self.kmax, self.kmax + 1):
            zs = z - 0.5 * x0 + 2.0 * k * math.pi
            s_p = s_p + jnp.sqrt(s2p) * jnp.exp(-0.5 * s2p * zs * zs)
            zs = zs + math.pi
            s_m = s_m + jnp.sqrt(jnp.maximum(s2m, 0.0)) * jnp.exp(
                -0.5 * s2m * zs * zs)
        return math.sqrt(0.5 / math.pi) * (N_p * s_p + N_m * s_m)
