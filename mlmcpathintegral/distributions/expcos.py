"""ExpCos distribution: p(x | x_p, x_m) = Z^-1 exp[beta(cos(x-x_p) +
cos(x-x_m))] on [-pi, pi), Z = 2 pi I0(2 beta |cos((x_p-x_m)/2)|).

Reference parity: src/distribution/expcosdistribution.{hh,cc}.  Used for
the quenched-Schwinger link heat bath (quenchedschwingeraction.cc:46-55)
and the semi-coarsened fill-in.

The identity cos(x-x_p)+cos(x-x_m) = 2 cos(dx/2) cos(x - (x_p+x_m)/2)
reduces sampling to a centred ExpCos with tau = 2 beta |cos(dx/2)|,
sampled by Gaussian-envelope rejection and shifted back
(expcosdistribution.hh:50-66).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from mlmcpathintegral.distributions.rejection import (
    batched_rejection_sample_mask,
)
from mlmcpathintegral.utils.special import fast_i0_scaled, mod_2pi

TWO_PI = 2.0 * math.pi
FOURPI2_INV = 1.0 / (4.0 * math.pi * math.pi)


class ExpCosDistribution:
    """Batched draw/evaluate; ``beta`` scalar, ``x_p``/``x_m`` arrays."""

    @staticmethod
    def draw(key, beta, x_p, x_m, dtype=None, fallback=None,
             max_iter: int = 100):
        """Rejection draw.  With ``fallback`` (an array of current values in
        the output frame) the loop is truncated at ``max_iter`` rounds and
        unaccepted lanes return ``fallback`` — exact for MCMC heat-bath use
        (state-independent kernel mixture), NOT for density-matched
        fill-ins, which must omit ``fallback``."""
        x_p = jnp.asarray(x_p)
        x_m = jnp.broadcast_to(jnp.asarray(x_m), x_p.shape)
        x_p = jnp.broadcast_to(x_p, x_m.shape)
        shape = x_p.shape
        if dtype is None:
            dtype = x_p.dtype
        pi = jnp.asarray(math.pi, dtype)
        dx = (x_m - x_p).astype(dtype)
        tau = 2.0 * beta * jnp.abs(jnp.cos(0.5 * dx))
        # mixed envelope: uniform proposals for small tau, TIGHT Gaussian
        # (sigma^2 = pi^2/(4 tau); valid since cos x - 1 + 2 x^2/pi^2 <= 0
        # on [-pi, pi]) otherwise — per-round acceptance >= 0.64 for all
        # tau, vs ~23% for the reference's sigma^2 = 2 pi^2/tau envelope
        # (expcosdistribution.hh:50-66)
        use_uni = tau < 0.45
        sigma = 0.5 * pi / jnp.sqrt(jnp.maximum(tau, 1e-12))

        def propose_accept(k):
            ks, kn, ku = jax.random.split(k, 3)
            x_u = jax.random.uniform(ks, shape, dtype, -math.pi, math.pi)
            x_g = sigma * jax.random.normal(kn, shape, dtype)
            x = jnp.where(use_uni, x_u, x_g)
            u = jax.random.uniform(ku, shape, dtype)
            log_ratio = tau * (jnp.cos(x) - 1.0) + jnp.where(
                use_uni, 0.0, 2.0 * tau * x * x / (math.pi ** 2))
            ok = jnp.logical_and(
                jnp.logical_and(-pi <= x, x < pi),
                jnp.log(u) <= log_ratio)
            return x, ok

        x, acc = batched_rejection_sample_mask(key, propose_accept, shape,
                                               dtype, max_iter)
        shift = 0.5 * (x_p + x_m) + jnp.where(jnp.abs(dx) > pi, pi, 0.0)
        out = mod_2pi(x + shift)
        if fallback is not None:
            out = jnp.where(acc, out, fallback)
        return out

    @staticmethod
    def log_evaluate(x, beta, x_p, x_m):
        """log p(x | x_p, x_m), stable for large beta.

        Direct form: log p = beta[cos(x-x_p)+cos(x-x_m)] - log Z with
        log Z = log(2 pi I0e(sigma)) + sigma, sigma = 2 beta |cos(dx/2)|
        (equivalent to the transformed form in expcosdistribution.cc:7-27)."""
        sigma = 2.0 * beta * jnp.abs(jnp.cos(0.5 * (x_p - x_m)))
        s = beta * (jnp.cos(x - x_p) + jnp.cos(x - x_m))
        log_Z = math.log(TWO_PI) + jnp.log(fast_i0_scaled(sigma)) + sigma
        return s - log_Z

    @staticmethod
    def evaluate(x, beta, x_p, x_m):
        return jnp.exp(ExpCosDistribution.log_evaluate(x, beta, x_p, x_m))
