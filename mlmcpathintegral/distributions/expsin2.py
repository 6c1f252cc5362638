"""ExpSin2 distribution: p(x) = Z^-1 exp(-sigma sin^2(x/2)), x in [-pi, pi].

Normalisation Z = 2 pi e^{-sigma/2} I0(sigma/2).  Sampling is rejection with
a Gaussian envelope, batched over lanes (reference:
src/distribution/expsin2distribution.{hh,cc}; draw loop hh:44-58).

Used by the rotor heat-bath (src/action/qm/rotoraction.cc:20-37) and the
rotor conditioned fine action (src/action/qm/rotorconditionedfineaction.cc).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from mlmcpathintegral.distributions.rejection import (
    batched_rejection_sample_mask,
)
from mlmcpathintegral.utils.special import fast_i0_scaled

TWO_PI = 2.0 * math.pi


class ExpSin2Distribution:
    """Batched draw/evaluate; ``sigma`` may be a scalar or an array
    broadcastable to the draw shape (per-lane parameters)."""

    @staticmethod
    def draw(key, sigma, shape=None, dtype=None, fallback=None,
             max_iter: int = 100):
        """Draw samples; returns array of ``shape`` (default: sigma.shape).

        With ``fallback`` the rejection loop is truncated at ``max_iter``
        rounds and unaccepted lanes return ``fallback`` — exact only for
        MCMC heat-bath use (state-independent mixture with the identity
        kernel); density-matched fill-ins must omit it."""
        sigma = jnp.asarray(sigma)
        if shape is None:
            shape = sigma.shape
        if dtype is None:
            dtype = sigma.dtype
        sig = jnp.broadcast_to(sigma, shape).astype(dtype)
        pi = jnp.asarray(math.pi, dtype)
        width = pi / jnp.sqrt(2.0 * sig)

        def propose_accept(k):
            kn, ku = jax.random.split(k)
            r = width * jax.random.normal(kn, shape, dtype)
            u = jax.random.uniform(ku, shape, dtype)
            sin_half = jnp.sin(0.5 * r)
            log_ratio = -sig * (sin_half * sin_half - (r * r) / (pi * pi))
            ok = jnp.logical_and(jnp.abs(r) < pi, jnp.log(u) < log_ratio)
            return r, ok

        x, acc = batched_rejection_sample_mask(key, propose_accept, shape,
                                               dtype, max_iter)
        if fallback is not None:
            x = jnp.where(acc, x, fallback)
        return x

    @staticmethod
    def evaluate(x, sigma):
        """p(x; sigma) — batched elementwise."""
        return jnp.exp(ExpSin2Distribution.log_evaluate(x, sigma))

    @staticmethod
    def log_evaluate(x, sigma):
        """log p(x; sigma), stable for large sigma.

        With Z = 2 pi e^{-sigma/2} I0(sigma/2) one has
        log Z = log(2 pi I0e(sigma/2)) where I0e(z) = e^{-z} I0(z), so
        log p = -sigma sin^2(x/2) - log(2 pi I0e(sigma/2))."""
        sin_half = jnp.sin(0.5 * x)
        log_Z = math.log(TWO_PI) + jnp.log(fast_i0_scaled(0.5 * sigma))
        return -sigma * sin_half * sin_half - log_Z
