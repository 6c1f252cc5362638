"""Gaussian fill-in distribution: 4-D joint approximation of the plaquette
fill-in pi(theta_1..theta_4 | phi_12, phi_23, phi_34, phi_41).

Reference parity: src/distribution/gaussianfillindistribution.{hh,cc}.  The
four interior link angles of a coarse Schwinger cell are parameterised by a
3-D eta subspace plus a uniform gauge shift omega; the density in eta is a
two-component Gaussian mixture (main peak at 0, secondary at
(pi, 0, pi/2)) with width set by 4 beta cos/sin(Phi*), including periodic
peak copies for beta <= 72.  Draw and evaluate form a consistent pair.
"""

from __future__ import annotations

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.utils.special import mod_2pi

PI = math.pi


def _construct_peaks(n_offsets: int):
    """Peak locations in units of pi/2 with periodic offset copies
    (gaussianfillindistribution.cc:77-121)."""
    p_main = [(0, 0, 0), (2, 2, 2), (-2, 2, 2), (2, -2, 2), (-2, -2, 2),
              (2, 2, -2), (-2, 2, -2), (2, -2, -2), (-2, -2, -2)]
    p_secondary = [(2, 0, 1), (-2, 0, 1), (0, 2, -1), (0, -2, -1)]
    rng = range(-n_offsets, n_offsets + 1)
    main, secondary = set(), set()
    for kx, ky, kz in itertools.product(rng, rng, rng):
        off = (4 * kx, 4 * ky, 4 * kz)
        for p in p_main:
            main.add(tuple(a + b for a, b in zip(p, off)))
        for p in p_secondary:
            secondary.add(tuple(a + b for a, b in zip(p, off)))
    conv = lambda s: 0.5 * PI * np.asarray(sorted(s), dtype=float)
    return conv(main), conv(secondary)


class GaussianFillinDistribution:

    def __init__(self, beta: float, add_gaussian_noise: bool = True):
        if not add_gaussian_noise:
            raise ValueError("sampling only from peak is broken in the "
                             "reference and unsupported here "
                             "(gaussianfillindistribution.hh:58-62)")
        self.beta = float(beta)
        n_offsets = 0 if beta > 72.0 else 1
        self.main_peaks, self.secondary_peaks = _construct_peaks(n_offsets)

    def _get_pc(self, Phi_star):
        """Main-peak probability (gaussianfillindistribution.hh:176-189)."""
        beta = self.beta
        s2p = beta * jnp.cos(Phi_star)
        s2m = beta * jnp.sin(Phi_star)
        rho = ((s2p / jnp.maximum(s2m, 1e-300)) ** 1.5
               * jnp.exp(-4.0 * (s2p - s2m)))
        pc = 1.0 / (1.0 + rho)
        pc = jnp.where(Phi_star < 0.125 * PI, 1.0, pc)
        return jnp.where(Phi_star > 0.375 * PI, 0.0, pc)

    @staticmethod
    def _fold(Phi):
        """Map Phi to Phi* in [0, pi/2] with (swap, shift) bookkeeping."""
        swap = Phi < 0
        Phi_star = jnp.abs(Phi)
        shift = Phi_star > 0.5 * PI
        swap = jnp.logical_xor(swap, shift)
        Phi_star = jnp.where(shift, PI - Phi_star, Phi_star)
        return Phi_star, swap, shift

    def draw(self, key, phi_12, phi_23, phi_34, phi_41, dtype=None):
        """Returns (theta_1..theta_4), each with the broadcast shape of the
        phi arguments (gaussianfillindistribution.hh:85-140)."""
        phi_12, phi_23, phi_34, phi_41 = jnp.broadcast_arrays(
            jnp.asarray(phi_12), jnp.asarray(phi_23), jnp.asarray(phi_34),
            jnp.asarray(phi_41))
        shape = phi_12.shape
        if dtype is None:
            dtype = phi_12.dtype
        Phi = 0.25 * (phi_12 + phi_23 + phi_34 + phi_41)
        Phi_star, swap, shift = self._fold(Phi)
        p_c = self._get_pc(Phi_star)
        k1, k2, k3 = jax.random.split(key, 3)
        main = jax.random.uniform(k1, shape, dtype) < p_c
        sigma = jnp.where(
            main, 1.0 / jnp.sqrt(4.0 * self.beta * jnp.cos(Phi_star)),
            1.0 / jnp.sqrt(jnp.maximum(
                4.0 * self.beta * jnp.sin(Phi_star), 1e-300)))
        e1 = jnp.where(main, 0.0, PI)
        e2 = jnp.zeros(shape, dtype)
        e3 = jnp.where(main, 0.0, 0.5 * PI)
        xi = jax.random.normal(k2, (*shape, 3), dtype)
        sqrt2 = math.sqrt(2.0)
        e1 = e1 + sqrt2 * sigma * xi[..., 0]
        e2 = e2 + sqrt2 * sigma * xi[..., 1]
        e3 = e3 + sigma * xi[..., 2]
        e1, e2 = (jnp.where(swap, e2, e1), jnp.where(swap, e1, e2))
        e1 = jnp.where(shift, e1 + PI, e1)
        e2 = jnp.where(shift, e2 + PI, e2)
        omega = 2.0 * PI * jax.random.uniform(k3, shape, dtype)
        th1 = mod_2pi(0.5 * (+e1 + e2 + e3) + omega)
        th2 = mod_2pi(0.5 * (+e1 - e2 - e3) + omega + Phi - phi_12)
        th3 = mod_2pi(0.5 * (-e1 - e2 + e3) + omega + 2.0 * Phi
                      - phi_12 - phi_23)
        th4 = mod_2pi(0.5 * (-e1 + e2 - e3) + omega + 3.0 * Phi
                      - phi_12 - phi_23 - phi_34)
        return th1, th2, th3, th4

    def evaluate(self, theta_1, theta_2, theta_3, theta_4,
                 phi_12, phi_23, phi_34, phi_41):
        """Mixture density in the eta subspace
        (gaussianfillindistribution.cc:6-75)."""
        e1 = mod_2pi(0.5 * (theta_1 + theta_2 - theta_3 - theta_4)
                     + 0.5 * (phi_41 - phi_23))
        e2 = mod_2pi(0.5 * (theta_1 - theta_2 - theta_3 + theta_4)
                     + 0.5 * (phi_34 - phi_12))
        e3 = mod_2pi(0.5 * (theta_1 - theta_2 + theta_3 - theta_4)
                     + 0.25 * (-phi_12 + phi_23 - phi_34 + phi_41))
        Phi = 0.25 * (phi_12 + phi_23 + phi_34 + phi_41)
        Phi_star, swap, shift = self._fold(Phi)
        e1 = jnp.where(shift, mod_2pi(e1 + PI), e1)
        e2 = jnp.where(shift, mod_2pi(e2 + PI), e2)
        e1, e2 = (jnp.where(swap, e2, e1), jnp.where(swap, e1, e2))
        p_c = self._get_pc(Phi_star)
        s2c = 2.0 * self.beta * jnp.cos(Phi_star)
        s2s = 2.0 * self.beta * jnp.sin(Phi_star)

        def peak_sum(peaks, s2inv):
            p = jnp.asarray(peaks)                      # [P, 3]
            d1 = e1[..., None] - p[:, 0]
            d2 = e2[..., None] - p[:, 1]
            d3 = e3[..., None] - p[:, 2]
            Q = d1 * d1 + d2 * d2 + 2.0 * d3 * d3
            return jnp.sum(jnp.exp(-0.5 * s2inv[..., None] * Q), axis=-1)

        g_c = peak_sum(self.main_peaks, s2c)
        g_s = peak_sum(self.secondary_peaks, s2s)
        norm_c = s2c ** 1.5
        norm_s = jnp.maximum(s2s, 0.0) ** 1.5
        return p_c * norm_c * g_c + (1.0 - p_c) * norm_s * g_s

    def log_evaluate(self, *args):
        return jnp.log(jnp.maximum(self.evaluate(*args), 1e-300))
