"""Harmonic oscillator action V(x) = m0/2 mu^2 x^2 on a periodic 1-D lattice.

Reference parity: src/action/qm/harmonicoscillatoraction.{hh,cc} and
harmonicoscillatorrenormalisation.hh.

Batched exact sampler: the reference samples exactly via a dense Cholesky
factor of the covariance (harmonicoscillatoraction.cc:38-66).  The precision
matrix is *circulant tridiagonal*, so here the exact draw is spectral:
x = irfft(rfft(z) / sqrt(lambda_k)) with lambda_k the precision symbol —
O(M log M), batched over chains, exact for the periodic lattice.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models.base import QMAction, RenormalisationType


class HarmonicOscillatorAction(QMAction):

    def __init__(self, lattice: Lattice1D,
                 renormalisation: RenormalisationType = RenormalisationType.NONE,
                 m0: float = 1.0, mu2: float = 1.0):
        super().__init__(lattice, renormalisation, m0)
        self.mu2 = float(mu2)

    # -- action --------------------------------------------------------------

    def evaluate(self, x):
        """S[x] = a m0/2 sum_j [ (x_j - x_{j-1})^2/a^2 + mu^2 x_j^2 ]
        (harmonicoscillatoraction.cc:8-18)."""
        a = self.a_lat
        dx = x - jnp.roll(x, 1, axis=-1)
        s = jnp.sum(dx * dx, axis=-1) / (a * a) \
            + self.mu2 * jnp.sum(x * x, axis=-1)
        return 0.5 * a * self.m0 * s

    def force(self, x):
        """P_j = m0/a ((2 + a^2 mu^2) x_j - x_{j-1} - x_{j+1})
        (harmonicoscillatoraction.cc:21-35); equals grad(evaluate)."""
        c = 2.0 + self.a_lat * self.a_lat * self.mu2
        return (self.m0 / self.a_lat) * (
            c * x - jnp.roll(x, 1, axis=-1) - jnp.roll(x, -1, axis=-1))

    # -- conditioned single-site geometry -------------------------------------

    def getWcurvature(self, x_m, x_p):
        """W'' = 2 m0/a + a m0 mu^2 (constant)."""
        c = (2.0 / self.a_lat + self.a_lat * self.mu2) * self.m0
        return jnp.full(jnp.broadcast_shapes(jnp.shape(x_m), jnp.shape(x_p)),
                        c, dtype=jnp.result_type(x_m, x_p))

    def getWminimum(self, x_m, x_p):
        """argmin W = (x_- + x_+) / (2 (1 + a^2 mu^2 / 2))."""
        scaling = 0.5 / (1.0 + 0.5 * self.a_lat * self.a_lat * self.mu2)
        return scaling * (x_m + x_p)

    # -- multigrid -------------------------------------------------------------

    def coarse_action(self) -> "HarmonicOscillatorAction":
        """Coarsen with renormalised (m0, mu2)
        (harmonicoscillatorrenormalisation.hh:39-79)."""
        a2mu2 = self.a_lat * self.a_lat * self.mu2
        if self.renormalisation is RenormalisationType.NONE:
            m0c, mu2c = self.m0, self.mu2
        elif self.renormalisation is RenormalisationType.PERTURBATIVE:
            m0c = self.m0 * (1.0 - 0.5 * a2mu2)
            mu2c = self.mu2 * (1.0 + 0.25 * a2mu2)
        else:  # NONPERTURBATIVE (exact for the harmonic oscillator)
            m0c = self.m0 / (1.0 + 0.5 * a2mu2)
            mu2c = self.mu2 * (1.0 + 0.25 * a2mu2)
        return HarmonicOscillatorAction(self.lattice.coarse_lattice(),
                                        self.renormalisation, m0c, mu2c)

    # -- exact sampler (spectral; replaces dense Cholesky) ---------------------

    def precision_symbol(self, dtype=jnp.float32) -> jnp.ndarray:
        """Eigenvalues of the circulant precision matrix on the rfft grid:
        lambda_k = a m0 mu^2 + (2 m0/a)(1 - cos(2 pi k / M))."""
        M = self.M_lat
        k = np.arange(M // 2 + 1)
        lam = (self.a_lat * self.m0 * self.mu2
               + 2.0 * self.m0 / self.a_lat
               * (1.0 - np.cos(2.0 * math.pi * k / M)))
        return jnp.asarray(lam, dtype)

    def exact_draw(self, key, n_chains: int, dtype=jnp.float32):
        """Draw exact samples x ~ N(0, Q^{-1}), batched: [n_chains, M]."""
        M = self.M_lat
        z = jax.random.normal(key, (n_chains, M), dtype)
        zf = jnp.fft.rfft(z, axis=-1)
        lam = self.precision_symbol(jnp.float32 if dtype == jnp.float32
                                    else jnp.float64)
        x = jnp.fft.irfft(zf / jnp.sqrt(lam), n=M, axis=-1)
        return x.astype(dtype)

    # -- analytics --------------------------------------------------------------

    def Xsquared_analytical(self) -> float:
        """Exact <X^2> at finite lattice spacing
        (harmonicoscillatoraction.cc:69-76)."""
        a, mu2, M = self.a_lat, self.mu2, self.M_lat
        R = (1.0 + 0.5 * a * a * mu2
             - a * math.sqrt(mu2) * math.sqrt(1.0 + 0.25 * a * a * mu2))
        return (1.0 / (2.0 * self.m0 * math.sqrt(mu2)
                       * math.sqrt(1.0 + 0.25 * a * a * mu2))
                * (1.0 + R**M) / (1.0 - R**M))

    def Xsquared_analytical_continuum(self) -> float:
        """Continuum <X^2> (harmonicoscillatoraction.cc:78-82)."""
        mu = math.sqrt(self.mu2)
        T = self.lattice.T_final
        return (1.0 / (2.0 * self.m0 * mu)
                * (1.0 + math.exp(-mu * T)) / (1.0 - math.exp(-mu * T)))

    def info_string(self):
        return (f"HarmonicOscillator(M={self.M_lat}, a={self.a_lat:.5f}, "
                f"m0={self.m0}, mu2={self.mu2})")
