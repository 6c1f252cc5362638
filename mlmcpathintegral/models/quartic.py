"""Quartic (double-well) oscillator: V(x) = m0/2 mu^2 x^2 + lambda/4 (x-x0)^4.

Reference parity: src/action/qm/quarticoscillatoraction.{hh,cc}.  With
mu2 < 0 and lambda > 0 this is the double-well benchmark model.  No
parameter renormalisation on coarsening (quarticoscillatoraction.hh:105-110).
"""

from __future__ import annotations

import jax.numpy as jnp

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models.base import QMAction, RenormalisationType


class QuarticOscillatorAction(QMAction):

    def __init__(self, lattice: Lattice1D,
                 renormalisation: RenormalisationType = RenormalisationType.NONE,
                 m0: float = 1.0, mu2: float = 1.0,
                 lam: float = 1.0, x0: float = 0.0):
        super().__init__(lattice, renormalisation, m0)
        self.mu2 = float(mu2)
        self.lam = float(lam)
        self.x0 = float(x0)

    def evaluate(self, x):
        """S = a/2 sum_j [ m0((dx_j/a)^2 + mu^2 x_j^2) + lambda/2 (x_j-x0)^4 ]
        (quarticoscillatoraction.cc:3-25)."""
        a = self.a_lat
        dx = x - jnp.roll(x, 1, axis=-1)
        xs = x - self.x0
        xs2 = xs * xs
        s = self.m0 * (jnp.sum(dx * dx, axis=-1) / (a * a)
                       + self.mu2 * jnp.sum(x * x, axis=-1)) \
            + 0.5 * self.lam * jnp.sum(xs2 * xs2, axis=-1)
        return 0.5 * a * s

    def force(self, x):
        """P_j = m0/a((2+a^2 mu^2)x_j - x_{j-1} - x_{j+1}) + a lambda (x_j-x0)^3
        (quarticoscillatoraction.cc:27-52)."""
        c = 2.0 + self.a_lat * self.a_lat * self.mu2
        xs = x - self.x0
        return (self.m0 / self.a_lat) * (
            c * x - jnp.roll(x, 1, axis=-1) - jnp.roll(x, -1, axis=-1)
        ) + self.a_lat * self.lam * xs * xs * xs

    def getWcurvature(self, x_m, x_p):
        """W'' = 2 m0/a + a m0 mu^2 + 3 a lambda (xbar - x0)^2
        (quarticoscillatoraction.hh:170-180)."""
        xbar = 0.5 * (x_m + x_p)
        xs = xbar - self.x0
        return ((2.0 / self.a_lat + self.a_lat * self.mu2) * self.m0
                + 3.0 * self.lam * self.a_lat * xs * xs)

    def getWminimum(self, x_m, x_p):
        """Fixed-point iteration (4 steps) for the W minimum
        (quarticoscillatoraction.hh:184-200)."""
        xbar = 0.5 * (x_m + x_p)
        rho = 1.0 / (1.0 + 0.5 * self.a_lat * self.a_lat * self.mu2)
        c = 0.5 * self.a_lat * self.a_lat * self.lam / self.m0
        x = xbar
        for _ in range(4):
            xs = x - self.x0
            x = rho * (xbar - c * xs * xs * xs)
        return x

    def coarse_action(self) -> "QuarticOscillatorAction":
        return QuarticOscillatorAction(self.lattice.coarse_lattice(),
                                       self.renormalisation, self.m0,
                                       self.mu2, self.lam, self.x0)

    def info_string(self):
        return (f"QuarticOscillator(M={self.M_lat}, a={self.a_lat:.5f}, "
                f"m0={self.m0}, mu2={self.mu2}, lambda={self.lam}, "
                f"x0={self.x0})")
