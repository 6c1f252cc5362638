"""Quantities of interest: pure batched functions x[..., ndof] -> [...].

The reference's QoI class hierarchy + QoIFactory
(src/qoi/quantityofinterest.hh:16-36) becomes plain function factories that
bake lattice metadata in as constants.  Each MC method applies the QoI
inside the jitted sampling loop, fused with the sampler kernel.

Reference parity:
  * qoi_x_squared        — src/qoi/qm/qoixsquared.cc:3-19
  * qoi_susceptibility   — src/qoi/qm/qoisusceptibility.cc:3-19
  * 2-D QoIs (phi^2, avg plaquette, 2-D susceptibility, magnetic
    susceptibility) live next to their QFT models.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.utils.special import mod_2pi

FOUR_PI2_INV = 1.0 / (4.0 * math.pi * math.pi)


def _lattice_of(obj):
    """Accept either a lattice or an action (the reference's QoIFactory
    takes actions, quantityofinterest.hh:26-36)."""
    return getattr(obj, "lattice", obj)


def qoi_x_squared(lattice: Lattice1D):
    """<X^2> estimator: (1/M) sum_j x_j^2 (qoixsquared.cc:3-19)."""
    def evaluate(x):
        return jnp.mean(x * x, axis=-1)
    return evaluate


def qoi_susceptibility(lattice: Lattice1D):
    """Topological susceptibility chi_t = Q[x]^2 / T with winding number
    Q = (1/2pi) sum_j mod_2pi(x_j - x_{j-1}) (qoisusceptibility.cc:3-19)."""
    T_final = _lattice_of(lattice).T_final

    def evaluate(x):
        dx = x - jnp.roll(x, 1, axis=-1)
        Q = jnp.sum(mod_2pi(dx), axis=-1)
        return FOUR_PI2_INV * Q * Q / T_final
    return evaluate


def qoi_2d_susceptibility(action):
    """V chi_t = Q^2/(4 pi^2), Q = sum_P mod_2pi(theta_P) over plaquettes
    of a gauge action (qoi2dsusceptibility.cc:6-28)."""
    def evaluate(theta):
        plaq = action.plaquette_angles(theta)
        Q = jnp.sum(mod_2pi(plaq), axis=(-2, -1))
        return FOUR_PI2_INV * Q * Q
    return evaluate


def qoi_avg_plaquette(action):
    """(1/(Mt Mx)) sum_P cos(theta_P) (qoiavgplaquette.cc:6-27)."""
    def evaluate(theta):
        return jnp.mean(jnp.cos(action.plaquette_angles(theta)),
                        axis=(-2, -1))
    return evaluate


def qoi_2d_phi_squared(action_or_lattice):
    """(1/M) sum phi^2 for scalar 2-D fields (qoi2dphisquared.cc:3-11)."""
    def evaluate(phi):
        return jnp.mean(phi * phi, axis=-1)
    return evaluate


def make_qoi(name: str, obj):
    """Factory by name (the analog of QoIFactory wiring in driver_qm.cc /
    driver_qft.cc)."""
    if name == "x_squared":
        return qoi_x_squared(obj)
    if name == "susceptibility":
        return qoi_susceptibility(obj)
    if name == "2d_susceptibility":
        return qoi_2d_susceptibility(obj)
    if name == "avg_plaquette":
        return qoi_avg_plaquette(obj)
    if name == "2d_phi_squared":
        return qoi_2d_phi_squared(obj)
    raise ValueError(f"unknown QoI '{name}'")
