"""Conditioned fine actions for 1-D QM models.

Reference parity:
  * GaussianConditionedFineAction — src/action/qm/gaussianconditionedfineaction.cc:
    odd sites ~ N(Wminimum, 1/Wcurvature), evaluate = sum of
    1/2 W'' dx^2 - 1/2 log W''  (the Gaussian log-density up to const).
  * RotorConditionedFineAction — src/action/qm/rotorconditionedfineaction.cc:
    odd sites ~ mod_2pi(x0 + ExpSin2(sigma = 2 W'')), evaluate =
    -log p_ExpSin2(dx; sigma) with the exact Bessel normalisation.

All odd sites are conditionally independent given the even sites, so the
fill is one vectorised draw over [..., M/2] sites, not a site loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mlmcpathintegral.conditioned.base import ConditionedFineAction
from mlmcpathintegral.distributions.expsin2 import ExpSin2Distribution
from mlmcpathintegral.utils.special import mod_2pi


def _even_neighbours(x):
    """For odd sites 2j+1: left neighbour x[2j], right neighbour x[2j+2]
    (periodic).  Returns (x_m, x_p) of shape [..., M/2]."""
    x_even = x[..., ::2]
    return x_even, jnp.roll(x_even, -1, axis=-1)


class GaussianConditionedFineAction(ConditionedFineAction):
    """Fill odd sites from N(Wminimum, 1/Wcurvature)."""

    def fill_fine_points(self, key, x):
        x_m, x_p = _even_neighbours(x)
        x0 = self.action.getWminimum(x_m, x_p)
        curv = self.action.getWcurvature(x_m, x_p)
        xi = jax.random.normal(key, x0.shape, x.dtype)
        return x.at[..., 1::2].set(x0 + xi / jnp.sqrt(curv))

    def evaluate(self, x):
        x_m, x_p = _even_neighbours(x)
        dx = x[..., 1::2] - self.action.getWminimum(x_m, x_p)
        curv = self.action.getWcurvature(x_m, x_p)
        return jnp.sum(0.5 * curv * dx * dx - 0.5 * jnp.log(curv), axis=-1)


class RotorConditionedFineAction(ConditionedFineAction):
    """Fill odd sites from the exact ExpSin2 conditional of the rotor."""

    def fill_fine_points(self, key, x):
        x_m, x_p = _even_neighbours(x)
        x0 = self.action.getWminimum(x_m, x_p)
        sigma = 2.0 * self.action.getWcurvature(x_m, x_p)
        xi = ExpSin2Distribution.draw(key, sigma)
        return x.at[..., 1::2].set(mod_2pi(x0 + xi))

    def evaluate(self, x):
        x_m, x_p = _even_neighbours(x)
        dx = x[..., 1::2] - self.action.getWminimum(x_m, x_p)
        sigma = 2.0 * self.action.getWcurvature(x_m, x_p)
        return -jnp.sum(ExpSin2Distribution.log_evaluate(dx, sigma), axis=-1)


def make_conditioned_fine_action(action) -> ConditionedFineAction:
    """Factory: pick the conditioned fine action matching the action type
    (the analog of the per-model ConditionedFineActionFactory wiring in
    driver_qm.cc:305-335)."""
    from mlmcpathintegral.models.rotor import RotorAction
    if isinstance(action, RotorAction):
        return RotorConditionedFineAction(action)
    return GaussianConditionedFineAction(action)
