"""O(3) sigma-model conditioned fine action.

Reference parity: src/action/qft/nonlinearsigmaconditionedfineaction.{hh,cc}.
The fill-in is the exact single-site heat bath at every fine-only vertex
(all of whose nearest neighbours are coarse on the rotate hierarchy, so the
fills are conditionally independent and vectorise); evaluate is the
CompactExp log-density of the spin projection onto the neighbour-sum
direction (the uniform azimuth factor is constant and cancels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.conditioned.base import ConditionedFineAction
from mlmcpathintegral.distributions.compactexp import CompactExpDistribution
from mlmcpathintegral.models.qft.nonlinearsigma import (
    angles_to_vec, vec_to_angles,
)


class NonlinearSigmaConditionedFineAction(ConditionedFineAction):

    def __init__(self, action):
        super().__init__(action)
        lat = action.lattice
        self.beta = action.beta
        self._fineonly = lat.fineonly_vertices
        self._nn_fine = lat.neighbour_vertices[self._fineonly, :4]
        coarse = np.zeros(lat.nvertices, bool)
        coarse[lat.coarse_vertices] = True
        if not coarse[self._nn_fine].all():
            raise ValueError("sigma fill-in needs all-coarse neighbours at "
                             "fine-only vertices (CoarsenRotate)")

    def fill_fine_points(self, key, state):
        act = self.action
        vec = angles_to_vec(state)
        vec = act._heatbath_colour(key, vec, self._fineonly)
        return vec_to_angles(vec)

    def evaluate(self, state):
        vec = angles_to_vec(state)
        delta = jnp.sum(vec[..., self._nn_fine, :], axis=-2)
        nrm = jnp.linalg.norm(delta, axis=-1)
        z = jnp.sum(vec[..., self._fineonly, :] * delta, axis=-1) \
            / jnp.maximum(nrm, 1e-30)
        return -jnp.sum(CompactExpDistribution.log_evaluate(
            z, self.beta * nrm), axis=-1)
