"""GFF conditioned fine action.

Reference parity: src/action/qft/gffconditionedfineaction.{hh,cc}.  Fill
the fine-only vertices from the exact single-site conditional of the
5-point stencil, phi ~ N(Delta/(4+mu2), 1/(4+mu2)); evaluate is the sum of
the matching Gaussian energies (the constant -1/2 log kappa normalisation is
site-independent and cancels in all two-level Delta-S differences, so the
reference omits it and so do we).

The reference fills the fine-only vertices *sequentially*
(gffconditionedfineaction.cc:7-25), which is only self-consistent when all
4 nearest neighbours of every fine-only vertex are coarse vertices — true
exactly for the CoarsenRotate hierarchy it is used with.  This
implementation vectorises the fill over all fine-only vertices at once and
asserts that independence property at construction.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.conditioned.base import ConditionedFineAction


class GFFConditionedFineAction(ConditionedFineAction):

    def __init__(self, action):
        super().__init__(action)
        lat = action.lattice
        self.mu2 = action.mu2
        self._fineonly = lat.fineonly_vertices
        self._nn_fine = lat.neighbour_vertices[self._fineonly, :4]
        coarse = np.zeros(lat.nvertices, bool)
        coarse[lat.coarse_vertices] = True
        if not coarse[self._nn_fine].all():
            raise ValueError(
                "GFF conditioned fill-in needs every fine-only vertex to "
                "have only coarse nearest neighbours (use CoarsenRotate, "
                "cf. gffconditionedfineaction.cc:7-25)")
        # gather-free grid path (unrotated fine lattice): fine-only
        # vertices are the odd checkerboard of the [Mx, Mt] grid, so the
        # fill/evaluate run as periodic rolls + a parity mask instead of
        # neighbour-table gathers (see GFFAction._nbsum rationale)
        self._grid = None
        if not lat.rotated:
            Mt, Mx = lat.Mt_lat, lat.Mx_lat
            i = np.arange(Mt)[None, :]
            j = np.arange(Mx)[:, None]
            self._grid = (Mx, Mt,
                          jnp.asarray((i + j) % 2 == 1))   # fine-only mask
        if self._grid is None or getattr(action, "n_gibbs_smooth", 0):
            # shadow the combined-pass hook: the batched screen probes
            # for it with getattr and must fall back to fill + evaluate
            self.fill_with_logq_sf = None

    def fill_fine_points(self, key, phi):
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        if self._grid is not None:
            Mx, Mt, mask = self._grid
            delta = self.action._nbsum(phi)
            xi = jax.random.normal(key, phi.shape, phi.dtype)
            filled = sigma * xi + delta / kappa
            g = jnp.where(mask.reshape(-1), filled, phi)
            return g
        delta = jnp.sum(phi[..., self._nn_fine], axis=-1)
        xi = jax.random.normal(key, delta.shape, phi.dtype)
        return phi.at[..., self._fineonly].set(sigma * (xi + sigma * delta))

    def fill_with_logq_sf(self, key, phi):
        """Fill + S_cond + S_fine of the filled state in ONE stencil pass.

        The fine lattice is bipartite: every edge joins an even (coarse)
        and an odd (filled) vertex, so with delta = nbsum(phi) (whose
        odd entries only read the even plane, unchanged by the fill)

            S_fine(phi') = 1/2 kappa sum phi'^2 - sum_odd phi'_odd delta
            S_cond(phi') = 1/2 sum xi^2

        — no second/third neighbour pass over the [S, C, ndof] proposal
        tensor (the batched screen's HBM hot spot).  Shadowed to None in
        __init__ when the closed form does not apply (rotated fine
        lattice or Gibbs-smoothed action)."""
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        Mx, Mt, mask = self._grid
        m = mask.reshape(-1)
        delta = self.action._nbsum(phi)
        xi = jax.random.normal(key, phi.shape, phi.dtype)
        g = jnp.where(m, sigma * xi + delta / kappa, phi)
        S_q = 0.5 * jnp.sum(jnp.where(m, xi * xi, 0.0), axis=-1)
        S_f = (0.5 * kappa * jnp.sum(g * g, axis=-1)
               - jnp.sum(jnp.where(m, g * delta, 0.0), axis=-1))
        return g, S_q, S_f

    def fill_with_logq(self, key, phi):
        """Fill + the filled state's conditioned action in one pass.

        For the exact Gaussian conditional, S_cond(filled) =
        1/2 kappa (sigma xi)^2 summed over fine-only sites = 1/2 sum xi^2
        (minus the constant 1/2 log kappa per site, omitted exactly as in
        :meth:`evaluate`) — no second neighbour-stencil pass over the
        [S, C, ndof] proposal tensor (the batched screen's HBM hot spot).
        """
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        if self._grid is not None:
            Mx, Mt, mask = self._grid
            m = mask.reshape(-1)
            delta = self.action._nbsum(phi)
            xi = jax.random.normal(key, phi.shape, phi.dtype)
            g = jnp.where(m, sigma * xi + delta / kappa, phi)
            S_q = 0.5 * jnp.sum(jnp.where(m, xi * xi, 0.0), axis=-1)
            return g, S_q
        delta = jnp.sum(phi[..., self._nn_fine], axis=-1)
        xi = jax.random.normal(key, delta.shape, phi.dtype)
        g = phi.at[..., self._fineonly].set(sigma * (xi + sigma * delta))
        return g, 0.5 * jnp.sum(xi * xi, axis=-1)

    def evaluate(self, phi):
        kappa = 4.0 + self.mu2
        if self._grid is not None:
            Mx, Mt, mask = self._grid
            delta = self.action._nbsum(phi)
            dphi = phi - delta / kappa
            return 0.5 * kappa * jnp.sum(
                jnp.where(mask.reshape(-1), dphi * dphi, 0.0), axis=-1)
        delta = jnp.sum(phi[..., self._nn_fine], axis=-1)
        dphi = phi[..., self._fineonly] - delta / kappa
        return 0.5 * kappa * jnp.sum(dphi * dphi, axis=-1)
