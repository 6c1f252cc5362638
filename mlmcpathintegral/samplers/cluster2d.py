"""Wolff single-cluster sampler for the 2-D O(3) sigma model.

Reference parity: src/sampler/clustersampler.cc:52-89 (generic BFS cluster
growth over the lattice neighbour graph, applied to the sigma model's
spin-flip cluster action, nonlinearsigmaaction.cc:166-210).

Batched design: the sequential BFS becomes *parallel label propagation* — each
sweep performs one independent bond trial for every edge from the current
frontier to an outside vertex, and an outside vertex joins if any trial
succeeds.  This is distribution-identical to the BFS: bond probabilities
depend only on (flipped frontier spin, unflipped outside spin), every
frontier->outside edge receives exactly one independent trial, and the
probability of not joining factorises over trials in both schedules.  The
sweep loop is a ``lax.while_loop`` bounded by the vertex count; all chains
grow their clusters in lockstep.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.models.qft.nonlinearsigma import (
    angles_to_vec, vec_to_angles,
)
from mlmcpathintegral.samplers.base import Sampler, default_dtype


class Cluster2DState(NamedTuple):
    x: jnp.ndarray   # [C, 2N] angle state


class Cluster2DSampler(Sampler):
    """Works with actions exposing ``new_reflection``, ``S_ell_vec``,
    ``flip_vec`` and storing spins as (theta, phi) angle pairs (the O(3)
    sigma model)."""

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10):
        super().__init__(action)
        self.n_burnin = int(n_burnin)
        self.n_updates = int(n_updates)
        self._nn = np.asarray(action.lattice.neighbour_vertices[:, :4])

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        return Cluster2DState(x=self.action.initialise_state(key, n_chains,
                                                             dtype))

    def _single_cluster_update(self, key, x):
        act = self.action
        N = act.lattice.nvertices
        vec = angles_to_vec(x)           # [C, N, 3]
        C = vec.shape[0]
        k_r, k_seed, k_grow = jax.random.split(key, 3)
        r = act.new_reflection(k_r, C, vec.dtype)       # [C, 3]
        seed = jax.random.randint(k_seed, (C,), 0, N)
        chain = jnp.arange(C)
        seed_mask = jax.nn.one_hot(seed, N, dtype=bool)

        r_b = r[:, None, :]
        vec = jnp.where(seed_mask[..., None], act.flip_vec(vec, r_b), vec)
        in_cluster = seed_mask
        frontier = seed_mask
        nn = jnp.asarray(self._nn)       # [N, 4]

        def cond(carry):
            vec, in_cluster, frontier, key, it = carry
            return jnp.logical_and(jnp.any(frontier), it < N)

        def body(carry):
            vec, in_cluster, frontier, key, it = carry
            key, sub = jax.random.split(key)
            # r.sigma per vertex; frontier spins are already flipped
            r_sigma = jnp.sum(vec * r_b, axis=-1)          # [C, N]
            s_ell = (-2.0 * act.beta
                     * r_sigma[..., None] * r_sigma[:, nn])  # [C, N, 4]
            # edge is live when the neighbour is on the frontier and this
            # vertex is outside the cluster
            live = jnp.logical_and(frontier[:, nn],
                                   ~in_cluster[..., None])
            p_connect = 1.0 - jnp.exp(jnp.minimum(0.0, -s_ell))
            u = jax.random.uniform(sub, s_ell.shape, vec.dtype)
            bonded = jnp.logical_and(live, u < p_connect)
            join = jnp.any(bonded, axis=-1)                # [C, N]
            vec = jnp.where(join[..., None], act.flip_vec(vec, r_b), vec)
            in_cluster = jnp.logical_or(in_cluster, join)
            return (vec, in_cluster, join, key, it + 1)

        it0 = jnp.zeros((), jnp.int32)
        vec, _, _, _, _ = jax.lax.while_loop(
            cond, body, (vec, in_cluster, frontier, k_grow, it0))
        return vec_to_angles(vec)

    def draw(self, key, state: Cluster2DState):
        x = state.x
        def body(x, k):
            return self._single_cluster_update(k, x), None
        keys = jax.random.split(key, self.n_updates)
        x, _ = jax.lax.scan(body, x, keys)
        accept = jnp.ones(x.shape[:-1], bool)
        return Cluster2DState(x=x), accept

    def prepare(self, key, n_chains, dtype=None):
        return super().prepare(key, n_chains, dtype, self.n_burnin)
