"""Wolff single-cluster sampler for 1-D cluster actions (rotor).

Reference parity: src/sampler/clustersampler.{hh,cc}; the 1-D specialised
bidirectional walk (clustersampler.cc:92-132) is reproduced exactly as a
bounded ``lax.scan``: from a random seed the cluster grows site by site to
the right until a bond fails (or the walk wraps to the seed), then to the
left until a bond fails (or the walk reaches the last forward site) —
including the reference's boundary behaviour when the cluster wraps the full
circle.  Each scan step is a cheap [n_chains] vector op, so thousands of
chains walk their clusters in lockstep.

The action must provide the ClusterAction hooks (rotoraction.hh:226-268):
``new_reflection(key, n_chains, dtype)``, ``S_ell(x_i, x_j, xbar)``,
``flip(x, xbar)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.samplers.base import Sampler, default_dtype


class ClusterState(NamedTuple):
    x: jnp.ndarray   # [C, M]


class ClusterSampler(Sampler):
    """``vectorised=True`` (default) replaces the sequential bidirectional
    scan with a closed-form masked update: every link the walk tests has
    exactly one already-flipped endpoint, and for the rotor reflection
    S_ell(flip(x_i), x_j) = -S_ell(x_i, x_j), so ALL bond probabilities
    are computable from the original configuration at once.  The cluster
    is then the contiguous run of open bonds around the seed, found with
    two argmax reductions instead of 2M sequential scatter steps — the
    same distribution (each tested link consumes an independent uniform),
    ~100x faster on a vector machine.  The walk path (``vectorised=False``) is kept as
    the executable specification (clustersampler.cc:92-132)."""

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10,
                 vectorised: bool = True):
        super().__init__(action)
        self.n_burnin = int(n_burnin)
        self.n_updates = int(n_updates)
        self.vectorised = bool(vectorised)

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        return ClusterState(x=self.action.initialise_state(key, n_chains,
                                                           dtype))

    # -- single 1-D cluster update (clustersampler.cc:92-132) ------------------

    def _single_cluster_update(self, key, x):
        act = self.action
        C, M = x.shape
        k_refl, k_seed, k_walk = jax.random.split(key, 3)
        xbar = act.new_reflection(k_refl, C, x.dtype)          # [C]
        i0 = jax.random.randint(k_seed, (C,), 0, M)            # [C]
        return self._walk_core(k_walk, x, xbar, i0)

    def _walk_core(self, key, x, xbar, i0):
        act = self.action
        C, M = x.shape
        k_fwd, k_bwd = jax.random.split(key, 2)
        chain = jnp.arange(C)
        # flip the seed site
        x = x.at[chain, i0].set(act.flip(x[chain, i0], xbar))

        def walk(x, key, start, direction, stop_at, extra_guard):
            """Sequential bonded walk. From position i, bond to
            i+direction; flip the neighbour if bonded; stop on first
            unbonded link or when the next position hits ``stop_at``.
            ``extra_guard(step)`` bounds the trip count. Returns
            (x, last_position_reached)."""
            def body(carry, k):
                x, pos, active, last = carry
                nxt = (pos + direction) % M
                s_ell = act.S_ell(x[chain, pos], x[chain, nxt], xbar)
                p_connect = 1.0 - jnp.exp(jnp.minimum(0.0, -s_ell))
                u = jax.random.uniform(k, (C,), x.dtype)
                bonded = jnp.logical_and(active, u < p_connect)
                flipped = act.flip(x[chain, nxt], xbar)
                x = x.at[chain, nxt].set(
                    jnp.where(bonded, flipped, x[chain, nxt]))
                # the reference records the position *before* the final
                # advance as i_last (clustersampler.cc:103-113)
                last = jnp.where(active, pos, last)
                pos = jnp.where(bonded, nxt, pos)
                active = jnp.logical_and(bonded, nxt != stop_at)
                return (x, pos, active, last), None

            keys = jax.random.split(key, M)
            active0 = jnp.ones((C,), bool)
            (x, pos, _, last), _ = jax.lax.scan(
                body, (x, start, active0, start), keys)
            return x, pos, last

        # forward walk: stop when wrapping back to the seed
        x, i_p, i_last_p = walk(x, k_fwd, i0, +1, i0, None)
        # backward walk: stop when reaching the last forward position
        x, _, _ = walk(x, k_bwd, i0, -1, i_last_p, None)
        return x

    # -- vectorised 1-D cluster update (same distribution, no scan) ------------

    def _vector_cluster_update(self, key, x):
        """Masked-run formulation of single_cluster_update1d.

        Walk semantics reproduced exactly (clustersampler.cc:92-132):
          * forward from seed i0 through open bonds; on a FULL wrap the
            final link (i0-1 -> i0) tests a doubly-flipped pair and, if
            open, re-flips the seed;
          * backward until the first closed bond or until re-flipping
            i_last_p (the forward walk's last position).
        Every tested link has one flipped endpoint except those two
        terminal links (both endpoints flipped).  With the rotor
        reflection, S_ell flips sign per flipped endpoint, so
        p_one = 1 - exp(min(0, +S_ell_orig)) and
        p_two = 1 - exp(min(0, -S_ell_orig)).
        """
        act = self.action
        C, M = x.shape
        k_refl, k_seed, k_vec = jax.random.split(key, 3)
        xbar = act.new_reflection(k_refl, C, x.dtype)            # [C]
        i0 = jax.random.randint(k_seed, (C,), 0, M)              # [C]
        return self._vector_core(k_vec, x, xbar, i0)

    def _vector_core(self, key, x, xbar, i0):
        act = self.action
        C, M = x.shape
        k_fwd, k_bwd = jax.random.split(key, 2)

        # undirected bond b: sites (b, b+1); S_ell of the ORIGINAL config
        s_orig = act.S_ell(x, jnp.roll(x, -1, axis=-1),
                           xbar[:, None])                        # [C, M]
        p_one = 1.0 - jnp.exp(jnp.minimum(0.0, s_orig))
        p_two = 1.0 - jnp.exp(jnp.minimum(0.0, -s_orig))

        # everything in ABSOLUTE bond positions — per-chain gathers
        # (take_along_axis) hit a catastrophic XLA path at M >= 128; masked min-reductions are uniformly fast
        cols = jnp.arange(M)[None, :]                            # [1, M]
        rel = (cols - i0[:, None]) % M     # forward walk order of bond b
        rel_b = (i0[:, None] - cols) % M   # site distance going left
        # backward walk order of bond b; rel_b==0 maps to M-1: after a
        # fully-wrapping backward walk (only reachable when the first
        # forward bond is closed, B_lim==M) the reference re-tests bond
        # (i0, i0+1) with both endpoints flipped and may re-flip the seed
        # (clustersampler.cc:108-113 do-while exits on i_m==i_last_p only
        # AFTER the flip).  For F_raw>=1 this bond's order M-1 >= B_lim,
        # so including it never changes B.
        k_bw = (rel_b - 1) % M

        # forward: bond at rel = k is tested k-th; rel = M-1 is the
        # full-wrap link with both endpoints flipped
        u_f = jax.random.uniform(k_fwd, (C, M), x.dtype)
        p_f = jnp.where(rel == M - 1, p_two, p_one)
        closed_f = u_f >= p_f
        # F_raw = walk order of the first closed forward bond (M if none)
        F_raw = jnp.min(jnp.where(closed_f, rel, M), axis=-1)    # [C]

        # backward: bond b is tested (rel_b(b) - 1)-th; the link that
        # would re-flip i_last_p has both endpoints flipped.  Cap B at
        # B_lim = distance from i0 to i_last_p going left.
        B_lim = jnp.where(F_raw >= M, 1, M - F_raw)              # [C]
        u_b = jax.random.uniform(k_bwd, (C, M), x.dtype)
        # terminal backward link re-flips i_last_p (both endpoints
        # flipped -> p_two) — except after a full forward wrap, where the
        # seed is net-unflipped and the link has one flipped endpoint
        term = jnp.logical_and(k_bw == (B_lim - 1)[:, None],
                               (F_raw < M)[:, None])
        p_b = jnp.where(term, p_two, p_one)
        closed_b = u_b >= p_b
        B_raw = jnp.min(jnp.where(closed_b, k_bw, M), axis=-1)
        B = jnp.minimum(B_raw, B_lim)                            # [C]
        n_flips = ((rel == 0).astype(jnp.int32)
                   + jnp.logical_and(rel >= 1,
                                     rel <= F_raw[:, None]).astype(jnp.int32)
                   + jnp.logical_and(rel_b >= 1,
                                     rel_b <= B[:, None]).astype(jnp.int32)
                   # full forward wrap: the final link flips the seed a
                   # second time (clustersampler.cc do-while exits only
                   # after the flip)
                   + jnp.logical_and(rel == 0,
                                     (F_raw >= M)[:, None]).astype(jnp.int32)
                   # full BACKWARD wrap (F_raw==0, all M backward links
                   # open): the terminal link re-flips the seed
                   + jnp.logical_and(rel == 0,
                                     (B >= M)[:, None]).astype(jnp.int32))
        odd = (n_flips % 2) == 1
        return jnp.where(odd, act.flip(x, xbar[:, None]), x)

    def draw(self, key, state: ClusterState):
        x = state.x
        update = (self._vector_cluster_update if self.vectorised
                  else self._single_cluster_update)
        if self.n_updates == 1:
            x = update(key, x)
        else:
            def body(x, k):
                return update(k, x), None
            keys = jax.random.split(key, self.n_updates)
            x, _ = jax.lax.scan(body, x, keys)
        accept = jnp.ones(x.shape[:-1], bool)
        return ClusterState(x=x), accept

    def prepare(self, key, n_chains, dtype=None):
        return super().prepare(key, n_chains, dtype, self.n_burnin)
