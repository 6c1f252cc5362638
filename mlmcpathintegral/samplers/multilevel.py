"""Multilevel sampler: persistent per-level states with a tau-adaptive,
data-dependent level walk.

Reference parity: src/sampler/multilevelsampler.{hh,cc}.  Unlike the
hierarchical sampler, per-level states persist between draws and the chain
only promotes a sample to the next finer level once the current level has
accumulated ceil(tau_int) draws since its last promotion
(multilevelsampler.cc:71-113); the walk returns to the coarsest level after
every unpromoted draw.

Batched design: the reference's data-dependent do/while level walk is expressed
as *statically nested* ``lax.while_loop``s — producing one decorrelated
sample at level ell loops {obtain a decorrelated sample at level ell+1
(recursively), apply the two-level step, record, count} until the level's
counter reaches ceil(tau_int) computed *on device* from the batched
statistics.  The whole draw is one jittable program; all chains walk in
lockstep using cross-chain tau estimates (the batched analog of the
reference's single-chain estimates).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral.samplers.base import Sampler, default_dtype
from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


class MultilevelSamplerState(NamedTuple):
    tl: tuple            # per-level TwoLevelState, ell = 0 .. L-2
    coarse: Any          # coarsest-level sampler state
    stats: tuple         # per-level sampler StatsState, ell = 0 .. L-1
    t_sampler: jnp.ndarray   # [L] int32 draws since last promotion
    t_indep_sum: jnp.ndarray  # [L] running sum of promotion spacings
    n_indep: jnp.ndarray      # [L] number of promotions


class MultilevelSampler(Sampler):

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, n_max_level: int,
                 n_autocorr_window: int = 20):
        super().__init__(fine_action)
        self.n_level = n_max_level - fine_action.lattice.coarsening_level
        if self.n_level < 2:
            raise ValueError(f"need >= 2 levels, got {self.n_level}")
        self.actions = [fine_action]
        self.twolevel_steps = []
        for ell in range(self.n_level - 1):
            coarse = self.actions[ell].coarse_action()
            cond = conditioned_fine_action_factory(self.actions[ell])
            self.twolevel_steps.append(
                TwoLevelMetropolisStep(coarse, self.actions[ell], cond))
            self.actions.append(coarse)
        self.coarse_sampler = coarse_sampler_factory(self.actions[-1])
        self.qois = [qoi_factory(a) for a in self.actions]
        self.stats_defs = [Statistics(f"Q_sampler[{ell}]", n_autocorr_window)
                           for ell in range(self.n_level)]

    # -- state -----------------------------------------------------------------

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        k_x, k_c = jax.random.split(key)
        coarse = self.coarse_sampler.init(k_c, n_chains, dtype)
        # seed the hierarchy upward from the coarsest state by
        # prolongate + fill, so every level starts inside its proposal
        # distribution (cf. samplers/hierarchical.py prepare)
        L = self.n_level
        xs = [None] * L
        xs[L - 1] = self.coarse_sampler.x_of(coarse)
        for ell in range(L - 2, -1, -1):
            k_x, s1, s2 = jax.random.split(k_x, 3)
            x = self.actions[ell].initialise_state(s1, n_chains, dtype)
            x = self.actions[ell].prolongate(xs[ell + 1], x)
            cond = self.twolevel_steps[ell].conditioned_fine_action
            xs[ell] = cond.fill_fine_points(s2, x)
        tl = tuple(self.twolevel_steps[ell].init(xs[ell])
                   for ell in range(self.n_level - 1))
        stats = tuple(self.stats_defs[ell].init(n_chains, dtype)
                      for ell in range(self.n_level))
        L = self.n_level
        return MultilevelSamplerState(
            tl=tl, coarse=coarse, stats=stats,
            t_sampler=jnp.zeros((L,), jnp.int32),
            t_indep_sum=jnp.zeros((L,), jnp.float32),
            n_indep=jnp.zeros((L,), jnp.float32))

    def prepare(self, key, n_chains, dtype=None):
        k_c, k_i = jax.random.split(key)
        state = self.init(k_i, n_chains, dtype)
        coarse = self.coarse_sampler.prepare(k_c, n_chains, dtype)
        return state._replace(coarse=coarse)

    def x_of(self, state):
        return state.tl[0].theta

    def set_state(self, state, x):
        tl0 = self.twolevel_steps[0].set_state(state.tl[0], x)
        return state._replace(tl=(tl0,) + tuple(state.tl[1:]))

    # -- draw (multilevelsampler.cc:71-113) ------------------------------------

    def _draw_level(self, ell: int, carry):
        """Loop until level ``ell`` has produced a tau-decorrelated sample;
        statically recursive over levels."""
        L = self.n_level

        def cond(carry):
            state, key = carry
            tau = stats_mod.tau_int_device(state.stats[ell])
            return state.t_sampler[ell] < jnp.ceil(tau).astype(jnp.int32)

        def body(carry):
            state, key = carry
            key, sub = jax.random.split(key)
            if ell == L - 1:
                cstate, _ = self.coarse_sampler.draw(sub, state.coarse)
                state = state._replace(coarse=cstate)
                x_ell = self.coarse_sampler.x_of(cstate)
            else:
                # recursively obtain a decorrelated coarser sample
                state, key = self._draw_level(ell + 1, (state, key))
                x_coarse = (self.coarse_sampler.x_of(state.coarse)
                            if ell + 1 == L - 1
                            else state.tl[ell + 1].theta)
                key, sub2 = jax.random.split(key)
                tl_ell, _ = self.twolevel_steps[ell].draw(
                    sub2, state.tl[ell], x_coarse)
                tl = tuple(tl_ell if k == ell else state.tl[k]
                           for k in range(L - 1))
                state = state._replace(tl=tl)
                x_ell = tl_ell.theta
            q = self.qois[ell](x_ell)
            stats = tuple(
                stats_mod.record(state.stats[k], q) if k == ell
                else state.stats[k] for k in range(L))
            state = state._replace(
                stats=stats,
                t_sampler=state.t_sampler.at[ell].add(1))
            return (state, key)

        state, key = jax.lax.while_loop(cond, body, carry)
        # promotion bookkeeping (multilevelsampler.cc:92-109)
        t = state.t_sampler[ell].astype(jnp.float32)
        state = state._replace(
            t_indep_sum=state.t_indep_sum.at[ell].add(t),
            n_indep=state.n_indep.at[ell].add(1.0),
            t_sampler=state.t_sampler.at[ell].set(0))
        return (state, key)

    def draw(self, key, state: MultilevelSamplerState):
        state, _ = self._draw_level(0, (state, key))
        accept = jnp.ones(self.x_of(state).shape[:-1], bool)
        return state, accept

    def t_indep(self, state):
        """Average spacing between promoted samples per level."""
        import numpy as np
        s = np.asarray(state.t_indep_sum)
        n = np.asarray(state.n_indep)
        return s / np.maximum(n, 1.0)
