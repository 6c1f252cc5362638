"""Hierarchical (delayed-acceptance) sampler.

Reference parity: src/sampler/hierarchicalsampler.{hh,cc} — the paper's key
autocorrelation-reduction device.  A draw restricts the current fine state
down the level hierarchy, redraws the coarsest level with a standalone
sampler, then walks back up applying a TwoLevelMetropolisStep per level;
the overall acceptance is the AND of all level acceptances and the
reference aborts on the first rejection (hierarchicalsampler.cc:55-81).

Batched design: the level loop is unrolled at trace time (n_level is static);
"abort on first rejection" becomes per-chain masking — every chain runs all
levels in lockstep but a chain's state only advances while its running
accept flag is still true.  The whole draw is one fused XLA program.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral.samplers.base import Sampler, default_dtype


class HierarchicalState(NamedTuple):
    xs: tuple               # per-level states, xs[ell]: [C, M_ell]
    coarse: Any             # coarse-sampler state pytree
    n_total: jnp.ndarray    # [L] per-level attempted moves
    n_accepted: jnp.ndarray  # [L] per-level accepted moves


class HierarchicalSampler(Sampler):

    def __init__(self, fine_action, coarse_sampler_factory,
                 conditioned_fine_action_factory, n_max_level: int):
        """``coarse_sampler_factory(action) -> Sampler`` builds the
        coarsest-level sampler; ``conditioned_fine_action_factory(action) ->
        ConditionedFineAction`` builds the per-level fill-in
        (hierarchicalsampler.cc:8-52)."""
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

    # -- state -----------------------------------------------------------------

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        k_x, k_c = jax.random.split(key)
        xs = [self.action.initialise_state(k_x, n_chains, dtype)]
        for ell in range(1, self.n_level):
            xs.append(self.actions[ell - 1].restrict(xs[ell - 1]))
        coarse = self.coarse_sampler.init(k_c, n_chains, dtype)
        z = jnp.zeros((self.n_level,), jnp.int64)
        return HierarchicalState(xs=tuple(xs), coarse=coarse,
                                 n_total=z, n_accepted=z)

    def prepare(self, key, n_chains, dtype=None):
        """Prepare the coarsest-level sampler (burn-in/autotune, the work its
        factory-built ctor does in the reference) and seed the hierarchy by
        an upward prolongate+fill pass from the burned-in coarsest state —
        so the fine chains start inside the proposal distribution."""
        dtype = dtype or default_dtype()
        k_x, k_c = jax.random.split(key)
        coarse = self.coarse_sampler.prepare(k_c, n_chains, dtype)
        L = self.n_level
        xs = [None] * L
        xs[L - 1] = self.coarse_sampler.x_of(coarse)
        for ell in range(L - 2, -1, -1):
            k_x, sub = jax.random.split(k_x)
            x = self.actions[ell].initialise_state(sub, n_chains, dtype)
            x = self.actions[ell].prolongate(xs[ell + 1], x)
            cond = self.twolevel_steps[ell].conditioned_fine_action
            k_x, sub = jax.random.split(k_x)
            xs[ell] = cond.fill_fine_points(sub, x)
        z = jnp.zeros((self.n_level,), jnp.int64)
        return HierarchicalState(xs=tuple(xs), coarse=coarse,
                                 n_total=z, n_accepted=z)

    def set_state(self, state, x):
        xs = (x,) + tuple(state.xs[1:])
        return state._replace(xs=xs)

    def x_of(self, state):
        return state.xs[0]

    # -- draw (hierarchicalsampler.cc:55-81) -----------------------------------

    def draw(self, key, state: HierarchicalState):
        L = self.n_level
        xs = list(state.xs)
        # restrict current fine state down the hierarchy
        for ell in range(1, L):
            xs[ell] = self.actions[ell - 1].restrict(xs[ell - 1])

        keys = jax.random.split(key, L)
        C = xs[0].shape[0]
        n_total = state.n_total
        n_accepted = state.n_accepted
        # coarsest level: standalone sampler move
        cs = self.coarse_sampler.set_state(state.coarse, xs[L - 1])
        cs, accept_all = self.coarse_sampler.draw(keys[L - 1], cs)
        xs[L - 1] = self._x_of(cs)
        n_total = n_total.at[L - 1].add(C)
        n_accepted = n_accepted.at[L - 1].add(
            jnp.sum(accept_all, dtype=jnp.int64))

        # walk back up; per-chain early exit via masking (the per-level
        # acceptance bookkeeping matches hierarchicalsampler.cc:90-117:
        # a level only counts attempts by chains still alive)
        for ell in range(L - 2, -1, -1):
            step = self.twolevel_steps[ell]
            tl = step.init(xs[ell])
            tl, acc = step.draw(keys[ell], tl, xs[ell + 1])
            xs[ell] = jnp.where(accept_all[..., None], tl.theta, xs[ell])
            n_total = n_total.at[ell].add(
                jnp.sum(accept_all, dtype=jnp.int64))
            n_accepted = n_accepted.at[ell].add(jnp.sum(
                jnp.logical_and(accept_all, acc), dtype=jnp.int64))
            accept_all = jnp.logical_and(accept_all, acc)

        return HierarchicalState(xs=tuple(xs), coarse=cs,
                                 n_total=n_total,
                                 n_accepted=n_accepted), accept_all

    @staticmethod
    def _x_of(sampler_state):
        return sampler_state.x

    def show_stats(self, state):
        """Per-level acceptance report (hierarchicalsampler.cc:90-117)."""
        import numpy as np
        n_tot = np.asarray(state.n_total)
        n_acc = np.asarray(state.n_accepted)
        for ell in range(self.n_level):
            tag = ("[finest]  " if ell == 0 else
                   "[coarsest]" if ell == self.n_level - 1 else
                   "          ")
            p = n_acc[ell] / max(int(n_tot[ell]), 1)
            print(f"  level {ell} {tag} : p = {p:.3f}")
