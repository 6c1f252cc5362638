"""Exact sampler wrapper for actions that can draw independent samples.

Reference parity: HarmonicOscillatorAction and GFFAction double as Samplers
(harmonicoscillatoraction.hh:264-276, gffaction.hh:356-375), selected with
``sampler = 'exact'``.  Here any action exposing
``exact_draw(key, n_chains, dtype)`` qualifies.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mlmcpathintegral.samplers.base import Sampler, default_dtype


class ExactState(NamedTuple):
    x: jnp.ndarray


class ExactSampler(Sampler):

    #: successive draws are iid — the two-level/multilevel coarse
    #: subsampling loops (montecarlotwolevel.cc:82-94) can use t = 1
    independent_draws = True

    def __init__(self, action):
        super().__init__(action)
        if not hasattr(action, "exact_draw"):
            raise ValueError(
                f"action {action.info_string()} has no exact sampler")

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        return ExactState(x=self.action.exact_draw(key, n_chains, dtype))

    def draw(self, key, state: ExactState):
        x = self.action.exact_draw(key, state.x.shape[0], state.x.dtype)
        accept = jnp.ones(x.shape[:-1], bool)
        return ExactState(x=x), accept

    def draw_batch(self, key, state: ExactState, n: int):
        """``n`` iid draws for every chain as ONE batched program:
        (state', xs[n, C, ndof]).  The batched two-level screen uses
        this to collapse the coarse phase from n sequential scan steps
        into a single (n*C)-row draw (one matrix product for the
        spectral samplers)."""
        C, N = state.x.shape
        xs = self.action.exact_draw(key, n * C, state.x.dtype)
        xs = xs.reshape(n, C, N)
        return ExactState(x=xs[-1]), xs

    def draw_batch_with_action(self, key, state: ExactState, n: int):
        """Like :meth:`draw_batch` but also returns S(x) per draw, in
        closed form from the driving normals when the action supports it
        (GFFAction.exact_draw_with_action) — the screen then skips its
        coarse-action evaluate over the whole proposal batch."""
        C, N = state.x.shape
        if hasattr(self.action, "exact_draw_with_action"):
            xs, S = self.action.exact_draw_with_action(key, n * C,
                                                       state.x.dtype)
        else:
            xs = self.action.exact_draw(key, n * C, state.x.dtype)
            S = self.action.evaluate(xs)
        xs = xs.reshape(n, C, N)
        return ExactState(x=xs[-1]), xs, S.reshape(n, C)

    def prepare(self, key, n_chains, dtype=None):
        return self.init(key, n_chains, dtype)
