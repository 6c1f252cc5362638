"""Batched rejection sampling for vmapped/sharded chains.

The reference's distributions draw one scalar at a time inside a
``while(true)`` loop (e.g. src/distribution/expsin2distribution.hh:44-58).
On an accelerator the draw is batched: every lane proposes and accept/rejects in
lockstep, a ``lax.while_loop`` iterates until *all* lanes have accepted,
and accepted lanes are frozen.  Envelopes in this family are tight
(acceptance >~ 0.5 by construction), so the expected number of sweeps is
O(log(batch)/log(1/p_reject)) — a handful.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def batched_rejection_sample_mask(key, propose_accept, shape, dtype,
                                  max_iter: int = 100):
    """Run batched rejection sampling until all lanes accept.

    ``propose_accept(key) -> (proposal, accept_mask)`` proposes a full batch
    of candidates of ``shape`` and a boolean mask of which lanes accept.

    Returns ``(x, accepted)`` where ``x`` has ``shape``/``dtype`` and
    ``accepted`` marks lanes that genuinely accepted within ``max_iter``
    rounds (the rest keep their final proposal).  The loop exits early once
    every lane has accepted, so the ``max_iter`` bound only matters when a
    caller deliberately truncates it (see the ``fallback`` pattern in the
    heat-bath draws: unaccepted lanes keep the current state, which is an
    exact state-independent mixture of the heat-bath kernel with the
    identity kernel and therefore still preserves the target).
    """
    def cond(carry):
        i, _key, _x, acc = carry
        return jnp.logical_and(i < max_iter, ~jnp.all(acc))

    def body(carry):
        i, key, x, acc = carry
        key, sub = jax.random.split(key)
        proposal, ok = propose_accept(sub)
        # freeze lanes that have already accepted
        x = jnp.where(acc, x, proposal)
        acc = jnp.logical_or(acc, ok)
        return i + 1, key, x, acc

    key, sub = jax.random.split(key)
    x0, acc0 = propose_accept(sub)
    i0 = jnp.zeros((), jnp.int32)
    _, _, x, acc = jax.lax.while_loop(cond, body, (i0, key, x0, acc0))
    return x.astype(dtype), acc


def batched_rejection_sample(key, propose_accept, shape, dtype,
                             max_iter: int = 100):
    """As :func:`batched_rejection_sample_mask`, returning only the samples
    (exact draws: callers that need the density to hold — the conditioned
    fill-ins — use this with a large ``max_iter``)."""
    x, _ = batched_rejection_sample_mask(key, propose_accept, shape, dtype,
                                         max_iter)
    return x
