"""Fused overrelax + heat-bath sweep chain of the quenched Schwinger model.

The link sweep (quenchedschwingeraction.cc:25-66) is the coarse chain of
the headline MLMC: per draw, 4 overrelaxation quarter-sweeps and 4
heat-bath quarter-sweeps with ExpCos rejection draws over
[n_chains, Mx, Mt, 2] link angles.  Under XLA each quarter-sweep is its own
fusion and the rejection loop a ``lax.while_loop``.
``schwinger_sweep_chain`` runs ``n_steps`` whole draws in ONE launch of the
CUDA kernel (ops/cuda/schwinger.cu), with the link field resident in shared
memory: one read and one write of the field per launch, and per step only
the topological sum and plaquette energy of each chain leave the chip.

This module also holds the kernel's plain-JAX reference (the same body on
[Mx, Mt, C] arrays, chains last), chosen only by ``reference=True``; it
runs on any backend and is what the CPU tests drive.  Both draw from the
counter RNG of ops/counter_rng.py.

The rejection draw is truncated at ``k_rej`` rounds; stragglers keep the
current link (the exact identity-mixture argument of
distributions/rejection.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.ops import cuda_kernels
from mlmcpathintegral.ops.counter_rng import (
    CounterRng, check_element_capacity, element_ids,
)

TWO_PI = 2.0 * math.pi
PI = math.pi
FOURPI2_INV = 1.0 / (4.0 * math.pi * math.pi)


def _mod_2pi(x):
    """[-pi, pi) wrap (utils.special.mod_2pi)."""
    return x - TWO_PI * jnp.floor(0.5 * (x + PI) / PI)


def _sh(A, di, dj, Mt):
    """A(i+di, j+dj) for A of shape [Mx, Mt, C] (axis 0 = j, axis 1 = i)."""
    out = A
    if di:
        out = jnp.roll(out, -di, axis=1)
    if dj:
        out = jnp.roll(out, -dj, axis=0)
    return out


def _staples(T, X, mu, Mt):
    """(theta_p, theta_m) for direction mu (models/qft/schwinger.py
    staple_angles_mu; quenchedschwingeraction.cc:25-44)."""
    def sh(A, di, dj):
        return _sh(A, di, dj, Mt)
    if mu == 0:
        tp = _mod_2pi(sh(T, 0, 1) + X - sh(X, 1, 0))
        tm = _mod_2pi(sh(T, 0, -1) + sh(X, 1, -1) - sh(X, 0, -1))
    else:
        tp = _mod_2pi(T + sh(X, 1, 0) - sh(T, 0, 1))
        tm = _mod_2pi(sh(T, -1, 1) + sh(X, -1, 0) - sh(T, -1, 0))
    return tp, tm


def _parity_mask(shape, axis, parity):
    idx = jax.lax.broadcasted_iota(jnp.int32, shape, axis)
    return (idx % 2) == parity


def _expcos_rejection(rng, tau, k_rej, dtype):
    """Draw the centred variable x ~ exp(tau cos x) on [-pi, pi) by a
    mixed-envelope rejection: uniform proposals for small tau, a TIGHT
    Gaussian envelope (sigma^2 = pi^2/(4 tau); valid because
    cos x - 1 + 2 x^2/pi^2 <= 0 on [-pi, pi]) otherwise.  Per-round
    acceptance >= 0.64 for ALL tau — the reference's looser envelope
    (sigma^2 = 2 pi^2/tau, expcosdistribution.hh:50-66) accepts only
    ~23% per round at large tau and ~tau^(1/2) at small tau.
    Returns (x, accepted_mask)."""
    use_uni = tau < 0.45
    sigma = 0.5 * PI / jnp.sqrt(jnp.maximum(tau, 1e-12))
    def round_(r, carry):
        x, acc = carry
        # 3 words per round, not 4: u2 doubles as the uniform-branch
        # proposal and the Box-Muller angle — each site consumes exactly
        # one of the two branches, so the reuse is exact (per-site the
        # consumed values are independent)
        u1 = r.uniform(dtype)
        u2 = r.uniform(dtype)
        prop_u = PI * (2.0 * u2 - 1.0)
        prop_g = sigma * (jnp.sqrt(-2.0 * jnp.log(u1))
                          * jnp.cos(TWO_PI * u2))
        prop = jnp.where(use_uni, prop_u, prop_g)
        u = r.uniform(dtype)
        log_ratio = tau * (jnp.cos(prop) - 1.0) + jnp.where(
            use_uni, 0.0, 2.0 * tau * prop * prop / (PI * PI))
        ok = jnp.logical_and(jnp.logical_and(-PI <= prop, prop < PI),
                             jnp.log(u) <= log_ratio)
        x = jnp.where(jnp.logical_and(ok, ~acc), prop, x)
        return x, jnp.logical_or(acc, ok)

    x, acc = rng.rounds(k_rej, 3, round_,
                        (jnp.zeros_like(tau), jnp.zeros(tau.shape, jnp.bool_)))
    return x, acc


def _expcos_draw(rng, cur, tp, tm, beta, k_rej, dtype):
    """Heat-bath draw from p(x) ~ exp[beta(cos(x-tp)+cos(x-tm))], rejection
    truncated at k_rej rounds; lanes that never accept keep ``cur`` (exact
    identity-mixture, distributions/rejection.py)."""
    dx = tm - tp
    tau = 2.0 * beta * jnp.abs(jnp.cos(0.5 * dx))
    shift = 0.5 * (tp + tm) + jnp.where(jnp.abs(dx) > PI, PI, 0.0)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype)
    out = _mod_2pi(x + shift)
    return jnp.where(acc, out, cur)


def _group_update(T, X, mu, parity, new_of, Mt):
    """Apply ``new_of(cur, tp, tm)`` to the (mu, parity) link group."""
    tp, tm = _staples(T, X, mu, Mt)
    cur = T if mu == 0 else X
    new = new_of(cur, tp, tm)
    if mu == 0:   # temporal links grouped by j parity (axis 0)
        mask = _parity_mask(cur.shape, 0, parity)
        return jnp.where(mask, new, T), X
    mask = _parity_mask(cur.shape, 1, parity)   # i parity (axis 1)
    return T, jnp.where(mask, new, X)


def _one_step(T, X, rng, *, beta, Mt, n_overrelax, n_heatbath, k_rej,
              dtype):
    """One full draw: n_overrelax + n_heatbath coloured sweeps."""
    groups = [(0, 0), (0, 1), (1, 0), (1, 1)]

    def overrelax(cur, tp, tm):
        return _mod_2pi(tp + tm - cur)

    def heatbath(cur, tp, tm):
        return _expcos_draw(rng, cur, tp, tm, beta, k_rej, dtype)

    for _ in range(n_overrelax):
        for mu, parity in groups:
            T, X = _group_update(T, X, mu, parity, overrelax, Mt)
    for _ in range(n_heatbath):
        for mu, parity in groups:
            T, X = _group_update(T, X, mu, parity, heatbath, Mt)
    return T, X


def seed_words(seed, chain_offset=0):
    """int32 [3]: the two seed words and the global id of the first
    local chain (the kernels' ``seeds`` operand)."""
    seed_arr = jnp.atleast_1d(jnp.asarray(seed, jnp.int32))
    if seed_arr.shape[0] == 1:
        seed_arr = jnp.concatenate([seed_arr, jnp.zeros((1,), jnp.int32)])
    off = jnp.asarray(chain_offset, jnp.int32).reshape(1)
    return jnp.concatenate([seed_arr[:2], off])


def _plaquettes(T, X, Mt):
    return _mod_2pi(T + _sh(X, 1, 0, Mt) - _sh(T, 0, 1, Mt) - X)


def _sweep_chain_reference(theta, seeds, *, beta, Mt, Mx, n_steps,
                           n_overrelax, n_heatbath, k_rej, step_offset):
    C = theta.shape[0]
    g = theta.reshape(C, Mx, Mt, 2).transpose(3, 1, 2, 0)   # [2, Mx, Mt, C]
    site, chain = element_ids((Mx, Mt, C), seeds[2])
    seed1 = seeds[0].astype(jnp.uint32)
    seed2 = seeds[1].astype(jnp.uint32)

    def body(carry, s):
        T, X = carry
        rng = CounterRng(seed1, site, chain, seed2, step=s)
        T, X = _one_step(T, X, rng, beta=beta, Mt=Mt,
                         n_overrelax=n_overrelax, n_heatbath=n_heatbath,
                         k_rej=k_rej, dtype=theta.dtype)
        plaq = _plaquettes(T, X, Mt)
        return (T, X), (jnp.sum(plaq, axis=(0, 1)),
                        jnp.sum(jnp.cos(plaq), axis=(0, 1)))

    steps = step_offset + jnp.arange(n_steps, dtype=jnp.uint32)
    (T, X), (qsum, esum) = jax.lax.scan(body, (g[0], g[1]), steps)
    theta_out = jnp.stack([T, X]).transpose(3, 1, 2, 0).reshape(C, -1)
    return theta_out, qsum, esum


def _sweep_chain_cuda(theta, seeds, *, beta, Mt, Mx, n_steps, n_overrelax,
                      n_heatbath, k_rej, step_offset):
    cuda_kernels.require_gpu("schwinger_sweep_chain")
    if theta.dtype != jnp.float32:
        raise ValueError(f"the CUDA sweep runs in float32, got "
                         f"{theta.dtype}; float64 runs take the XLA path")
    cuda_kernels.register()
    C = theta.shape[0]
    cpc, tpc = cuda_kernels.cta_shape(C, 4 * theta.shape[1], Mx * Mt // 2)
    trace = jax.ShapeDtypeStruct((n_steps, C), jnp.float32)
    return jax.ffi.ffi_call(
        "mlmcpi_schwinger_sweep_chain",
        (jax.ShapeDtypeStruct(theta.shape, jnp.float32), trace, trace),
    )(seeds, theta, Mx=np.int32(Mx), Mt=np.int32(Mt),
      n_steps=np.int32(n_steps), step_offset=np.int32(step_offset),
      n_overrelax=np.int32(n_overrelax), n_heatbath=np.int32(n_heatbath),
      k_rej=np.int32(k_rej), beta=np.float32(beta), cpc=np.int32(cpc),
      tpc=np.int32(tpc))


@functools.partial(jax.jit, static_argnames=(
    "beta", "Mt", "Mx", "n_steps", "n_overrelax", "n_heatbath", "k_rej",
    "step_offset", "reference"))
def schwinger_sweep_chain(theta, seed, *, beta, Mt, Mx, n_steps,
                          n_overrelax=1, n_heatbath=1, k_rej=6,
                          step_offset=0, chain_offset=0, reference=False):
    """``n_steps`` consecutive overrelaxed heat-bath draws of every chain.

    theta: [C, Mx*Mt*2] flat link angles (the action's state layout);
    seed: int32 scalar or (2,)-vector of per-launch randomness;
    ``chain_offset``: global id of the first chain (non-zero for a shard,
    so every chain draws the stream of its global id).  Returns
    (theta', qsum, esum) with qsum[s, c] = sum_P mod_2pi(theta_P) (the
    topological sum; the susceptibility QoI is qsum^2 / 4 pi^2) and
    esum[s, c] = sum_P cos(theta_P) (the plaquette energy, the chain's slow
    mode) after step s.  Draw s uses stream index ``step_offset + s``, so
    one launch of n steps equals n launches of one step.

    ``reference=True`` runs the plain-JAX reference on any backend;
    otherwise the CUDA kernel runs, on a GPU in float32 only.
    """
    C = theta.shape[0]
    check_element_capacity(Mx * Mt, C)
    kw = dict(beta=float(beta), Mt=int(Mt), Mx=int(Mx),
              n_steps=int(n_steps), n_overrelax=int(n_overrelax),
              n_heatbath=int(n_heatbath), k_rej=int(k_rej),
              step_offset=int(step_offset))
    seeds = seed_words(seed, chain_offset)
    if reference:
        return _sweep_chain_reference(theta, seeds, **kw)
    return _sweep_chain_cuda(theta, seeds, **kw)
