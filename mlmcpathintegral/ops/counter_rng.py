"""Counter-based RNG of the fused Schwinger kernels.

A hash generator in plain integer vector ops with the murmur3 finalizer
(full avalanche): draws are a pure function of (seed pair, site id, chain
id, step, draw counter), so the plain-JAX references (ops/schwinger.py,
ops/schwinger_twolevel.py) and the CUDA kernels (ops/cuda/schwinger.cu)
draw the same numbers bit for bit.  This module is the specification the
CUDA code implements.

Two-lane stream separation: each element keys TWO independent 32-bit
lanes — one from its site index (+ per-step seed and step counter), one
from its global chain index (+ second seed word) — advanced by a shared
draw counter and combined through a FINAL avalanche:

    bits = fmix32( fmix32(base_site + ctr*C1) + fmix32(base_chain + ctr*C2) )

The outer fmix32 is load-bearing.  An earlier revision XORed the two
lanes directly; then, at fixed counter, the site lane is a CONSTANT for
every chain and the chain lane a constant for every site — so the whole
ensemble's noise at one counter was a single random word per chain,
reused by every site and step through fixed XOR masks.  Marginals stay
perfectly uniform (XOR by a constant is measure-preserving), but pairs
of sites/steps are functionally dependent (measured: cross-site corr
-0.9, cross-step +0.97 on the float uniforms), which biased fused HMC
chains at the percent level.  Hashing the SUM of the lanes restores
pairwise independence: inputs differing by any constant avalanche to
decorrelated outputs.  Two elements share a full stream only on a
whole-uint32 collision of the combined input sequence (~2^-64 per
pair over two counters), vs the exact-distinctness-by-construction of
the XOR form — a trade that buys actual independence.
"""

from __future__ import annotations

import copy
import math

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * math.pi


def fmix32(h):
    """murmur3 32-bit finalizer (full avalanche)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


class CounterRng:
    """Per-element two-lane counter RNG (see module docstring).

    ``site_id``/``chain_id``: uint32 arrays (broadcastable) uniquely
    identifying the lattice site and the global chain lane of each
    element — build them with :func:`element_ids`.

    ``seed2`` extends the per-step entropy to 64 bits: with a single
    32-bit seed per draw, a production-length chain of N draws replays a
    full per-step noise stream with probability ~ N^2/2^33 (birthday
    collisions at N ~ 1e5); the pair collides at ~ N^2/2^65.

    ``step`` (optional, may be a dynamic uint32) folds a per-step index
    into the site lane so a multi-step fused kernel draws an independent
    stream per step from ONE (seed, seed2) pair — used by the chained
    sweeps (schwinger_sweep_chain)."""

    def __init__(self, seed_u32, site_id, chain_id, seed2_u32=None,
                 step=None):
        base_s = fmix32(site_id * jnp.uint32(0x9E3779B9) ^ seed_u32)
        if step is not None:
            base_s = fmix32(base_s + jnp.uint32(step)
                            * jnp.uint32(0x165667B1))
        base_c = chain_id * jnp.uint32(0x85EBCA77)
        if seed2_u32 is not None:
            base_c = base_c ^ seed2_u32
        self.base_s = base_s
        self.base_c = fmix32(base_c)
        self.ctr = 0

    def bits(self):
        self.ctr += 1
        c = jnp.uint32(self.ctr)
        return fmix32(fmix32(self.base_s + c * jnp.uint32(0xC2B2AE3D))
                      + fmix32(self.base_c + c * jnp.uint32(0x27D4EB2F)))

    def rounds(self, n_rounds, words, body, init):
        """``n_rounds`` rejection rounds as one ``fori_loop``:
        ``body(rng_k, carry) -> carry`` draws ``words`` numbers per round
        from an rng positioned where the unrolled loop would be, so the
        stream is the unrolled loop's while the program stays one round
        long (compile time independent of the round count)."""
        c0 = self.ctr

        def step(k, carry):
            r = copy.copy(self)
            r.ctr = c0 + words * k
            return body(r, carry)

        out = jax.lax.fori_loop(0, n_rounds, step, init)
        self.ctr = c0 + words * n_rounds
        return out

    def uniform(self, dtype):
        """(0, 1] uniforms: the top 23 bits as the mantissa of a float in
        [1, 2), mapped to (0, 1]."""
        fbits = (self.bits() >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
        f = jax.lax.bitcast_convert_type(fbits, jnp.float32)   # [1, 2)
        return (jnp.float32(2.0) - f).astype(dtype)            # (0, 1]

    def normal(self, dtype):
        """Standard normals via Box-Muller."""
        u1 = self.uniform(dtype)
        u2 = self.uniform(dtype)
        return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(TWO_PI * u2)


MAX_SITES = 1 << 31      # per-lane ids: full uint32 minus a safety bit
MAX_CHAINS = 1 << 31


def check_element_capacity(n_sites: int, n_chains: int) -> None:
    """Reject configurations whose per-lane ids would wrap uint32 —
    a silent wrap would hand identical noise streams to distinct sites."""
    if n_sites > MAX_SITES or n_chains > MAX_CHAINS:
        raise ValueError(
            f"counter RNG supports up to {MAX_SITES} sites and "
            f"{MAX_CHAINS} chains per launch (got {n_sites} sites, "
            f"{n_chains} chains); larger lattices need a wider id scheme")


def element_ids(shape, chain_offset=0, chain_axis=-1):
    """(site_id, chain_id) uint32 arrays of ``shape`` where ``chain_axis``
    indexes the chains.  site_id enumerates the non-chain axes in
    row-major order; chain_id is the global chain index, the local index
    plus ``chain_offset`` (the first local chain's id under sharding)."""
    ndim = len(shape)
    chain_axis = chain_axis % ndim
    site = jnp.zeros(shape, jnp.uint32)
    for ax in range(ndim):
        if ax == chain_axis:
            continue
        site = site * jnp.uint32(shape[ax]) \
            + jax.lax.broadcasted_iota(jnp.uint32, shape, ax)
    chain = (jax.lax.broadcasted_iota(jnp.uint32, shape, chain_axis)
             + jnp.asarray(chain_offset).astype(jnp.uint32))
    return site, chain
