"""Batched on-device statistics: mean, variance, autocorrelation, tau_int.

The reference keeps one scalar ``Statistics`` object per quantity and makes
every getter an MPI collective so N ranks behave like one long chain
(src/common/statistics.{hh,cc}).  Here the accumulator is *batched over
chains*: each of the ``n_chains`` independent chains carries its own running
moments, a ring buffer of its last ``k_max`` samples and running lagged
products S_k (statistics.cc:4-27).  Getters aggregate across chains exactly
the way the reference aggregates across ranks (uniform average of per-rank
accumulators, sum of sample counts; statistics.cc:31-98), so results are
directly comparable.  When chains are sharded over a device mesh the chain
axis just becomes a global axis; getters pull the (small) state to host.

Semantics matched to the reference:
  * record: running avg, long-term moments E[Q..Q^4], windowed
    S_k = (1/N_k) sum_i Q_i Q_{i-k} with N_k = n_longterm - k
  * soft reset clears {n, avg} only; long-term moments survive burn-in
    so tau_int can be learned during warm-up (statistics.hh:128-147)
  * tau_int = max(1, 1 + 2 sum_{k>=1} (1 - k/N) C_k / C_0) with
    C_k = <S_k> - <Q>^2 (statistics.cc:82-98)
  * error(avg) = sqrt(tau_int * Var / N), variance error via 4th moments
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class StatsState(NamedTuple):
    """Pure accumulator pytree; shapes: scalar counters, [C] moments,
    [C, k_max] window buffers."""
    n: jnp.ndarray          # per-chain sample count since last (soft) reset
    avg: jnp.ndarray        # [C] running average since last reset
    n_lt: jnp.ndarray       # per-chain long-term sample count
    avg_lt: jnp.ndarray     # [C] long-term running E[Q]
    avg2_lt: jnp.ndarray    # [C] long-term running E[Q^2]
    avg3_lt: jnp.ndarray    # [C] long-term running E[Q^3]
    avg4_lt: jnp.ndarray    # [C] long-term running E[Q^4]
    ring: jnp.ndarray       # [C, k_max]; ring[:, k] = Q_{t-k}
    S_k: jnp.ndarray        # [C, k_max] running lagged products


def init(n_chains: int, k_max: int, dtype=jnp.float32) -> StatsState:
    # each field gets its OWN buffer: a shared zeros array would alias
    # leaves of the MC chunk carries, breaking their donate_argnums
    # ("attempt to donate the same buffer twice")
    def z():
        return jnp.zeros((n_chains,), dtype)

    def zk():
        return jnp.zeros((n_chains, k_max), dtype)

    def c0():
        return jnp.zeros((), jnp.int32)

    return StatsState(c0(), z(), c0(), z(), z(), z(), z(), zk(), zk())


def record(state: StatsState, Q: jnp.ndarray) -> StatsState:
    """Record one new sample per chain. Q: [C]. Pure function, jit/scan safe."""
    Q = Q.astype(state.avg.dtype)
    n = state.n + 1
    n_lt = state.n_lt + 1
    nf = n.astype(Q.dtype)
    nltf = n_lt.astype(Q.dtype)
    avg = ((nf - 1.0) * state.avg + Q) / nf
    avg_lt = ((nltf - 1.0) * state.avg_lt + Q) / nltf
    Q2 = Q * Q
    avg2_lt = ((nltf - 1.0) * state.avg2_lt + Q2) / nltf
    avg3_lt = ((nltf - 1.0) * state.avg3_lt + Q2 * Q) / nltf
    avg4_lt = ((nltf - 1.0) * state.avg4_lt + Q2 * Q2) / nltf
    # shift ring buffer: newest at index 0
    ring = jnp.concatenate([Q[:, None], state.ring[:, :-1]], axis=1)
    k_max = state.ring.shape[1]
    k = jnp.arange(k_max)
    # N_k = n_lt - k; lag-k product only valid once k samples exist
    N_k = (nltf - k.astype(Q.dtype))[None, :]
    valid = (k[None, :] < n_lt).astype(Q.dtype)
    prod = Q[:, None] * ring
    S_k_new = ((N_k - 1.0) * state.S_k + prod) / jnp.maximum(N_k, 1.0)
    S_k = valid * S_k_new + (1.0 - valid) * state.S_k
    return StatsState(n, avg, n_lt, avg_lt, avg2_lt, avg3_lt, avg4_lt,
                      ring, S_k)


def record_masked(state: StatsState, Q: jnp.ndarray, enabled) -> StatsState:
    """Record one sample per chain only when ``enabled`` (scalar bool).
    Used by the MC drivers to hit exact sample targets inside fixed-size
    jitted chunks."""
    new = record(state, Q)
    return jax.tree.map(lambda a, b: jnp.where(enabled, a, b), new, state)


def record_block(state: StatsState, Qs: jnp.ndarray,
                 n_valid=None) -> StatsState:
    """Record a [T, C] block of samples in CLOSED FORM — no sequential scan.

    Mathematically equal (up to float reassociation; the block form does
    fewer divisions, so it is if anything *more* accurate) to T calls of
    :func:`record`.  The running moments are updated from block sums, the
    ring buffer by one gather, and the windowed lagged products S_k by
    k_max lagged dot products of the block against (ring history ++
    block) — O(T*k_max) fully-parallel work instead of a T-step scan
    that rewrites the whole [C, k_max] window per step.  On the MC hot
    paths the scan was the dominant HBM traffic for cheap screens
    (T=256, k_max=40, C=4096: ~2 x 1.3 MB x T x stats per chunk,
    strictly sequential).

    ``n_valid`` (traced int32 scalar, or None for the full block) records
    only the leading ``n_valid`` samples — the block analog of
    :func:`record_masked` for the prefix masks the MC chunk drivers use
    (``i < n_active``).
    """
    T = Qs.shape[0]
    dtype = state.avg.dtype
    Qb = Qs.astype(dtype).T                       # [C, T]
    k_max = state.ring.shape[1]
    if n_valid is None:
        v = jnp.asarray(T, jnp.int32)
        Qm = Qb
    else:
        v = jnp.clip(jnp.asarray(n_valid, jnp.int32), 0, T)
        Qm = Qb * (jnp.arange(T) < v)[None, :].astype(dtype)
    vf = v.astype(dtype)

    n_new = state.n + v
    n_lt_new = state.n_lt + v
    nf = jnp.maximum(n_new.astype(dtype), 1.0)
    nltf = jnp.maximum(n_lt_new.astype(dtype), 1.0)
    n_old_f = state.n.astype(dtype)
    nlt_old_f = state.n_lt.astype(dtype)

    Qm2 = Qm * Qm
    s1 = jnp.sum(Qm, axis=1)
    s2 = jnp.sum(Qm2, axis=1)
    s3 = jnp.sum(Qm2 * Qm, axis=1)
    s4 = jnp.sum(Qm2 * Qm2, axis=1)
    avg = (n_old_f * state.avg + s1) / nf
    avg_lt = (nlt_old_f * state.avg_lt + s1) / nltf
    avg2_lt = (nlt_old_f * state.avg2_lt + s2) / nltf
    avg3_lt = (nlt_old_f * state.avg3_lt + s3) / nltf
    avg4_lt = (nlt_old_f * state.avg4_lt + s4) / nltf

    # ext[:, p] holds global sample index n_lt_old - k_max + p: the ring
    # (oldest first) then the block.  Slots before any recorded history
    # are zeros (ring is zero-initialised and only ever shifted), so
    # lagged products against them vanish and the pair-count arithmetic
    # below excludes them from the normalisation.
    ext = jnp.concatenate([state.ring[:, ::-1], Qb], axis=1)
    k = jnp.arange(k_max)
    # new ring, newest first: the last k_max entries of the valid prefix
    ring = jnp.take(ext, k_max + v - 1 - k, axis=1)

    # lagged pair sums over the new valid pairs of each lag
    P = jnp.stack(
        [jnp.sum(Qm * jax.lax.dynamic_slice_in_dim(ext, k_max - lag, T, 1),
                 axis=1)
         for lag in range(k_max)], axis=1)        # [C, k_max]
    kf = k.astype(dtype)[None, :]
    N_old = jnp.maximum(nlt_old_f - kf, 0.0)
    N_new = jnp.maximum(nlt_old_f + vf - kf, 0.0)
    S_k = jnp.where(N_new > 0.0,
                    (N_old * state.S_k + P) / jnp.maximum(N_new, 1.0),
                    state.S_k)
    return StatsState(n_new, avg, n_lt_new, avg_lt, avg2_lt, avg3_lt,
                      avg4_lt, ring, S_k)


def record_many(state: StatsState, Qs: jnp.ndarray) -> StatsState:
    """Record a [T, C] block of samples (closed-form block update)."""
    return record_block(state, Qs)


def tau_int_device(state: StatsState) -> jnp.ndarray:
    """Integrated autocorrelation time as a traced scalar (aggregated over
    the chain axis exactly like the host-side getter).  Enables fully
    on-device adaptive logic (e.g. the tau-based coarse subsampling loops of
    the two-level/multilevel methods, montecarlotwolevel.cc:82-94)."""
    avg = jnp.mean(state.avg_lt)
    C_k = jnp.mean(state.S_k, axis=0) - avg * avg
    n = (state.n_lt * state.ring.shape[0]).astype(C_k.dtype)
    k = jnp.arange(1, C_k.shape[0], dtype=C_k.dtype)
    tau = jnp.sum((1.0 - k / jnp.maximum(n, 1.0)) * C_k[1:])
    good = jnp.logical_and(state.n_lt >= 2, C_k[0] > 0.0)
    return jnp.where(good, jnp.maximum(1.0, 1.0 + 2.0 * tau
                                       / jnp.where(good, C_k[0], 1.0)), 1.0)


def variance_device(state: StatsState) -> jnp.ndarray:
    """Cross-chain sample variance as a traced scalar (statistics.cc:30-35)."""
    avg = jnp.mean(state.avg_lt)
    avg2 = jnp.mean(state.S_k[:, 0])
    n = (state.n_lt * state.ring.shape[0]).astype(avg.dtype)
    return jnp.where(state.n_lt >= 2,
                     n / jnp.maximum(n - 1.0, 1.0) * (avg2 - avg * avg), 0.0)


@jax.jit
def _device_summary(state: StatsState):
    """All scalar estimators of one accumulator, reduced ON DEVICE.

    Every device->host transfer costs a round trip; pulling the full
    [C, k_max] accumulator per getter made the MC adaptive loops
    orchestration-bound.  One
    jitted reduction returning two tiny vectors replaces ~9 transfers
    per getter call.

    Returns (floats[5] = [avg, variance, variance_error, tau_int,
    window_capped], ints[2] = [n, n_lt]); formulas exactly as the
    host getters / statistics.cc:30-98.
    """
    C = state.ring.shape[0]
    k_max = state.ring.shape[1]
    avg = jnp.mean(state.avg)
    a1 = jnp.mean(state.avg_lt)
    a2 = jnp.mean(state.avg2_lt)
    a3 = jnp.mean(state.avg3_lt)
    a4 = jnp.mean(state.avg4_lt)
    C_k = jnp.mean(state.S_k, axis=0) - a1 * a1
    nf = state.n_lt.astype(C_k.dtype) * float(C)
    # variance (statistics.cc:30-35); S_k[:,0] is the running E[Q^2]
    avg2w = jnp.mean(state.S_k[:, 0])
    # gates use the TOTAL count nf = n_lt * C, matching the host getters
    # they replace
    var = jnp.where(nf >= 2.0,
                    nf / jnp.maximum(nf - 1.0, 1.0) * (avg2w - a1 * a1),
                    0.0)
    # variance error via 4th moments
    ve = (a4 - 4.0 * a1 * a3 + 8.0 * a1 * a1 * a2 - a2 * a2
          - 4.0 * a1 ** 4) / jnp.maximum(nf, 1.0)
    var_err = jnp.where(nf >= 1.0, jnp.sqrt(jnp.maximum(ve, 0.0)),
                        0.0)
    # tau_int = max(1, 1 + 2 sum (1 - k/N) C_k/C_0) (statistics.cc:82-98)
    k = jnp.arange(1, k_max, dtype=C_k.dtype)
    tsum = jnp.sum((1.0 - k / jnp.maximum(nf, 1.0)) * C_k[1:])
    good = jnp.logical_and(state.n_lt >= 2, C_k[0] > 0.0)
    tau = jnp.where(
        good, jnp.maximum(1.0, 1.0 + 2.0 * tsum
                          / jnp.where(good, C_k[0], 1.0)), 1.0)
    capped = jnp.logical_and(state.n_lt > k_max + 2,
                             jnp.logical_and(C_k[0] > 0.0,
                                             C_k[-1] > 0.1 * C_k[0]))
    floats = jnp.stack([avg, var, var_err, tau, capped.astype(C_k.dtype)])
    ints = jnp.stack([state.n, state.n_lt])
    return floats, ints


def tau_binning(series) -> float:
    """Binning estimate of tau_int from a scalar time series:
    tau ~= (plateau error / naive error)^2 over doubling bin sizes
    (native/statistics_engine.cc mlmc_stats_binning).  Used as a
    cross-check when the windowed tau_int is capped by k_max and hence
    only a lower bound.  For iid
    chains the normalised autocorrelation of the cross-chain mean equals
    the per-chain one, so the series may be cross-chain means."""
    from mlmcpathintegral.utils.native import binning_analysis
    series = np.asarray(series, np.float64).ravel()
    if series.size < 64:
        return 1.0
    n_levels = max(2, int(math.log2(series.size)) - 3)
    errs = binning_analysis(series, n_levels=min(n_levels, 16))
    if errs[0] <= 0.0:
        return 1.0
    return float(max(1.0, (errs.max() / errs[0]) ** 2))


def soft_reset(state: StatsState) -> StatsState:
    return state._replace(n=jnp.zeros_like(state.n),
                          avg=jnp.zeros_like(state.avg))


def hard_reset(state: StatsState) -> StatsState:
    """Full reset: clears the long-term moments and the autocorrelation
    window as well (statistics.hh:128-147 ``hard_reset``), unlike
    :func:`soft_reset` which keeps them so tau_int survives burn-in."""
    return jax.tree.map(jnp.zeros_like, state)


class Statistics:
    """Host-side view over a StatsState: reference-compatible estimators.

    All getters aggregate over the chain axis (the analog of the reference's
    allreduce over MPI ranks).
    """

    def __init__(self, label: str, k_max: int):
        self.label = label
        self.k_max = k_max
        self._warned_capped = False
        self._host_cache = (None, None)   # (device state, host copy)

    def init(self, n_chains: int, dtype=jnp.float32) -> StatsState:
        return init(n_chains, self.k_max, dtype)

    # -- estimators (host side; state may live on device, pulled once) -----

    def _np(self, state: StatsState):
        """Host copy of the accumulator, memoized on state identity: the
        MC adaptive loops call several getters on the same immutable
        state, and each device->host leaf transfer costs a round trip —
        one pull per state, not per getter."""
        cached_dev, cached_host = self._host_cache
        if cached_dev is state:
            return cached_host
        host = StatsState(*jax.device_get(tuple(state)))
        self._host_cache = (state, host)
        return host

    def _scalars(self, state):
        """Device-reduced scalar estimators, memoized on state identity
        (see _device_summary).  One dispatch + one small transfer per
        distinct state instead of one full-accumulator pull per getter."""
        cached_dev, cached = getattr(self, "_scalar_cache", (None, None))
        if cached_dev is state:
            return cached
        f, i = jax.device_get(_device_summary(state))
        out = (np.asarray(f, np.float64), np.asarray(i, np.int64))
        self._scalar_cache = (state, out)
        return out

    def samples(self, state) -> int:
        f, i = self._scalars(state)
        return int(i[0]) * state.avg.shape[0]

    def local_samples(self, state) -> int:
        return int(np.asarray(state.n))

    def average(self, state) -> float:
        return float(self._scalars(state)[0][0])

    def variance(self, state) -> float:
        return float(self._scalars(state)[0][1])

    def variance_error(self, state) -> float:
        return float(self._scalars(state)[0][2])

    def auto_corr(self, state) -> np.ndarray:
        s = self._np(state)
        avg = np.mean(s.avg_lt)
        return np.mean(s.S_k, axis=0) - avg * avg

    def tau_int(self, state) -> float:
        f, _ = self._scalars(state)
        if f[4] > 0.0 and not self._warned_capped:
            self._warned_capped = True
            import warnings
            warnings.warn(
                f"Statistics[{self.label}]: autocorrelation has not "
                f"decayed within the k_max={self.k_max} window — tau_int "
                f"is a lower bound; widen n_autocorr_window or cross-check "
                f"with utils.native.binning_analysis", stacklevel=2)
        return float(f[3])

    def window_capped(self, state, threshold: float = 0.1) -> bool:
        """True when the normalised autocorrelation at the window edge is
        still above ``threshold`` — the windowed tau_int is then only a
        lower bound."""
        if threshold != 0.1:
            s = self._np(state)
            if int(s.n_lt) <= self.k_max + 2:
                return False
            C_k = self.auto_corr(state)
            return bool(C_k[0] > 0.0 and C_k[-1] > threshold * C_k[0])
        return bool(self._scalars(state)[0][4] > 0.0)

    def error(self, state) -> float:
        n = self.samples(state)
        if n == 0:
            return float("inf")
        return float(math.sqrt(self.tau_int(state)
                               * max(self.variance(state), 0.0) / n))

    def summary(self, state) -> str:
        return (f" {self.label}: Avg +/- Err = {self.average(state):.6f}"
                f" +/- {self.error(state):.6f}\n"
                f" {self.label}: Var +/- Err = {self.variance(state):.6f}"
                f" +/- {self.variance_error(state):.6f}\n"
                f" {self.label}: tau_{{int}}   = {self.tau_int(state):.3f}\n"
                f" {self.label}: window      = {self.k_max}\n"
                f" {self.label}: # samples   = {self.samples(state)}")
