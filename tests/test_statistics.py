"""Statistics accumulator tests.

Validates the batched on-device accumulator against a pure-python replica of
the reference algorithm (src/common/statistics.cc:4-27, 82-98) and against
known properties of iid / AR(1) streams.
"""

import math
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


class ReferenceStatistics:
    """Direct transcription of the reference's single-chain algorithm
    (statistics.cc) used as a golden model."""

    def __init__(self, k_max):
        self.k_max = k_max
        self.reset()

    def reset(self):
        self.n = 0
        self.n_lt = 0
        self.avg = 0.0
        self.avg_lt = 0.0
        self.avg2_lt = 0.0
        self.avg3_lt = 0.0
        self.avg4_lt = 0.0
        self.Q_k = deque()
        self.S_k = [0.0] * self.k_max

    def record(self, Q):
        self.n += 1
        self.n_lt += 1
        self.Q_k.appendleft(Q)
        if len(self.Q_k) > self.k_max:
            self.Q_k.pop()
        self.avg = ((self.n - 1) * self.avg + Q) / self.n
        self.avg_lt = ((self.n_lt - 1) * self.avg_lt + Q) / self.n_lt
        self.avg2_lt = ((self.n_lt - 1) * self.avg2_lt + Q * Q) / self.n_lt
        self.avg3_lt = ((self.n_lt - 1) * self.avg3_lt + Q**3) / self.n_lt
        self.avg4_lt = ((self.n_lt - 1) * self.avg4_lt + Q**4) / self.n_lt
        for k in range(len(self.Q_k)):
            N_k = self.n_lt - k
            self.S_k[k] = ((N_k - 1) * self.S_k[k]
                           + self.Q_k[0] * self.Q_k[k]) / N_k

    def tau_int(self):
        C_k = [s - self.avg_lt**2 for s in self.S_k]
        t = sum((1.0 - k / self.n_lt) * C_k[k]
                for k in range(1, len(C_k)))
        return max(1.0, 1.0 + 2.0 * t / C_k[0])

    def variance(self):
        return self.n_lt / (self.n_lt - 1.0) * (self.S_k[0] - self.avg_lt**2)


def test_single_chain_matches_reference_model():
    rng = np.random.default_rng(0)
    samples = rng.normal(size=300) + 0.7 * np.sin(np.arange(300) * 0.1)
    k_max = 10

    ref = ReferenceStatistics(k_max)
    stats = Statistics("Q", k_max)
    st = stats.init(n_chains=1, dtype=jnp.float64)
    for q in samples:
        ref.record(q)
        st = stats_mod.record(st, jnp.asarray([q], jnp.float64))

    assert stats.average(st) == pytest.approx(ref.avg, rel=1e-12)
    assert stats.variance(st) == pytest.approx(ref.variance(), rel=1e-10)
    assert stats.tau_int(st) == pytest.approx(ref.tau_int(), rel=1e-8)


def test_iid_stream_tau_int_near_one():
    rng = np.random.default_rng(1)
    T, C = 2000, 16
    Qs = jnp.asarray(rng.normal(size=(T, C)))
    stats = Statistics("Q", 20)
    st = stats.init(C, jnp.float64)
    st = stats_mod.record_many(st, Qs)
    assert stats.average(st) == pytest.approx(0.0, abs=0.02)
    assert stats.variance(st) == pytest.approx(1.0, rel=0.05)
    assert stats.tau_int(st) == pytest.approx(1.0, abs=0.1)


def test_ar1_stream_tau_int():
    # AR(1): x_t = rho x_{t-1} + e_t; tau_int = (1+rho)/(1-rho)
    rho = 0.6
    expect_tau = (1 + rho) / (1 - rho)   # = 4.0
    rng = np.random.default_rng(2)
    T, C = 20000, 32
    e = rng.normal(size=(T, C)) * math.sqrt(1 - rho * rho)
    x = np.zeros((T, C))
    x[0] = rng.normal(size=C)
    for t in range(1, T):
        x[t] = rho * x[t - 1] + e[t]
    stats = Statistics("Q", 50)
    st = stats.init(C, jnp.float64)
    st = stats_mod.record_many(st, jnp.asarray(x))
    assert stats.tau_int(st) == pytest.approx(expect_tau, rel=0.1)


def test_soft_reset_keeps_longterm():
    rng = np.random.default_rng(3)
    stats = Statistics("Q", 5)
    st = stats.init(4, jnp.float64)
    st = stats_mod.record_many(st, jnp.asarray(rng.normal(size=(50, 4))))
    tau_before = stats.tau_int(st)
    st = stats_mod.soft_reset(st)
    assert stats.local_samples(st) == 0
    # long-term accumulators survive -> tau_int still defined
    assert stats.tau_int(st) == pytest.approx(tau_before)


def test_record_masked_noop_when_disabled():
    stats = Statistics("Q", 5)
    st = stats.init(4, jnp.float64)
    st2 = stats_mod.record_masked(st, jnp.ones(4), jnp.asarray(False))
    assert stats.local_samples(st2) == 0
    st3 = stats_mod.record_masked(st, jnp.ones(4), jnp.asarray(True))
    assert stats.local_samples(st3) == 1


def _record_scan(state, Qs):
    def body(s, q):
        return stats_mod.record(s, q), None
    state, _ = jax.lax.scan(body, state, Qs)
    return state


@pytest.mark.parametrize("T,k_max", [(7, 5), (64, 40), (3, 8), (40, 40)])
def test_record_block_matches_sequential(T, k_max):
    """record_block == T sequential record() calls, including the
    partial-history start-up regime (T < k_max, T == k_max, T > k_max)
    and a second block continuing from real ring history."""
    rng = np.random.default_rng(7)
    C = 16
    Qs1 = jnp.asarray(rng.normal(size=(T, C)))
    Qs2 = jnp.asarray(rng.normal(size=(T, C)))
    st_a = stats_mod.init(C, k_max, jnp.float64)
    st_b = stats_mod.init(C, k_max, jnp.float64)
    for Qs in (Qs1, Qs2):
        st_a = _record_scan(st_a, Qs)
        st_b = stats_mod.record_block(st_b, Qs)
    for name, a, b in zip(st_a._fields, st_a, st_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("n_valid", [0, 1, 5, 11, 16])
def test_record_block_prefix_matches_masked_scan(n_valid):
    """record_block(n_valid=v) == per-step record_masked(i < v)."""
    rng = np.random.default_rng(8)
    T, C, k_max = 16, 8, 10
    warm = jnp.asarray(rng.normal(size=(6, C)))
    Qs = jnp.asarray(rng.normal(size=(T, C)))
    st_a = _record_scan(stats_mod.init(C, k_max, jnp.float64), warm)
    st_b = stats_mod.record_block(stats_mod.init(C, k_max, jnp.float64),
                                  warm)

    def masked_scan(s):
        def body(s, inp):
            q, i = inp
            return stats_mod.record_masked(s, q, i < n_valid), None
        s, _ = jax.lax.scan(body, s, (Qs, jnp.arange(T)))
        return s

    st_a = masked_scan(st_a)
    st_b = stats_mod.record_block(st_b, Qs, n_valid=jnp.asarray(n_valid))
    for name, a, b in zip(st_a._fields, st_a, st_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_record_block_traced_n_valid_jit():
    """n_valid may be a traced scalar inside jit (the chunk drivers pass
    the live n_active)."""
    rng = np.random.default_rng(9)
    T, C, k_max = 12, 4, 6
    Qs = jnp.asarray(rng.normal(size=(T, C)), jnp.float32)

    @jax.jit
    def step(st, nv):
        return stats_mod.record_block(st, Qs, n_valid=nv)

    st = step(stats_mod.init(C, k_max), jnp.asarray(7, jnp.int32))
    assert stats_mod.Statistics("Q", k_max).samples(st) == 7 * C
