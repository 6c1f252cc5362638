"""Vectorised 1-D Wolff cluster update vs the sequential walk spec.

The masked-run update (samplers/cluster.py::_vector_cluster_update) must
sample the same distribution as the bidirectional walk transcription of
clustersampler.cc:92-132.  Checks: chi_t oracle agreement for both, and
cross-sampler agreement of mean/variance of the susceptibility.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models.rotor import RotorAction
from mlmcpathintegral.qoi import qoi_susceptibility
from mlmcpathintegral.samplers.cluster import ClusterSampler


def _run(vectorised: bool, seed: int, M=16, C=512, steps=300):
    lat = Lattice1D(M_lat=M, T_final=4.0)
    act = RotorAction(lat, m0=0.25)
    s = ClusterSampler(act, n_burnin=100, n_updates=5,
                       vectorised=vectorised)
    qoi = qoi_susceptibility(act)
    state = s.prepare(jax.random.PRNGKey(seed), C, jnp.float64)

    @jax.jit
    def chunk(key, state):
        def body(carry, k):
            st, acc = carry
            st, _ = s.draw(k, st)
            return (st, acc + qoi(st.x)), None
        keys = jax.random.split(key, steps)
        (state, acc), _ = jax.lax.scan(body, (state, jnp.zeros(C)), keys)
        return state, acc / steps

    _, q = chunk(jax.random.PRNGKey(seed + 1000), state)
    return np.asarray(q), act.chit_exact()


def test_vectorised_matches_oracle():
    q, oracle = _run(vectorised=True, seed=0)
    err = q.std(ddof=1) / np.sqrt(q.size)
    assert abs(q.mean() - oracle) < 4 * err
    assert err < 0.05 * oracle


def test_walk_and_vectorised_agree():
    qv, oracle = _run(vectorised=True, seed=1)
    qw, _ = _run(vectorised=False, seed=2)
    ev = qv.std(ddof=1) / np.sqrt(qv.size)
    ew = qw.std(ddof=1) / np.sqrt(qw.size)
    assert abs(qv.mean() - qw.mean()) < 4 * np.hypot(ev, ew)
    # second moment agreement (distribution, not just mean)
    v_v, v_w = (qv ** 2).mean(), (qw ** 2).mean()
    e2 = np.hypot((qv ** 2).std(ddof=1), (qw ** 2).std(ddof=1)) \
        / np.sqrt(qv.size)
    assert abs(v_v - v_w) < 4 * e2


def _exact_outcome_dist(s_orig, i0, M):
    """Exact distribution over flip-masks of one 1-D cluster update with
    fixed reflection/seed, enumerated from the walk semantics of
    clustersampler.cc:92-132.

    ``s_orig[b]`` is S_ell of the ORIGINAL configuration on bond
    (b, b+1); each flipped endpoint flips its sign, so a link with one
    flipped endpoint opens w.p. p_one = 1-exp(min(0, s)) and one with
    two flipped endpoints w.p. p_two = 1-exp(min(0, -s)).
    """
    p_one = 1.0 - np.exp(np.minimum(0.0, s_orig))
    p_two = 1.0 - np.exp(np.minimum(0.0, -s_orig))
    out = {}

    def o_f(k):  # forward open prob at walk order k (bond i0+k)
        b = (i0 + k) % M
        return p_two[b] if k == M - 1 else p_one[b]

    for F in range(M + 1):
        pF = 1.0
        for k in range(min(F, M)):
            pF *= o_f(k)
        if F < M:
            pF *= 1.0 - o_f(F)
        if pF == 0.0:
            continue
        B_lim = 1 if F == M else M - F

        def o_b(k):  # backward open prob at walk order k (bond i0-k-1)
            b = (i0 - k - 1) % M
            return p_two[b] if (F < M and k == B_lim - 1) else p_one[b]

        for B in range(B_lim + 1):
            pB = 1.0
            for k in range(min(B, B_lim)):
                pB *= o_b(k)
            if B < B_lim:
                pB *= 1.0 - o_b(B)
            if pB == 0.0:
                continue
            cnt = np.zeros(M, np.int64)
            cnt[i0] += 1                        # seed flip
            for r in range(1, min(F, M - 1) + 1):
                cnt[(i0 + r) % M] += 1          # forward flips
            if F == M:
                cnt[i0] += 1                    # full fwd wrap re-flip
            for rb in range(1, B + 1):
                cnt[(i0 - rb) % M] += 1         # backward flips (rb==M
            mask = tuple(cnt % 2)               # re-flips the seed)
            out[mask] = out.get(mask, 0.0) + pF * pB
    return out


@pytest.mark.parametrize("M,i0,seed", [(3, 0, 0), (3, 2, 1),
                                       (4, 1, 2), (4, 3, 3)])
def test_cluster_cores_match_exact_enumeration(M, i0, seed):
    """Both the sequential walk and the vectorised masked-run update must
    reproduce the exact per-outcome probabilities — including the
    full-backward-wrap seed re-flip (F=0, B=M) that the vectorised path
    missed before round 4."""
    lat = Lattice1D(M_lat=M, T_final=float(M))
    act = RotorAction(lat, m0=1.3)
    rng = np.random.default_rng(seed)
    xbar = float(rng.uniform(-np.pi, np.pi))
    # keep every site away from the flip fixed points xbar + pi/2 mod pi
    x_row = xbar + np.pi / 2 + 0.3 + 0.5 * rng.uniform(0.2, 1.0, M)
    x_row = np.angle(np.exp(1j * x_row))
    flip_row = np.asarray(act.flip(jnp.asarray(x_row), xbar))
    assert np.min(np.abs(np.angle(np.exp(1j * (flip_row - x_row))))) > 0.05

    s_orig = np.asarray(act.S_ell(jnp.asarray(x_row),
                                  jnp.roll(jnp.asarray(x_row), -1), xbar))
    exact = _exact_outcome_dist(s_orig, i0, M)
    assert abs(sum(exact.values()) - 1.0) < 1e-12

    C = 120_000
    x = jnp.tile(jnp.asarray(x_row)[None, :], (C, 1))
    xb = jnp.full((C,), xbar)
    i0v = jnp.full((C,), i0, jnp.int32)

    def empirical(core, key):
        final = np.asarray(core(key, x, xb, i0v))
        d_orig = np.abs(np.angle(np.exp(1j * (final - x_row[None, :]))))
        d_flip = np.abs(np.angle(np.exp(1j * (final - flip_row[None, :]))))
        masks = (d_flip < d_orig).astype(np.int64)
        vals, counts = np.unique(masks, axis=0, return_counts=True)
        return {tuple(v): c / C for v, c in zip(vals, counts)}

    s = ClusterSampler(act)
    for name, core, key in [
            ("walk", s._walk_core, jax.random.PRNGKey(100 + seed)),
            ("vector", s._vector_core, jax.random.PRNGKey(200 + seed))]:
        emp = empirical(core, key)
        keys = set(exact) | set(emp)
        tv = 0.5 * sum(abs(exact.get(k, 0.0) - emp.get(k, 0.0))
                       for k in keys)
        # TV of a multinomial with ~2^M cells at C=120k is ~0.004
        assert tv < 0.012, (name, tv, sorted(
            (k, exact.get(k, 0.0), emp.get(k, 0.0)) for k in keys))


class _StubClusterAction:
    """Synthetic cluster action making the full-backward-wrap path
    reachable.  For the rotor, S_ell = -2K cos(x_i-xbar)cos(x_j-xbar)
    factorises over sites, so the ring always has an EVEN number of
    positive bonds and the 'exactly one open-under-p_two bond' wrap
    configurations have probability zero.  Here sites carry x = +-m_b
    (distinct magnitudes m encode the site, the sign its flip parity)
    and S_ell = s0(|x_i|,|x_j|) sign(x_i) sign(x_j) with s0 chosen to
    make exactly ONE bond positive — the flip-odd + symmetric structure
    the vectorised core assumes, without the rotor's parity constraint.
    """

    def __init__(self, scale=0.7, thresh=3.0):
        self.scale = scale
        self.thresh = thresh

    def S_ell(self, x_i, x_j, xbar):
        s0 = self.scale * (self.thresh - jnp.abs(x_i) * jnp.abs(x_j))
        return s0 * jnp.sign(x_i) * jnp.sign(x_j)

    @staticmethod
    def flip(x, xbar):
        return -x

    @staticmethod
    def new_reflection(key, n_chains, dtype=None):
        return jnp.zeros((n_chains,), dtype or jnp.float32)


def test_cluster_full_backward_wrap_exact():
    """Regression for ADVICE r3 (medium): with the first forward bond
    closed (F=0) the backward walk may wrap the whole ring and re-test
    bond (i0, i0+1) doubly-flipped, re-flipping the seed
    (clustersampler.cc:108-113).  The pre-round-4 vectorised core
    omitted that link entirely; this stub makes the path ~17% likely."""
    M, i0 = 4, 0
    mags = np.array([1.0, 2.0, 3.0, 5.0])
    act = _StubClusterAction()
    s_orig = np.asarray(act.S_ell(jnp.asarray(mags),
                                  jnp.roll(jnp.asarray(mags), -1), 0.0))
    # exactly one positive bond, at the seed: forward stops immediately
    assert s_orig[i0] > 0 and np.all(s_orig[1:] < 0)
    exact = _exact_outcome_dist(s_orig, i0, M)
    assert abs(sum(exact.values()) - 1.0) < 1e-12
    # the wrap outcome (everything flipped except the re-flipped seed)
    wrap_mask = tuple(int(j != i0) for j in range(M))
    assert exact.get(wrap_mask, 0.0) > 0.05

    C = 150_000
    x = jnp.tile(jnp.asarray(mags)[None, :], (C, 1))
    xb = jnp.zeros((C,))
    i0v = jnp.full((C,), i0, jnp.int32)
    s = ClusterSampler(act)
    for name, core, key in [
            ("walk", s._walk_core, jax.random.PRNGKey(11)),
            ("vector", s._vector_core, jax.random.PRNGKey(22))]:
        final = np.asarray(core(key, x, xb, i0v))
        masks = (final < 0).astype(np.int64)
        vals, counts = np.unique(masks, axis=0, return_counts=True)
        emp = {tuple(v): c / C for v, c in zip(vals, counts)}
        keys = set(exact) | set(emp)
        tv = 0.5 * sum(abs(exact.get(k, 0.0) - emp.get(k, 0.0))
                       for k in keys)
        assert tv < 0.012, (name, tv, sorted(
            (k, exact.get(k, 0.0), emp.get(k, 0.0)) for k in keys))
        assert abs(emp.get(wrap_mask, 0.0) - exact[wrap_mask]) < 0.01, name


@pytest.mark.parametrize("m0", [0.25, 1.0])
def test_vectorised_larger_lattice(m0):
    lat = Lattice1D(M_lat=64, T_final=4.0)
    act = RotorAction(lat, m0=m0)
    s = ClusterSampler(act, n_burnin=100, n_updates=10, vectorised=True)
    qoi = qoi_susceptibility(act)
    C = 256
    state = s.prepare(jax.random.PRNGKey(3), C, jnp.float64)

    @jax.jit
    def chunk(key, state):
        def body(carry, k):
            st, acc = carry
            st, _ = s.draw(k, st)
            return (st, acc + qoi(st.x)), None
        keys = jax.random.split(key, 200)
        (state, acc), _ = jax.lax.scan(body, (state, jnp.zeros(C)), keys)
        return state, acc / 200

    _, q = chunk(jax.random.PRNGKey(4), state)
    q = np.asarray(q)
    err = q.std(ddof=1) / np.sqrt(q.size)
    assert abs(q.mean() - act.chit_exact()) < 4 * err
