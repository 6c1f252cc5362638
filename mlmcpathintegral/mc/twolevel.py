"""Two-level Monte Carlo: mean/variance of Y = Q_fine - Q_coarse.

Reference parity: src/montecarlo/montecarlotwolevel.{hh,cc} — the screening
diagnostic for the two-level method.  Each sample: subsample the coarse
sampler until ~2 tau_int draws have elapsed (capped at 100;
montecarlotwolevel.cc:82-94), then apply one TwoLevelMetropolisStep and
record Q_fine, Q_coarse and their difference.

The tau-dependent subsampling runs *on device* as a
``fori_loop`` whose traced trip count comes from the on-device tau_int of
the coarse-sampler statistics — the whole sampling pass is one jitted scan,
no host round-trips per sample.
"""

from __future__ import annotations

import functools
import math
import time

import jax
import jax.numpy as jnp

from mlmcpathintegral.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


def make_coarse_subsampler(coarse_sampler, qoi_coarse, t_max: int = 100):
    """Returns a jitted-safe function drawing one ~independent coarse sample:
    (key, coarse_state, stats_cs, t_accum) -> same, where t_accum
    accumulates (sum_t, n_indep) for the t_indep estimate.

    The subsampling clock records the sampler's ``subsample_observable``
    when it provides one, else the coarse QoI (the reference's rule,
    montecarlotwolevel.cc:82-94).  The override exists because the rule
    silently assumes the QoI is the chain's SLOWEST mode — true for
    heat-bath topology but false for cluster samplers, whose chi_t is
    the FASTEST mode; clocking those on chi_t left coarse proposals
    configuration-correlated and biased the screened chain by ~1%
    (measured at 6+ sigma, round 4)."""

    independent = getattr(coarse_sampler, "independent_draws", False)
    clock_obs = getattr(coarse_sampler, "subsample_observable", qoi_coarse)

    def draw_coarse_sample(key, cstate, stats_cs, t_accum):
        if independent:
            # exact sampler: draws are iid, one per sample suffices
            t = jnp.ones((), jnp.int32)
        else:
            two_tau = jnp.minimum(
                float(t_max),
                jnp.ceil(2.0 * stats_mod.tau_int_device(stats_cs)))
            t = two_tau.astype(jnp.int32)

        def body(i, carry):
            cstate, stats_cs, key = carry
            key, sub = jax.random.split(key)
            cstate, _ = coarse_sampler.draw(sub, cstate)
            stats_cs = stats_mod.record(
                stats_cs, clock_obs(coarse_sampler.x_of(cstate)))
            return (cstate, stats_cs, key)

        cstate, stats_cs, _ = jax.lax.fori_loop(
            0, t, body, (cstate, stats_cs, key))
        sum_t, n_indep = t_accum
        t_accum = (sum_t + t.astype(sum_t.dtype), n_indep + 1.0)
        return cstate, stats_cs, t_accum

    draw_coarse_sample.sampler = coarse_sampler
    return draw_coarse_sample


def make_batched_screen(fine_action, coarse_action, cond, qoi_fine,
                        qoi_coarse, *, slice_budget_bytes: int = 2 ** 28):
    """Batched delayed-acceptance screen (a batched redesign of the
    sequential per-step TwoLevelMetropolisStep loop).

    Because every fill-in is conditionally independent of the CURRENT
    fine state (ConditionedFineAction.independent_fill — prolongate +
    fill overwrite all dofs from coarse data + fresh noise), an entire
    chunk of proposals can be generated as ONE batched tensor program:
    prolongate, fill, both action evaluations and both QoIs run over a
    [S, C, ndof] proposal tensor (large fused device ops) instead of S
    sequential scan steps of small [C, ndof] ops.  Only the Metropolis
    accept/reject chain remains sequential — a scan over [C] scalars.

    The accept ratio (twolevelmetropolisstep.cc:35-89) needs
    S_c(restrict(theta_cur)); after any acceptance restrict(theta_cur)
    IS that proposal's coarse sample, so the carried scalar is updated
    from the batched S_c values and only the incoming state's value is
    computed explicitly.

    Returns screen(key, tl, xcs) -> (tl_new, qf_trace, qc_trace,
    accept_trace) with traces of shape [S, C].  Proposals are processed
    in static slices so the [S, C, ndof] tensor never exceeds
    ``slice_budget_bytes`` of HBM.
    """

    fill_with_logq = getattr(cond, "fill_with_logq", None)
    fill_with_logq_sf = getattr(cond, "fill_with_logq_sf", None)

    def screen_slice(key, tl, s_cc0, qf0, xcs, s_cc_pre=None):
        S = xcs.shape[0]
        k_fill, k_acc = jax.random.split(key)
        theta_prop = fine_action.prolongate(
            xcs, jnp.broadcast_to(tl.theta, (S,) + tl.theta.shape))
        if fill_with_logq_sf is not None:
            # combined fill + proposal log-density + fine action in one
            # stencil pass (bipartite edge identity — see
            # GFFConditionedFineAction.fill_with_logq_sf)
            theta_prop, S_q, S_f = fill_with_logq_sf(k_fill, theta_prop)
        elif fill_with_logq is not None:
            # combined fill + proposal log-density: for conditionally-
            # Gaussian fills S_q(filled) = 1/2 sum xi^2 in closed form,
            # saving a full stencil pass over the [S, C, ndof] proposals
            theta_prop, S_q = fill_with_logq(k_fill, theta_prop)
            S_f = fine_action.evaluate(theta_prop)    # [S, C]
        else:
            theta_prop = cond.fill_fine_points(k_fill, theta_prop)
            S_q = cond.evaluate(theta_prop)           # [S, C]
            S_f = fine_action.evaluate(theta_prop)    # [S, C]
        S_cc = (coarse_action.evaluate(xcs)           # [S, C]
                if s_cc_pre is None else s_cc_pre)
        qf = qoi_fine(theta_prop)                     # [S, C]
        u = jax.random.uniform(k_acc, S_f.shape, S_f.dtype)

        def body(carry, inp):
            s_f, s_q, s_cc, q_cur, idx_cur = carry
            Sf_t, Sq_t, Scc_t, qf_t, u_t, t = inp
            dS = (Sf_t - s_f) + (s_cc - Scc_t) + (s_q - Sq_t)
            acc = jnp.logical_or(dS < 0.0, u_t < jnp.exp(-dS))
            s_f = jnp.where(acc, Sf_t, s_f)
            s_q = jnp.where(acc, Sq_t, s_q)
            s_cc = jnp.where(acc, Scc_t, s_cc)
            q_cur = jnp.where(acc, qf_t, q_cur)
            idx_cur = jnp.where(acc, t, idx_cur)
            return (s_f, s_q, s_cc, q_cur, idx_cur), (q_cur, acc)

        init = (tl.S_fine, tl.S_cond, s_cc0, qf0,
                jnp.full(s_cc0.shape, -1, jnp.int32))
        (s_f, s_q, s_cc, q_cur, idx), (qf_cur, acc) = jax.lax.scan(
            body, init,
            (S_f, S_q, S_cc, qf, u, jnp.arange(S, dtype=jnp.int32)))
        # materialise the final fine state: the last accepted proposal,
        # else the incoming state (one gather, instead of carrying the
        # [C, ndof] field through the scan)
        any_acc = idx >= 0
        theta_fin = jnp.take_along_axis(
            theta_prop, jnp.maximum(idx, 0)[None, :, None], axis=0)[0]
        theta_fin = jnp.where(any_acc[:, None], theta_fin, tl.theta)
        tl_new = type(tl)(theta=theta_fin, S_fine=s_f, S_cond=s_q)
        return tl_new, s_cc, q_cur, qf_cur, acc

    def screen(key, tl, xcs, s_cc_pre=None):
        S, C = xcs.shape[0], xcs.shape[1]
        ndof = tl.theta.shape[-1]
        s_slice = max(1, min(S, slice_budget_bytes
                             // max(C * ndof * 4, 1)))
        while S % s_slice:
            s_slice -= 1          # largest divisor within the budget
        n_slices = S // s_slice
        s_cc0 = coarse_action.evaluate(fine_action.restrict(tl.theta))
        qf0 = qoi_fine(tl.theta)
        if n_slices == 1:
            tl, s_cc0, qf0, qf_c, acc = screen_slice(
                key, tl, s_cc0, qf0, xcs, s_cc_pre)
            qf_all, acc_all = qf_c, acc
        else:
            # scan over slices: ONE compiled slice body regardless of
            # n_slices (the Python loop unrolled 16-64 slice copies into
            # the trace at large lattices, blowing compile time — the
            # 128^2 rows were stuck at chunk_size 64 because of it)
            xs = xcs.reshape(n_slices, s_slice, C, xcs.shape[-1])
            pre = (jnp.zeros((n_slices, 0)) if s_cc_pre is None
                   else s_cc_pre.reshape(n_slices, s_slice, C))

            def body(carry, inp):
                tl, s_cc0, qf0 = carry
                k, xc_s, pre_s = inp
                tl, s_cc0, qf0, qf_c, acc = screen_slice(
                    k, tl, s_cc0, qf0, xc_s,
                    None if s_cc_pre is None else pre_s)
                return (tl, s_cc0, qf0), (qf_c, acc)

            keys = jax.random.split(key, n_slices)
            (tl, s_cc0, qf0), (qf_all, acc_all) = jax.lax.scan(
                body, (tl, s_cc0, qf0), (keys, xs, pre))
            qf_all = qf_all.reshape(S, C)
            acc_all = acc_all.reshape(S, C)
        qc = qoi_coarse(xcs)                          # [S, C]
        return tl, qf_all, qc, acc_all

    return screen


class MonteCarloTwoLevel:

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, *,
                 n_burnin: int = 100, n_samples: int = 10000,
                 n_autocorr_window: int = 20,
                 n_coarse_autocorr_window: int = 20,
                 n_fine_autocorr_window: int = 20,
                 n_delta_autocorr_window: int = 20,
                 chunk_size: int = 256):
        self.fine_action = fine_action
        self.coarse_action = fine_action.coarse_action()
        self.qoi_fine = qoi_factory(fine_action)
        self.qoi_coarse = qoi_factory(self.coarse_action)
        self.coarse_sampler = coarse_sampler_factory(self.coarse_action)
        self.conditioned_fine_action = conditioned_fine_action_factory(
            fine_action)
        self.twolevel_step = TwoLevelMetropolisStep(
            self.coarse_action, fine_action, self.conditioned_fine_action)
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)
        self.chunk_size = int(chunk_size)
        self.stats_fine = Statistics("QoI[fine]", n_fine_autocorr_window)
        self.stats_coarse = Statistics("QoI[coarse]", n_coarse_autocorr_window)
        self.stats_diff = Statistics("delta QoI", n_delta_autocorr_window)
        self.stats_cs = Statistics("QoI[coarsesampler]", n_autocorr_window)

        draw_coarse = make_coarse_subsampler(self.coarse_sampler,
                                             self.qoi_coarse)

        if getattr(self.conditioned_fine_action, "independent_fill", False):
            # batched screen: coarse chain first (sequential, sampler-
            # specific), then ALL proposals/fills/actions/QoIs as one
            # tensor program + a scalar accept scan (make_batched_screen)
            screen = make_batched_screen(
                fine_action, self.coarse_action,
                self.conditioned_fine_action, self.qoi_fine,
                self.qoi_coarse)

            batch_draw = (getattr(self.coarse_sampler, "draw_batch", None)
                          if getattr(self.coarse_sampler,
                                     "independent_draws", False) else None)

            @functools.partial(jax.jit, donate_argnums=(1,))
            def _chunk(key, carry, n_active):
                (cstate, tl, st_f, st_c, st_d, st_cs, t_accum) = carry
                k_coarse, k_screen = jax.random.split(key)

                if batch_draw is not None:
                    # iid coarse sampler: the whole chunk's coarse
                    # samples in one batched draw — no scan at all;
                    # closed-form S(x) from the driving normals when
                    # the sampler provides it
                    bdwa = getattr(self.coarse_sampler,
                                   "draw_batch_with_action", None)
                    if bdwa is not None:
                        cstate, xcs, s_cc_pre = bdwa(k_coarse, cstate,
                                                     self.chunk_size)
                    else:
                        cstate, xcs = batch_draw(k_coarse, cstate,
                                                 self.chunk_size)
                        s_cc_pre = None
                    st_cs = stats_mod.record_many(st_cs,
                                                  self.qoi_coarse(xcs))
                    sum_t, n_indep = t_accum
                    t_accum = (sum_t + float(self.chunk_size),
                               n_indep + float(self.chunk_size))
                else:
                    def body_c(carry, k):
                        cstate, st_cs, t_accum = carry
                        cstate, st_cs, t_accum = draw_coarse(
                            k, cstate, st_cs, t_accum)
                        return (cstate, st_cs, t_accum), \
                            self.coarse_sampler.x_of(cstate)

                    keys = jax.random.split(k_coarse, self.chunk_size)
                    (cstate, st_cs, t_accum), xcs = jax.lax.scan(
                        body_c, (cstate, st_cs, t_accum), keys)
                    s_cc_pre = None
                tl, qf, qc, acc = screen(k_screen, tl, xcs, s_cc_pre)
                idx = jnp.arange(self.chunk_size)
                st_f = stats_mod.record_block(st_f, qf, n_valid=n_active)
                st_c = stats_mod.record_block(st_c, qc, n_valid=n_active)
                st_d = stats_mod.record_block(st_d, qf - qc,
                                              n_valid=n_active)
                n_acc = jnp.sum(jnp.where((idx < n_active)[:, None],
                                          acc, False), dtype=jnp.int32)
                return (cstate, tl, st_f, st_c, st_d, st_cs, t_accum), \
                    n_acc
        else:
            @functools.partial(jax.jit, donate_argnums=(1,))
            def _chunk(key, carry, n_active):
                (cstate, tl, st_f, st_c, st_d, st_cs, t_accum) = carry

                def body(carry, inp):
                    cstate, tl, st_cs, t_accum = carry
                    k, i = inp
                    k1, k2 = jax.random.split(k)
                    cstate, st_cs, t_accum = draw_coarse(k1, cstate, st_cs,
                                                         t_accum)
                    xc = self.coarse_sampler.x_of(cstate)
                    tl, accept = self.twolevel_step.draw(k2, tl, xc)
                    qf = self.qoi_fine(tl.theta)
                    qc = self.qoi_coarse(xc)
                    n_acc = jnp.where(i < n_active,
                                      jnp.sum(accept, dtype=jnp.int32), 0)
                    return (cstate, tl, st_cs, t_accum), (qf, qc, n_acc)

                keys = jax.random.split(key, self.chunk_size)
                idx = jnp.arange(self.chunk_size)
                (cstate, tl, st_cs, t_accum), (qf, qc, acc) = jax.lax.scan(
                    body, (cstate, tl, st_cs, t_accum), (keys, idx))
                st_f = stats_mod.record_block(st_f, qf, n_valid=n_active)
                st_c = stats_mod.record_block(st_c, qc, n_valid=n_active)
                st_d = stats_mod.record_block(st_d, qf - qc,
                                              n_valid=n_active)
                return (cstate, tl, st_f, st_c, st_d, st_cs, t_accum), \
                    jnp.sum(acc)

        self._chunk = _chunk

    def evaluate_difference(self, key, n_chains: int, dtype=None,
                            verbose: bool = False, mesh=None):
        """Burn-in then record n_samples of (Q_f, Q_c, Y); returns the stats
        states dict (montecarlotwolevel.cc:38-79).  With ``mesh`` the
        chain carries are sharded over the mesh's 'chains' axis (the
        reference splits two-level samples over MPI ranks,
        montecarlotwolevel.cc:62-63 — this is the same data parallelism
        over devices)."""
        t0 = time.monotonic()
        self.timings = {}
        k_prep, k_run = jax.random.split(key)
        cstate = self.coarse_sampler.prepare(k_prep, n_chains, dtype)
        rdtype = self.coarse_sampler.x_of(cstate).dtype
        # initialise the fine chain from prolongate + fill of the initial
        # coarse sample: a draw from the proposal q itself, so the screened
        # chain never starts in q's tail (where the delayed-acceptance
        # ratio's q(theta_cur) factor would freeze it — relevant for
        # sharply-peaked fill-ins like the Gaussian Schwinger variant)
        k_prep2 = jax.random.fold_in(k_prep, 1)
        x_fine = self.fine_action.initialise_state(k_prep, n_chains, rdtype)
        x_fine = self.fine_action.prolongate(
            self.coarse_sampler.x_of(cstate), x_fine)
        x_fine = self.conditioned_fine_action.fill_fine_points(k_prep2,
                                                               x_fine)
        tl = self.twolevel_step.init(x_fine)
        st_f = self.stats_fine.init(n_chains, rdtype)
        st_c = self.stats_coarse.init(n_chains, rdtype)
        st_d = self.stats_diff.init(n_chains, rdtype)
        st_cs = self.stats_cs.init(n_chains, rdtype)
        t_accum = (jnp.zeros((), rdtype), jnp.zeros((), rdtype))
        carry = (cstate, tl, st_f, st_c, st_d, st_cs, t_accum)
        if mesh is not None:
            from mlmcpathintegral.parallel import shard_chains
            carry = shard_chains(mesh, carry)

        # accepted-move count accumulates ON DEVICE: an int(n_acc) pull
        # per chunk would serialise the dispatch pipeline;
        # float accumulator: int32 wraps past 2^31 accepted moves on long
        # runs; per-chunk counts stay exact in int32
        n_accepted = jnp.zeros((), jnp.float64 if jax.config.jax_enable_x64
                               else jnp.float32)
        n_done = 0
        jax.block_until_ready(carry)
        self.timings["prepare_s"] = time.monotonic() - t0
        t_phase = time.monotonic()
        # burn-in phase: discard into the masked region (n_active=chunk);
        # afterwards hard-reset the Y statistics (montecarlotwolevel.cc:66-69)
        n_burn = 0
        while n_burn < self.n_burnin:
            n = min(self.chunk_size, self.n_burnin - n_burn)
            k_run, sub = jax.random.split(k_run)
            carry, _ = self._chunk(sub, carry, n)
            n_burn += n
        cstate, tl, _, _, _, st_cs, t_accum = carry
        st_f = self.stats_fine.init(n_chains, rdtype)
        st_c = self.stats_coarse.init(n_chains, rdtype)
        st_d = self.stats_diff.init(n_chains, rdtype)
        carry = (cstate, tl, st_f, st_c, st_d, st_cs, t_accum)
        if verbose:
            print("Burnin completed")
        jax.block_until_ready(carry)
        self.timings["burnin_s"] = time.monotonic() - t_phase

        t_phase = time.monotonic()
        local_target = -(-self.n_samples // n_chains)
        while n_done < local_target:
            n = min(self.chunk_size, local_target - n_done)
            k_run, sub = jax.random.split(k_run)
            carry, n_acc = self._chunk(sub, carry, n)
            n_accepted = n_accepted + n_acc.astype(n_accepted.dtype)
            n_done += n
        jax.block_until_ready(carry)
        # sampling-phase wall: the scope matching the reference-baseline
        # eff formula (run_ref_baselines.py prorates the C++ total over
        # the sampling fraction, excluding the TwoLevelMetropolisStep
        # constructor's 10000 self-timing draws and burn-in)
        self.timings["sampling_s"] = time.monotonic() - t_phase
        self.elapsed_s = time.monotonic() - t0
        cstate, tl, st_f, st_c, st_d, st_cs, t_accum = carry
        self.p_accept = float(n_accepted) / (n_done * n_chains)
        sum_t, n_indep = t_accum
        self.t_indep = float(sum_t) / max(float(n_indep), 1.0)
        return {"fine": st_f, "coarse": st_c, "diff": st_d,
                "coarse_sampler": st_cs}

    def show_statistics(self, stats):
        print(self.stats_fine.summary(stats["fine"]))
        print(self.stats_coarse.summary(stats["coarse"]))
        print(self.stats_diff.summary(stats["diff"]))
        print("=== Coarse level sampler statistics ===")
        print(self.stats_cs.summary(stats["coarse_sampler"]))
        print(f" subsampling t_indep = {self.t_indep:.3f}")
        print(f" two-level acceptance = {self.p_accept:.4f}")
