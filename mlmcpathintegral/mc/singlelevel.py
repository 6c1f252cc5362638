"""Single-level Monte-Carlo estimation.

Reference parity: src/montecarlo/montecarlosinglelevel.{hh,cc}.  The host
drives an adaptive outer loop (recompute the target sample count from the
running tau_int and variance, montecarlosinglelevel.cc:57-89) around a
fixed-size jitted chunk that advances *all chains* one draw per step,
evaluates the QoI and updates the batched statistics in the scan carry.

The reference distributes the target across MPI ranks with ``distribute_n``
(mpi/mpi_wrapper.hh:125); here it distributes across the chain batch — the
per-chain target is ceil(n_target / n_chains), and the all-ranks
``mpi_allreduce_and`` convergence check becomes a trivial host comparison
because every chain advances in lockstep.
"""

from __future__ import annotations

import math
import time

import jax
import jax.numpy as jnp

from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


class MonteCarloSingleLevel:

    def __init__(self, action, qoi, sampler, *,
                 n_burnin: int = 100, n_samples: int = 0,
                 epsilon: float = 1e-2, n_autocorr_window: int = 20,
                 n_min_samples_qoi: int = 100, chunk_size: int = 256,
                 qoi_log_path=None, save_states_path=None):
        self.action = action
        self.qoi = qoi
        self.sampler = sampler
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)      # 0 => adaptive via epsilon
        self.epsilon = float(epsilon)
        self.n_min_samples_qoi = int(n_min_samples_qoi)
        self.chunk_size = int(chunk_size)
        self.stats_Q = Statistics("Q", n_autocorr_window)
        self.elapsed_s = 0.0
        #: LOG_QOI analog (montecarlosinglelevel.cc:46-76): stream every
        #: recorded per-chain QoI value to a binary float64 file of shape
        #: [n_steps, n_chains] for offline analysis (tools/analyze_qoi_log)
        self.qoi_log_path = qoi_log_path
        #: SAVE_STATES analog (config.h:16-23, montecarlosinglelevel.cc:
        #: 61-70): dump the recorded chain states per chunk as
        #: ``states_<offset>.npz`` ([n_recorded, n_chains, ndof]) under
        #: this directory, for inspection (not resumption — see
        #: utils/checkpoint.py for the real checkpointing)
        self.save_states_path = save_states_path
        #: per-step cross-chain QoI means, accumulated for the binning
        #: cross-check of a window-capped tau_int (chains are iid, so the
        #: normalised autocorrelation of the cross-chain mean equals the
        #: per-chain one)
        self._qbar_history = []

        def _chunk_body(key, sampler_state, stats_state, n_active,
                        with_states: bool, with_qs: bool):
            """Advance chunk_size draws; record QoI only for the first
            n_active steps (montecarlosinglelevel.cc:58-77)."""
            def body(ss, k):
                ss, accept = self.sampler.draw(k, ss)
                x = self.sampler.x_of(ss)
                q = self.qoi(x)
                out = (jnp.sum(accept), q)
                if with_states:
                    out = out + (x,)
                return ss, out
            keys = jax.random.split(key, self.chunk_size)
            ss, outs = jax.lax.scan(body, sampler_state, keys)
            st = stats_mod.record_block(stats_state, outs[1],
                                        n_valid=n_active)
            # cross-chain mean of the QoI trace, reduced on device: the
            # binning cross-check only needs this [chunk] vector, not the
            # full [chunk, C] trace, whose per-chunk device-to-host copy
            # would serialise the dispatch pipeline
            qbar = jnp.mean(outs[1], axis=1)
            full = tuple(outs[1:]) if with_qs else ()
            return (ss, st, jnp.sum(outs[0]), qbar) + full

        import functools
        self._chunk_impl = jax.jit(
            functools.partial(_chunk_body, with_states=False,
                              with_qs=False))
        #: LOG_QOI variant returning the full per-step QoI trace
        self._chunk_impl_log = jax.jit(
            functools.partial(_chunk_body, with_states=False,
                              with_qs=True))
        #: SAVE_STATES variant additionally returning the per-step state
        #: trace [chunk, C, ndof] (only compiled when states are saved)
        self._chunk_impl_states = jax.jit(
            functools.partial(_chunk_body, with_states=True,
                              with_qs=True))
        self._log_fh = None

    def _chunk(self, key, sampler_state, stats_state, n_active,
               record_history=True):
        import numpy as np
        save = self.save_states_path is not None and record_history
        log = self._log_fh is not None
        if save:
            ss, st, n_acc, qbar, qs, xs = self._chunk_impl_states(
                key, sampler_state, stats_state, n_active)
        elif log:
            ss, st, n_acc, qbar, qs = self._chunk_impl_log(
                key, sampler_state, stats_state, n_active)
        else:
            ss, st, n_acc, qbar = self._chunk_impl(key, sampler_state,
                                                   stats_state, n_active)
        n = int(n_active)
        if log:
            np.asarray(qs[:n]).astype(np.float64).tofile(self._log_fh)
        if record_history:
            # keep the [n] vector on device; pulled lazily by
            # _tau_binning / at end of run
            self._qbar_history.append(qbar[:n])
        if save:
            from pathlib import Path
            d = Path(self.save_states_path)
            d.mkdir(parents=True, exist_ok=True)
            offset = sum(h.shape[0] for h in self._qbar_history) - n
            np.savez_compressed(d / f"states_{offset:08d}.npz",
                                x=np.asarray(xs[:n]))
        return ss, st, n_acc

    # -------------------------------------------------------------------------

    def evaluate(self, key, n_chains: int, dtype=None, verbose: bool = False):
        """Run burn-in + adaptive sampling; returns (sampler_state,
        stats_state).  Mirrors MonteCarloSingleLevel::evaluate
        (montecarlosinglelevel.cc:23-94)."""
        t0 = time.monotonic()
        k_prep, k_burn, k_loop = jax.random.split(key, 3)
        sstate = self.sampler.prepare(k_prep, n_chains, dtype)
        stats = self.stats_Q.init(
            n_chains,
            self.sampler.x_of(sstate).dtype if dtype is None else dtype)

        # burn-in recorded into long-term moments then soft-reset, so tau_int
        # is learned during warm-up (montecarlosinglelevel.cc:28-38)
        self._qbar_history = []
        n_burn_done = 0
        while n_burn_done < self.n_burnin:
            n = min(self.chunk_size, self.n_burnin - n_burn_done)
            k_burn, sub = jax.random.split(k_burn)
            sstate, stats, _ = self._chunk(sub, sstate, stats, n,
                                           record_history=False)
            n_burn_done += n
        stats = stats_mod.soft_reset(stats)
        if verbose:
            print("Burnin completed")

        # open the QoI log after burn-in (montecarlosinglelevel.cc:46-56)
        if self.qoi_log_path is not None:
            self._log_fh = open(self.qoi_log_path, "wb")
        two_eps_inv2 = 2.0 / (self.epsilon * self.epsilon)
        # accepted count accumulates on device; ``done`` is tracked
        # host-side (each chunk records exactly n masked samples, so the
        # counter equals stats.n by construction — no per-chunk pull)
        # Kahan-compensated float accumulator: a plain float32 sum loses
        # whole per-chunk counts past ~2^24; per-chunk counts
        # stay exact in int32 (chunk*chains < 2^31), and the compensation
        # keeps the running sum exact to ~2^48 accepted moves
        acc_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        n_accepted = jnp.zeros((), acc_dtype)
        n_acc_comp = jnp.zeros((), acc_dtype)
        n_drawn = 0
        done = 0
        while True:
            n_target = self._target(stats, two_eps_inv2)
            local_target = -(-n_target // n_chains)   # ceil
            if done >= local_target:
                break
            n = min(self.chunk_size, local_target - done)
            k_loop, sub = jax.random.split(k_loop)
            sstate, stats, n_acc = self._chunk(sub, sstate, stats, n)
            y = n_acc.astype(acc_dtype) - n_acc_comp
            t = n_accepted + y
            n_acc_comp = (t - n_accepted) - y
            n_accepted = t
            done += n
            n_drawn += self.chunk_size * n_chains
        self.p_accept = float(n_accepted) / max(n_drawn, 1)
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None
        self.elapsed_s = time.monotonic() - t0
        return sstate, stats

    def _target(self, stats, two_eps_inv2) -> int:
        if self.n_samples > 0:
            return self.n_samples
        tau = self.stats_Q.tau_int(stats)
        if self.stats_Q.window_capped(stats):
            tau = max(tau, self._tau_binning())
        var = self.stats_Q.variance(stats)
        return max(self.n_min_samples_qoi,
                   int(math.ceil(tau * two_eps_inv2 * var)))

    def _tau_binning(self) -> float:
        """Binning cross-check of a window-capped tau_int over the
        per-step cross-chain mean series."""
        import numpy as np
        if not self._qbar_history:
            return 1.0
        return stats_mod.tau_binning(np.concatenate(
            [np.asarray(h, np.float64) for h in self._qbar_history]))

    # -------------------------------------------------------------------------

    def numerical_result(self, stats) -> float:
        return self.stats_Q.average(stats)

    def statistical_error(self, stats) -> float:
        return self.stats_Q.error(stats)

    def show_statistics(self, stats):
        print(self.stats_Q.summary(stats))
        print(f" [timer SinglelevelMC] : {self.elapsed_s:.4f} s")
