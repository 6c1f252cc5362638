"""Full multilevel Monte Carlo (MLMC) with the telescoping estimator.

Reference parity: src/montecarlo/montecarlomultilevel.{hh,cc}.
Per level ell < L-1 the estimator measures Y_ell = Q_ell(theta_ell) -
Q_{ell+1}(theta_{ell+1}) where theta_{ell+1} is a tau-subsampled coarse
sample and theta_ell comes from one TwoLevelMetropolisStep screening; the
coarsest level measures Y_{L-1} = Q_{L-1}.  The result is
sum_ell mean(Y_ell) with error sqrt(sum err_ell^2)
(montecarlomultilevel.cc:255-271).

Adaptive sample allocation (montecarlomultilevel.cc:147-164):
  N_ell = ceil( 2/eps^2 * S * sqrt(V_ell / C_ell^eff) * tau_ell ),
  S = sum_ell sqrt(V_ell * C_ell^eff),
  C_ell^eff = ceil(tau_ell) * (C_twolevel + t_indep * C_coarse)
with costs measured by timing the jitted per-level kernels (the analog of
the reference's 10000-draw constructor timings).

Each level owns one jitted chunk program (subsample -> screen -> QoI ->
record, batched over chains); the host only runs the outer adaptive loop.
Unlike the reference (which aborts for MPI size > 1, driver_qm.cc:382-386),
every level here is chain-parallel.

With ``fused`` set, every level of a quenched Schwinger hierarchy runs one
fused chunk per launch instead: the two-level chunk
(ops/schwinger_twolevel.py) on levels ell < L-1 and the sweep chain
(ops/schwinger.py) on the coarsest level — the CUDA kernels on a GPU
(``fused="cuda"``) or their plain-JAX references (``fused="reference"``).
"""

from __future__ import annotations

import functools
import math
import time

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mlmcpathintegral.mc.twolevel import make_coarse_subsampler
from mlmcpathintegral.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics

FUSED_CHOICES = (None, "cuda", "reference")


class MonteCarloMultiLevel:

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, *,
                 n_level: int, epsilon: float = 1e-2, n_burnin: int = 100,
                 n_samples: int = 0, n_autocorr_window: int = 20,
                 n_min_samples_qoi: int = 100, chunk_size: int = 128,
                 fused: str | None = None, t_max: int = 100):
        if fused not in FUSED_CHOICES:
            raise ValueError(f"fused must be one of {FUSED_CHOICES}, "
                             f"got {fused!r}")
        self.n_level = int(n_level)
        self.epsilon = float(epsilon)
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)   # fixed per-level target if > 0
        self.n_min_samples_qoi = int(n_min_samples_qoi)
        self.chunk_size = int(chunk_size)
        self.fused = fused
        self.t_max = int(t_max)

        # build the action hierarchy + per-level machinery
        # (montecarlomultilevel.cc:26-68)
        self.actions = [fine_action]
        self.twolevel_steps = []
        self.coarse_samplers = []     # sampler feeding level ell (on ell+1)
        for ell in range(self.n_level - 1):
            coarse = self.actions[ell].coarse_action()
            cond = conditioned_fine_action_factory(self.actions[ell])
            self.twolevel_steps.append(
                TwoLevelMetropolisStep(coarse, self.actions[ell], cond))
            self.actions.append(coarse)
            self.coarse_samplers.append(coarse_sampler_factory(coarse))
        # independent sampler instance for the coarsest-level measurements
        self.coarsest_sampler = coarse_sampler_factory(self.actions[-1])
        self.qois = [qoi_factory(a) for a in self.actions]
        self.stats_qoi = [Statistics(f"Y[{ell}]", n_autocorr_window)
                          for ell in range(self.n_level)]
        self.stats_cs = [Statistics(f"Q_sampler[{ell}]", n_autocorr_window)
                         for ell in range(self.n_level - 1)]
        #: slow-mode (plaquette-energy) statistics of the fused in-kernel
        #: coarse chains: the t_sub clock runs on max(tau_QoI, tau_slow)
        #: so a configuration mode slower than the QoI cannot silently
        #: under-decorrelate the coarse proposals (the unfused path's
        #: analog is the sampler-provided subsample_observable in
        #: mc/twolevel.py)
        self.stats_slow = [Statistics(f"E_sampler[{ell}]",
                                      n_autocorr_window)
                           for ell in range(self.n_level)]
        # start at the fused floor (below): when the post-burn-in
        # estimate matches, the second compile round is a no-op
        self._t_sub = [self.FUSED_T_SUB_MIN] * self.n_level
        self._fused_cache = {}
        self._mesh = None
        if self.fused is not None:
            self._check_fusable()
        self._build_kernels()

    # -- fused path (Schwinger, both-coarsening) --------------------------------

    def _check_fusable(self):
        """The fused chunks run the quenched Schwinger action with
        both-direction coarsening and their own heat-bath coarse chain on
        every level; anything else is refused here, never run unfused."""
        from mlmcpathintegral.models.qft.schwinger import (
            QuenchedSchwingerAction,
        )
        from mlmcpathintegral.ops import cuda_kernels
        from mlmcpathintegral.ops.schwinger_twolevel import (
            twolevel_cta_shape,
        )
        from mlmcpathintegral.samplers.heatbath import (
            OverrelaxedHeatBathSampler,
        )
        samplers = self.coarse_samplers + [self.coarsest_sampler]
        for act in self.actions:
            if type(act) is not QuenchedSchwingerAction:
                raise ValueError("fused MLMC runs the quenched Schwinger "
                                 f"action only, got {type(act).__name__}")
        for ell in range(self.n_level - 1):
            lat = self.actions[ell].lattice
            if (self.actions[ell]._coarsen_case() != "both"
                    or lat.Mt_lat % 2 or lat.Mx_lat % 2):
                raise ValueError(f"fused MLMC needs both-direction "
                                 f"coarsening of even lattices (level {ell})")
        for smp in samplers:
            # the fused chunks run their own in-kernel heat-bath chain; a
            # user-chosen sampler (e.g. the cluster sampler) is not
            # silently replaced
            if not isinstance(smp, OverrelaxedHeatBathSampler):
                raise ValueError("fused MLMC runs heat-bath coarse chains; "
                                 f"got {type(smp).__name__}")
        if self.fused == "cuda":
            # the kernels' static shared-memory rule, at any chain count
            for ell in range(self.n_level - 1):
                lat = self.actions[ell].lattice
                twolevel_cta_shape(2 * cuda_kernels.N_SM, lat.Mt_lat,
                                   lat.Mx_lat)
            lat = self.actions[-1].lattice
            cuda_kernels.cta_shape(2 * cuda_kernels.N_SM, 4 * lat.nedges, 1)

    def _over_chains(self, fn, chain_args, seed, out_axes):
        """fn(*chain_args, seed, chain_offset) on the whole chain axis, or,
        when evaluate() got a mesh, once per shard of it under shard_map
        (XLA cannot partition a custom call) with the shard's global chain
        offset, so every chain draws the same stream either way.
        ``out_axes`` gives each output's chain axis."""
        mesh = self._mesh
        if mesh is None:
            return fn(*chain_args, seed, 0)
        n_local = chain_args[0].shape[0] // mesh.shape["chains"]

        def local(*args):
            *xs, seed = args
            return fn(*xs, seed, jax.lax.axis_index("chains") * n_local)

        def spec(axis):
            return P(*([None] * axis), "chains")

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=tuple(spec(0) for _ in chain_args) + (P(),),
            out_specs=tuple(spec(a) for a in out_axes),
            check_vma=False)(*chain_args, seed)

    def _make_fused_chunk(self, ell: int, t_sub: int):
        """Jitted fused two-level chunk for level ell at a static
        subsampling rate t_sub."""
        from mlmcpathintegral.ops.schwinger_twolevel import (
            schwinger_twolevel_chain,
        )
        act, cact = self.actions[ell], self.actions[ell + 1]
        lat = act.lattice
        smp = self.coarse_samplers[ell]
        chunk_size = self.chunk_size
        four_pi2_inv = 1.0 / (4.0 * math.pi ** 2)
        ec_center = self._energy_center(cact)

        def kernel(theta_f, theta_c, s_f, s_q, seed, offset):
            return schwinger_twolevel_chain(
                theta_f, theta_c, s_f, s_q, seed,
                beta=act.beta, beta_c=cact.beta,
                Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                n_steps=chunk_size, t_sub=t_sub,
                n_overrelax_c=smp.n_sweep_overrelax,
                n_heatbath_c=smp.n_sweep_heatbath,
                chain_offset=offset, reference=self.fused == "reference")

        @functools.partial(jax.jit, donate_argnums=(1,))
        def chunk(key, carry, n_active):
            cstate, tl, st_y, st_cs, st_slow, t_accum = carry
            seed = jax.random.randint(key, (2,), -2**31, 2**31 - 1,
                                      jnp.int32)
            thf, thc, sf, sq, y, qc, ec, acc = self._over_chains(
                kernel, (tl.theta, cstate.x, tl.S_fine, tl.S_cond), seed,
                (0, 0, 0, 0, 1, 1, 1, 1))
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            st_cs = stats_mod.record_many(st_cs,
                                          four_pi2_inv * qc * qc)
            # slow-mode (plaquette-energy) trace of the in-kernel coarse
            # chain, centered at its analytic mean (see _energy_center)
            st_slow = stats_mod.record_many(st_slow, ec - ec_center)
            sum_t, n_indep = t_accum
            t_accum = (sum_t + t_sub * chunk_size,
                       n_indep + float(chunk_size))
            cstate = type(cstate)(x=thc)
            tl_new = type(tl)(theta=thf, S_fine=sf, S_cond=sq)
            # per-step cross-chain Y mean: feeds the binning reliability
            # cross-check of a window-capped tau
            return (cstate, tl_new, st_y, st_cs, st_slow, t_accum), \
                jnp.mean(y, axis=1)

        return chunk

    def _make_fused_chunk_L(self, t_sub: int):
        """Jitted fused coarsest-level chunk: chunk_size tau-subsampled
        measurements driven by the multi-step heat-bath sweep chain."""
        from mlmcpathintegral.ops.schwinger import schwinger_sweep_chain
        cact = self.actions[-1]
        lat = cact.lattice
        smp = self.coarsest_sampler
        chunk_size = self.chunk_size
        four_pi2_inv = 1.0 / (4.0 * math.pi ** 2)
        ec_center = self._energy_center(cact)

        def kernel(x, seed, offset):
            return schwinger_sweep_chain(
                x, seed, beta=cact.beta, Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                n_steps=chunk_size * t_sub,
                n_overrelax=smp.n_sweep_overrelax,
                n_heatbath=smp.n_sweep_heatbath, chain_offset=offset,
                reference=self.fused == "reference")

        @functools.partial(jax.jit, donate_argnums=(1,))
        def chunk_L(key, carry, n_active):
            cstate, st_y, st_cs, st_slow, t_accum = carry
            seed = jax.random.randint(key, (2,), -2**31, 2**31 - 1,
                                      jnp.int32)
            x, qsum, esum = self._over_chains(kernel, (cstate.x,), seed,
                                              (0, 1, 1))
            qoi = four_pi2_inv * qsum * qsum       # [chunk*t_sub, C]
            st_cs = stats_mod.record_many(st_cs, qoi)
            st_slow = stats_mod.record_many(st_slow, esum - ec_center)
            y = qoi[t_sub - 1::t_sub]              # [chunk, C]
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            sum_t, n_indep = t_accum
            t_accum = (sum_t + t_sub * chunk_size,
                       n_indep + float(chunk_size))
            return (type(cstate)(x=x), st_y, st_cs, st_slow, t_accum), \
                jnp.mean(y, axis=1)

        return chunk_L

    @staticmethod
    def _energy_center(action) -> float:
        """Analytic per-sweep plaquette-energy mean of a heat-bath chain,
        N_cells * I1(beta)/I0(beta): recording the slow-mode trace
        CENTERED keeps the f32 autocorrelation accumulators
        well-conditioned (tau is shift-invariant)."""
        from scipy.special import i0e, i1e
        lat = action.lattice
        return float(lat.Mt_lat * lat.Mx_lat
                     * i1e(action.beta) / i0e(action.beta))

    #: minimum in-kernel coarse sweeps per recorded sample on fused
    #: levels.  Delayed acceptance is exact only for INDEPENDENT coarse
    #: proposals; ceil(2 tau_QoI) (the reference's subsample rule)
    #: under-decorrelates the heat-bath CONFIGURATION at weak coupling
    #: and measurably biased the screened chain (~-0.4% at 8x8 beta=4:
    #: seeds at -2.8/-3.7 sigma with t_sub=4 move to -0.1/+0.4 sigma at
    #: t_sub=8, same keys).
    FUSED_T_SUB_MIN = 8

    def _update_t_sub(self, carries, carry_L):
        """Re-estimate the per-level coarse subsampling rates from
        max(tau_QoI, tau_slow) of the in-kernel coarse chain — the
        reference clocks on the QoI alone (montecarlotwolevel.cc:82-94),
        which silently assumes the QoI is the chain's slowest mode; the
        fused kernels additionally emit the plaquette-energy trace so a
        slow CONFIGURATION mode is measured rather than assumed
        (FUSED_T_SUB_MIN stays as the backstop).  The fused kernels take
        t_sub statically, so this adapts between chunks rather than
        between draws."""
        if self.fused is None:
            return

        def quantised(tau):
            # round ceil(2 tau) UP to a power of two: extra decorrelation
            # is harmless and the fused chunks recompile per distinct
            # (static) t_sub, so coarse quantisation bounds recompiles;
            # floor at FUSED_T_SUB_MIN (proposal-independence safety)
            t = min(self.t_max, max(self.FUSED_T_SUB_MIN,
                                    math.ceil(2.0 * tau)))
            # cap again after rounding: the power-of-two round-up could
            # otherwise overshoot t_max (100 -> 128)
            return min(1 << (t - 1).bit_length(), self.t_max)

        def ratchet(cur, new):
            # recompile only when the compiled rate is too SMALL (the
            # coarse samples would be more correlated than requested —
            # still unbiased, the Y statistics see the real correlation,
            # but allocation efficiency drops) or grossly too large
            # (>= 4x: each recorded sample pays t_sub coarse sweeps)
            return new if (new > cur or new * 4 <= cur) else cur

        for ell in range(self.n_level - 1):
            tau = max(self.stats_cs[ell].tau_int(carries[ell][3]),
                      self.stats_slow[ell].tau_int(carries[ell][4]))
            self._t_sub[ell] = ratchet(self._t_sub[ell], quantised(tau))
        stats_L = Statistics("cs_L", self.stats_qoi[-1].k_max)
        tau = max(stats_L.tau_int(carry_L[2]),
                  self.stats_slow[-1].tau_int(carry_L[3]))
        self._t_sub[-1] = ratchet(self._t_sub[-1], quantised(tau))

    # -------------------------------------------------------------------------

    def _fused_dispatch(self, make, level):
        """Per-(level, t_sub, mesh) cache of the jitted fused chunks."""
        def dispatch(key, carry, n_active):
            k = (level, self._t_sub[level], self._mesh)
            fn = self._fused_cache.get(k)
            if fn is None:
                fn = self._fused_cache[k] = make(self._t_sub[level])
            return fn(key, carry, n_active)
        return dispatch

    def _build_kernels(self):
        self._chunk = []
        if self.fused is not None:
            for ell in range(self.n_level - 1):
                self._chunk.append(self._fused_dispatch(
                    functools.partial(self._make_fused_chunk, ell), ell))
            self._chunk_L = self._fused_dispatch(self._make_fused_chunk_L,
                                                 self.n_level - 1)
            return
        for ell in range(self.n_level - 1):
            draw_coarse = make_coarse_subsampler(self.coarse_samplers[ell],
                                                 self.qois[ell + 1])
            step = self.twolevel_steps[ell]
            qoi_f, qoi_c = self.qois[ell], self.qois[ell + 1]
            if getattr(step.conditioned_fine_action, "independent_fill",
                       False):
                # batched screen for unfused levels: coarse chain scan
                # first, then one tensor program of proposals + a scalar
                # accept scan (mc/twolevel.py::make_batched_screen)
                from mlmcpathintegral.mc.twolevel import (
                    make_batched_screen,
                )
                screen = make_batched_screen(
                    self.actions[ell], self.actions[ell + 1],
                    step.conditioned_fine_action, qoi_f, qoi_c)

                def chunk(key, carry, n_active, *,
                          draw_coarse=draw_coarse, screen=screen):
                    cstate, tl, st_y, st_cs, st_slow, t_accum = carry
                    k_c, k_s = jax.random.split(key)

                    def body_c(carry, k):
                        cstate, st_cs, t_accum = carry
                        cstate, st_cs, t_accum = draw_coarse(
                            k, cstate, st_cs, t_accum)
                        return (cstate, st_cs, t_accum), \
                            draw_coarse.sampler.x_of(cstate)

                    (cstate, st_cs, t_accum), xcs = jax.lax.scan(
                        body_c, (cstate, st_cs, t_accum),
                        jax.random.split(k_c, self.chunk_size))
                    tl, qf, qc, _ = screen(k_s, tl, xcs)
                    st_y = stats_mod.record_block(st_y, qf - qc,
                                                  n_valid=n_active)
                    y = qf - qc
                    return (cstate, tl, st_y, st_cs, st_slow, t_accum), \
                        jnp.mean(y, axis=1)
            else:
                def chunk(key, carry, n_active, *, draw_coarse=draw_coarse,
                          step=step, qoi_f=qoi_f, qoi_c=qoi_c):
                    cstate, tl, st_y, st_cs, st_slow, t_accum = carry

                    def body(carry, k):
                        cstate, tl, st_cs, t_accum = carry
                        k1, k2 = jax.random.split(k)
                        cstate, st_cs, t_accum = draw_coarse(k1, cstate,
                                                             st_cs, t_accum)
                        xc = draw_coarse.sampler.x_of(cstate)
                        tl, _ = step.draw(k2, tl, xc)
                        y = qoi_f(tl.theta) - qoi_c(xc)
                        return (cstate, tl, st_cs, t_accum), y
                    keys = jax.random.split(key, self.chunk_size)
                    (cstate, tl, st_cs, t_accum), y = \
                        jax.lax.scan(body,
                                     (cstate, tl, st_cs, t_accum), keys)
                    st_y = stats_mod.record_block(st_y, y,
                                                  n_valid=n_active)
                    return (cstate, tl, st_y, st_cs, st_slow, t_accum), \
                        jnp.mean(y, axis=1)

            self._chunk.append(jax.jit(chunk, donate_argnums=(1,)))

        # coarsest level: Y = Q_{L-1} on a tau-subsampled standalone chain
        draw_coarse = make_coarse_subsampler(self.coarsest_sampler,
                                             self.qois[-1])
        qoi_L = self.qois[-1]

        def chunk_L(key, carry, n_active):
            cstate, st_y, st_cs, st_slow, t_accum = carry

            def body(carry, k):
                cstate, st_cs, t_accum = carry
                cstate, st_cs, t_accum = draw_coarse(k, cstate, st_cs,
                                                     t_accum)
                y = qoi_L(draw_coarse.sampler.x_of(cstate))
                return (cstate, st_cs, t_accum), y
            keys = jax.random.split(key, self.chunk_size)
            (cstate, st_cs, t_accum), y = jax.lax.scan(
                body, (cstate, st_cs, t_accum), keys)
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            return (cstate, st_y, st_cs, st_slow, t_accum), \
                jnp.mean(y, axis=1)

        self._chunk_L = jax.jit(chunk_L, donate_argnums=(1,))

    # -------------------------------------------------------------------------

    def evaluate(self, key, n_chains: int, dtype=None, verbose: bool = False,
                 mesh=None):
        """Run the full MLMC estimation.  With ``mesh`` (a 1-D
        jax.sharding.Mesh with a 'chains' axis) every per-level carry is
        sharded over the chain axis — the multilevel method the reference
        explicitly cannot parallelise (driver_qm.cc:382-386) runs
        chain-parallel across devices here; per-chain work stays local
        and only the host-side getters aggregate."""
        t_start = time.monotonic()
        self.timings = {}   # wall-clock per phase (prepare incl. compiles)
        L = self.n_level
        self.n_chains = n_chains
        self._mesh = mesh
        keys = jax.random.split(key, 2 * L + 2)

        # initialise per-level carries.  The whole per-level state
        # construction (sampler prepare incl. its burn-in scan,
        # prolongate, conditioned fill, cached action values) runs as ONE
        # jitted program per level instead of hundreds of tiny eager op
        # dispatches.  Only the statistics zero-buffers stay eager — XLA may alias
        # identical constant outputs, which would break the chunk
        # kernels' donate_argnums.
        carries = []
        rdtype = None
        for ell in range(L - 1):
            def build_level(k_prep, k_fine, *, ell=ell):
                cstate = self.coarse_samplers[ell].prepare(k_prep,
                                                           n_chains, dtype)
                xc = self.coarse_samplers[ell].x_of(cstate)
                # start the screened chain from prolongate + fill of the
                # initial coarse sample (a draw from q — see mc/twolevel.py)
                x_fine = self.actions[ell].initialise_state(
                    k_fine, n_chains, xc.dtype)
                x_fine = self.actions[ell].prolongate(xc, x_fine)
                x_fine = self.twolevel_steps[ell] \
                    .conditioned_fine_action.fill_fine_points(
                        jax.random.fold_in(k_fine, 1), x_fine)
                tl = self.twolevel_steps[ell].init(x_fine)
                return cstate, tl
            try:
                cstate, tl = jax.jit(build_level)(keys[2 * ell],
                                                  keys[2 * ell + 1])
            except jax.errors.JAXTypeError:
                # sampler prepare with host-side logic (e.g. the HMC
                # step-size autotune bisection) cannot trace — build
                # this level's carry eagerly
                cstate, tl = build_level(keys[2 * ell], keys[2 * ell + 1])
            rdtype = self.coarse_samplers[ell].x_of(cstate).dtype
            st_y = self.stats_qoi[ell].init(n_chains, rdtype)
            st_cs = self.stats_cs[ell].init(n_chains, rdtype)
            st_slow = self.stats_slow[ell].init(n_chains, rdtype)
            t_accum = (jnp.zeros((), rdtype), jnp.zeros((), rdtype))
            carries.append((cstate, tl, st_y, st_cs, st_slow, t_accum))
        try:
            cstate = jax.jit(lambda k: self.coarsest_sampler.prepare(
                k, n_chains, dtype))(keys[2 * L])
        except jax.errors.JAXTypeError:
            cstate = self.coarsest_sampler.prepare(keys[2 * L], n_chains,
                                                   dtype)
        rdtype = (self.coarsest_sampler.x_of(cstate).dtype
                  if rdtype is None else rdtype)
        st_y = self.stats_qoi[L - 1].init(n_chains, rdtype)
        st_cs_L = Statistics("cs_L", self.stats_cs[0].k_max
                             if self.stats_cs else 20).init(n_chains, rdtype)
        st_slow_L = self.stats_slow[-1].init(n_chains, rdtype)
        t_accum = (jnp.zeros((), rdtype), jnp.zeros((), rdtype))
        carry_L = (cstate, st_y, st_cs_L, st_slow_L, t_accum)

        if mesh is not None:
            from mlmcpathintegral.parallel import shard_chains
            carries = [shard_chains(mesh, c) for c in carries]
            carry_L = shard_chains(mesh, carry_L)

        key_run = keys[2 * L + 1]
        # warm the statistics scalar-reduction jit (utils/statistics.py
        # _device_summary) so its one-time compile lands in the prepare
        # phase, not inside a timed sampling phase
        self.stats_qoi[L - 1].samples(carry_L[1])
        jax.block_until_ready((carries, carry_L))
        self.timings["prepare_s"] = time.monotonic() - t_start

        self.chunk_log = []   # (ell, dispatch_s, block_s) per run_level call
        #: per-level per-step cross-chain Y means recorded since the last
        #: reset — the series behind the binning reliability cross-check
        self._reset_ybar(L)

        def run_level(ell, carry, n_more, key_run):
            """Record n_more further samples on level ell.  n_more=0
            dispatches ONE chunk recording nothing (n_active=0): a
            kernel warm-up whose chain steps are extra decorrelation."""
            done = 0
            t_d0 = time.monotonic()
            n_chunks = 0
            while done < n_more or (n_more == 0 and n_chunks == 0):
                n = min(self.chunk_size, n_more - done)
                key_run, sub = jax.random.split(key_run)
                # n as an int32 scalar (a Python int would trace as a weak
                # type, distinct from the burn-in path's dtype)
                n_dev = jnp.asarray(n, jnp.int32)
                if ell == L - 1:
                    carry, ybar = self._chunk_L(sub, carry, n_dev)
                else:
                    carry, ybar = self._chunk[ell](sub, carry, n_dev)
                if n > 0:
                    # recorded steps are the first n of the chunk; keep
                    # the [n] vector on device, pulled once at the end
                    self._ybar_history[ell].append(ybar[:n])
                done += n
                n_chunks += 1
            t_d1 = time.monotonic()
            jax.block_until_ready(carry)
            self.chunk_log.append((ell, n_chunks, round(t_d1 - t_d0, 4),
                                   round(time.monotonic() - t_d1, 4)))
            return carry, key_run

        def warm_all_levels(carries, carry_L, key_run):
            """Dispatch one n_active=0 chunk per level: compiles (and
            first-executes) every level kernel at the current t_sub
            without recording a sample.  The extra chunk_size chain
            steps are pure additional decorrelation.  Keeps JIT compile
            walls out of the timed burn-in / cost / sampling phases (the
            C++ reference's compile happens at build time and is not in
            its benchmark wall either).

            Levels compile CONCURRENTLY: each level's chunk is an
            independent XLA program, so the cold-start wall is max over
            levels instead of the sum — device execution of the warm
            chunks still serialises on the device, but that part is
            milliseconds."""
            from concurrent.futures import ThreadPoolExecutor
            keys = jax.random.split(key_run, L + 1)
            key_run = keys[L]

            def warm_one(ell):
                c = carry_L if ell == L - 1 else carries[ell]
                c, _ = run_level(ell, c, 0, keys[ell])
                return ell, c

            with ThreadPoolExecutor(max_workers=L) as ex:
                for ell, c in ex.map(warm_one, range(L - 1, -1, -1)):
                    if ell == L - 1:
                        carry_L = c
                    else:
                        carries[ell] = c
            return carries, carry_L, key_run

        t_phase = time.monotonic()
        carries, carry_L, key_run = warm_all_levels(carries, carry_L,
                                                    key_run)
        self.timings["compile_burnin_s"] = time.monotonic() - t_phase

        # burn-in on every level, coarsest to finest
        # (montecarlomultilevel.cc:83-100)
        t_phase = time.monotonic()
        burn_local = -(-self.n_burnin // n_chains)
        for ell in range(L - 1, -1, -1):
            c = carry_L if ell == L - 1 else carries[ell]
            c, key_run = run_level(ell, c, burn_local, key_run)
            if ell == L - 1:
                carry_L = c
            else:
                carries[ell] = c
        # reset Y statistics after burn-in (soft: keep long-term moments for
        # tau_int, montecarlomultilevel.cc:104-110)
        carries = [(cs, tl, stats_mod.soft_reset(st_y), st_cs, st_sl, ta)
                   for (cs, tl, st_y, st_cs, st_sl, ta) in carries]
        carry_L = (carry_L[0], stats_mod.soft_reset(carry_L[1]),
                   carry_L[2], carry_L[3], carry_L[4])
        self._reset_ybar(L)
        if verbose:
            print("Burnin completed")
        jax.block_until_ready((carries, carry_L))
        self.timings["burnin_s"] = time.monotonic() - t_phase

        # adapt the fused kernels' static subsampling rates to the
        # coarse-sampler tau_int learned during burn-in, then compile the
        # re-built kernels outside the timed cost/sampling phases
        t_phase = time.monotonic()
        self._update_t_sub(carries, carry_L)
        self.timings["tsub_update_s"] = time.monotonic() - t_phase
        t_phase = time.monotonic()
        carries, carry_L, key_run = warm_all_levels(carries, carry_L,
                                                    key_run)
        self.timings["compile_cost_s"] = time.monotonic() - t_phase

        # measure per-sample cost of each level kernel (the analog of the
        # reference's 10000-draw constructor timings); kernels are warm,
        # so this is pure device sampling work and its recorded samples
        # count toward the targets
        t_cost0 = time.monotonic()
        self.cost_per_sample = []
        for ell in range(L):
            c = carry_L if ell == L - 1 else carries[ell]
            n_probe = self.chunk_size
            t0 = time.monotonic()
            c, key_run = run_level(ell, c, n_probe, key_run)
            per = (time.monotonic() - t0) / (n_probe * n_chains)
            self.cost_per_sample.append(per * 1e6)   # micro-seconds
            if ell == L - 1:
                carry_L = c
            else:
                carries[ell] = c

        self.timings["cost_measure_s"] = time.monotonic() - t_cost0

        # adaptive loop (montecarlomultilevel.cc:113-169)
        two_eps_inv2 = 2.0 / (self.epsilon * self.epsilon)
        n_target = [self.n_min_samples_qoi] * L
        if self.n_samples > 0:
            n_target = [self.n_samples] * L
        # the sampling window, named for profiler traces (zero cost
        # when no profiler is running)
        with jax.profiler.TraceAnnotation("mlmc_sampling"):
            while True:
                for ell in range(L - 1, -1, -1):
                    c = carry_L if ell == L - 1 else carries[ell]
                    st_y = c[1] if ell == L - 1 else c[2]
                    have = self.stats_qoi[ell].samples(st_y)
                    want = n_target[ell]
                    if have < want:
                        n_more = -(-(want - have) // n_chains)
                        c, key_run = run_level(ell, c, n_more, key_run)
                        if ell == L - 1:
                            carry_L = c
                        else:
                            carries[ell] = c
                if self.n_samples > 0:
                    # fixed per-level target: one pass fills every level
                    # exactly; the adaptive re-estimation below (tau / V /
                    # cost getters, t_sub refresh) is allocation machinery
                    # the fixed-target run does not consume — skipping it
                    # keeps the sampling phase free of host round-trips
                    break
                self._update_t_sub(carries, carry_L)
                # recompute targets from variances, tau and costs
                V = [];  tau = [];  C_eff = []
                for ell in range(L):
                    c = carry_L if ell == L - 1 else carries[ell]
                    st_y = c[1] if ell == L - 1 else c[2]
                    V.append(max(self.stats_qoi[ell].variance(st_y), 0.0))
                    t = self.stats_qoi[ell].tau_int(st_y)
                    if self.stats_qoi[ell].window_capped(st_y):
                        # windowed tau is a lower bound: cross-check with the
                        # binning estimate so the allocation does not
                        # undersample a slowly-decorrelating level
                        t = max(t, self._tau_binning_level(ell))
                    tau.append(t)
                    C_eff.append(math.ceil(tau[ell]) * self.cost_per_sample[ell])
                S = sum(math.sqrt(v * c) for v, c in zip(V, C_eff))
                n_target = [
                    max(self.n_min_samples_qoi,
                        math.ceil(two_eps_inv2 * S
                                  * math.sqrt(V[ell] / max(C_eff[ell], 1e-12))
                                  * tau[ell]))
                    for ell in range(L)]
                ok = True
                for ell in range(L):
                    c = carry_L if ell == L - 1 else carries[ell]
                    st_y = c[1] if ell == L - 1 else c[2]
                    ok = ok and (self.stats_qoi[ell].samples(st_y)
                                 >= n_target[ell])
                if ok:
                    break
        self.n_target = n_target
        self.elapsed_s = time.monotonic() - t_start
        self.timings["sampling_s"] = (self.elapsed_s
                                      - sum(self.timings.values()))

        stats = []
        for ell in range(L):
            c = carry_L if ell == L - 1 else carries[ell]
            stats.append(c[1] if ell == L - 1 else c[2])
        self._final_stats = stats
        #: learned slow-mode (plaquette-energy) tau per fused level —
        #: the quantity the t_sub clock ran on (diagnostic; None on
        #: unfused levels, whose clock is the sampler's
        #: subsample_observable)
        self.tau_slow = []
        for ell in range(L):
            if self.fused is None:
                self.tau_slow.append(None)
                continue
            c = carry_L if ell == L - 1 else carries[ell]
            st_sl = c[3] if ell == L - 1 else c[4]
            self.tau_slow.append(self.stats_slow[ell].tau_int(st_sl))
        self.reliability = self._assess_reliability(stats)
        return stats

    # -------------------------------------------------------------------------

    def _reset_ybar(self, L: int):
        import numpy as np
        self._ybar_history = [[] for _ in range(L)]
        #: per-level (concatenated float64 host series, #chunks consumed)
        self._ybar_cache = [(np.empty(0), 0) for _ in range(L)]

    def _tau_binning_level(self, ell) -> float:
        """Binning tau estimate for level ell's recorded Y series (the
        per-step cross-chain means collected by run_level).

        The host-side series is cached incrementally: only chunks
        appended since the last call are transferred and concatenated,
        and their device buffers are released — the adaptive loop calls
        this every round for every window-capped level, so re-pulling
        the full history each time was O(rounds x samples) device-to-host
        traffic."""
        import numpy as np
        hist = self._ybar_history[ell]
        cache, used = self._ybar_cache[ell]
        if len(hist) > used:
            new = [np.asarray(h, np.float64) for h in hist[used:]]
            parts = ([cache] if cache.size else []) + new
            cache = np.concatenate(parts)
            # release the consumed device buffers (keep list length so
            # `used` stays a valid index)
            for i in range(used, len(hist)):
                hist[i] = None
            self._ybar_cache[ell] = (cache, len(hist))
        if cache.size == 0:
            return 1.0
        return stats_mod.tau_binning(cache)

    def _assess_reliability(self, stats):
        """Per-level reliability report: surface
        window_capped and a binning cross-check of tau so a
        confident-but-wrong estimate flags itself instead of quoting a
        tight error bar with an underestimated tau (the committed r3
        64x64 fixed-beta study failed exactly this way, 17.9 sigma off
        with window-capped tau; cf. statistics.cc:82-90 which caps
        silently).  A level is flagged when its windowed tau is capped
        AND the binning estimate exceeds it by >1.5x."""
        out = []
        for ell in range(self.n_level):
            st_y = stats[ell]
            capped = self.stats_qoi[ell].window_capped(st_y)
            tau_w = self.stats_qoi[ell].tau_int(st_y)
            tau_b = self._tau_binning_level(ell) if capped else None
            tau_eff = max(tau_w, tau_b) if tau_b is not None else tau_w
            out.append({
                "level": ell,
                "window_capped": bool(capped),
                "tau_int": float(tau_w),
                "tau_binning": (None if tau_b is None else float(tau_b)),
                "tau_eff": float(tau_eff),
                "flagged": bool(capped and tau_eff > 1.5 * tau_w),
            })
        return out

    @property
    def reliable(self) -> bool:
        """False when any level's tau_int is window-capped and the
        binning cross-check says it is substantially underestimated —
        the reported statistical_error is then too small."""
        rel = getattr(self, "reliability", None)
        return rel is None or not any(r["flagged"] for r in rel)

    def statistical_error_robust(self, stats=None) -> float:
        """Statistical error with each level's tau replaced by
        max(windowed, binning) — an upper-bound error bar that stays
        honest when the autocorrelation window saturates."""
        explicit = stats is not None
        stats = stats if explicit else self._final_stats
        # the cached reliability was computed for _final_stats; an
        # explicit stats argument needs its own assessment or tau_eff
        # would come from mismatched statistics
        rel = (self._assess_reliability(stats) if explicit
               else getattr(self, "reliability", None)
               or self._assess_reliability(stats))
        tot = 0.0
        for ell in range(self.n_level):
            n = self.stats_qoi[ell].samples(stats[ell])
            if n == 0:
                return float("inf")
            v = max(self.stats_qoi[ell].variance(stats[ell]), 0.0)
            tot += rel[ell]["tau_eff"] * v / n
        return math.sqrt(tot)

    def numerical_result(self, stats=None) -> float:
        stats = stats if stats is not None else self._final_stats
        return sum(self.stats_qoi[ell].average(stats[ell])
                   for ell in range(self.n_level))

    def statistical_error(self, stats=None) -> float:
        stats = stats if stats is not None else self._final_stats
        return math.sqrt(sum(self.stats_qoi[ell].error(stats[ell]) ** 2
                             for ell in range(self.n_level)))

    def show_statistics(self, stats=None):
        stats = stats if stats is not None else self._final_stats
        print(f" Q: Avg +/- Err = {self.numerical_result(stats):.6f} "
              f"+/- {self.statistical_error(stats):.6f}")
        print(f" [timer MultilevelMC] : {self.elapsed_s:.4f} s")

    def show_detailed_statistics(self, stats=None):
        stats = stats if stats is not None else self._final_stats
        print("=== Statistics of QoI ===")
        for ell in range(self.n_level):
            print(f"level = {ell}")
            print(self.stats_qoi[ell].summary(stats[ell]))
            print(f" target number of samples = {self.n_target[ell]}")
            print(f" cost per sample          = "
                  f"{self.cost_per_sample[ell]:.3f} mu s")
            print("------------------------------------")
