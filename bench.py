"""Benchmark: effective samples/sec of the chain engine on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

The HEADLINE is the BASELINE.json north star: full multilevel (MLMC)
Schwinger susceptibility on the 8x8 beta=4 nonperturbative config,
1/tau_int-weighted effective samples/sec, compared against the REAL
reference C++ build (baselines/ref_baselines.json, produced by
baselines/run_ref_baselines.py from the binaries built by
baselines/build_reference.sh).  The reference MLMC number is serial by
construction — driver_qft aborts the multilevel method under MPI
(driver_qft.cc:412-416) — so it is NOT core-scaled.

Secondary benchmarks (reported in detail, each with its own real-C++
vs_baseline, core-scaled where the reference parallelises):
  * schwinger heat-bath chain (XLA and fused CUDA variants)
  * batched HMC on the M=64 harmonic oscillator

A run needs a GPU and exits non-zero without one; ``BENCH_CPU=1`` asks
for a CPU run explicitly (tests only: it skips the CUDA cells and its
numbers are not device numbers).  A cell that fails is named under
"errors" in the last line and the run exits non-zero.  Every row set is
stamped with the platform, device kind, device count, card name and
power limit.
"""

import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax

from mlmcpathintegral.utils.compile_cache import enable_compile_cache


def _setup_backend() -> str:
    """'gpu', or 'cpu' when BENCH_CPU asks for it; no GPU otherwise is an
    error — the benchmark never falls back to the CPU on its own."""
    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
        return "cpu"
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found '{platform}' "
                         f"(set BENCH_CPU=1 for an explicit CPU run)")
    return "gpu"


def _device_record() -> dict:
    """Where the numbers come from: JAX's view of the device plus the
    card's name and power limit from nvidia-smi (None on CPU runs)."""
    dev = jax.devices()[0]
    card = None
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


# the MC acceptance ratios need full f32 in every matrix product: TF32
# (the GPU default for f32 operands) keeps ~3 decimal digits, the same
# hazard that biased a reduced-precision GFF screen ~9 sigma
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

REPO = Path(__file__).resolve().parent


def _load_baseline(name):
    f = REPO / "baselines" / name
    if f.exists():
        return json.loads(f.read_text())
    return None


def _ncores():
    f = REPO / "baselines" / "ncores.txt"
    return int(f.read_text()) if f.exists() else 1


def _xla_cost(jitted, *args):
    """XLA's own flops/bytes estimate for one call of a jitted program."""
    try:
        c = jitted.lower(*args).compile().cost_analysis()
        if isinstance(c, list):
            c = c[0] if c else {}
        return {"flops": float(c.get("flops", 0.0)),
                "bytes": float(c.get("bytes accessed", 0.0))}
    except Exception:
        return None


def _xla_rates(cost, wall_per_chunk):
    """Achieved rates of one jitted chunk from XLA's cost model (no peak
    table yet: shares of the device's roofline are not reported)."""
    if not cost or not cost["flops"]:
        return None
    per_s = 1.0 / wall_per_chunk
    return {"xla_flops_per_chunk": cost["flops"],
            "xla_bytes_per_chunk": cost["bytes"],
            "flops_per_sec": round(cost["flops"] * per_s, 1),
            "hbm_gbps": round(cost["bytes"] * per_s / 1e9, 3)}


def _ref_eff(run: str, core_scaled: bool):
    """Effective-samples/s of one real-reference run
    (baselines/ref_baselines.json), optionally scaled by the host core
    count (the aggregate throughput of an MPI run on this machine —
    valid only for methods the reference parallelises)."""
    data = _load_baseline("ref_baselines.json")
    if not data:
        return None
    eff = data.get("runs", {}).get(run, {}).get("eff_samples_per_sec")
    if eff is None:
        return None
    return eff * (_ncores() if core_scaled else 1)


def bench_harmonic():
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.models import HarmonicOscillatorAction
    from mlmcpathintegral.qoi import qoi_x_squared
    from mlmcpathintegral.samplers import HMCSampler
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics

    M, C, NT = 64, 8192, 20
    dtype = jnp.float32
    lat = Lattice1D(M_lat=M, T_final=4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=NT, dt=0.1, n_burnin=50, unroll=4)
    qoi = qoi_x_squared(lat)
    stats = Statistics("Q", 40)

    key = jax.random.PRNGKey(0)
    k_prep, k_run = jax.random.split(key)
    sstate = sampler.prepare(k_prep, C, dtype)
    STEPS = 64

    @jax.jit
    def chunk(key, sstate, stats_state):
        def body(carry, k):
            ss, st = carry
            ss, acc = sampler.draw(k, ss)
            st = stats_mod.record(st, qoi(ss.x))
            return (ss, st), jnp.sum(acc)
        keys = jax.random.split(key, STEPS)
        (ss, st), acc = jax.lax.scan(body, (sstate, stats_state), keys)
        return ss, st, jnp.sum(acc)

    stats_state = stats.init(C, dtype)
    k_run, sub = jax.random.split(k_run)
    sstate, stats_state, _ = chunk(sub, sstate, stats_state)   # warm-up
    jax.block_until_ready(stats_state)
    stats_state = stats_mod.soft_reset(stats_state)

    n_chunks = 8
    t0 = time.monotonic()
    for _ in range(n_chunks):
        k_run, sub = jax.random.split(k_run)
        sstate, stats_state, _ = chunk(sub, sstate, stats_state)
    jax.block_until_ready(stats_state)
    wall = time.monotonic() - t0
    n_samples = n_chunks * STEPS * C
    tau = stats.tau_int(stats_state)
    eff = n_samples / wall / tau
    base = _ref_eff("harmonic_hmc", core_scaled=True)
    vs = eff / base if base else None
    roofline = _xla_rates(_xla_cost(chunk, sub, sstate, stats_state),
                          wall / n_chunks)
    return {
        "bench": "hmc_harmonic", "M": M, "n_chains": C, "nt": NT,
        "samples_per_sec": round(n_samples / wall, 1),
        "tau_int": round(tau, 3),
        "avg_x2": round(stats.average(stats_state), 5),
        "oracle_x2": round(action.Xsquared_analytical(), 5),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(vs, 2) if vs else None,
        "roofline": roofline,
    }


def bench_schwinger_fused():
    """The same chain as bench_schwinger on the sampler's fused CUDA sweep
    chain (``OverrelaxedHeatBathSampler(fused="cuda").draw_chain``): the
    link field stays in shared memory across all STEPS draws of a launch
    and only the per-step topological sums leave the chip."""
    import numpy as np

    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    from mlmcpathintegral.samplers.heatbath import HeatBathState
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics

    Mt, Mx, BETA, C = 8, 8, 4.0, 4096
    dtype = jnp.float32
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    action = QuenchedSchwingerAction(lat, beta=BETA)
    sampler = OverrelaxedHeatBathSampler(action, n_sweep_heatbath=1,
                                         n_sweep_overrelax=1, n_burnin=100,
                                         fused="cuda")
    stats = Statistics("chit", 40)
    FOUR_PI2_INV = 1.0 / (4.0 * np.pi ** 2)

    key = jax.random.PRNGKey(1)
    k_prep, k_run = jax.random.split(key)
    x = sampler.prepare(k_prep, C, dtype).x
    STEPS = 256

    @jax.jit
    def chunk(key, x, stats_state):
        st, qsum = sampler.draw_chain(key, HeatBathState(x=x), STEPS)
        y = FOUR_PI2_INV * qsum * qsum          # [STEPS, C] QoI trace
        return st.x, stats_mod.record_many(stats_state, y)

    stats_state = stats.init(C, dtype)
    k_run, sub = jax.random.split(k_run)
    x, stats_state = chunk(sub, x, stats_state)   # warm-up
    jax.block_until_ready(stats_state)
    stats_state = stats_mod.soft_reset(stats_state)

    n_chunks = 8
    t0 = time.monotonic()
    for _ in range(n_chunks):
        k_run, sub = jax.random.split(k_run)
        x, stats_state = chunk(sub, x, stats_state)
    jax.block_until_ready(stats_state)
    wall = time.monotonic() - t0
    n_samples = n_chunks * STEPS * C
    tau = stats.tau_int(stats_state)
    eff = n_samples / wall / tau
    base = _ref_eff("schwinger_heatbath", core_scaled=True)
    vs = eff / base if base else None
    # one jax.profiler trace artifact of a single chunk
    trace_dir = REPO / "bench_profile" / "schwinger_fused"
    k_run, sub = jax.random.split(k_run)
    with jax.profiler.trace(str(trace_dir)):
        jax.block_until_ready(chunk(sub, x, stats_state))
    return {
        "bench": "schwinger_heatbath_fused", "Mt": Mt, "Mx": Mx,
        "beta": BETA, "n_chains": C, "steps_per_launch": STEPS,
        "samples_per_sec": round(n_samples / wall, 1),
        "link_updates_per_sec": round(2 * Mt * Mx * n_samples / wall, 1),
        "tau_int": round(tau, 3),
        "avg_chit": round(stats.average(stats_state), 5),
        "oracle_chit": round(action.chit_exact(), 5),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(vs, 2) if vs else None,
        "profile_trace": str(trace_dir),
    }


def bench_schwinger():
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics

    Mt, Mx, BETA, C = 8, 8, 4.0, 4096
    dtype = jnp.float32
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    action = QuenchedSchwingerAction(lat, beta=BETA)
    sampler = OverrelaxedHeatBathSampler(action, n_sweep_heatbath=1,
                                         n_sweep_overrelax=1, n_burnin=100)
    qoi = qoi_2d_susceptibility(action)
    stats = Statistics("chit", 40)

    key = jax.random.PRNGKey(1)
    k_prep, k_run = jax.random.split(key)
    sstate = sampler.prepare(k_prep, C, dtype)
    STEPS = 32

    @jax.jit
    def chunk(key, sstate, stats_state):
        def body(carry, k):
            ss, st = carry
            ss, _ = sampler.draw(k, ss)
            st = stats_mod.record(st, qoi(ss.x))
            return (ss, st), None
        keys = jax.random.split(key, STEPS)
        (ss, st), _ = jax.lax.scan(body, (sstate, stats_state), keys)
        return ss, st

    stats_state = stats.init(C, dtype)
    k_run, sub = jax.random.split(k_run)
    sstate, stats_state = chunk(sub, sstate, stats_state)   # warm-up
    jax.block_until_ready(stats_state)
    stats_state = stats_mod.soft_reset(stats_state)

    n_chunks = 8
    t0 = time.monotonic()
    for _ in range(n_chunks):
        k_run, sub = jax.random.split(k_run)
        sstate, stats_state = chunk(sub, sstate, stats_state)
    jax.block_until_ready(stats_state)
    wall = time.monotonic() - t0
    n_samples = n_chunks * STEPS * C
    tau = stats.tau_int(stats_state)
    eff = n_samples / wall / tau
    base = _ref_eff("schwinger_heatbath", core_scaled=True)
    vs = eff / base if base else None
    # achieved rates from XLA's own cost model for the jitted chunk
    roofline = _xla_rates(_xla_cost(chunk, sub, sstate, stats_state),
                          wall / n_chunks)
    return {
        "bench": "schwinger_heatbath",
        "Mt": Mt, "Mx": Mx, "beta": BETA,
        "n_chains": C,
        "samples_per_sec": round(n_samples / wall, 1),
        "tau_int": round(tau, 3),
        "avg_chit": round(stats.average(stats_state), 5),
        "oracle_chit": round(action.chit_exact(), 5),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(vs, 2) if vs else None,
        "roofline": roofline,
    }


def bench_schwinger_mlmc(fused: bool, n_samples: int = 100_000,
                         n_chains: int = 1024, chunk_size: int = 64,
                         n_repeat: int = 1, coarse: str = "heatbath"):
    """Full multilevel Schwinger susceptibility — the BASELINE.json
    north-star configuration (matches baselines/configs/
    ref_qft_schwinger_mlmc.in): estimate vs analytic oracle, wall-clock,
    per-level costs, and eff samples/s vs the real reference MLMC run."""
    from mlmcpathintegral.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.mc import MonteCarloMultiLevel
    from mlmcpathintegral.models.base import RenormalisationType
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.samplers import (
        OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    )

    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(
        lat, beta=4.0, renormalisation=RenormalisationType.NONPERTURBATIVE)
    C, N_SAMPLES = n_chains, n_samples
    if coarse == "cluster":
        # the hybrid cluster+mix sampler (the reference config's
        # coarsesampler='cluster' analog, unbiased since round 4); runs
        # the unfused XLA path because fusing would override the sampler
        factory = lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5)
    else:
        # heat-bath coarse chains run IN-KERNEL in the fused path (the
        # headline);
        # effective samples/s is decorrelation-normalised, so comparing
        # against the reference's cluster-coarse run stays meaningful
        factory = lambda a: OverrelaxedHeatBathSampler(
            a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=100)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=N_SAMPLES,
        chunk_size=(256 if fused else chunk_size),
        fused="cuda" if fused and coarse == "heatbath" else None)
    runs = []
    base = _ref_eff("schwinger_mlmc", core_scaled=False)
    oracle = act.chit_exact()
    for rep in range(n_repeat):
        stats = mc.evaluate(jax.random.PRNGKey(2 + rep), n_chains=C,
                            dtype=jnp.float32)
        num = mc.numerical_result()
        err = mc.statistical_error()
        tau0 = mc.stats_qoi[0].tau_int(stats[0])
        n0 = mc.stats_qoi[0].samples(stats[0])
        wall = mc.elapsed_s
        sampling = max(mc.timings["sampling_s"], 1e-9)
        # the method wall is the per-level sampling work (cost-probe
        # chunks record real samples, so they are part of it) — the SAME
        # scope as the reference number: ref_baselines.json
        # schwinger_mlmc eff uses the per-level cost breakdown total,
        # which excludes burn-in and constructor self-timing
        # (montecarlomultilevel.cc:207-252, run_ref_baselines.py:105-110).
        # JIT compile phases are excluded like the reference's cmake
        # build; they are reported per phase in "timings".
        method_wall = max(mc.timings["cost_measure_s"] + sampling, 1e-9)
        eff = n0 / (tau0 * method_wall)
        runs.append({
            "chit": round(num, 5), "err": round(err, 5),
            "sigma_dev": round(abs(num - oracle) / err, 2),
            "tau_int_Y0": round(tau0, 3),
            "t_sub": list(mc._t_sub),
            "tau_slow": [None if t is None else round(t, 3)
                         for t in getattr(mc, "tau_slow", [])],
            "wall_s": round(wall, 2),
            "method_wall_s": round(method_wall, 3),
            "timings": {k: round(v, 2) for k, v in mc.timings.items()},
            "cost_per_sample_us": [round(c, 3)
                                   for c in mc.cost_per_sample],
            "sampling_samples_per_sec": round(2 * N_SAMPLES / sampling, 1),
            "eff_samples_per_sec": round(eff, 1),
            "eff_samples_per_sec_incl_all_phases": round(
                n0 / (tau0 * wall), 1),
        })
    effs = sorted(r["eff_samples_per_sec"] for r in runs)
    med = effs[len(effs) // 2]
    worst_sigma = max(r["sigma_dev"] for r in runs)
    return {
        "bench": ("schwinger_mlmc_fused" if fused
                  else "schwinger_mlmc") + (
                      "_cluster" if coarse == "cluster" else ""),
        "coarse_sampler": coarse,
        "Mt": 8, "Mx": 8, "beta": 4.0,
        "n_level": 2, "n_chains": C, "n_samples_per_level": N_SAMPLES,
        "eff_samples_per_sec": med,
        "eff_median": med, "eff_min": effs[0], "eff_max": effs[-1],
        "n_runs": len(effs),
        "chit": runs[-1]["chit"], "err": runs[-1]["err"],
        "oracle_chit": round(oracle, 5),
        "sigma_dev": worst_sigma,
        "vs_baseline": round(med / base, 2) if base else None,
        "runs": runs,
    }


def bench_gff_twolevel(seed: int = 4):
    """Two-level GFF <phi^2> with the hierarchical fill-in (BASELINE
    config 4, baselines/configs/ref_qft_gff_twolevel.in: 16x16 rotated
    coarsening, mass 10, heat-bath coarse sampler) vs the spectral
    oracle gff_phi_squared_analytical (driver_qft.cc:280-316);
    vs_baseline compares eff samples/s of the DIFFERENCE estimator
    against the real reference run (same formula as
    baselines/run_ref_baselines.py: n / (tau_delta * method_wall)),
    core-scaled (the reference parallelises two-level over MPI ranks,
    montecarlotwolevel.cc:62-63)."""
    from mlmcpathintegral.conditioned.gff import GFFConditionedFineAction
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.mc import MonteCarloTwoLevel
    from mlmcpathintegral.models.qft import GFFAction
    from mlmcpathintegral.qoi import qoi_2d_phi_squared
    from mlmcpathintegral.samplers import ExactSampler

    C = 4096
    lat = Lattice2D(16, 16, CoarseningType.ROTATE)
    act = GFFAction(lat, mass=10.0)
    # coarse proposals from the EXACT smoothed-GFF sampler (the
    # reference supports sampler='exact' for the GFF too,
    # gffaction.hh:356-375): tau_int = 1 by construction and the dense
    # rotated draw is one matrix product — no heat-bath chain to subsample
    mc = MonteCarloTwoLevel(
        act, qoi_2d_phi_squared,
        coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=GFFConditionedFineAction,
        n_burnin=100, n_samples=1600 * C, chunk_size=256,
        n_autocorr_window=40, n_coarse_autocorr_window=40,
        n_fine_autocorr_window=40, n_delta_autocorr_window=40)
    # warm the jit cache so the measured run is the method, not XLA
    mc.n_samples, real_n = 2 * C, mc.n_samples
    mc.evaluate_difference(jax.random.PRNGKey(seed), n_chains=C,
                           dtype=jnp.float32)
    mc.n_samples = real_n
    stats = mc.evaluate_difference(jax.random.PRNGKey(seed + 1), n_chains=C,
                                   dtype=jnp.float32)
    # sampling-phase wall: the same scope as the reference eff number
    # (run_ref_baselines.py method_wall_est_s excludes the constructor
    # self-timing and burn-in from the C++ total)
    wall = mc.timings["sampling_s"]
    fine_avg = mc.stats_fine.average(stats["fine"])
    fine_err = mc.stats_fine.error(stats["fine"])
    oracle = act.phi_squared_analytical()
    n_diff = mc.stats_diff.samples(stats["diff"])
    tau_d = mc.stats_diff.tau_int(stats["diff"])
    eff = n_diff / (tau_d * wall)
    base = _ref_eff("gff_twolevel", core_scaled=True)
    return {
        "bench": "gff_twolevel", "Mt": 16, "Mx": 16, "mass": 10.0,
        "coarsening": "rotate", "n_chains": C, "seed": seed,
        "avg_phi2": round(fine_avg, 6), "err": round(fine_err, 6),
        "oracle_phi2": round(oracle, 6),
        "sigma_dev": round(abs(fine_avg - oracle) / fine_err, 2),
        "delta_var_over_fine_var": round(
            mc.stats_diff.variance(stats["diff"])
            / mc.stats_fine.variance(stats["fine"]), 4),
        "p_accept": round(mc.p_accept, 4),
        "tau_int_delta": round(tau_d, 3),
        "t_indep": round(mc.t_indep, 2),
        "wall_s": round(wall, 2),
        "wall_total_s": round(mc.elapsed_s, 2),
        "timings": {k: round(v, 2) for k, v in mc.timings.items()},
        "samples_per_sec": round(n_diff / wall, 1),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(eff / base, 2) if base else None,
    }


def _median_of_seeds(fn, seeds):
    """Run fn(seed) per seed; return the median-by-eff row annotated with
    the per-seed spread."""
    runs = sorted((fn(s) for s in seeds),
                  key=lambda r: r["eff_samples_per_sec"])
    med = dict(runs[len(runs) // 2])
    med["eff_min_max"] = [runs[0]["eff_samples_per_sec"],
                          runs[-1]["eff_samples_per_sec"]]
    devs = [r.get("sigma_dev") for r in runs]
    med["sigma_dev_seeds"] = devs
    if all(d is not None for d in devs):
        med["sigma_dev"] = max(devs)
    med["n_runs"] = len(runs)
    return med


def bench_quartic_twolevel(seed: int = 14):
    """Two-level double-well Y = Q_f - Q_c diagnostic (BASELINE config 2,
    baselines/configs/ref_qm_quartic_twolevel.in: M=64, T=4, m0=mu2=
    lambda=x0=1, HMC coarse sampler) vs the real reference run
    (quartic_twolevel baseline, driver_qm.cc two-level path).  No closed
    form exists for the double well; the oracle is the C++ run's own
    fine-level <x^2> (montecarlotwolevel.cc:38-94), compared in combined
    sigma units.  eff = n_diff / (tau_delta * wall), core-scaled like the
    other two-level rows (the reference splits two-level samples over
    MPI ranks, montecarlotwolevel.cc:62-63)."""
    from mlmcpathintegral.conditioned import make_conditioned_fine_action
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.mc import MonteCarloTwoLevel
    from mlmcpathintegral.models import (
        QuarticOscillatorAction, RenormalisationType,
    )
    from mlmcpathintegral.qoi import qoi_x_squared
    from mlmcpathintegral.samplers import HMCSampler

    C = 4096
    lat = Lattice1D(M_lat=64, T_final=4.0)
    act = QuarticOscillatorAction(lat, RenormalisationType.NONE,
                                  m0=1.0, mu2=1.0, lam=1.0, x0=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(
            a, nt=100, dt=0.1, n_burnin=100, unroll=4),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=100, n_samples=256 * C, chunk_size=64,
        n_autocorr_window=40, n_coarse_autocorr_window=40,
        n_fine_autocorr_window=40, n_delta_autocorr_window=40)
    # warm the jit cache so the measured run is the method, not XLA
    mc.n_samples, real_n = C, mc.n_samples
    mc.evaluate_difference(jax.random.PRNGKey(seed), n_chains=C,
                           dtype=jnp.float32)
    mc.n_samples = real_n
    stats = mc.evaluate_difference(jax.random.PRNGKey(seed + 1), n_chains=C,
                                   dtype=jnp.float32)
    # sampling-phase wall (same scope as the C++ method_wall_est_s —
    # see bench_gff_twolevel)
    wall = mc.timings["sampling_s"]
    fine_avg = mc.stats_fine.average(stats["fine"])
    fine_err = mc.stats_fine.error(stats["fine"])
    n_diff = mc.stats_diff.samples(stats["diff"])
    tau_d = mc.stats_diff.tau_int(stats["diff"])
    eff = n_diff / (tau_d * wall)
    base = _ref_eff("quartic_twolevel", core_scaled=True)
    ref = (_load_baseline("ref_baselines.json") or {}).get(
        "runs", {}).get("quartic_twolevel", {})
    ref_avg = ref.get("fine", {}).get("avg")
    ref_err = ref.get("fine", {}).get("avg_err", 0.0)
    sigma = (abs(fine_avg - ref_avg) / math.hypot(fine_err, ref_err)
             if ref_avg is not None else None)
    return {
        "bench": "quartic_twolevel", "M": 64, "n_chains": C, "seed": seed,
        "avg_x2": round(fine_avg, 6), "err": round(fine_err, 6),
        "ref_cpp_x2": ref_avg,
        "sigma_dev": round(sigma, 2) if sigma is not None else None,
        "delta_avg": round(mc.stats_diff.average(stats["diff"]), 6),
        "delta_var_over_fine_var": round(
            mc.stats_diff.variance(stats["diff"])
            / mc.stats_fine.variance(stats["fine"]), 4),
        "p_accept": round(mc.p_accept, 4),
        "tau_int_delta": round(tau_d, 3),
        "t_indep": round(mc.t_indep, 2),
        "wall_s": round(wall, 2),
        "wall_total_s": round(mc.elapsed_s, 2),
        "timings": {k: round(v, 2) for k, v in mc.timings.items()},
        "samples_per_sec": round(n_diff / wall, 1),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(eff / base, 2) if base else None,
    }


def bench_rotor_cluster_M(M: int, n_chains: int = 4096,
                          n_updates: int = 10, seed: int = 3):
    """Topological rotor chi_t with the vectorised Wolff cluster sampler
    (the reference's algorithm for this model — flat tau_int in a,
    clustersampler.cc:92-132; r2 shipped a heat-bath chain with tau=34.7
    instead, VERDICT r2 item 5).  Matches the baseline runs' physics AND
    cluster count (baselines/logs/rotor_cluster_M*.in: T=4, m0=0.25,
    n_updates=10 — r3 ran n_updates=5, leaving tau_int ~20% above the
    reference's 1.05-1.13; VERDICT r3 item 8)."""
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.models.rotor import RotorAction
    from mlmcpathintegral.qoi import qoi_susceptibility
    from mlmcpathintegral.samplers import ClusterSampler
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics

    C = n_chains
    dtype = jnp.float32
    lat = Lattice1D(M_lat=M, T_final=4.0)
    action = RotorAction(lat, m0=0.25)
    sampler = ClusterSampler(action, n_burnin=100, n_updates=n_updates,
                             vectorised=True)
    qoi = qoi_susceptibility(action)
    stats = Statistics("chit", 40)
    key = jax.random.PRNGKey(seed)
    k_prep, k_run = jax.random.split(key)
    STEPS = 128

    sstate = jax.jit(lambda k: sampler.prepare(k, C, dtype))(k_prep)

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def chunk(key, sstate, stats_state):
        def body(carry, k):
            ss, st = carry
            ss, _ = sampler.draw(k, ss)
            return (ss, stats_mod.record(st, qoi(ss.x))), None
        keys = jax.random.split(key, STEPS)
        (ss, st), _ = jax.lax.scan(body, (sstate, stats_state), keys)
        return ss, st

    stats_state = stats.init(C, dtype)
    k_run, sub = jax.random.split(k_run)
    sstate, stats_state = chunk(sub, sstate, stats_state)   # warm-up
    jax.block_until_ready(stats_state)
    stats_state = stats_mod.soft_reset(stats_state)

    n_chunks = 8
    t0 = time.monotonic()
    for _ in range(n_chunks):
        k_run, sub = jax.random.split(k_run)
        sstate, stats_state = chunk(sub, sstate, stats_state)
    jax.block_until_ready(stats_state)
    wall = time.monotonic() - t0
    n_samples = n_chunks * STEPS * C
    tau = stats.tau_int(stats_state)
    eff = n_samples / wall / tau
    avg = stats.average(stats_state)
    oracle = action.chit_exact()
    err = stats.error(stats_state)
    base = _ref_eff(f"rotor_cluster_M{M}", core_scaled=True)
    return {
        "bench": "rotor_cluster_vec",
        "M": M, "n_chains": C,
        "n_updates": n_updates, "seed": seed,
        "samples_per_sec": round(n_samples / wall, 1),
        "tau_int": round(tau, 3),
        "avg_chit": round(avg, 5),
        "err": round(err, 5),
        "oracle_chit": round(oracle, 5),
        "sigma_dev": round(abs(avg - oracle) / err, 2),
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(eff / base, 2) if base else None,
    }


def bench_rotor():
    """Rotor chi_t across M = 64/128/256 with the cluster sampler, each
    size vs its own reference baseline (rotor_cluster_M64/128/256).
    Per size the row is the median-of-3-seeds by effective throughput
   ; sigma_dev is the worst across the reported rows and
    headline vs_baseline the minimum across sizes.  An n_updates=5
    single-seed sensitivity row per size documents the tau/cost
    trade-off against the reference's n_updates=10."""
    rows = []
    for M in (64, 128, 256):
        runs = sorted((bench_rotor_cluster_M(M, seed=s)
                       for s in (3, 17, 29)),
                      key=lambda r: r["eff_samples_per_sec"])
        med = dict(runs[1])
        med["eff_min_max"] = [runs[0]["eff_samples_per_sec"],
                              runs[-1]["eff_samples_per_sec"]]
        med["sigma_dev_seeds"] = [r["sigma_dev"] for r in runs]
        med["tau_int_seeds"] = [r["tau_int"] for r in runs]
        rows.append(med)
    sens = [bench_rotor_cluster_M(M, n_updates=5) for M in (64, 128, 256)]
    vs = [r["vs_baseline"] for r in rows if r["vs_baseline"]]
    return {
        "bench": "rotor_cluster_vec_M64_128_256",
        "tau_int": [r["tau_int"] for r in rows],
        "sigma_dev": max(max(r["sigma_dev_seeds"]) for r in rows),
        "eff_samples_per_sec": min(r["eff_samples_per_sec"] for r in rows),
        "vs_baseline": round(min(vs), 2) if vs else None,
        "sizes": rows,
        "n_updates_sensitivity": sens,
    }


def bench_sigma_heatbath_seed(seed: int = 6):
    """O(3) nonlinear sigma model magnetic susceptibility with the
    overrelaxed heat-bath sampler (BASELINE config 7,
    baselines/configs/ref_qft_sigma_heatbath.in: 16x16 rotate, beta=1.5)
    — the reference's first-class driver_qft model
    (driver_qft.cc:241-246, heat-bath nonlinearsigmaaction.cc:24-73).
    No closed-form oracle exists for O(3): the gate compares against the
    real C++ run's own <chi_m> in combined sigma units (the quartic-row
    protocol).  eff = samples / (tau * wall), core-scaled (the reference
    parallelises single-level over MPI ranks)."""
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.qft.nonlinearsigma import (
        NonlinearSigmaAction, qoi_magnetic_susceptibility,
    )
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics

    Mt, Mx, BETA, C = 16, 16, 1.5, 4096
    dtype = jnp.float32
    lat = Lattice2D(Mt, Mx, CoarseningType.ROTATE)
    action = NonlinearSigmaAction(lat, beta=BETA)
    sampler = OverrelaxedHeatBathSampler(action, n_sweep_heatbath=1,
                                         n_sweep_overrelax=1, n_burnin=200)
    qoi_raw = qoi_magnetic_susceptibility(action)
    # record the QoI CENTERED at the C++ mean: chi_m ~ 73 +- 21 makes
    # the f32 autocorrelation accumulators (sums of x_t x_{t+k} ~ 5e3
    # per term) lose the ~4e2 covariance signal to round-off — one r5
    # pilot seed's tau_int collapsed to 0.002 exactly this way.  tau,
    # variance and error are shift-invariant; the mean is shifted back.
    CENTER = 73.55
    qoi = lambda x: qoi_raw(x) - CENTER
    stats = Statistics("chi_m", 100)

    key = jax.random.PRNGKey(seed)
    k_prep, k_run = jax.random.split(key)
    sstate = jax.jit(lambda k: sampler.prepare(k, C, dtype))(k_prep)
    STEPS = 64

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def chunk(key, sstate, stats_state):
        def body(carry, k):
            ss, st = carry
            ss, _ = sampler.draw(k, ss)
            return (ss, stats_mod.record(st, qoi(ss.x))), None
        keys = jax.random.split(key, STEPS)
        (ss, st), _ = jax.lax.scan(body, (sstate, stats_state), keys)
        return ss, st

    stats_state = stats.init(C, dtype)
    k_run, sub = jax.random.split(k_run)
    sstate, stats_state = chunk(sub, sstate, stats_state)   # warm-up
    jax.block_until_ready(stats_state)
    stats_state = stats_mod.soft_reset(stats_state)

    n_chunks = 8
    t0 = time.monotonic()
    for _ in range(n_chunks):
        k_run, sub = jax.random.split(k_run)
        sstate, stats_state = chunk(sub, sstate, stats_state)
    jax.block_until_ready(stats_state)
    wall = time.monotonic() - t0
    n_samples = n_chunks * STEPS * C
    tau = stats.tau_int(stats_state)
    eff = n_samples / wall / tau
    avg = stats.average(stats_state) + CENTER
    err = stats.error(stats_state)
    base = _ref_eff("sigma_heatbath", core_scaled=True)
    ref = (_load_baseline("ref_baselines.json") or {}).get(
        "runs", {}).get("sigma_heatbath", {})
    ref_avg = ref.get("Q", {}).get("avg")
    ref_err = ref.get("Q", {}).get("avg_err", 0.0)
    sigma = (abs(avg - ref_avg) / math.hypot(err, ref_err)
             if ref_avg is not None else None)
    return {
        "bench": "sigma_heatbath", "Mt": Mt, "Mx": Mx, "beta": BETA,
        "n_chains": C, "seed": seed,
        "samples_per_sec": round(n_samples / wall, 1),
        "tau_int": round(tau, 3),
        "avg_chi_m": round(avg, 4), "err": round(err, 4),
        "ref_cpp_chi_m": ref_avg,
        "sigma_dev": round(sigma, 2) if sigma is not None else None,
        "eff_samples_per_sec": round(eff, 1),
        "vs_baseline": round(eff / base, 2) if base else None,
    }


def bench_sigma_heatbath():
    """Median-of-3 seeds (the round-4 rotor protocol) for the sigma row."""
    return _median_of_seeds(bench_sigma_heatbath_seed, (6, 16, 26))


def _gate(row):
    """Mark a benchmark row failed when it disagrees with its analytic
    oracle by more than 3 sigma: a benchmark that
    advertises its own inconsistency is not quotable."""
    if not isinstance(row, dict):
        return row
    sd = row.get("sigma_dev")
    if sd is not None and sd > 3.0:
        row["failed"] = f"sigma_dev {sd} > 3"
    return row


def _cell(errors: dict, name: str, fn, *args, **kw):
    """Run one benchmark cell.  A failure is recorded under the cell's
    name, printed in the last line and ends the run non-zero; no other
    cell's number stands in for it."""
    t0 = time.monotonic()
    try:
        row = fn(*args, **kw)
    except Exception as e:
        errors[name] = repr(e)[:300]
        row = {"error": errors[name]}
    print(f"bench: {name} {'FAILED' if name in errors else 'done'} in "
          f"{time.monotonic() - t0:.1f}s", file=sys.stderr, flush=True)
    return row


def main() -> int:
    backend = _setup_backend()
    enable_compile_cache()
    on_gpu = backend == "gpu"
    errors = {}
    # the headline runs the fused CUDA levels on the GPU (device-scale
    # sample budget, median of 3 repeats in one process: runs 2-3 are
    # compile-warm) and the XLA levels only on an explicit CPU run
    if on_gpu:
        mlmc = _cell(errors, "schwinger_mlmc", bench_schwinger_mlmc,
                     fused=True, n_samples=4_000_000, n_repeat=3)
    else:
        mlmc = _cell(errors, "schwinger_mlmc", bench_schwinger_mlmc,
                     fused=False)
    fused = (_cell(errors, "schwinger_fused", bench_schwinger_fused)
             if on_gpu else None)
    sch = _cell(errors, "schwinger", bench_schwinger)
    har = _cell(errors, "harmonic", bench_harmonic)
    rot = _cell(errors, "rotor", bench_rotor)
    gff = _cell(errors, "gff_twolevel", _median_of_seeds,
                bench_gff_twolevel, (4, 24, 44))
    qua = _cell(errors, "quartic_twolevel", _median_of_seeds,
                bench_quartic_twolevel, (14, 34, 54))
    sig = _cell(errors, "sigma_heatbath", bench_sigma_heatbath)
    # the reference config's own coarsesampler='cluster' analog: hybrid
    # cluster+mix coarse chains on the unfused path; median-of-3 like
    # every other row
    mlmc_cluster = _cell(
        errors, "schwinger_mlmc_cluster", bench_schwinger_mlmc,
        fused=False, n_samples=1_000_000 if on_gpu else 100_000,
        n_repeat=3, coarse="cluster")
    detail = {
        "device": _device_record(),
        "headline": mlmc.get("bench"),
        "schwinger_mlmc": _gate(mlmc),
        "schwinger": _gate(sch),
        "schwinger_fused": _gate(fused),
        "harmonic": _gate(har),
        "rotor": _gate(rot),
        "gff_twolevel": _gate(gff),
        "quartic_twolevel": _gate(qua),
        "sigma_heatbath": _gate(sig),
        "schwinger_mlmc_cluster": _gate(mlmc_cluster),
    }
    # full detail on disk; ONLY a compact driver-parseable line on the
    # LAST stdout line (the reference driver prints its oracle comparison
    # last too, driver_qft.cc:441-455)
    (REPO / "BENCH_detail.json").write_text(json.dumps(detail, indent=1))
    headline = {
        "metric": "mlmc_effective_samples_per_sec_per_device",
        "value": mlmc.get("eff_samples_per_sec"),
        "unit": "eff_samples/s",
        "path": "cuda" if on_gpu else "xla",
        "errors": errors,
        "vs_baseline": mlmc.get("vs_baseline"),
        "sigma_dev": mlmc.get("sigma_dev"),
        "device": detail["device"],
        "eff_median_min_max_n": [mlmc.get("eff_median"),
                                 mlmc.get("eff_min"), mlmc.get("eff_max"),
                                 mlmc.get("n_runs")],
        "secondary_vs_baseline": {
            k: (detail[k] or {}).get("vs_baseline")
            for k in ("schwinger_fused", "harmonic", "rotor",
                      "gff_twolevel", "quartic_twolevel",
                      "sigma_heatbath")},
        "detail_file": "BENCH_detail.json",
    }
    print(json.dumps(headline))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
