#!/usr/bin/env python
"""Smoke run of the main path on one NVIDIA GPU, phase by phase.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the chain-sharded path on 4 cards

Phases (one card):
  1. the fused CUDA kernels (Schwinger sweep chain, two-level chunk) vs
     their plain-JAX references and the XLA sampler, 8x8 and 64x64,
     1024 chains, float32;
  2. the CLI entry point on the shipped configs (float64, unfused XLA):
     configs/qft_schwinger_multilevel.in and configs/qft_gff_twolevel.in;
  3. the headline MLMC configuration (8x8, beta=4, 2 levels, heat-bath
     coarse chains) on the fused kernels, and again with them off;
  4. a size users run: the continuum trajectory at 64x64 (beta = 64),
     3 levels, fused.

Each phase prints its lines before the last; any failed gate or error
ends the run with a non-zero exit code.  The last line of standard output
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Without a GPU, or without the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time

ORACLE_SIGMA = 4.0
FOUR_PI2_INV = 1.0 / (4.0 * math.pi ** 2)


class GateFailed(Exception):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateFailed(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def peak_mem() -> str:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 2**30:.3f} GiB"


def report(phase: str, what: str, **fields) -> None:
    parts = [f"[{phase}] {what}"]
    parts += [f"{k}={v}" for k, v in fields.items()]
    parts.append(f"peak_device_mem={peak_mem()}")
    print("  ".join(parts), flush=True)


def wrapped_diff(a, b):
    import numpy as np
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def chain_mean_err(x):
    """Mean over steps and chains of a [steps, C] trace, with the error
    from the spread of the per-chain means (independent chains, so the
    error holds whatever the autocorrelation time)."""
    import numpy as np
    per_chain = np.asarray(x, np.float64).mean(axis=0)
    return per_chain.mean(), per_chain.std(ddof=1) / math.sqrt(
        per_chain.size)


def sigma_dev(a, ea, b, eb=0.0) -> float:
    return abs(a - b) / math.sqrt(ea * ea + eb * eb)


# --------------------------------------------------------------------------
# Phase 1: kernels vs the plain references
# --------------------------------------------------------------------------

def phase_kernels(M: int, C: int = 1024, n_chain: int = 2000,
                  n_burn: int = 1000, n_chunk: int = 64,
                  reference: bool = False) -> None:
    """The comparisons of the fused kernels with their references at an
    M x M lattice.  ``reference=True`` runs the reference in the kernel's
    place (CPU rehearsal of this function)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mlmcpathintegral.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.base import RenormalisationType
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.ops.schwinger import schwinger_sweep_chain
    from mlmcpathintegral.ops.schwinger_twolevel import (
        schwinger_twolevel_chain,
    )
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler
    from mlmcpathintegral.samplers.heatbath import HeatBathState
    from mlmcpathintegral.utils.special import mod_2pi

    f32 = jnp.float32
    tag = f"phase 1 {M}x{M} C={C}"
    seed = jnp.asarray([5, -7], jnp.int32)
    theta = jax.random.uniform(jax.random.PRNGKey(0), (C, 2 * M * M), f32,
                               -math.pi, math.pi)
    beta = 4.0
    sweep = dict(beta=beta, Mt=M, Mx=M)

    # overrelaxation only: no randomness, the same arithmetic
    t0 = time.monotonic()
    k = schwinger_sweep_chain(theta, seed, n_steps=1, n_heatbath=0,
                              reference=reference, **sweep)[0]
    r = schwinger_sweep_chain(theta, seed, n_steps=1, n_heatbath=0,
                              reference=True, **sweep)[0]
    d = float(wrapped_diff(k, r).max())
    report(tag, "sweep overrelax-only kernel vs reference",
           max_dtheta=d, limit=1e-5, wall_s=f"{time.monotonic() - t0:.3f}")
    gate(d <= 1e-5, f"{tag}: overrelax max |dtheta| {d} > 1e-5")

    # one full draw on the same seed.  A rejection test that sits within
    # rounding of its threshold may go the other way (log/cos round
    # differently on the card than in XLA), and the link then differs
    # by O(1); such flips must stay rare.
    k = schwinger_sweep_chain(theta, seed, n_steps=1, reference=reference,
                              **sweep)[0]
    r = schwinger_sweep_chain(theta, seed, n_steps=1, reference=True,
                              **sweep)[0]
    frac = float((wrapped_diff(k, r) > 1e-4).mean())
    report(tag, "sweep one draw kernel vs reference",
           frac_links_dtheta_over_1e4=frac, limit=1e-3)
    gate(frac <= 1e-3, f"{tag}: one-draw mismatch fraction {frac} > 1e-3")

    # a long chain: kernel vs the XLA heat-bath sampler vs chit_exact
    lat = Lattice2D(M, M, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=beta)
    x0 = schwinger_sweep_chain(theta, jnp.asarray([1, 2], jnp.int32),
                               n_steps=n_burn, reference=reference,
                               **sweep)[0]
    t0 = time.monotonic()
    x_k, q_k, e_k = jax.block_until_ready(schwinger_sweep_chain(
        x0, seed, n_steps=n_chain, reference=reference, **sweep))
    wall_k = time.monotonic() - t0
    smp = OverrelaxedHeatBathSampler(act)

    @jax.jit
    def xla_chain(key, x):
        def body(st, kk):
            st, _ = smp.draw(kk, st)
            P = act.plaquette_angles(st.x)
            return st, (jnp.sum(mod_2pi(P), axis=(-2, -1)),
                        jnp.sum(jnp.cos(P), axis=(-2, -1)))
        st, (q, e) = jax.lax.scan(body, HeatBathState(x=x),
                                  jax.random.split(key, n_chain))
        return q, e

    t0 = time.monotonic()
    q_x, e_x = jax.block_until_ready(xla_chain(jax.random.PRNGKey(9), x0))
    wall_x = time.monotonic() - t0
    ek, eek = chain_mean_err(e_k)
    ex, eex = chain_mean_err(e_x)
    ck, eck = chain_mean_err(FOUR_PI2_INV * np.asarray(q_k) ** 2)
    cx, ecx = chain_mean_err(FOUR_PI2_INV * np.asarray(q_x) ** 2)
    oracle = act.chit_exact()
    dev_e, dev_c = sigma_dev(ek, eek, ex, eex), sigma_dev(ck, eck, cx, ecx)
    dev_o = sigma_dev(ck, eck, oracle)
    report(tag, f"sweep chain {n_chain} steps kernel vs XLA sampler",
           plaq_energy=f"{ek:.4f}+-{eek:.4f} vs {ex:.4f}+-{eex:.4f}",
           dev_energy_sigma=f"{dev_e:.2f}",
           V_chi=f"{ck:.4f}+-{eck:.4f} vs {cx:.4f}+-{ecx:.4f}",
           dev_chi_sigma=f"{dev_c:.2f}", oracle=f"{oracle:.4f}",
           dev_oracle_sigma=f"{dev_o:.2f}",
           kernel_s=f"{wall_k:.3f}", xla_s_incl_compile=f"{wall_x:.3f}",
           kernel_sweeps_per_s=f"{n_chain * C / wall_k:.0f}")
    gate(dev_e < ORACLE_SIGMA and dev_c < ORACLE_SIGMA
         and dev_o < ORACLE_SIGMA,
         f"{tag}: sweep chain disagrees (energy {dev_e:.2f}, chi "
         f"{dev_c:.2f}, oracle {dev_o:.2f} sigma)")

    # the sampler's fused route: draw_chain is one launch of the sweep
    # chain with the seed drawn from its key, and draw is one step of it
    smp_f = OverrelaxedHeatBathSampler(
        act, fused="reference" if reference else "cuda")
    key = jax.random.PRNGKey(3)
    seed_k = jax.random.randint(key, (2,), -2**31, 2**31 - 1, jnp.int32)
    st_s, q_s = smp_f.draw_chain(key, HeatBathState(x=x0), 64)
    x_d, q_d, _ = schwinger_sweep_chain(x0, seed_k, n_steps=64,
                                        reference=reference, **sweep)
    st_1, _ = smp_f.draw(key, HeatBathState(x=x0))
    x_1 = schwinger_sweep_chain(x0, seed_k, n_steps=1, reference=reference,
                                **sweep)[0]
    same = (np.array_equal(st_s.x, x_d) and np.array_equal(q_s, q_d)
            and np.array_equal(st_1.x, x_1))
    report(tag, "sampler fused route (draw_chain, draw) vs the sweep chain",
           identical=same)
    gate(same, f"{tag}: the sampler's fused route differs from the kernel")

    # the two-level chunk from one start, kernel vs reference: the
    # headline coupling at 8x8, the continuum trajectory
    # beta = 4 (M/16)^2 beyond (the large-beta fill branch)
    beta_f = beta if M <= 8 else 4.0 * (M / 16) ** 2
    act = QuenchedSchwingerAction(
        lat, beta=beta_f,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    cact = act.coarse_action()
    cond = QuenchedSchwingerConditionedFineAction(act)
    csweep = dict(beta=cact.beta, Mt=M // 2, Mx=M // 2)
    thc = jax.random.uniform(jax.random.PRNGKey(1), (C, M * M // 2), f32,
                             -math.pi, math.pi)
    thc = schwinger_sweep_chain(thc, jnp.asarray([3, 4], jnp.int32),
                                n_steps=n_burn, reference=reference,
                                **csweep)[0]
    thf = cond.fill_fine_points(jax.random.PRNGKey(2),
                                act.prolongate(thc, jnp.zeros_like(theta)))
    sf, sq = act.evaluate(thf), cond.evaluate(thf)
    kw = dict(beta=act.beta, beta_c=cact.beta, Mt=M, Mx=M, n_steps=n_chunk,
              t_sub=8)
    t0 = time.monotonic()
    out_k = jax.block_until_ready(schwinger_twolevel_chain(
        thf, thc, sf, sq, seed, reference=reference, **kw))
    wall_k = time.monotonic() - t0
    out_r = schwinger_twolevel_chain(thf, thc, sf, sq, seed, reference=True,
                                     **kw)
    fine_k = out_k[0]
    rel_sf = float(np.max(np.abs(np.asarray(out_k[2], np.float64)
                                 - np.asarray(act.evaluate(fine_k)))
                          / np.abs(np.asarray(out_k[2], np.float64))))
    rel_sq = float(np.max(np.abs(np.asarray(out_k[3], np.float64)
                                 - np.asarray(cond.evaluate(fine_k)))
                          / np.abs(np.asarray(out_k[3], np.float64))))
    ak, eak = chain_mean_err(out_k[7])
    ar, ear = chain_mean_err(out_r[7])
    yk, eyk = chain_mean_err(out_k[4])
    yr, eyr = chain_mean_err(out_r[4])
    dev_a, dev_y = sigma_dev(ak, eak, ar, ear), sigma_dev(yk, eyk, yr, eyr)
    finite = all(bool(np.isfinite(np.asarray(o)).all()) for o in out_k)
    report(tag, f"two-level chunk beta={act.beta:.3f} beta_c="
           f"{cact.beta:.3f} {n_chunk} steps t_sub=8 kernel vs reference",
           rel_err_S_fine=f"{rel_sf:.2e}", rel_err_S_cond=f"{rel_sq:.2e}",
           limit=1e-4, accept=f"{ak:.4f}+-{eak:.4f} vs {ar:.4f}+-{ear:.4f}",
           dev_accept_sigma=f"{dev_a:.2f}",
           Y=f"{yk:.4f}+-{eyk:.4f} vs {yr:.4f}+-{eyr:.4f}",
           dev_Y_sigma=f"{dev_y:.2f}", finite=finite,
           kernel_s=f"{wall_k:.3f}",
           kernel_samples_per_s=f"{n_chunk * C / wall_k:.0f}")
    gate(finite, f"{tag}: two-level chunk output not finite")
    gate(rel_sf <= 1e-4 and rel_sq <= 1e-4,
         f"{tag}: cached actions off by {rel_sf:.2e}/{rel_sq:.2e}")
    gate(dev_a < ORACLE_SIGMA and dev_y < ORACLE_SIGMA,
         f"{tag}: acceptance {dev_a:.2f} / Y {dev_y:.2f} sigma")


# --------------------------------------------------------------------------
# Phase 2: the CLI entry point
# --------------------------------------------------------------------------

def phase_cli(cfg: str) -> float:
    """Run drivers.qft.main on a shipped config; returns the r of its
    ``|numerical - analytical| = r * statistical error`` line."""
    import jax

    from mlmcpathintegral.drivers import qft

    x64 = jax.config.jax_enable_x64
    buf = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(buf):
            rc = qft.main([cfg])
    finally:
        jax.config.update("jax_enable_x64", x64)
    wall = time.monotonic() - t0
    out = buf.getvalue()
    print("\n".join("    | " + ln for ln in out.splitlines()[-12:]))
    m = re.search(r"=\s*([0-9.]+)\s*\*\s*statistical error", out)
    gate(rc in (0, None) and m is not None,
         f"phase 2 {cfg}: rc={rc}, no oracle line")
    r = float(m.group(1))
    report("phase 2", f"CLI {cfg}", dev_sigma=r, limit=ORACLE_SIGMA,
           wall_s_incl_compile=f"{wall:.2f}")
    gate(r < ORACLE_SIGMA, f"phase 2 {cfg}: {r} sigma from the oracle")
    return r


# --------------------------------------------------------------------------
# Phases 3-4: MLMC through MonteCarloMultiLevel
# --------------------------------------------------------------------------

def make_mlmc(M: int, beta: float, n_level: int, fused, n_samples: int,
              chunk_size: int = 256):
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
    from mlmcpathintegral.samplers import OverrelaxedHeatBathSampler

    act = QuenchedSchwingerAction(
        Lattice2D(M, M, CoarseningType.BOTH), beta=beta,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=100),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=n_level, n_burnin=100, n_samples=n_samples,
        chunk_size=chunk_size, fused=fused)
    return act, mc


def run_mlmc(phase: str, M: int, beta: float, n_level: int, fused,
             n_samples: int, n_chains: int = 1024, chunk_size: int = 256,
             seed: int = 2, mesh=None):
    """One MLMC estimate; prints the timings and the oracle gate."""
    import jax
    import jax.numpy as jnp

    act, mc = make_mlmc(M, beta, n_level, fused, n_samples, chunk_size)
    t0 = time.monotonic()
    stats = mc.evaluate(jax.random.PRNGKey(seed), n_chains=n_chains,
                        dtype=jnp.float32, mesh=mesh)
    wall = time.monotonic() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = act.chit_exact()
    dev = abs(num - oracle) / err
    t = mc.timings
    compile_s = t["compile_burnin_s"] + t["compile_cost_s"]
    method_s = t["cost_measure_s"] + t["sampling_s"]
    n0 = mc.stats_qoi[0].samples(stats[0])
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    report(phase, f"MLMC {M}x{M} beta={beta} L={n_level} "
           f"fused={fused} C={n_chains} chunk={chunk_size}",
           chi=f"{num:.5f}+-{err:.5f}", oracle=f"{oracle:.5f}",
           dev_sigma=f"{dev:.2f}", limit=ORACLE_SIGMA,
           wall_s=f"{wall:.2f}", compile_s=f"{compile_s:.2f}",
           prepare_s=f"{t['prepare_s']:.2f}", burnin_s=f"{t['burnin_s']:.2f}",
           sampling_s=f"{method_s:.3f}",
           samples_per_s_level0=f"{n0 / method_s:.0f}",
           eff_samples_per_s=f"{n0 / (tau0 * method_s):.0f}",
           t_sub="/".join(map(str, mc._t_sub)),
           cost_us_per_sample="/".join(f"{c:.4f}"
                                       for c in mc.cost_per_sample))
    gate(math.isfinite(num) and math.isfinite(err),
         f"{phase}: estimate not finite")
    gate(dev < ORACLE_SIGMA, f"{phase}: {dev:.2f} sigma from chit_exact")
    return mc, stats


def phase_four_cards(fused: str = "cuda", C: int = 1024, M: int = 64,
                     chunk_size: int = 256) -> None:
    """Chain-sharded fused MLMC on 4 cards vs 1 card with the same key,
    and the dp x sp halo sweeps on a (2, 2) mesh vs the unsharded sweep.
    The arguments shrink it for a rehearsal on 4 virtual CPU devices."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.parallel import chain_mesh
    from mlmcpathintegral.parallel.spatial import (
        make_schwinger_sweep_noise, make_sharded_schwinger_heatbath,
        make_sharded_schwinger_sweep, schwinger_heatbath_sweep_noise,
    )

    gate(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, JAX has "
         f"{len(jax.devices())}")
    n = 2 * chunk_size * C
    kw = dict(n_chains=C, chunk_size=chunk_size, seed=11)
    mc1, st1 = run_mlmc("4 cards", 8, 4.0, 2, fused, n, **kw)
    mc4, st4 = run_mlmc("4 cards", 8, 4.0, 2, fused, n, mesh=chain_mesh(4),
                        **kw)
    worst = 0.0
    for ell in range(mc1.n_level):
        s1, s4 = mc1.stats_qoi[ell], mc4.stats_qoi[ell]
        gate(len(st4[ell].avg.sharding.device_set) == 4,
             f"level {ell} statistics not on 4 devices")
        for name in ("average", "variance", "tau_int"):
            a, b = getattr(s1, name)(st1[ell]), getattr(s4, name)(st4[ell])
            rel = abs(a - b) / max(abs(a), 1e-30)
            worst = max(worst, rel)
            print(f"    level {ell} {name}: 1 card {a!r}  4 cards {b!r}  "
                  f"rel {rel:.2e}")
    report("4 cards", "fused MLMC 4 cards vs 1 card, same key",
           worst_rel_diff=f"{worst:.2e}", limit=1e-5,
           shard_devices=len(st4[0].avg.sharding.device_set))
    gate(worst <= 1e-5, f"4 vs 1 card statistics differ by {worst:.2e}")

    # spatial halo sweeps: same noise -> same links, sharded vs dense
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("chains", "space"))
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=4.0)
    theta = act.initialise_state(jax.random.PRNGKey(4), C, jnp.float32)
    spec = NamedSharding(mesh, P("chains", None))
    sweep = make_sharded_schwinger_sweep(act, mesh, axis="space",
                                         chain_axis="chains")
    noise = make_schwinger_sweep_noise(jax.random.PRNGKey(5), act, C,
                                       max_iter=6)
    dense = schwinger_heatbath_sweep_noise(act, theta, noise)
    shard = sweep(jax.device_put(theta, spec), noise)
    # same noise, same arithmetic; as in phase 1 a rejection test within
    # rounding of its threshold may flip, which must stay rare
    dd = wrapped_diff(shard, dense)
    frac = float((dd > 1e-4).mean())
    report("4 cards", "dp x sp sweep (2 x 2 mesh) vs dense, same noise",
           max_dtheta=float(dd.max()), frac_links_dtheta_over_1e4=frac,
           limit=1e-3, shard_devices=len(shard.sharding.device_set))
    gate(frac <= 1e-3, f"sharded sweep differs on {frac} of the links")

    # keyed per-shard streams: the equilibrium plaquette vs the dense
    # XLA heat bath and the analytic I1/I0
    from scipy.special import i0e, i1e
    keyed = make_sharded_schwinger_heatbath(act, mesh, axis="space",
                                            chain_axis="chains")
    x_s = jax.device_put(theta, spec)
    x_d = theta
    e_s, e_d = [], []
    key = jax.random.PRNGKey(6)
    dense_sweep = jax.jit(act.heatbath_sweep)
    for i in range(200):
        key, k1, k2 = jax.random.split(key, 3)
        x_s, x_d = keyed(k1, x_s), dense_sweep(k2, x_d)
        if i >= 100:
            e_s.append(jnp.mean(jnp.cos(act.plaquette_angles(x_s)),
                                axis=(-2, -1)))
            e_d.append(jnp.mean(jnp.cos(act.plaquette_angles(x_d)),
                                axis=(-2, -1)))
    ms, es = chain_mean_err(jnp.stack(e_s))
    md, ed = chain_mean_err(jnp.stack(e_d))
    exact = float(i1e(4.0) / i0e(4.0))
    dev_sd, dev_so = sigma_dev(ms, es, md, ed), sigma_dev(ms, es, exact)
    report("4 cards", "keyed dp x sp heat bath 200 sweeps vs dense",
           plaquette=f"{ms:.5f}+-{es:.5f} vs {md:.5f}+-{ed:.5f}",
           exact=f"{exact:.5f}", dev_dense_sigma=f"{dev_sd:.2f}",
           dev_exact_sigma=f"{dev_so:.2f}")
    gate(dev_sd < ORACLE_SIGMA and dev_so < ORACLE_SIGMA,
         "keyed sharded heat bath disagrees")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card chain-sharded path")
    args = ap.parse_args(argv)

    print(f"card: {card_line()}", flush=True)
    import jax
    print(f"jax {jax.__version__}", flush=True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 3
    try:
        from mlmcpathintegral.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"the repository is not beside chip_smoke.py: {e}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"devices: {len(devices)} x {devices[0].device_kind}", flush=True)

    t_all = time.monotonic()
    with jax.default_matmul_precision("highest"):
        if args.four_cards:
            phase_four_cards()
        else:
            for M in (8, 64):
                phase_kernels(M)
            phase_cli("configs/qft_schwinger_multilevel.in")
            phase_cli("configs/qft_gff_twolevel.in")
            n_head = 16 * 256 * 1024
            run_mlmc("phase 3", 8, 4.0, 2, "cuda", n_head)
            run_mlmc("phase 3", 8, 4.0, 2, None, n_head)
            mc, _ = run_mlmc("phase 4", 64, 64.0, 3, "cuda", 3 * 256 * 1024)
            for ell, n_chunks, disp, block in mc.chunk_log:
                print(f"    level {ell}: {n_chunks} chunks dispatch "
                      f"{disp}s block {block}s")
            print(f"    timings: {mc.timings}")
    print(f"all phases passed in {time.monotonic() - t_all:.1f}s",
          flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
