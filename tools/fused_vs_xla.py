#!/usr/bin/env python
"""Fused CUDA MLMC levels vs the unfused XLA levels, on the GPU.

For the headline configuration (8x8, beta=4, 2 levels) and the continuum
trajectory at 64x64 (beta=64, 3 levels), both with heat-bath coarse
chains, 1024 chains and chunk 256 in float32, each run reports:

  * the sampling wall time (cost probe + sampling loop), samples/s and
    effective samples/s of level 0, with compile, prepare and burn-in
    beside them (profiler off);
  * from a profiler trace of a second, shorter run (the first run of
    each kind only): the device's idle
    share inside the sampling window (the ``mlmc_sampling`` annotation
    of MonteCarloMultiLevel.evaluate), the device time per recorded
    level-0 sample, and for the fused runs the CUDA kernels' time per
    coarse sweep.

At 8x8 the runs go fused, unfused, fused so a drift of the card shows;
at 64x64, where an unfused run takes minutes, one of each.  Usage (one process, one card):

    python tools/fused_vs_xla.py [--sizes 8,64] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import card_line, make_mlmc  # noqa: E402
from mlmcpathintegral.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

CONFIGS = {8: (4.0, 2, 16 * 256 * 1024), 64: (64.0, 3, 3 * 256 * 1024)}
KERNEL_NAMES = ("sweep_chain_kernel", "twolevel_kernel")


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_summary(trace_dir: str) -> dict:
    """Device busy time, idle share and fused-kernel time inside the
    ``mlmc_sampling`` window of the newest trace under trace_dir."""
    from jax.profiler import ProfileData
    files = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    data = ProfileData.from_file(str(files[-1]))
    window = None
    device_lines = {}
    for plane in data.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == "mlmc_sampling":
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
        elif plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                device_lines.setdefault(line.name, []).extend(
                    (ev.start_ns, ev.start_ns + ev.duration_ns, ev.name)
                    for ev in line.events)
    if window is None:
        raise RuntimeError("no mlmc_sampling annotation in the trace")
    # kernel executions are on the stream lines; module/op summary lines
    # span them and would double-count
    streams = [n for n in device_lines if n.lower().startswith("stream")]
    names = streams or list(device_lines)
    w0, w1 = window
    evs = [(max(s, w0), min(e, w1), n) for ln in names
           for s, e, n in device_lines[ln] if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in evs])
    kern = sum(e - s for s, e, n in evs
               if any(k in n for k in KERNEL_NAMES))
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "idle_share": 1.0 - busy / (w1 - w0),
            "fused_kernel_s": kern * 1e-9,
            "device_lines": sorted(device_lines)}


def run(M: int, fused, trace_root: str | None) -> dict:
    beta, n_level, n_samples = CONFIGS[M]
    chunk, C = 256, 1024
    act, mc = make_mlmc(M, beta, n_level, fused, n_samples, chunk)
    t0 = time.monotonic()
    stats = mc.evaluate(jax.random.PRNGKey(2), n_chains=C,
                        dtype=jnp.float32)
    wall = time.monotonic() - t0
    t = dict(mc.timings)
    method_s = t["cost_measure_s"] + t["sampling_s"]
    n0 = mc.stats_qoi[0].samples(stats[0])
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    num, err = mc.numerical_result(), mc.statistical_error()
    row = {
        "M": M, "beta": beta, "n_level": n_level, "fused": fused,
        "n_chains": C, "chunk": chunk, "wall_s": wall, "timings": t,
        "sampling_s": method_s, "samples_level0": n0,
        "samples_per_s": n0 / method_s,
        "eff_samples_per_s": n0 / (tau0 * method_s), "tau0": tau0,
        "t_sub": list(mc._t_sub), "chit": num, "err": err,
        "dev_sigma": abs(num - act.chit_exact()) / err,
    }
    if trace_root is None:
        return row
    # traced second run: 2 chunks per level inside the sampling window
    mc.n_samples = 3 * chunk * C
    trace_dir = tempfile.mkdtemp(prefix=f"trace_{M}_{fused}_",
                                 dir=trace_root)
    with jax.profiler.trace(trace_dir):
        mc.evaluate(jax.random.PRNGKey(3), n_chains=C, dtype=jnp.float32)
    tr = trace_summary(trace_dir)
    n_window = 2 * chunk * C
    row["trace"] = tr
    row["device_s_per_sample"] = tr["busy_s"] / n_window
    if fused:
        sweeps = 2 * chunk * sum(mc._t_sub)    # per chain, all levels
        row["kernel_s_per_sweep"] = tr["fused_kernel_s"] / sweeps
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="8,64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("fused_vs_xla.py needs a GPU")
    enable_compile_cache()
    card = card_line()
    print(f"card: {card}  jax {jax.__version__}", flush=True)
    trace_root = str(REPO / "bench_profile")
    Path(trace_root).mkdir(exist_ok=True)
    rows = []
    with jax.default_matmul_precision("highest"):
        for M in (int(s) for s in args.sizes.split(",")):
            order = ("cuda", None, "cuda") if M <= 8 else ("cuda", None)
            traced = set()
            for fused in order:
                r = run(M, fused, None if fused in traced else trace_root)
                traced.add(fused)
                r["card"] = card
                rows.append(r)
                print(json.dumps({k: v for k, v in r.items()
                                  if k != "timings"}), flush=True)
                print(f"  timings {r['timings']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    for M in sorted({r["M"] for r in rows}):
        med = {}
        for fused in ("cuda", None):
            sel = [r for r in rows if r["M"] == M and r["fused"] == fused]
            med[fused] = sorted(r["samples_per_s"] for r in sel)
        print(f"{M}x{M}: samples/s fused {med['cuda']} unfused "
              f"{med[None]}  ratio "
              f"{min(med['cuda']) / max(med[None]):.2f}"
              f"..{max(med['cuda']) / min(med[None]):.2f}", flush=True)
    return 0 if all(math.isfinite(r["chit"]) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
