"""Probe the MLMC orchestration gap.

Runs the north-star MLMC config at a reduced sample budget with per-
run_level dispatch/block timing (mc/multilevel.py::chunk_log) to locate
where the wall-clock goes: host dispatch, device execution, or compiles.

Usage: python tools/mlmc_gap_probe.py [n_samples] [chunk_size]
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from mlmcpathintegral.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp


def main():
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    chunk_size = int(sys.argv[2]) if len(sys.argv) > 2 else 256

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
    from mlmcpathintegral.samplers import QuenchedSchwingerClusterSampler

    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(
        lat, beta=4.0, renormalisation=RenormalisationType.NONPERTURBATIVE)
    t0 = time.monotonic()
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=n_samples,
        chunk_size=chunk_size)
    print(f"ctor: {time.monotonic() - t0:.2f}s", flush=True)
    stats = mc.evaluate(jax.random.PRNGKey(2), n_chains=1024,
                        dtype=jnp.float32, verbose=True)
    print(json.dumps({
        "n_samples": n_samples, "chunk_size": chunk_size,
        "chit": mc.numerical_result(), "err": mc.statistical_error(),
        "oracle": act.chit_exact(),
        "t_sub": list(mc._t_sub),
        "timings": {k: round(v, 2) for k, v in mc.timings.items()},
        "cost_per_sample_us": [round(c, 3) for c in mc.cost_per_sample],
    }, indent=1))
    print("chunk_log (ell, n_chunks, dispatch_s, block_s):")
    for row in mc.chunk_log:
        print("  ", row)


if __name__ == "__main__":
    main()
