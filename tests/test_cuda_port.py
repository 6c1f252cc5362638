"""What surrounds the CUDA kernels, tested on the CPU.

The counter RNG's specification re-implemented in numpy, the CTA launch
rule, the wrappers' refusals, the reference chunk's shapes and streams,
the fused-MLMC options and their chain sharding, the compile-cache
helper, the removed sampler options, and the GPU-only entry points'
refusal to run without a GPU.  The kernels themselves are compared with
their references on the card (the gpu-marked tests, and chip_smoke.py).
"""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.ops import cuda_kernels
from mlmcpathintegral.ops.counter_rng import CounterRng
from mlmcpathintegral.ops.schwinger import schwinger_sweep_chain
from mlmcpathintegral.ops.schwinger_twolevel import (
    schwinger_twolevel_chain, twolevel_cta_shape,
)

REPO = Path(__file__).resolve().parents[1]
PI = math.pi


# -- the counter RNG, re-implemented in numpy (what the CUDA code follows) --

def _np_fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _np_bits(seed1, seed2, site, chain, step, ctr):
    u = np.uint32
    base_s = _np_fmix32((site * u(0x9E3779B9)) ^ u(seed1))
    if step is not None:
        base_s = _np_fmix32(base_s + u(step) * u(0x165667B1))
    base_c = _np_fmix32((chain * u(0x85EBCA77)) ^ u(seed2))
    return _np_fmix32(_np_fmix32(base_s + u(ctr) * u(0xC2B2AE3D))
                      + _np_fmix32(base_c + u(ctr) * u(0x27D4EB2F)))


@pytest.mark.parametrize("step", [None, 0, 7, 2**31 + 5])
def test_numpy_murmur3_matches_counter_rng(step):
    site = np.arange(64, dtype=np.uint32).reshape(8, 8) * np.uint32(977)
    chain = np.arange(64, dtype=np.uint32).reshape(8, 8)[::-1] \
        + np.uint32(2**30)
    seed1, seed2 = 0xDEADBEEF, 12345
    rng = CounterRng(jnp.uint32(seed1), jnp.asarray(site),
                     jnp.asarray(chain), jnp.uint32(seed2),
                     step=None if step is None else jnp.uint32(step))
    with np.errstate(over="ignore"):
        for ctr in range(1, 5):
            got = np.asarray(rng.bits())
            want = _np_bits(seed1, seed2, site, chain, step, ctr)
            np.testing.assert_array_equal(got, want)
        # uniforms: the top 23 bits as a mantissa in [1, 2), mapped to (0, 1]
        u = np.asarray(rng.uniform(jnp.float32))
        bits = _np_bits(seed1, seed2, site, chain, step, 5)
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32)
        np.testing.assert_array_equal(u, np.float32(2.0) - f)


def test_rng_rounds_equal_unrolled_stream():
    """rng.rounds (the reference's fori_loop over rejection rounds) draws
    the counters the unrolled loop would."""
    site = jnp.arange(16, dtype=jnp.uint32)
    chain = jnp.zeros(16, jnp.uint32) + 3
    a = CounterRng(jnp.uint32(1), site, chain, jnp.uint32(2), step=4)
    a.bits()
    rows = a.rounds(3, 2, lambda r, acc: acc + [r.bits(), r.bits()][1],
                    jnp.zeros(16, jnp.uint32))
    b = CounterRng(jnp.uint32(1), site, chain, jnp.uint32(2), step=4)
    b.bits()
    want = jnp.zeros(16, jnp.uint32)
    for _ in range(3):
        b.bits()
        want = want + b.bits()
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(want))
    assert a.ctr == b.ctr == 7


# -- the CTA launch rule ------------------------------------------------------

@pytest.mark.parametrize("n_chains,field_bytes,links", [
    (1024, 512, 32),        # 8x8 sweep: many small chains
    (4096, 640, 8),         # 4x4-coarse two-level chunk
    (1024, 40960, 512),     # 64x64 two-level chunk
    (200, 512, 32),         # too few chains for 2 blocks per SM
])
def test_cta_shape_fills_the_card(n_chains, field_bytes, links):
    cpc, tpc = cuda_kernels.cta_shape(n_chains, field_bytes, links)
    assert n_chains % cpc == 0
    assert n_chains // cpc >= 2 * cuda_kernels.N_SM or cpc == 1
    assert cpc * (field_bytes + cuda_kernels.SMEM_PER_CHAIN_EXTRA) \
        + cuda_kernels.SMEM_PER_BLOCK_EXTRA <= cuda_kernels.SMEM_PER_BLOCK
    assert tpc & (tpc - 1) == 0 and tpc >= min(links, 256)
    assert cpc * tpc <= cuda_kernels.MAX_THREADS_PER_BLOCK
    # maximal: doubling the chains per CTA breaks a condition
    c2 = 2 * cpc
    assert (n_chains % c2 or n_chains // c2 < 2 * cuda_kernels.N_SM
            or c2 * (field_bytes + 64) + 1024 > cuda_kernels.SMEM_PER_BLOCK
            or c2 * tpc > 1024)


def test_cta_shape_refuses_a_field_over_shared_memory():
    with pytest.raises(ValueError, match="too large for the fused CUDA"):
        cuda_kernels.cta_shape(1024, 232 * 1024, 64)


def test_twolevel_cta_shape_sizes():
    # 128x128: 128 KB trial + 32 KB coarse fits one block
    cpc, _ = twolevel_cta_shape(1024, 128, 128)
    assert cpc == 1
    with pytest.raises(ValueError):
        twolevel_cta_shape(1024, 256, 256)


# -- the wrappers -------------------------------------------------------------

def _fields(C=8, M=4, dtype=jnp.float32):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    fine = jax.random.uniform(k1, (C, 2 * M * M), dtype, -PI, PI)
    coarse = jax.random.uniform(k2, (C, M * M // 2), dtype, -PI, PI)
    return fine, coarse, jnp.zeros(C, dtype), jnp.zeros(C, dtype)


def _call(which, dtype, **kw):
    fine, coarse, sf, sq = _fields(dtype=dtype)
    if which == "sweep":
        return schwinger_sweep_chain(fine, 1, beta=2.0, Mt=4, Mx=4,
                                     n_steps=2, **kw)
    return schwinger_twolevel_chain(fine, coarse, sf, sq, 1, beta=2.0,
                                    beta_c=0.5, Mt=4, Mx=4, n_steps=2,
                                    t_sub=2, **kw)


@pytest.mark.parametrize("which", ["sweep", "twolevel"])
def test_cuda_path_refuses_a_non_gpu_backend(which):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        _call(which, jnp.float32)


@pytest.mark.parametrize("which", ["sweep", "twolevel"])
def test_cuda_path_refuses_float64(which, monkeypatch):
    monkeypatch.setattr(cuda_kernels, "require_gpu", lambda what: None)
    with pytest.raises(ValueError, match="float32"):
        _call(which, jnp.float64)


def test_reference_chunk_shapes_and_seeds():
    C, n_steps, t_sub = 8, 2, 2          # as in _call
    out = _call("twolevel", jnp.float32, reference=True)
    shapes = [o.shape for o in out]
    assert shapes == [(C, 32), (C, 8), (C,), (C,), (n_steps, C),
                      (n_steps * t_sub, C), (n_steps * t_sub, C),
                      (n_steps, C)]
    again = _call("twolevel", jnp.float32, reference=True)
    for a, b in zip(out, again):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fine, coarse, sf, sq = _fields()
    other = schwinger_twolevel_chain(fine, coarse, sf, sq, 2, beta=2.0,
                                     beta_c=0.5, Mt=4, Mx=4, n_steps=2,
                                     t_sub=2, reference=True)
    assert not np.array_equal(np.asarray(other[1]), np.asarray(out[1]))


def test_chain_offset_draws_the_global_streams():
    """A shard of chains [k, k+n) run with chain_offset=k reproduces those
    chains of the whole run: the kernels key the RNG by global chain id."""
    fine, *_ = _fields(C=8)
    full = schwinger_sweep_chain(fine, 3, beta=2.0, Mt=4, Mx=4, n_steps=3,
                                 reference=True)
    part = schwinger_sweep_chain(fine[4:], 3, beta=2.0, Mt=4, Mx=4,
                                 n_steps=3, chain_offset=4, reference=True)
    np.testing.assert_array_equal(np.asarray(part[0]),
                                  np.asarray(full[0][4:]))
    np.testing.assert_array_equal(np.asarray(part[1]),
                                  np.asarray(full[1][:, 4:]))


# -- fused MLMC options and sharding -----------------------------------------

def _mlmc(fused, coarse="heatbath", M=4, n_samples=64, chunk=4):
    from mlmcpathintegral.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.mc import MonteCarloMultiLevel
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral.qoi import qoi_2d_susceptibility
    from mlmcpathintegral.samplers import (
        OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    )
    cls = (OverrelaxedHeatBathSampler if coarse == "heatbath"
           else QuenchedSchwingerClusterSampler)
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=2.0)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: cls(a, n_burnin=4),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=8, n_samples=n_samples, chunk_size=chunk,
        fused=fused)


@pytest.mark.parametrize("fused,coarse,match", [
    ("mosaic", "heatbath", "fused must be one of"),
    ("reference", "cluster", "heat-bath coarse chains"),
])
def test_fused_mlmc_refuses_what_it_cannot_run(fused, coarse, match):
    with pytest.raises(ValueError, match=match):
        _mlmc(fused, coarse)


def test_fused_mlmc_refuses_a_field_over_shared_memory():
    with pytest.raises(ValueError, match="too large for the fused CUDA"):
        _mlmc("cuda", M=256)


def test_fused_mlmc_sharded_matches_unsharded():
    """The per-shard kernel calls under shard_map, with each shard's
    global chain offset, give the statistics of the unsharded run."""
    from mlmcpathintegral.parallel import chain_mesh
    C = 16
    mc1 = _mlmc("reference")
    st1 = mc1.evaluate(jax.random.PRNGKey(1), n_chains=C,
                       dtype=jnp.float32)
    mc4 = _mlmc("reference")
    st4 = mc4.evaluate(jax.random.PRNGKey(1), n_chains=C,
                       dtype=jnp.float32, mesh=chain_mesh(4))
    for ell in range(2):
        assert len(st4[ell].avg.sharding.device_set) == 4
        for name in ("average", "variance"):
            a = getattr(mc1.stats_qoi[ell], name)(st1[ell])
            b = getattr(mc4.stats_qoi[ell], name)(st4[ell])
            assert abs(a - b) <= 1e-5 * max(abs(a), 1e-12), (ell, name)


# -- the removed sampler options ---------------------------------------------

@pytest.mark.parametrize("section", ["hmc", "heatbath"])
def test_removed_use_pallas_key_is_refused(section):
    from mlmcpathintegral.drivers.common import make_sampler_factory
    name = "HMC" if section == "hmc" else "heatbath"
    with pytest.raises(ValueError, match="use_pallas was removed"):
        make_sampler_factory(name, {section: {"use_pallas": True}})


@pytest.mark.parametrize("value,expect", [("none", None),
                                          ("cuda", "cuda"),
                                          ("reference", "reference")])
def test_heatbath_fused_key_selects_the_route(value, expect):
    from mlmcpathintegral.drivers.common import make_sampler_factory
    from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
    from mlmcpathintegral.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    act = QuenchedSchwingerAction(Lattice2D(4, 4, CoarseningType.BOTH),
                                  beta=2.0)
    factory = make_sampler_factory("heatbath", {"heatbath": {"fused": value}})
    assert factory(act).fused == expect


def test_heatbath_fused_key_refuses_unknown_values():
    from mlmcpathintegral.drivers.common import make_sampler_factory
    with pytest.raises(ValueError, match="heatbath.fused"):
        make_sampler_factory("heatbath", {"heatbath": {"fused": "mosaic"}})


@pytest.mark.parametrize("sampler", ["HMCSampler",
                                     "OverrelaxedHeatBathSampler",
                                     "ClusterSampler"])
def test_samplers_refuse_use_pallas(sampler):
    from mlmcpathintegral import samplers
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.models.rotor import RotorAction
    act = RotorAction(Lattice1D(M_lat=8, T_final=4.0), m0=0.25)
    with pytest.raises(TypeError):
        getattr(samplers, sampler)(act, use_pallas=True)


# -- compile cache -----------------------------------------------------------

def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_default_dir(monkeypatch):
    from mlmcpathintegral.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    d = compile_cache.enable_compile_cache()
    assert d == str(REPO / ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == d
    assert calls["jax_persistent_cache_min_compile_time_secs"] < 1.0


def test_compile_cache_respects_environment(monkeypatch, tmp_path):
    from mlmcpathintegral.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


# -- GPU-only entry points ---------------------------------------------------

def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BENCH_CPU", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(res):
    return res.returncode != 0 and '"ok"' not in res.stdout \
        and '"metric"' not in res.stdout


def test_bench_refuses_without_gpu():
    assert _no_result(_run_cpu(["bench.py"], REPO))


def test_bench_cell_failure_is_reported_not_replaced():
    """A failing cell is named in ``errors`` (which the last line carries
    and which makes the run exit non-zero); its row holds only the error."""
    code = ("import json, bench; e = {}; "
            "r = bench._cell(e, 'schwinger_mlmc', lambda: 1 / 0); "
            "print(json.dumps([e, r]))")
    res = _run_cpu(["-c", code], REPO)
    errors, row = json.loads(res.stdout.strip().splitlines()[-1])
    assert "ZeroDivisionError" in errors["schwinger_mlmc"]
    assert row == {"error": errors["schwinger_mlmc"]}
    assert "schwinger_mlmc FAILED" in res.stderr


def test_chip_smoke_refuses_without_gpu():
    res = _run_cpu(["chip_smoke.py"], REPO)
    assert _no_result(res) and "no GPU" in res.stderr


def test_chip_smoke_refuses_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    assert _no_result(_run_cpu(["chip_smoke.py"], tmp_path))


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_sweep_matches_reference(gpu):
    fine, *_ = _fields(C=1024, M=8)
    k = schwinger_sweep_chain(fine, 5, beta=4.0, Mt=8, Mx=8, n_steps=1)
    r = schwinger_sweep_chain(fine, 5, beta=4.0, Mt=8, Mx=8, n_steps=1,
                              reference=True)
    d = np.abs(np.asarray(k[0]) - np.asarray(r[0]))
    assert (np.minimum(d, 2 * PI - d) > 1e-4).mean() <= 1e-3


@pytest.mark.gpu
def test_cuda_twolevel_matches_reference(gpu):
    fine, coarse, sf, sq = _fields(C=1024, M=8)
    kw = dict(beta=4.0, beta_c=1.0, Mt=8, Mx=8, n_steps=1, t_sub=1)
    k = schwinger_twolevel_chain(fine, coarse, sf, sq, 5, **kw)
    r = schwinger_twolevel_chain(fine, coarse, sf, sq, 5, reference=True,
                                 **kw)
    assert (np.abs(np.asarray(k[1]) - np.asarray(r[1])) > 1e-4).mean() \
        <= 1e-3
