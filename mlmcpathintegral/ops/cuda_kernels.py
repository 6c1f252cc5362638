"""Build, load and register the CUDA kernels of ``ops/cuda/`` (jax.ffi).

The shared library is compiled with ``nvcc`` from the committed sources at
first use, or ahead of time with::

    python -m mlmcpathintegral.ops.cuda_kernels

into ``ops/cuda/build/`` (listed in .gitignore).  The file name carries a
hash of the sources and flags, so an edited kernel is rebuilt.  The build
needs the CUDA toolkit (``nvcc`` on PATH, or under ``$CUDA_HOME``) and
targets Hopper (sm_90a).

``cta_shape`` is the launch rule both kernels share: how many chains one
thread block (CTA) keeps in shared memory and how many threads serve each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "cuda"
SOURCES = ("schwinger.cu",)
BUILD_DIR = SRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: FFI target name -> exported handler symbol
TARGETS = {
    "mlmcpi_schwinger_sweep_chain": "SchwingerSweepChain",
    "mlmcpi_schwinger_twolevel_chunk": "SchwingerTwoLevelChunk",
}

# H100 SXM: streaming multiprocessors, and the shared memory one block may
# opt in to (227 KB of the SM's 256 KB)
N_SM = 132
SMEM_PER_BLOCK = 232448
# shared memory beside the fields: per chain the reduction row and cached
# scalars, per block the per-warp reduction scratch
SMEM_PER_CHAIN_EXTRA = 64
SMEM_PER_BLOCK_EXTRA = 1024
MAX_THREADS_PER_CHAIN = 256
MAX_THREADS_PER_BLOCK = 1024


def cta_shape(n_chains: int, field_bytes: int, links_per_group: int):
    """(chains per CTA, threads per chain) for a kernel that keeps
    ``field_bytes`` of shared memory per chain and updates
    ``links_per_group`` links per chain in each colour group.

    Threads per chain: the group size rounded up to a power of two, at
    most 256.  Chains per CTA: the largest power of two that divides
    ``n_chains``, fits the shared memory and still leaves at least two
    blocks per SM (2 x 132) — fewer only when the chains do not allow it.
    A field that does not fit one block's shared memory is refused."""
    if field_bytes + SMEM_PER_CHAIN_EXTRA + SMEM_PER_BLOCK_EXTRA \
            > SMEM_PER_BLOCK:
        raise ValueError(
            f"a chain's fields take {field_bytes} bytes of shared memory; "
            f"a thread block holds at most {SMEM_PER_BLOCK} — this lattice "
            f"is too large for the fused CUDA kernels, run it unfused")
    tpc = min(MAX_THREADS_PER_CHAIN,
              1 << max(0, (int(links_per_group) - 1).bit_length()))

    def fits(cpc):
        return (n_chains % cpc == 0
                and n_chains // cpc >= 2 * N_SM
                and cpc * tpc <= MAX_THREADS_PER_BLOCK
                and cpc * (field_bytes + SMEM_PER_CHAIN_EXTRA)
                + SMEM_PER_BLOCK_EXTRA <= SMEM_PER_BLOCK)

    cpc = 1
    while fits(2 * cpc):
        cpc *= 2
    return cpc, tpc


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libmlmcpi_cuda_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this version of it is already built."""
    lib = library_path()
    if lib.exists():
        return lib
    import jax.ffi
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)     # atomic: concurrent builders never see half
    return lib


@functools.cache
def register():
    """Build (if needed), load and register the FFI targets once per
    process; returns the loaded library, which must stay referenced."""
    import jax.ffi
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for target, symbol in TARGETS.items():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, symbol)),
            platform="CUDA")
    return lib


def require_gpu(what: str) -> None:
    """The CUDA kernels run only on a GPU backend; say so instead of
    failing inside XLA (the plain-JAX reference is never substituted)."""
    import jax
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"{what}: the CUDA kernel needs a GPU, the default backend is "
            f"'{jax.default_backend()}'; pass reference=True to run the "
            f"plain-JAX reference instead")


if __name__ == "__main__":
    print(build())
