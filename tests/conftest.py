"""Test configuration: run on a virtual 8-device CPU mesh with f64.

Correctness tests run against the reference's f64 semantics on CPU;
multi-device sharding tests use the forced host-platform device count
(the analog of the reference's `mpirun -n N` checks, SURVEY.md §4).

``JAX_PLATFORMS=cpu`` is set before JAX is imported: on a machine with a
GPU, every pytest-xdist worker would otherwise reserve most of the card's
memory and the second one would fail.  Tests that need the GPU are marked
``gpu`` and skip here; ``python chip_smoke.py`` runs what they check on
the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

CPU_DEVICES = jax.local_devices(backend="cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never while a module is imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card")
