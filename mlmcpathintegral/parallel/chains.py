"""Chain-parallel device mesh: the replacement for the MPI layer.

The reference parallelises by running one independent Markov chain per MPI
rank and allreducing scalar statistics (src/mpi/mpi_wrapper.{hh,cc},
SURVEY.md §2.1).  Here the chain axis is a *sharded array axis* over a 1-D
``jax.sharding.Mesh``:

  * every sampler/MC kernel is already batched over chains, so sharding the
    leading axis of all state pytrees with ``NamedSharding(mesh,
    P('chains'))`` runs each device's chains locally with zero
    communication, and
  * statistics reductions (the ``jnp.mean`` over the chain axis inside
    tau_int/variance) compile to XLA collectives (NCCL on GPUs, over
    NVLink between the cards of a host) — the analog of
    ``mpi_allreduce_avg`` (mpi_wrapper.cc:44-120) — inserted automatically
    by the partitioner.

Several hosts run the same program under ``jax.distributed.initialize``;
nothing in the kernels changes (SURVEY.md §2.1).  A custom call (the
fused CUDA kernels) cannot be partitioned by XLA, so those run per shard
under ``shard_map`` (mc/multilevel.py ``_over_chains``).

``distribute_n`` (even split of a sample budget, mpi_wrapper.hh:125)
becomes a static per-chain target.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def chain_mesh(n_devices: int | None = None, devices=None,
               axis_name: str = "chains") -> Mesh:
    """1-D mesh over the chain axis.  ``devices`` defaults to all local
    devices (or the first n_devices of them)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_chains(mesh: Mesh, pytree, axis_name: str = "chains"):
    """Place every array leaf with its leading (chain) axis sharded over the
    mesh; scalars/rank-0 leaves are replicated."""
    def place(leaf):
        arr = jax.numpy.asarray(leaf)
        if arr.ndim == 0:
            spec = P()
        else:
            spec = P(axis_name, *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return jax.tree.map(place, pytree)


def distribute_n(n: int, n_chains: int) -> int:
    """Per-chain sample target for a global budget of n samples — the
    static analog of mpi_wrapper's distribute_n (mpi_wrapper.hh:125)."""
    return -(-n // n_chains)
