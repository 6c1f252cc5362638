"""Multi-host setup.

The reference scales across nodes with `mpirun` (one chain per rank); here
every host runs the *same single program* — call
:func:`initialize_multihost` once at startup, build a global ``chains``
mesh over all devices, and shard the chain batch with
``parallel.shard_chains``.  Statistics reductions then become collectives
between the devices of a host and across hosts, inserted by the
partitioner; no kernel changes (SURVEY.md §2.1).

Not yet run with several processes; the sharding semantics are covered by
the virtual-mesh tests (tests/test_parallel.py), which is the same
partitioner code path.
"""

from __future__ import annotations

import jax

from mlmcpathintegral.parallel.chains import chain_mesh


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Thin wrapper over ``jax.distributed.initialize``.  Where no cluster
    environment is detected (e.g. one GPU host) pass all three
    arguments: ``coordinator_address`` as ``host:port``."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_chain_mesh(axis_name: str = "chains"):
    """1-D mesh over every device of every host in the slice."""
    return chain_mesh(devices=jax.devices(), axis_name=axis_name)


def per_host_chains(n_chains_global: int) -> int:
    """Local chain count for an even split of the global batch."""
    n_proc = jax.process_count()
    if n_chains_global % n_proc:
        raise ValueError(
            f"global chain count {n_chains_global} must divide evenly over "
            f"{n_proc} hosts")
    return n_chains_global // n_proc
