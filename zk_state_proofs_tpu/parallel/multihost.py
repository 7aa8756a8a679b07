"""Multi-process initialization.

With several processes (one per host, or one per GPU) every process runs
the same program; `initialize()` wires them into one JAX runtime, after
which `make_mesh()` sees all global devices and the sharded verifier/
sweep/trie-reduction paths work unchanged — proof batches shard over every
process's devices and collectives run across them.

The reference has no distributed layer at all (SURVEY.md §2.3); this module
is the net-new scale-out entry point.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> dict:
    """jax.distributed.initialize. Where no cluster environment tells JAX
    the topology, pass coordinator_address ("host:port"), num_processes
    and process_id explicitly. Returns a summary of the resulting
    topology."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return topology()


def topology() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "backend": jax.default_backend(),
    }


def put_global(mesh: Mesh, arr, spec) -> jax.Array:
    """Build a global jax.Array over a (possibly multi-process) mesh from
    host data that every process holds identically — the witness-side
    bridge: each process computes/loads the same packed batch and this
    places each device's shard without any cross-host transfer of the
    full array (each process only materializes its addressable shards)."""
    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def gather_to_host(x) -> np.ndarray:
    """Global (possibly cross-process sharded) array -> full host numpy on
    every process. No-op beyond device transfer in single-process mode."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
