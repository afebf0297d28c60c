"""Device mesh + sharding helpers.

The replacement for the reference's multicore runtime
(``MultiCore.cs:43-92`` DSGD block partitioning + ``Parallel.For``):
embedding tables are row-sharded over a 1-D ``data`` mesh axis and the
minibatch is sharded the same way; XLA's SPMD partitioner inserts the
all-gather / all-to-all / scatter collectives that the reference's
block-diagonal schedule emulated on shared memory (SURVEY §2.9 P1/P2).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: int = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), (axis,))


def row_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard dim 0 across the mesh (embedding tables, batch arrays)."""
    return NamedSharding(mesh, P(axis))


def row_sharded_2d(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_rows_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 so row-sharding divides evenly (capacity padding also
    serves incremental growth, SURVEY §7 'incremental updates')."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)], axis=0)


# ---------------------------------------------------------------------------
# multi-host scaffolding
# ---------------------------------------------------------------------------
#
# The reference is strictly single-process (SURVEY §2.9: the only
# concurrency is System.Threading.Tasks). This framework adds
# a jax.distributed layer: every host runs the same program, calls
# initialize_distributed() first, and from then on jax.devices() is the
# GLOBAL device list, so make_mesh()/make_global_mesh() span the pod
# slice and the sharded epochs' psum/all-gather collectives ride ICI.
# Hosts load only their slice of the input (host_local_rows) and
# assemble global arrays with shard_host_local — DCN carries nothing but
# the input pipeline and eval reductions.
#
# Single-process (this repo's CI and the 8-device CPU dryrun) is the
# documented fallback: initialize_distributed() is a no-op and
# shard_host_local degrades to a plain device_put.


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None) -> bool:
    """Initialize the multi-host backend (jax.distributed.initialize).

    Reads JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID when the
    arguments are omitted (the README's multi-host run line). Returns
    False — and leaves jax untouched — when the configuration says
    single-process, so the same entry point runs everywhere.
    """
    import os
    coordinator_address = coordinator_address or \
        os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return True


def make_global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over ALL devices — across hosts after
    initialize_distributed() (jax.devices() is global), identical to
    make_mesh() in a single process."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_rows(num_rows: int, process_id: int = None,
                    num_processes: int = None):
    """[start, stop) of the row range this host loads — the host-sharded
    input plan for the blocked epochs: the group axis (user slabs,
    rating blocks) is split contiguously across hosts so each host
    parses/loads only its shard and feeds its local devices."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    per = (num_rows + n - 1) // n
    return pid * per, min((pid + 1) * per, num_rows)


def shard_host_local(mesh: Mesh, host_rows: np.ndarray, spec=None):
    """Assemble a row-sharded global array from each host's local rows
    (jax.make_array_from_process_local_data). host_rows is THIS host's
    slice (host_local_rows of the global shape); single-process it is
    the whole array and this is a plain sharded device_put."""
    from jax.sharding import PartitionSpec as P
    if spec is None:
        spec = P("data", *([None] * (host_rows.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host_rows, sharding)
    global_shape = (host_rows.shape[0] * jax.process_count(),) + \
        host_rows.shape[1:]
    return jax.make_array_from_process_local_data(sharding, host_rows,
                                                  global_shape)


def shard_mf_params(params: dict, mesh: Mesh) -> dict:
    """Row-shard the factor tables and bias vectors of an MF-family
    params dict across the mesh; scalars replicated."""
    out = {}
    for name, value in params.items():
        if getattr(value, "ndim", 0) >= 1:
            padded = pad_rows_to_multiple(np.asarray(value),
                                          mesh.devices.size)
            sharding = (row_sharded_2d(mesh) if padded.ndim == 2
                        else row_sharded(mesh))
            out[name] = jax.device_put(padded, sharding)
        else:
            out[name] = jax.device_put(value, replicated(mesh))
    return out
