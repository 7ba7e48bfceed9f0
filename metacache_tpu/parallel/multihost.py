"""Multi-host (multi-process) execution scaffolding.

The reference has no in-framework multi-node story — its only multi-node
path is offline partition + merge over result files
(/root/reference/src/mode_merge.cpp:80-293).  Here multi-host is
first-class: `jax.distributed` joins N processes into one JAX runtime, a
process-spanning mesh lays the **data axis across hosts (network)** and
the **table axis within a host (NVLink on a GPU host)**, and the
existing sharded query
steps (parallel.rows_mesh / parallel.mesh) run unchanged — GSPMD only
needs the mesh to span processes; the all_to_all over "table" stays
intra-host because the table axis is the fast-varying mesh dim.

Environment contract (one process per host):
    MC_COORDINATOR   host:port of process 0 (e.g. "10.0.0.1:8476")
    MC_NUM_PROCS     total process count
    MC_PROC_ID       this process's id in [0, MC_NUM_PROCS)

`metacache-tpu query ... -distributed` calls `initialize_from_env()`
before any JAX computation; each process then owns the row range
[pid*B/P, (pid+1)*B/P) of every global batch.
"""
from __future__ import annotations

import os

import numpy as np


def initialize_from_env() -> bool:
    """jax.distributed.initialize from MC_* env vars; returns True when
    multi-process mode is active.  Must run before the first JAX
    computation (backend initialization is one-shot)."""
    coord = os.environ.get("MC_COORDINATOR")
    if not coord:
        return False
    nproc = int(os.environ["MC_NUM_PROCS"])
    pid = int(os.environ["MC_PROC_ID"])
    initialize(coord, nproc, pid)
    return nproc > 1


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_ids=None) -> None:
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)


def make_global_mesh(num_data: int, num_table: int):
    """(data, table) mesh over ALL processes' devices.

    Device grid rows (data groups) are filled process-major so each data
    group's `num_table` table shards are devices of ONE process — the
    table-axis all_to_all stays within a host; only input distribution
    spans hosts (and that is host-side file reading, not a
    collective)."""
    import jax
    from jax.sharding import Mesh
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    need = num_data * num_table
    assert len(devs) >= need, f"need {need} devices, have {len(devs)}"
    grid = np.asarray(devs[:need], object).reshape(num_data, num_table)
    return Mesh(grid, ("data", "table"))


def process_row_range(total_rows: int) -> tuple[int, int]:
    """Rows of a global batch owned by this process (data-axis shard)."""
    import jax
    p = jax.process_count()
    i = jax.process_index()
    per = total_rows // p
    return i * per, (i + 1) * per if i + 1 < p else total_rows


def global_batch(local_rows: np.ndarray, mesh, spec=None):
    """Assemble a global device array from per-process local row slices.

    local_rows: this process's contiguous row block (all processes must
    pass equal-shaped blocks); the result is a global array sharded
    P("data") over the mesh — the multi-process equivalent of the
    single-process `jax.device_put(batch, NamedSharding(...))`."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, spec if spec is not None else P("data"))
    return jax.make_array_from_process_local_data(sharding, local_rows)


def replicated(arr, mesh):
    """Replicate a host array to every device of a multi-process mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(arr))


def local_values(global_arr) -> np.ndarray:
    """This process's rows of a P("data")-sharded result, in row order."""
    shards = sorted(global_arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])
