"""Multi-chip sharded classification over a jax.sharding.Mesh.

Maps the reference's parallelism strategies (SURVEY §2.7) onto a 2-D device
mesh ("data", "table"):

- P1 (thread data-parallelism over reads)  -> the "data" mesh axis: read
  batches are split across data groups.
- P2/P3 (database parts + multi-GPU query pipeline, the serial GPU P2P
  chain of src/query_batch.cu:464-527) -> the "table" mesh axis; the
  QUERY-side sharded step lives in parallel.rows_mesh (all_to_all slot
  exchange — the only collective query path; the earlier
  all_gather variant here was retired because it held O(P) match
  matrices per device).
- P4 (replication) -> reshape the mesh: more "data" rows, fewer "table"
  columns (table replicated when it fits).

This module keeps the mesh construction plus the BUILD-side sharded
sketch step: each device sketches its input slice and (feature,
location) pairs return sharded for table construction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.sketch_jax import sketch_windows


def make_mesh(num_data: int, num_table: int,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None
                         else jax.devices())
    assert devices.size >= num_data * num_table, \
        f"need {num_data * num_table} devices, have {devices.size}"
    grid = devices.reshape(-1)[:num_data * num_table].reshape(
        num_data, num_table)
    return Mesh(grid, ("data", "table"))


def sharded_build_step(windows, valid, tgt_ids, win_ids, mesh,
                       k: int, sketchlen: int):
    """Sharded database-build sketch step: each data-parallel device
    sketches its window slice; (feature, target, window) triples return
    sharded for host-side (or device-side) table construction.

    Reference counterpart: the N-producer build pipeline + per-part
    inserter threads (src/building.cpp:337-461).
    """
    from jax import shard_map

    def local(windows, valid, tgt_ids, win_ids):
        feats = sketch_windows(windows, valid, k=k, sketchlen=sketchlen)
        s = feats.shape[1]
        t = jnp.broadcast_to(tgt_ids[:, None], feats.shape)
        w = jnp.broadcast_to(win_ids[:, None], feats.shape)
        return feats.reshape(-1), t.reshape(-1), w.reshape(-1)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "table")), P(("data", "table")),
                  P(("data", "table")), P(("data", "table"))),
        out_specs=(P(("data", "table")), P(("data", "table")),
                   P(("data", "table"))),
    )(windows, valid, tgt_ids, win_ids)
