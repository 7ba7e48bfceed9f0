"""Multi-process CPU dryrun worker: one process of a 2-host cluster.

Run by __graft_entry__.dryrun_multichip (and usable standalone):

    python -m metacache_tpu.parallel.multihost_dryrun \
        --coordinator localhost:PORT --nprocs 2 --pid I --local-devices 4

Each process forces the CPU platform with N virtual devices, joins the
cluster via jax.distributed, builds the same synthetic database, and runs
the sharded row-layout query step over a process-spanning ("data",
"table") mesh — data axis across processes, table axis within a
process.  Every process verifies its own row range against a
single-device run and prints MULTIHOST_OK.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.local_devices}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    from metacache_tpu.parallel import multihost as MH
    MH.initialize(args.coordinator, args.nprocs, args.pid)

    assert jax.process_count() == args.nprocs
    ndev = len(jax.devices())
    assert ndev == args.nprocs * args.local_devices, \
        f"global devices {ndev} != {args.nprocs}x{args.local_devices}"

    # --- synthetic database (identical on every process) ---------------
    rng = np.random.default_rng(11)
    feats = np.unique(rng.integers(0, 2**32, 4096,
                                   dtype=np.uint64).astype(np.uint32))
    nf = len(feats)
    from metacache_tpu.ops.table import FeatureTable, pack_locations
    f_rep = np.repeat(feats, 2)
    ltgt = rng.integers(0, 64, nf * 2).astype(np.uint32)
    lwin = rng.integers(0, 500, nf * 2).astype(np.uint32)
    ft = FeatureTable.build(f_rep, pack_locations(ltgt, lwin))
    lin = np.zeros((64, 21), np.int32)
    lin[:, 0] = -np.arange(64) - 1
    lin[:, 4] = rng.integers(1, 9, 64)
    lin[:, 20] = 1

    num_table = 2
    num_data = ndev // num_table
    mesh = MH.make_global_mesh(num_data, num_table)
    # table axis must stay within one process
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1, \
            "table shards of one data group span processes"

    from metacache_tpu.parallel.rows_mesh import (shard_row_table,
                                                  sharded_query_step_rows)
    st = shard_row_table(ft, num_table, 255)

    B = num_data * num_table * 4          # global rows
    lo, hi = MH.process_row_range(B)
    # per-process local read windows (100bp reads, 1 window each);
    # deterministic content per GLOBAL row so results are checkable
    def make_rows(a, b):
        r2 = np.random.default_rng(1000)
        wins_all = r2.integers(0, 4, (B, 127), dtype=np.uint8)
        return wins_all[a:b]
    wins_loc = make_rows(lo, hi).reshape(hi - lo, 1, 127)
    valid_loc = np.full((hi - lo, 1), 100, np.int32)
    mwir_loc = np.full(hi - lo, 2, np.int32)

    from jax.sharding import PartitionSpec as P
    wins_g = MH.global_batch(wins_loc, mesh)
    valid_g = MH.global_batch(valid_loc, mesh)
    mwir_g = MH.global_batch(mwir_loc, mesh)
    put = lambda a: MH.replicated(a, mesh)

    res = sharded_query_step_rows(
        wins_g, valid_g, mwir_g,
        put(st.features), put(st.offsets), put(st.loc_tgt2d),
        put(st.loc_win2d), put(st.prefix),
        put(lin[:, 0]), put(lin),
        put(np.int32(1)), put(np.float32(1.0)),
        put(np.int32(19)), put(np.int32(0)),
        mesh=mesh, k=16, sketchlen=16,
        slots_per_feature=st.slots_per_feature, windows_per_query=1,
        max_candidates=2, prefix_bits=st.prefix_bits,
        prefix_steps=st.prefix_steps)
    got = MH.local_values(res.cls_tax)

    # --- verify: single-device run of this process's rows ---------------
    from metacache_tpu.ops.rows import query_step_rows
    from metacache_tpu.ops.table import unpack_locations
    from metacache_tpu.ops.probe import make_bucket_index
    lt, lw = unpack_locations(ft.locations)
    brows, bbits = make_bucket_index(ft.unique_features)
    import jax.numpy as jnp
    ref = query_step_rows(
        jnp.asarray(wins_loc), jnp.asarray(valid_loc),
        jnp.asarray(mwir_loc),
        jnp.asarray(ft.unique_features),
        jnp.asarray(ft.offsets.astype(np.int32)),
        jnp.asarray(lt.astype(np.int32)), jnp.asarray(lw.astype(np.int32)),
        jnp.asarray(lin[:, 0]), jnp.asarray(lin),
        jnp.int32(1), jnp.float32(1.0), jnp.int32(19), jnp.int32(0),
        jnp.asarray(brows),
        k=16, sketchlen=16,
        slots_per_feature=max(ft.max_bucket_size, 1),
        windows_per_query=1, max_candidates=2, prefix_bits=bbits,
        prefix_steps=0)
    want = np.asarray(ref.cls_tax)
    if not np.array_equal(got, want):
        print(f"MULTIHOST_FAIL pid={args.pid}: {got} != {want}",
              file=sys.stderr)
        return 1
    print(f"MULTIHOST_OK pid={args.pid} procs={jax.process_count()} "
          f"devices={ndev} rows=[{lo},{hi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
