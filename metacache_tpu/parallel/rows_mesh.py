"""Multi-device row-layout classification over a ("data", "table") mesh.

Two compositions of the row pipeline (ops.rows):

1. **Pure data parallelism** (table fits per device, reference P1/P4): every
   stage of the row pipeline is per-row, so sharding the window matrix
   across devices and replicating the table parallelizes the whole step
   with plain sharding annotations — XLA inserts no collectives at all.

2. **Table sharding** (DB larger than one device's memory, reference P2/P3):
   each "table"-axis device holds a feature-range shard (with its own
   dense location rows and prefix index) and probes the entire local
   batch; one `all_to_all` then trades slot columns for row subsets —
   device p receives ALL shards' match slots for 1/P of the rows and
   finishes candidates/LCA locally. This replaces the reference's serial
   GPU P2P pipeline (src/query_batch.cu:464-527) with a single XLA
   collective (NCCL over NVLink on a GPU host).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.rows import probe_rows, rows_to_result
from ..ops.pipeline import QueryResult
from ..ops.sketch_jax import sketch_windows
from ..ops.probe import make_bucket_index


class ShardedRowTable(NamedTuple):
    """Feature-range shards with fused location rows + prefix indexes.

    slot_bits == 0: loc_tgt2d holds dense (tgt, win)-lane fused rows.
    slot_bits > 0: two-tier slot-packed shards — loc_tgt2d = head rows
    [feat, cnt, ovfid, head_slots pk lanes], loc_win2d = overflow rows
    (the deep-bucket layout; also HALVES the all_to_all volume, since
    one pk lane replaces the (tgt, win) pair)."""
    features: np.ndarray      # (P, Fs) u32 ascending per shard, padded
    offsets: np.ndarray       # (P, Fs+1) i32
    loc_tgt2d: np.ndarray     # (P, Fs, 2+2*spf pad) i32 fused rows
    loc_win2d: np.ndarray     # (P, 1) i32 dummy (fused rows carry wins)
    prefix: np.ndarray        # (P, 2^bits, 1+S) i32 shard-local bucket rows
    slots_per_feature: int
    prefix_bits: int
    prefix_steps: int
    slot_bits: int = 0
    head_slots: int = 0


def shard_row_table(table, num_shards: int, maxloc: int,
                    layout: str = "auto") -> ShardedRowTable:
    """layout: "dense" (full-width fused rows), "two_tier" (61-slot
    packed heads + overflow rows), or "auto" (two-tier once the padded
    dense row would exceed 128 lanes, i.e. deep-bucket databases)."""
    f = table.unique_features
    offs = table.offsets
    from ..ops.table import unpack_locations
    from ..ops.table_device import slot_pack_bits
    ltgt, lwin = unpack_locations(table.locations)
    nf = len(f)
    spf = min(table.max_bucket_size, maxloc) or 1
    wbits = slot_pack_bits(int(lwin.max()) if len(lwin) else 0,
                           int(ltgt.max()) if len(ltgt) else 0)
    two_tier = wbits and (layout == "two_tier" or
                          (layout == "auto" and spf > 61))
    cuts = [int(round(i * nf / num_shards)) for i in range(num_shards + 1)]
    fs = max(max(cuts[i + 1] - cuts[i] for i in range(num_shards)), 1)
    # per-shard bucket-row indexes (same bits, padded to the widest S)
    prefix_bits = min(24, max(12, int(max(fs, 1)).bit_length() - 2))
    shard_buckets = []
    steps = 0
    feats = np.full((num_shards, fs), 0xFFFFFFFF, np.uint32)
    offsets = np.zeros((num_shards, fs + 1), np.int32)
    if two_tier:
        hsl = min(61, spf - 1)
        ow = spf - hsl
        ow_pad = max(64, ((ow + 7) // 8) * 8)
        heads = np.zeros((num_shards, fs, 64), np.int32)
        ovf_parts = []
    else:
        hsl = 0
        cols_pad = max(64, ((2 + 2 * spf + 7) // 8) * 8)
        fused = np.zeros((num_shards, fs, cols_pad), np.int32)
    for p in range(num_shards):
        a, b = cuts[p], cuts[p + 1]
        n = b - a
        feats[p, :n] = f[a:b]
        local = (offs[a:b + 1] - offs[a]).astype(np.int32)
        offsets[p, :n + 1] = local
        offsets[p, n + 1:] = local[-1] if n else 0
        sizes = np.minimum(np.diff(offs[a:b + 1]), spf).astype(np.int64)
        if two_tier:
            heads[p, :n, 0] = f[a:b].view(np.int32)
            heads[p, :n, 1] = sizes
            over = sizes > hsl
            novf = int(over.sum())
            heads[p, :n, 2][over] = 1 + np.arange(novf)
            orows = np.zeros((novf + 1, ow_pad), np.int32)
            if n and sizes.sum():
                rows = np.repeat(np.arange(n, dtype=np.int64), sizes)
                starts = np.zeros(n, np.int64)
                np.cumsum(sizes[:-1], out=starts[1:])
                cols = np.arange(int(sizes.sum()), dtype=np.int64) - \
                    np.repeat(starts, sizes)
                src = np.repeat(offs[a:b], sizes) + cols
                pk = (ltgt[src].astype(np.int64) << wbits) | lwin[src]
                in_head = cols < hsl
                heads[p][rows[in_head], 3 + cols[in_head]] = \
                    pk[in_head].astype(np.int32)
                oid = np.repeat(heads[p, :n, 2], sizes)
                osel = ~in_head
                orows[oid[osel], cols[osel] - hsl] = \
                    pk[osel].astype(np.int32)
            ovf_parts.append(orows)
        else:
            fused[p, :n, 0] = f[a:b].view(np.int32)
            fused[p, :n, 1] = sizes
            if n and sizes.sum():
                rows = np.repeat(np.arange(n, dtype=np.int64), sizes)
                starts = np.zeros(n, np.int64)
                np.cumsum(sizes[:-1], out=starts[1:])
                cols = np.arange(int(sizes.sum()), dtype=np.int64) - \
                    np.repeat(starts, sizes)
                src = np.repeat(offs[a:b], sizes) + cols
                fused[p][rows, 2 + cols] = ltgt[src]
                fused[p][rows, 2 + spf + cols] = lwin[src]
        br, _ = make_bucket_index(f[a:b], prefix_bits)
        shard_buckets.append(br)
    smax = max(br.shape[1] for br in shard_buckets)
    prefix = np.full((num_shards, 1 << prefix_bits, smax), -1, np.int32)
    for p, br in enumerate(shard_buckets):
        prefix[p, :, :br.shape[1]] = br
    if two_tier:
        omax = max(o.shape[0] for o in ovf_parts)
        ovf = np.zeros((num_shards, omax, ow_pad), np.int32)
        for p, o in enumerate(ovf_parts):
            ovf[p, :o.shape[0]] = o
        return ShardedRowTable(feats, offsets, heads, ovf, prefix, spf,
                               prefix_bits, steps, wbits, hsl)
    dummy = np.zeros((num_shards, 1), np.int32)
    return ShardedRowTable(feats, offsets, fused, dummy, prefix, spf,
                           prefix_bits, steps)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "sketchlen", "slots_per_feature",
                     "windows_per_query", "max_candidates",
                     "prefix_bits", "prefix_steps", "pack_bits",
                     "head_slots"))
def sharded_query_step_rows(windows, valid, mwir,
                            st_features, st_offsets, st_lt2, st_lw2,
                            st_prefix, merge_tax_of_target, lineages,
                            hits_min, hits_diff_frac, highest_rank,
                            merge_rank,
                            *, mesh: Mesh, k: int, sketchlen: int,
                            slots_per_feature: int, windows_per_query: int,
                            max_candidates: int, prefix_bits: int,
                            prefix_steps: int,
                            pack_bits: int = 0,
                            head_slots: int = 0) -> QueryResult:
    """Sharded row-layout step.

    Global shapes: windows (B, Wq, W) with B divisible by
    num_data*num_table; st_* carry a leading shard dim (P, ...).
    Output rows are ordered data-major then table-subset-major — the same
    row order as the input when num_table == 1; callers reorder for P>1.

    ``pack_bits > 0``: shards are two-tier slot-packed (head_slots-wide
    heads + overflow rows, ShardedRowTable.slot_bits) — the exchange is
    then ONE pk matrix instead of the (tgt, win) pair, halving the
    all_to_all volume.
    """
    from jax import shard_map
    num_table = mesh.shape["table"]
    dense_tag = ("two_tier", head_slots, False, False, pack_bits) \
        if pack_bits else True

    def local(wmat, vmat, mw, tf, to, lt2, lw2, ps, mt, lin,
              hits_min, hits_diff_frac, highest_rank, merge_rank):
        tf, to = tf[0], to[0]
        lt2, lw2, ps = lt2[0], lw2[0], ps[0]
        # sketch ONCE per read: the window matrix is sharded over BOTH
        # mesh axes, each device sketches 1/P of its data-shard's
        # reads, and one small all_gather over "table" redistributes
        # the finished sketches (wq*s u32/read — a fraction of the
        # probe-slot exchange) so every table shard probes the full
        # local batch. The reference likewise forwards sketches to
        # every GPU instead of re-sketching
        # (src/query_batch.cu:464-527, gpu_hashmap_operations.cuh:
        # 896-901).
        b_sub, wq, w = wmat.shape
        feats = sketch_windows(wmat.reshape(b_sub * wq, w),
                               vmat.reshape(b_sub * wq), k=k,
                               sketchlen=sketchlen)
        feats = feats.reshape(b_sub, wq * sketchlen)
        if num_table > 1:
            feats = jax.lax.all_gather(feats, "table", axis=0,
                                       tiled=True)
        tgt, win = probe_rows(feats, tf, to, lt2, lw2,
                              slots_per_feature, ps, prefix_bits,
                              prefix_steps, dense=dense_tag,
                              pack_bits=pack_bits)
        if num_table > 1:
            # trade slot columns for row subsets: device p receives all
            # shards' slots for rows [p*b_loc/P, (p+1)*b_loc/P)
            tgt = jax.lax.all_to_all(tgt, "table", split_axis=0,
                                     concat_axis=1, tiled=True)
            if not pack_bits:
                win = jax.lax.all_to_all(win, "table", split_axis=0,
                                         concat_axis=1, tiled=True)
            else:
                win = tgt
            r = jax.lax.axis_index("table")
            mw = jax.lax.dynamic_slice_in_dim(mw, r * b_sub, b_sub)
        return rows_to_result(
            tgt, win, mw, mt, lin, hits_min, hits_diff_frac,
            highest_rank, merge_rank, max_candidates=max_candidates,
            pack_bits=pack_bits)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "table")), P(("data", "table")), P("data"),
                  P("table"), P("table"), P("table"), P("table"),
                  P("table"), None, None, None, None, None, None),
        out_specs=QueryResult(
            cand_tgt=P(("data", "table")), cand_tax=P(("data", "table")),
            cand_hits=P(("data", "table")), cand_beg=P(("data", "table")),
            cand_end=P(("data", "table")), cls_tax=P(("data", "table")),
            hit_qid=P(("data", "table")), hit_tgt=P(("data", "table")),
            hit_win=P(("data", "table"))),
        check_vma=False,
    )(windows, valid, mwir, st_features, st_offsets, st_lt2, st_lw2,
      st_prefix, merge_tax_of_target, lineages,
      hits_min, hits_diff_frac, highest_rank, merge_rank)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "sketchlen", "slots_per_feature",
                     "windows_per_query", "max_candidates",
                     "prefix_bits", "prefix_steps", "pack_bits",
                     "head_slots"))
def sharded_query_step_rows_head(windows, valid, mwir,
                                 st_features, st_offsets, st_lt2,
                                 st_lw2, st_prefix,
                                 merge_tax_of_target, lineages,
                                 hits_min, hits_diff_frac,
                                 highest_rank, merge_rank,
                                 *, mesh: Mesh, k: int, sketchlen: int,
                                 slots_per_feature: int,
                                 windows_per_query: int,
                                 max_candidates: int, prefix_bits: int,
                                 prefix_steps: int, pack_bits: int,
                                 head_slots: int):
    """Escalation phase 1 on table-sharded two-tier layouts: every
    shard probes ONLY its head rows (one gather, no overflow rows);
    the exchange trades head slots for row subsets and each read's
    per-shard `over` flags OR-reduce through the same all_to_all.

    -> (QueryResult, over (B,) bool): over=False reads are EXACT;
    over=True reads must re-run through the full-depth step
    (sharded_query_step_rows) — the same two-phase structure as the
    single-chip summary loop. Requires slot-packed two-tier shards."""
    from jax import shard_map
    from ..ops.rows import probe_rows_head
    num_table = mesh.shape["table"]
    assert pack_bits and head_slots
    dense_tag = ("two_tier", head_slots, False, False, pack_bits)

    def local(wmat, vmat, mw, tf, to, lt2, lw2, ps, mt, lin,
              hits_min, hits_diff_frac, highest_rank, merge_rank):
        tf, to = tf[0], to[0]
        lt2, lw2, ps = lt2[0], lw2[0], ps[0]
        b_sub, wq, w = wmat.shape
        feats = sketch_windows(wmat.reshape(b_sub * wq, w),
                               vmat.reshape(b_sub * wq), k=k,
                               sketchlen=sketchlen)
        feats = feats.reshape(b_sub, wq * sketchlen)
        if num_table > 1:
            feats = jax.lax.all_gather(feats, "table", axis=0,
                                       tiled=True)
        pk, over = probe_rows_head(feats, lt2, ps, prefix_bits,
                                   dense_tag, pack_bits)
        if num_table > 1:
            pk = jax.lax.all_to_all(pk, "table", split_axis=0,
                                    concat_axis=1, tiled=True)
            over = jax.lax.all_to_all(
                over.astype(jnp.int32)[:, None], "table",
                split_axis=0, concat_axis=1, tiled=True)
            over = jnp.any(over > 0, axis=1)
            r = jax.lax.axis_index("table")
            mw = jax.lax.dynamic_slice_in_dim(mw, r * b_sub, b_sub)
        res = rows_to_result(
            pk, pk, mw, mt, lin, hits_min, hits_diff_frac,
            highest_rank, merge_rank, max_candidates=max_candidates,
            pack_bits=pack_bits)
        return res, over

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "table")), P(("data", "table")), P("data"),
                  P("table"), P("table"), P("table"), P("table"),
                  P("table"), None, None, None, None, None, None),
        out_specs=(QueryResult(
            cand_tgt=P(("data", "table")), cand_tax=P(("data", "table")),
            cand_hits=P(("data", "table")), cand_beg=P(("data", "table")),
            cand_end=P(("data", "table")), cls_tax=P(("data", "table")),
            hit_qid=P(("data", "table")), hit_tgt=P(("data", "table")),
            hit_win=P(("data", "table"))), P(("data", "table"))),
        check_vma=False,
    )(windows, valid, mwir, st_features, st_offsets, st_lt2, st_lw2,
      st_prefix, merge_tax_of_target, lineages,
      hits_min, hits_diff_frac, highest_rank, merge_rank)
