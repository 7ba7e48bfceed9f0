"""Device (JAX/XLA) query pipeline: probe -> gather -> sort -> candidate
sweep -> top-k -> ranked-LCA classification.

Device re-design of the reference query hot path:

- CPU: host_hashmap::query_host_hashmap (src/host_hashmap.hpp:629-723),
  matches_sorter k-way merge (src/query_handler.hpp:44-106),
  for_all_contiguous_window_ranges + best_distinct_... top-k
  (src/candidate_generation.hpp:47-252), classify (src/classification.cpp:146-189).
- GPU: gpu_hahstable_query kernels + segmented sort + generate_top_candidates
  (src/gpu_hashmap_operations.cuh:841-1043, src/query_batch.cu:34-61,593-658,
  src/gpu_result_processing.cuh).

Key re-formulations for XLA (static shapes, no data-dependent control flow,
no 64-bit emulation — locations travel as split (target, window) i32 lanes):

- The two-pointer contiguous-window sweep becomes a *vectorized binary
  search*: for every sorted match i, its window-range hit count is
  ``i + 1 - lower_bound((qid_i, tgt_i, win_i - (numWindows-1)))`` — the
  left pointer of the reference's sweep is exactly that lower bound.
- The per-query match sort and all segmented reductions run over one flat
  (query-id, target, window) key triple via lexicographic `lax.sort`.
- Candidate top-k with taxon merging becomes two more key sorts:
  (query, taxon, hits desc, pos) to merge per-taxon candidates, then
  (query, hits desc, first-insertion pos) for the final ranking — matching
  the reference's insertion-order tie-breaking.
- Ranked LCA over the top candidates is a per-rank agreement scan over the
  dense target-lineage table (the same flattening the reference ships to
  its GPUs, src/gpu_hashmap.cu:1383-1396).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .sketch_jax import sketch_windows
from .stage import stage

I32_MAX = np.int32(2**31 - 1)
TGT_SENTINEL = I32_MAX  # padding slots sort last within a query


def searchsorted_3key(k1, k2, k3, q1, q2, q3):
    """Left insertion points of (q1,q2,q3) into arrays sorted by (k1,k2,k3).

    Vectorized branchless binary search; ~log2(n) gather steps.
    """
    n = k1.shape[0]
    lo = jnp.zeros(q1.shape, dtype=jnp.int32)
    hi = jnp.full(q1.shape, n, dtype=jnp.int32)
    steps = max(1, (n - 1).bit_length()) if n > 1 else n
    for _ in range(steps):
        mid = jax.lax.div(lo + hi, jnp.int32(2))
        a, b, c = k1[mid], k2[mid], k3[mid]
        less = (a < q1) | ((a == q1) & ((b < q2) | ((b == q2) & (c < q3))))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


class QueryResult(NamedTuple):
    cand_tgt: jax.Array    # (B, K) i32, -1 = none
    cand_tax: jax.Array    # (B, K) i32 taxon id of candidate (merged rank)
    cand_hits: jax.Array   # (B, K) i32
    cand_beg: jax.Array    # (B, K) i32 window range begin
    cand_end: jax.Array    # (B, K) i32 window range end (inclusive)
    cls_tax: jax.Array     # (B,) i32 classified taxon id (0 = unclassified)
    # flat sorted matches for -allhits / -hits-per-ref style outputs
    hit_qid: jax.Array     # (M,) i32 (B = padding)
    hit_tgt: jax.Array     # (M,) i32
    hit_win: jax.Array     # (M,) i32


def probe_and_gather(feats, qid_w, table_feats, table_offsets,
                     loc_tgt, loc_win, slots_per_feature: int):
    """Features (T, s) -> flat (qid, tgt, win) slot arrays (M = T*s*C)."""
    t, s = feats.shape
    c = slots_per_feature
    flat = feats.reshape(-1)
    f_tab = table_feats
    nf = f_tab.shape[0]
    idx = jnp.searchsorted(f_tab, flat).astype(jnp.int32)
    idx_c = jnp.minimum(idx, max(nf - 1, 0))
    found = (f_tab[idx_c] == flat) & (flat != jnp.uint32(0xFFFFFFFF)) \
        if nf > 0 else jnp.zeros_like(flat, dtype=bool)
    off = jnp.where(found, table_offsets[idx_c], 0).astype(jnp.int32)
    cnt = jnp.where(
        found,
        (table_offsets[idx_c + 1] - table_offsets[idx_c]).astype(jnp.int32),
        0)
    cnt = jnp.minimum(cnt, c)
    # gather up to c locations per probed feature
    j = jax.lax.broadcasted_iota(jnp.int32, (t * s, c), 1)
    li = off[:, None] + j
    li = jnp.minimum(li, max(loc_tgt.shape[0] - 1, 0))
    hit = j < cnt[:, None]
    tgts = jnp.where(hit, loc_tgt[li], TGT_SENTINEL)
    wins = jnp.where(hit, loc_win[li], I32_MAX)
    qk = jnp.broadcast_to(jnp.repeat(qid_w, s)[:, None], (t * s, c))
    return qk.reshape(-1), tgts.reshape(-1), wins.reshape(-1), \
        hit.reshape(-1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature", "num_queries",
                     "max_candidates"))
def query_step(windows, valid, qid_w, max_win_in_range,
               table_feats, table_offsets, loc_tgt, loc_win,
               merge_tax_of_target, lineages,
               hits_min, hits_diff_frac, highest_rank, merge_rank,
               *, k: int, sketchlen: int, slots_per_feature: int,
               num_queries: int, max_candidates: int) -> QueryResult:
    """One fused classification step for a batch of reads.

    Args:
      windows: (T, W) u8 window codes (all queries' windows concatenated).
      valid: (T,) i32 chars per window.
      qid_w: (T,) i32 query index per window (num_queries for padding).
      max_win_in_range: (B,) i32 per-query contiguous-range length
        (candidate_generation_rules.maxWindowsInRange).
      table_feats/table_offsets/loc_tgt/loc_win: CSR feature table arrays
        (locations split into i32 target/window lanes).
      merge_tax_of_target: (num_targets,) i32 taxon id each target merges
        into at the classification's lowest rank (0 = none).
      lineages: (num_targets, R) i32 ranked taxon-id lineages per target.
      hits_min, hits_diff_frac, highest_rank, merge_rank: classification
        parameters (traced scalars).
    """
    b = num_queries

    feats = sketch_windows(windows, valid, k=k, sketchlen=sketchlen)
    qk, tgt, win, is_match = probe_and_gather(
        feats, qid_w, table_feats, table_offsets, loc_tgt, loc_win,
        slots_per_feature)
    qk = jnp.where(is_match, qk, jnp.int32(b))
    return matches_to_result(
        qk, tgt, win, max_win_in_range, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        num_queries=b, max_candidates=max_candidates)


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature", "num_queries",
                     "max_candidates", "num_parts"))
def query_step_multipart(windows, valid, qid_w, max_win_in_range,
                         part_feats, part_offsets, part_ltgt, part_lwin,
                         merge_tax_of_target, lineages,
                         hits_min, hits_diff_frac, highest_rank, merge_rank,
                         *, k: int, sketchlen: int,
                         slots_per_feature: tuple, num_queries: int,
                         max_candidates: int, num_parts: int) -> QueryResult:
    """Multi-part database query: sketch once, probe every part, merge the
    match lists before candidate generation — the single-device analog of
    the reference probing every DB part sequentially and merge-sorting
    matches (src/host_hashmap.hpp:695-723).

    part_* are tuples (length num_parts) of per-part CSR arrays;
    slots_per_feature is a per-part tuple.
    """
    b = num_queries
    feats = sketch_windows(windows, valid, k=k, sketchlen=sketchlen)
    qks, tgts, wins_ = [], [], []
    for p in range(num_parts):
        qk, tgt, win, is_match = probe_and_gather(
            feats, qid_w, part_feats[p], part_offsets[p], part_ltgt[p],
            part_lwin[p], slots_per_feature[p])
        qks.append(jnp.where(is_match, qk, jnp.int32(b)))
        tgts.append(tgt)
        wins_.append(win)
    qk = jnp.concatenate(qks)
    tgt = jnp.concatenate(tgts)
    win = jnp.concatenate(wins_)
    return matches_to_result(
        qk, tgt, win, max_win_in_range, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        num_queries=b, max_candidates=max_candidates)


def _segmented_fill_first(values, is_start):
    """For each element, the `values` entry at the start of its segment.

    Segments are delimited by `is_start` flags along the array. Uses a
    log-depth associative scan — no scatters/gathers.
    """
    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    filled, _ = jax.lax.associative_scan(
        combine, (values, is_start))
    return filled


def matches_to_result(qk, tgt, win, max_win_in_range,
                      merge_tax_of_target, lineages,
                      hits_min, hits_diff_frac, highest_rank, merge_rank,
                      *, num_queries: int,
                      max_candidates: int) -> QueryResult:
    """Sort flat matches, sweep ranges, rank candidates, classify.

    Factored out of query_step so the sharded multi-chip path can feed it
    collectively-merged match arrays (qk entries >= num_queries are
    padding and sort to the end).

    The two-pointer sweep's lower bound is computed by a *rank join* — sort
    the M match keys together with M probe keys (win - range + 1) and
    count originals by prefix sum — and all per-segment reductions use
    sorts + neighbor compares + log-depth scans instead of segment
    scatters. The only remaining gathers are O(B*K) at the very end.
    """
    b = num_queries
    kk = max_candidates
    m = qk.shape[0]

    # ---- sort all matches by (query, target, window) -------------------
    qk, tgt, win = jax.lax.sort((qk, tgt, win), num_keys=3)
    is_match = qk < b
    pos = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0).reshape(-1)

    # ---- contiguous-window-range hit counts via rank join --------------
    # lo_i = left insertion point of (qk_i, tgt_i, win_i - (nw-1)) in the
    # sorted match list == the reference sweep's left pointer
    # (for_all_contiguous_window_ranges, src/candidate_generation.hpp:71-91).
    nwin = max_win_in_range[jnp.minimum(qk, b - 1)]
    win_lo = jnp.maximum(win - (nwin - 1), 0)
    cq = jnp.concatenate([qk, qk])
    ct = jnp.concatenate([tgt, tgt])
    cw = jnp.concatenate([win, win_lo])
    cf = jnp.concatenate([jnp.ones(m, jnp.int32),
                          jnp.zeros(m, jnp.int32)])  # 1 = original
    cidx = jnp.concatenate([pos, pos])
    # probes sort before originals with an equal key (left insertion)
    cq, ct, cw, cf, cidx = jax.lax.sort((cq, ct, cw, cf, cidx),
                                        num_keys=4)
    orig_before = jnp.cumsum(cf) - cf  # originals strictly before
    # route probe ranks back to original positions: probes first, by pos
    sf, sidx, lo = jax.lax.sort((cf, cidx, orig_before.astype(jnp.int32)),
                                num_keys=2)
    lo = lo[:m]  # probes occupy the first m rows (flag 0), ordered by pos
    hits = pos + 1 - lo
    end_w = win

    # ---- best range per (query, target): first position of max hits ----
    # sort candidates-to-be by (query, target, hits desc, pos asc):
    # the first row of each (query, target) group is the reference's
    # curBest (max hits, earliest position among ties).
    neg_hits0 = jnp.where(is_match, -hits, I32_MAX)
    (qk1, tgt1, neg_hits1, pos1, end1, lo1) = jax.lax.sort(
        (qk, tgt, neg_hits0, pos, end_w, lo), num_keys=4)
    prev_q1 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), qk1[:-1]])
    prev_t1 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), tgt1[:-1]])
    is_cand = (qk1 < b) & ((qk1 != prev_q1) | (tgt1 != prev_t1))

    # taxon each candidate merges into (mergeBelow semantics)
    tax = merge_tax_of_target[
        jnp.clip(tgt1, 0, merge_tax_of_target.shape[0] - 1)]
    is_cand = is_cand & (tax != 0)

    # ---- merge candidates of the same taxon: keep first max-hits -------
    qk2 = jnp.where(is_cand, qk1, jnp.int32(b))
    taxkey = jnp.where(is_cand, tax, I32_MAX)
    neg_hits2 = jnp.where(is_cand, neg_hits1, I32_MAX)
    (qk2, taxkey, neg_hits2, pos2, tgt2, end2, lo2) = jax.lax.sort(
        (qk2, taxkey, neg_hits2, pos1, tgt1, end1, lo1), num_keys=4)
    prev_q2 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), qk2[:-1]])
    prev_x2 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), taxkey[:-1]])
    is_rep = (qk2 < b) & ((qk2 != prev_q2) | (taxkey != prev_x2))
    # first insertion position of the taxon = min pos over its whole
    # (query, taxon) group: forward segmented-min scan (reset at group
    # starts), then propagate each group's final value backward
    def min_comb(a, bv):
        (av, af) = a
        (bvv, bf) = bv
        return jnp.where(bf, bvv, jnp.minimum(av, bvv)), af | bf
    pos_or_max = jnp.where(qk2 < b, pos2, I32_MAX)
    run_min, _ = jax.lax.associative_scan(min_comb, (pos_or_max, is_rep))
    grp_end = jnp.concatenate([is_rep[1:], jnp.ones((1,), bool)])
    first_pos = _segmented_fill_first(run_min[::-1], grp_end[::-1])[::-1]

    # ---- final candidate ranking: hits desc, insertion (pos) asc -------
    qk3 = jnp.where(is_rep, qk2, jnp.int32(b))
    neg_hits3 = jnp.where(is_rep, neg_hits2, I32_MAX)
    fp3 = jnp.where(is_rep, first_pos, I32_MAX)
    (qk3, neg_hits3, fp3, tgt3, tax3, end3, lo3) = jax.lax.sort(
        (qk3, neg_hits3, fp3, tgt2, taxkey, end2, lo2), num_keys=3)

    qstart = jnp.searchsorted(qk3, jnp.arange(b, dtype=jnp.int32)
                              ).astype(jnp.int32)
    sel = qstart[:, None] + jnp.arange(kk, dtype=jnp.int32)[None, :]
    sel_c = jnp.minimum(sel, m - 1)
    okc = (sel < m) & (qk3[sel_c] == jnp.arange(b, dtype=jnp.int32)[:, None])
    cand_tgt = jnp.where(okc, tgt3[sel_c], -1)
    cand_tax = jnp.where(okc, tax3[sel_c], 0)
    cand_hits = jnp.where(okc, -neg_hits3[sel_c], 0)
    # range begin = window at the sweep's left pointer; only O(B*K)
    # gathers from the (query,target,window)-sorted array
    lo_sel = jnp.clip(lo3[sel_c], 0, m - 1)
    cand_beg = jnp.where(okc, win[lo_sel], 0)
    cand_end = jnp.where(okc, end3[sel_c], 0)

    # ---- classification: threshold + iterated ranked LCA ---------------
    cls_tax = classify_candidates(
        cand_tgt, cand_tax, cand_hits, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)

    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax, qk, tgt, win)


@stage("lca")
def classify_candidates(cand_tgt, cand_tax, cand_hits, lineages,
                        hits_min, hits_diff_frac, highest_rank, merge_rank):
    """Device ranked-LCA classification (reference: classify,
    src/classification.cpp:146-189).

    The reference's iterated pairwise LCA (starting each step at the
    current LCA's rank) equals, by lineage nestedness, the lowest rank
    >= rank(cand0.tax) at which ALL included candidates' lineages agree
    with candidate 0's (nonzero).
    """
    num_ranks = lineages.shape[1]
    exists = cand_tax != 0
    hits0 = cand_hits[:, 0]
    valid0 = exists[:, 0] & (hits0 >= hits_min)
    threshold = jnp.where(hits0 > hits_min,
                          (hits0 - hits_min).astype(jnp.float32) *
                          hits_diff_frac,
                          jnp.float32(0))
    include = cand_hits.astype(jnp.float32) > threshold[:, None]
    include = include.at[:, 0].set(True)
    include = jnp.cumprod((include & exists).astype(jnp.int32),
                          axis=1).astype(bool)

    tgt0 = jnp.maximum(cand_tgt, 0)
    lin = lineages[tgt0]                      # (B, K, R)
    lin = jnp.where(exists[:, :, None], lin, 0)
    lin0 = lin[:, 0, :]                       # (B, R)

    ranks = jnp.arange(num_ranks, dtype=jnp.int32)[None, :]
    # rank of cand0.tax = first nonzero lineage entry at rank >= merge_rank
    elig0 = (lin0 != 0) & (ranks >= merge_rank)
    r0 = jnp.where(elig0.any(axis=1),
                   jnp.argmax(elig0, axis=1).astype(jnp.int32),
                   jnp.int32(num_ranks))

    agree = (lin == lin0[:, None, :]) | ~include[:, :, None]
    all_agree = agree.all(axis=1) & (lin0 != 0)
    eligible = all_agree & (ranks >= r0[:, None])
    has = eligible.any(axis=1)
    lca_rank = jnp.where(has, jnp.argmax(eligible, axis=1).astype(jnp.int32),
                         jnp.int32(num_ranks))
    lca_tax = jnp.take_along_axis(
        lin0, jnp.minimum(lca_rank, num_ranks - 1)[:, None], axis=1)[:, 0]
    ok = valid0 & has & (lca_rank <= highest_rank)
    return jnp.where(ok, lca_tax, 0).astype(jnp.int32)
