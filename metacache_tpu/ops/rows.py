"""Row-layout query pipeline: one row per query, sorts along lanes.

The flat pipeline (ops.pipeline) sorts one giant (query, target, window)
array — O(M log^2 M) bitonic passes for M ~ millions. When every query in
a batch has the same (padded) window count Wq, the match slots form a
dense (B, L) matrix with L = Wq * sketchlen * slots_per_feature, and every
stage becomes a *per-row* sort of a few hundred lanes — bitonic depth
log^2(L) instead of log^2(B*L), and every row sorts independently. This
is the counterpart of the reference GPU's per-query segmented sort
(bb_segsort, src/query_batch.cu:34-61).

Semantics are identical to ops.pipeline.matches_to_result (verified by the
shared oracle tests); the runner picks this path for window-count-bucketed
batches.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sketch_jax import sketch_windows
from .pipeline import QueryResult, classify_candidates
from .stage import stage


I32_MAX = np.int32(2**31 - 1)


def _tag_wide(dense) -> bool:
    """True when the probe layout tag is a u64-feature variant
    ("u64pk<bits>(p)" dense, ("u64_two_tier", ...) tuple)."""
    if isinstance(dense, str):
        return dense.startswith("u64")
    if isinstance(dense, tuple):
        return isinstance(dense[0], str) and dense[0].startswith("u64")
    return False


def _meta_match(rows, flat, wide: bool):
    """Row-gather feature verification: one meta lane for u32 features,
    two (lo, hi) for u64."""
    if wide:
        lo = jax.lax.bitcast_convert_type(
            (flat & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
            jnp.int32)
        hi = jax.lax.bitcast_convert_type(
            (flat >> jnp.uint64(32)).astype(jnp.uint32), jnp.int32)
        return ((rows[:, 0] == lo) & (rows[:, 1] == hi) &
                (flat != jnp.uint64(0xFFFFFFFFFFFFFFFF)))
    flat_i32 = jax.lax.bitcast_convert_type(flat, jnp.int32)
    return (rows[:, 0] == flat_i32) & (flat != jnp.uint32(0xFFFFFFFF))


@stage("candidates")
def rows_to_result(tgt, win, mwir, merge_tax_of_target, lineages,
                   hits_min, hits_diff_frac, highest_rank, merge_rank,
                   *, max_candidates: int,
                   walk_elems: int = 0,
                   dedup_walk: int = 0,
                   fast_top2: bool = False,
                   emit_hits: bool = True,
                   pack_bits: int = 0) -> QueryResult:
    """(B, L) per-query match slots -> candidates + classification.

    `tgt`/`win` hold I32_MAX in padding slots; `mwir` is (B,).

    ``walk_elems > 0`` asserts that no contiguous window range ever
    contains more than ``walk_elems`` sorted match slots (callers bound it
    by max(mwir) * sketchlen * windows_per_query); the range sweep then
    runs as ``walk_elems`` masked lane shifts instead of the two
    double-width rank-join sorts.

    ``dedup_walk > 0`` asserts only max(mwir) <= dedup_walk: duplicate
    (tgt, win) slots are first compacted into distinct entries with run
    counts (one extra per-row sort + suffix-min tricks), after which a
    contiguous window range spans at most max(mwir) *distinct* entries,
    so the sweep is dedup_walk masked lane shifts. This is the long-read
    path, where walk_elems would be huge but mwir stays small.

    ``fast_top2`` asserts merge_rank == 0 (no taxon merging: candidate
    taxon == target, the default `-lowest sequence` configuration) and
    that merge_tax_of_target is nonzero for every real target. Then the
    best-per-target + taxon-merge + final-ranking sorts (3 multi-operand
    bitonic sorts over L lanes) collapse into one segmented suffix-max
    scan plus max_candidates masked max-reductions — the same candidate
    list, tie-broken identically (hits desc, then earliest best slot,
    which equals target insertion order as in
    src/candidate_generation.hpp:189-231).
    """
    b, l = tgt.shape
    kk = max_candidates

    if pack_bits:
        # clamping mwir to 2^(wbits-1) is semantically identity (the
        # caller guarantees 2^(wbits-1) > max window index, so the
        # clamped range still covers every window of a target) and
        # keeps the packed sweep's single-compare range test exact:
        # the inter-target gap 2^wbits - maxwin always exceeds mwir - 1
        mwir = jnp.minimum(mwir, jnp.int32(1 << (pack_bits - 1)))

    # ---- per-row sort by (target, window) ------------------------------
    if pack_bits:
        # packed single-key sort (pk order == (tgt, win) lexicographic),
        # then unpack: identical downstream semantics at half the sort
        pk = jax.lax.sort(tgt, dimension=1)
        pad = pk == I32_MAX
        tgt = jnp.where(pad, I32_MAX,
                        jax.lax.shift_right_logical(pk, jnp.int32(pack_bits)))
        win = jnp.where(pad, I32_MAX, pk & ((1 << pack_bits) - 1))
    else:
        tgt, win = jax.lax.sort((tgt, win), dimension=1, num_keys=2)
    is_match = tgt != I32_MAX
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    if emit_hits:
        hit_tgt_flat = tgt.reshape(-1)
        hit_win_flat = win.reshape(-1)
    else:
        hit_tgt_flat = hit_win_flat = None

    carry_beg = False
    if 0 < dedup_walk:
        # -- compact duplicate (t, w) runs to distinct entries + counts --
        prev_t = jnp.concatenate(
            [jnp.full((b, 1), -1, jnp.int32), tgt[:, :-1]], axis=1)
        prev_w = jnp.concatenate(
            [jnp.full((b, 1), -1, jnp.int32), win[:, :-1]], axis=1)
        col0 = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
        start = (col0 == 0) | (tgt != prev_t) | (win != prev_w)
        s_pos = jnp.where(start, pos, I32_MAX)
        nxt_incl = jax.lax.cummin(s_pos[:, ::-1], axis=1)[:, ::-1]
        nxt = jnp.concatenate(
            [nxt_incl[:, 1:], jnp.full((b, 1), I32_MAX, jnp.int32)],
            axis=1)
        nxt = jnp.minimum(nxt, l)          # next run's start (= my run end)
        cnt = nxt - pos                    # run length   (valid at starts)
        endpos = nxt - 1                   # last slot of the run
        ckey = jnp.where(start & is_match, 0, 1).astype(jnp.int32)
        (ckey2, _, tgt, win, cnt, endpos) = jax.lax.sort(
            (ckey, pos, tgt, win, cnt, endpos), dimension=1, num_keys=2)
        valid = ckey2 == 0
        # -- sweep over distinct entries: <= max(mwir) per range ---------
        w_lo = win - (mwir[:, None] - 1)
        hits = jnp.where(valid, cnt, 0)
        beg = win
        for e in range(1, dedup_walk):
            te = jnp.concatenate(
                [jnp.full((b, e), -1, jnp.int32), tgt[:, :-e]], axis=1)
            we = jnp.concatenate(
                [jnp.full((b, e), -1, jnp.int32), win[:, :-e]], axis=1)
            ce = jnp.concatenate(
                [jnp.zeros((b, e), jnp.int32), cnt[:, :-e]], axis=1)
            ve = jnp.concatenate(
                [jnp.zeros((b, e), bool), valid[:, :-e]], axis=1)
            ok = valid & ve & (te == tgt) & (we >= w_lo)
            hits = hits + jnp.where(ok, ce, 0)
            beg = jnp.where(ok, we, beg)   # last ok shift = smallest win
        is_match = valid
        tgt = jnp.where(valid, tgt, I32_MAX)
        win = jnp.where(valid, win, I32_MAX)
        pos = endpos                       # original range-end slot index
        lo = beg                           # carried begin WINDOW directly
        carry_beg = True
    elif 0 < walk_elems < l:
        w_lo = win - (mwir[:, None] - 1)
        hits = jnp.ones((b, l), jnp.int32)
        for e in range(1, walk_elems):
            te = jnp.concatenate(
                [jnp.full((b, e), -1, jnp.int32), tgt[:, :-e]], axis=1)
            we = jnp.concatenate(
                [jnp.full((b, e), -1, jnp.int32), win[:, :-e]], axis=1)
            hits = hits + ((te == tgt) & (we >= w_lo)).astype(jnp.int32)
        lo = pos + 1 - hits
    else:
        # rank join for the two-pointer left bound
        win_lo = jnp.maximum(win - (mwir[:, None] - 1), 0)
        ct = jnp.concatenate([tgt, tgt], axis=1)
        cw = jnp.concatenate([win, win_lo], axis=1)
        cf = jnp.concatenate([jnp.ones((b, l), jnp.int32),
                              jnp.zeros((b, l), jnp.int32)], axis=1)
        cidx = jnp.concatenate([pos, pos], axis=1)
        ct, cw, cf, cidx = jax.lax.sort((ct, cw, cf, cidx), dimension=1,
                                        num_keys=3)
        orig_before = jnp.cumsum(cf, axis=1) - cf
        _, _, lo = jax.lax.sort((cf, cidx, orig_before.astype(jnp.int32)),
                                dimension=1, num_keys=2)
        lo = lo[:, :l]
        hits = pos + 1 - lo

    if fast_top2 and max_candidates <= 4:
        return _fast_top2_result(
            tgt, win, hits, lo, is_match, carry_beg,
            hit_tgt_flat, hit_win_flat, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank,
            max_candidates)

    # ---- best range per target: sort by (tgt, hits desc, pos) ----------
    neg_hits0 = jnp.where(is_match, -hits, I32_MAX)
    (tgt1, neg1, pos1, end1, lo1) = jax.lax.sort(
        (tgt, neg_hits0, pos, win, lo), dimension=1, num_keys=3)
    col = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    prev_t = jnp.concatenate(
        [jnp.full((b, 1), -1, jnp.int32), tgt1[:, :-1]], axis=1)
    is_cand = (tgt1 != I32_MAX) & ((col == 0) | (tgt1 != prev_t))

    tax = merge_tax_of_target[
        jnp.clip(tgt1, 0, merge_tax_of_target.shape[0] - 1)]
    is_cand = is_cand & (tax != 0)

    # ---- merge by taxon: sort by (tax, hits desc, pos) -----------------
    taxkey = jnp.where(is_cand, tax, I32_MAX)
    neg2 = jnp.where(is_cand, neg1, I32_MAX)
    (taxkey2, neg2, pos2, tgt2, end2, lo2) = jax.lax.sort(
        (taxkey, neg2, pos1, tgt1, end1, lo1), dimension=1, num_keys=3)
    prev_x = jnp.concatenate(
        [jnp.full((b, 1), -1, jnp.int32), taxkey2[:, :-1]], axis=1)
    # taxon ids can be negative (sequence-level) — a -1 sentinel would
    # collide, so column 0 is always a group start
    is_rep = (taxkey2 != I32_MAX) & ((col == 0) | (taxkey2 != prev_x))

    # first insertion position per taxon group (groups are contiguous
    # runs after the sort; the representative is the group's first
    # element). One cummin with a per-group lane offset replaces two
    # tuple associative scans: with
    # g = group index and L2 > lane count, v = pos + g*L2 makes every
    # later group's values larger than any value of group g, so the
    # suffix min at a group start is g*L2 + min(pos in group).
    g = jnp.cumsum(is_rep.astype(jnp.int32), axis=1)
    l2 = 1 << int(l).bit_length()
    v = jnp.where(taxkey2 != I32_MAX, pos2 + g * l2, I32_MAX)
    sufmin = jax.lax.cummin(v[:, ::-1], axis=1)[:, ::-1]
    first_pos = sufmin - g * l2

    # ---- final ranking: hits desc, first insertion asc -----------------
    # representatives have pairwise-distinct first_pos (group minima of
    # disjoint position sets), so neg*L2 + first_pos is a unique total
    # order: for small kk, kk masked min-reductions replace the 6-array
    # bitonic sort
    if kk <= 4 and l * l2 < 2**31:
        comp = jnp.where(is_rep, neg2 * l2 + first_pos, I32_MAX)
        cols = {"neg": neg2, "tgt": tgt2, "tax": taxkey2, "end": end2,
                "lo": lo2}
        picked = {k: [] for k in cols}
        oks = []
        for _ in range(kk):
            m = comp.min(axis=1, keepdims=True)
            pick = comp == m
            ok = m[:, 0] != I32_MAX
            oks.append(ok)
            for key, arr in cols.items():
                picked[key].append(jnp.where(pick, arr, 0).sum(axis=1, dtype=jnp.int32))
            comp = jnp.where(pick, I32_MAX, comp)
        okc = jnp.stack(oks, axis=1)
        neg3 = jnp.stack(picked["neg"], axis=1)
        tgt3 = jnp.stack(picked["tgt"], axis=1)
        tax3 = jnp.stack(picked["tax"], axis=1)
        end3 = jnp.stack(picked["end"], axis=1)
        lo3 = jnp.stack(picked["lo"], axis=1)
    else:
        neg3 = jnp.where(is_rep, neg2, I32_MAX)
        fp3 = jnp.where(is_rep, first_pos, I32_MAX)
        (neg3, fp3, tgt3, tax3, end3, lo3) = jax.lax.sort(
            (neg3, fp3, tgt2, taxkey2, end2, lo2), dimension=1,
            num_keys=2)
        neg3, tgt3, tax3 = neg3[:, :kk], tgt3[:, :kk], tax3[:, :kk]
        end3, lo3 = end3[:, :kk], lo3[:, :kk]
        okc = neg3 != I32_MAX

    cand_tgt = jnp.where(okc, tgt3, -1)
    cand_tax = jnp.where(okc, tax3, 0)
    cand_hits = jnp.where(okc, -neg3, 0)
    if carry_beg:
        cand_beg = jnp.where(okc, lo3, 0)
    else:
        lo_sel = jnp.clip(lo3, 0, l - 1)
        cand_beg = jnp.where(
            okc, jnp.take_along_axis(win, lo_sel, axis=1), 0)
    cand_end = jnp.where(okc, end3, 0)

    cls_tax = classify_candidates(
        cand_tgt, cand_tax, cand_hits, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)

    # flat hit arrays for -allhits (row-major: qid = row index; always the
    # original pre-dedup sorted slots)
    if hit_tgt_flat is None:
        hit_qid = hit_tgt_flat = hit_win_flat = jnp.zeros((1,), jnp.int32)
    else:
        hit_qid = jnp.where(
            hit_tgt_flat.reshape(b, l) != I32_MAX,
            jax.lax.broadcasted_iota(jnp.int32, (b, l), 0),
            jnp.int32(b)).reshape(-1)
    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax, hit_qid, hit_tgt_flat, hit_win_flat)


def _fast_top2_result(tgt, win, hits, lo, is_match, carry_beg,
                      hit_tgt_flat, hit_win_flat, merge_tax_of_target,
                      lineages, hits_min, hits_diff_frac, highest_rank,
                      merge_rank, kk: int) -> QueryResult:
    """Top-k candidates without taxon merging (merge_rank == 0).

    Slots arrive (tgt, win)-sorted with padding (tgt == I32_MAX) last, so
    target groups are contiguous lane runs. Per group, the best range is
    the max of key = hits * L2 + (L2-1-col): highest hits, then earliest
    slot — the reference's curBest rule (max hits, first position,
    src/candidate_generation.hpp:96-115). A suffix cummax with per-group
    offsets -g*L2^2 isolates groups (later groups' values are strictly
    smaller since key < L2^2), placing each group's max at its start lane.
    Global ranking (hits desc, insertion asc) = plain max over group
    starts, because key order equals (hits desc, slot pos asc) and slot
    pos order equals target insertion order.
    """
    b, l = tgt.shape
    l2 = 1 << int(l).bit_length()
    kb = l2 * l2
    # group-isolated keys fit i32 only while l * l2^2 < 2^31 (~192
    # slots); deep-bucket databases (spf up to 254 -> l ~ 4k) widen the
    # scan to i64
    import contextlib
    wide = l * kb >= 2**31
    ctx = jax.enable_x64(True) if wide else contextlib.nullcontext()
    with ctx:
        # NOTE: the whole scan AND the extraction loop live inside the
        # x64 scope — any op mixing an int64 array with a Python scalar
        # outside it would silently demote (and truncate) to int32.
        kdt = jnp.int64 if wide else jnp.int32
        neg_inf = kdt(jnp.iinfo(kdt).min + 1)
        col = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)

        key = hits.astype(kdt) * l2 + (l2 - 1 - col)
        prev_t = jnp.concatenate(
            [jnp.full((b, 1), -1, jnp.int32), tgt[:, :-1]], axis=1)
        newt = (col == 0) | (tgt != prev_t)
        g = jnp.cumsum(newt.astype(kdt), axis=1)
        v = jnp.where(is_match, key - g * kb, neg_inf)
        sufmax = jax.lax.cummax(v[:, ::-1], axis=1)[:, ::-1]
        repkey = jnp.where(newt & is_match, sufmax + g * kb, neg_inf)

        shift = int(l2).bit_length() - 1
        comp = repkey
        c_tgt, c_tax, c_hits, c_beg, c_end = [], [], [], [], []
        ntax = merge_tax_of_target.shape[0]
        for _ in range(kk):
            mx = comp.max(axis=1, keepdims=True)
            ok = mx[:, 0] > 0
            bestkey = jnp.where(ok, mx[:, 0], 0)
            bestcol = jnp.clip(l2 - 1 - (bestkey & (l2 - 1)),
                               0, l - 1).astype(jnp.int32)
            bc = bestcol[:, None]
            t_b = jnp.take_along_axis(tgt, bc, axis=1)[:, 0]
            w_b = jnp.take_along_axis(win, bc, axis=1)[:, 0]
            lo_b = jnp.take_along_axis(lo, bc, axis=1)[:, 0]
            if carry_beg:
                beg_b = lo_b                   # begin window carried
            else:
                beg_b = jnp.take_along_axis(
                    win, jnp.clip(lo_b, 0, l - 1)[:, None], axis=1)[:, 0]
            tg = jnp.where(ok, t_b, -1)
            c_tgt.append(tg)
            c_tax.append(jnp.where(
                ok, merge_tax_of_target[jnp.clip(tg, 0, ntax - 1)], 0))
            c_hits.append(jnp.where(ok, bestkey >> shift,
                                    0).astype(jnp.int32))
            c_beg.append(jnp.where(ok, beg_b, 0))
            c_end.append(jnp.where(ok, w_b, 0))
            comp = jnp.where(comp == mx, neg_inf, comp)

    cand_tgt = jnp.stack(c_tgt, axis=1)
    cand_tax = jnp.stack(c_tax, axis=1)
    cand_hits = jnp.stack(c_hits, axis=1)
    cand_beg = jnp.stack(c_beg, axis=1)
    cand_end = jnp.stack(c_end, axis=1)

    cls_tax = classify_candidates(
        cand_tgt, cand_tax, cand_hits, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)
    if hit_tgt_flat is None:
        hit_qid = hit_tgt_flat = hit_win_flat = jnp.zeros((1,), jnp.int32)
    else:
        hit_qid = jnp.where(
            hit_tgt_flat.reshape(b, l) != I32_MAX,
            jax.lax.broadcasted_iota(jnp.int32, (b, l), 0),
            jnp.int32(b)).reshape(-1)
    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax, hit_qid, hit_tgt_flat, hit_win_flat)


def _classed_window(loc_tgt, pidx):
    """Extract each probe's classed head cell as a 64-lane window.

    pidx = (addr16 << 2) | cls (ops.probe.probe_bucket_classed);
    loc_tgt = the unified (P, 128) cell array. Cell bases are 8-unit
    aligned per class (table_device._classed_total16) and widths are
    1/2/4 units at width-aligned offsets, so NO cell crosses a 64-lane
    half: gather the row, select the half, then two static lane-shift
    selects at half width. Lanes beyond the cell's width hold
    neighbor-cell data — callers mask by bucket count, which never
    exceeds the cell class's slots.
    """
    a16 = jax.lax.shift_right_logical(pidx, jnp.int32(2))
    cls = pidx & 3
    row2 = loc_tgt[a16 >> 3]
    half = jax.lax.shift_right_logical(a16, jnp.int32(2)) & 1
    row = jnp.where(half[:, None] == 1, row2[:, 64:], row2[:, :64])
    o = a16 & 3
    for k in (1, 0):
        s = 16 << k
        shifted = jnp.concatenate(
            [row[:, s:], jnp.zeros((row.shape[0], s), row.dtype)],
            axis=1)
        bit = jax.lax.shift_right_logical(o, jnp.int32(k)) & 1
        row = jnp.where(bit[:, None] == 1, shifted, row)
    return row, cls


def _classed_head_slots(flat, loc_tgt, dense, idx_c):
    """Gather + decode one classed head cell per probe.

    -> (window (N, 64), found, cnt, isC class-C mask,
        slots (N, hsl) head slot lanes)."""
    hsl = dense[1]
    window, clsv = _classed_window(loc_tgt, idx_c)
    flat_i32 = jax.lax.bitcast_convert_type(flat, jnp.int32)
    found = (window[:, 0] == flat_i32) & (flat != jnp.uint32(0xFFFFFFFF))
    cnt = jnp.where(found, window[:, 1], 0)
    isC = clsv == 2
    hs = min(hsl, window.shape[1] - 3)
    slots = jnp.where(isC[:, None], window[:, 3:3 + hs],
                      window[:, 2:2 + hs])
    if hs < hsl:
        slots = jnp.concatenate(
            [slots, jnp.zeros((slots.shape[0], hsl - hs), jnp.int32)],
            axis=1)
    return window, found, cnt, isC, slots


def _classed_probe(flat, loc_tgt, loc_win, dense, c: int, idx_c):
    """Shared classed head/overflow slot extraction.

    -> (pks (N, c) packed slots masked to the bucket count,
        cnt, over (cnt > head)); c = slots_per_feature."""
    hsl = dense[1]
    opack = dense[3]
    window, found, cnt, isC, slots = _classed_head_slots(
        flat, loc_tgt, dense, idx_c)
    ow = c - hsl
    if ow > 0:
        oidx = jnp.where(found & isC, window[:, 2], 0)

        def half_gather(arr, idx):
            r2 = arr[idx >> 1]
            return jnp.where((idx & 1)[:, None] == 1, r2[:, 64:],
                             r2[:, :64])

        orow = half_gather(loc_win, oidx) if opack else loc_win[oidx]
        pks = jnp.concatenate([slots, orow[:, :ow]], axis=1)
    else:
        pks = slots[:, :c]
    j = jax.lax.broadcasted_iota(jnp.int32, pks.shape, 1)
    pks = jnp.where(j < cnt[:, None], pks, I32_MAX)
    return pks, cnt, cnt > hsl


@stage("gather_decode")
def probe_rows_head(feats, loc_tgt, prefix_starts, prefix_bits: int,
                    dense: tuple, pack_bits: int, idx_pre=None):
    """Head-only two-tier probe (escalation phase 1).

    ONE head-row gather per probe instead of head + overflow: slots
    beyond the head are dropped and each query gets an `over` flag
    (any probed bucket deeper than the head). Queries with over=False
    are classified EXACTLY by the head slots; over=True queries must
    re-run through the full-depth path (the caller's phase 2).

    -> (pk (B, f*head) packed slots with I32_MAX padding,
        over (B,) bool).
    Requires a slot-packed two-tier layout and pack_bits == slot_bits.
    """
    from .probe import probe_bucket, probe_bucket_classed
    b, f = feats.shape
    kind, hsl, hpack, _opack, slot_bits = dense
    assert slot_bits and slot_bits == pack_bits
    flat = feats.reshape(-1)
    if kind == "classed":
        if idx_pre is not None:
            idx_c = idx_pre
        else:
            idx_c, _ = probe_bucket_classed(flat, prefix_starts,
                                            prefix_bits)
        _w, _found, cnt, _isC, rows3 = _classed_head_slots(
            flat, loc_tgt, dense, idx_c)
        over = jnp.any((cnt > hsl).reshape(b, f), axis=1)
        j = jax.lax.broadcasted_iota(jnp.int32, (b * f, hsl), 1)
        hit = j < jnp.minimum(cnt, hsl)[:, None]
        pk = jnp.where(hit, rows3, I32_MAX)
    else:
        wide = _tag_wide(dense)
        if idx_pre is not None:
            idx_c = idx_pre
        elif wide:
            from .probe import probe_bucket64
            idx_c, _ = probe_bucket64(flat, prefix_starts, prefix_bits)
            idx_c = jnp.clip(idx_c, 0, None)
        else:
            idx_c, _ = probe_bucket(flat, prefix_starts, prefix_bits)
            idx_c = jnp.clip(idx_c, 0, None)
        if hpack:
            r2 = loc_tgt[idx_c >> 1]
            rows = jnp.where((idx_c & 1)[:, None] == 1, r2[:, 64:],
                             r2[:, :64])
        else:
            rows = loc_tgt[idx_c]
        nx = 2 if wide else 1
        found = _meta_match(rows, flat, wide)
        cnt = jnp.where(found, rows[:, nx], 0)
        over = jnp.any((cnt > hsl).reshape(b, f), axis=1)
        j = jax.lax.broadcasted_iota(jnp.int32, (b * f, hsl), 1)
        hit = j < jnp.minimum(cnt, hsl)[:, None]
        pk = jnp.where(hit, rows[:, nx + 2:nx + 2 + hsl], I32_MAX)
    return pk.reshape(b, f * hsl), over


@stage("gather_decode")
def probe_rows(feats, table_feats, table_offsets, loc_tgt, loc_win,
               slots_per_feature: int, prefix_starts=None,
               prefix_bits: int = 16, prefix_steps: int = 0,
               dense: bool = False, pack_bits: int = 0, idx_pre=None):
    """(B, F) features -> (B, F*C) match slots (tgt, win).

    ``pack_bits=w`` returns (pk, pk) instead, with
    pk = (tgt << w) | win and I32_MAX padding — the single-i32 slot
    encoding consumed by rows_to_result(pack_bits=w).

    With ``dense=True``, ``loc_tgt`` is a *fused* (F, 2+2C padded) row
    table [feature, count, tgt*C, win*C] (``loc_win`` is ignored): after
    the prefix search, a SINGLE row gather yields the membership check,
    bucket size and every location.
    """
    from .probe import (probe_bucket, probe_bucket64,
                        probe_bucket_classed, probe_features)
    b, f = feats.shape
    c = slots_per_feature
    flat = feats.reshape(-1)
    nf = table_feats.shape[0]
    classed = isinstance(dense, tuple) and dense[0] == "classed"
    wide = _tag_wide(dense)
    pks_classed = None
    if classed:
        if idx_pre is not None:
            idx_c = idx_pre
        else:
            idx_c, _ = probe_bucket_classed(flat, prefix_starts,
                                            prefix_bits)
        pks_classed, _cnt, _over = _classed_probe(
            flat, loc_tgt, loc_win, dense, c, idx_c)
        found = None
    elif idx_pre is not None:
        # bucket-probe stage precomputed by the caller (the prefetching
        # scan runs it one iteration ahead so it overlaps this
        # iteration's row gathers + candidates)
        idx_c, found = idx_pre, None
    elif prefix_starts is not None and prefix_starts.ndim == 2 and nf > 0:
        if wide:
            idx_c, found = probe_bucket64(flat, prefix_starts,
                                          prefix_bits)
        else:
            idx_c, found = probe_bucket(flat, prefix_starts,
                                        prefix_bits)
        idx_c = jnp.clip(idx_c, 0, nf - 1)
    elif prefix_starts is not None and nf > 0:
        idx_c, found = probe_features(flat, table_feats, prefix_starts,
                                      prefix_bits, prefix_steps,
                                      check=not dense)
    else:
        idx = jnp.searchsorted(table_feats, flat).astype(jnp.int32)
        idx_c = jnp.minimum(idx, max(nf - 1, 0))
        sent = jnp.asarray(jnp.iinfo(flat.dtype).max, flat.dtype)
        found = (table_feats[idx_c] == flat) & (flat != sent) \
            if nf > 0 else jnp.zeros_like(flat, dtype=bool)
    j = jax.lax.broadcasted_iota(jnp.int32, (b * f, c), 1)

    def half_gather(arr, idx):
        # pair-packed device rows: logical rows 2p/2p+1 in lanes
        # 0-63/64-127 of physical row p (ops.table_device)
        r2 = arr[idx >> 1]
        return jnp.where((idx & 1)[:, None] == 1, r2[:, 64:],
                         r2[:, :64])

    slot_bits = 0            # >0: gathered rows hold packed pk slots
    pks = None
    if classed:
        pks = pks_classed
        slot_bits = dense[4]
    elif isinstance(dense, tuple):
        # two-tier: head rows [feat, count, ovf_idx, slots*H] in
        # loc_tgt, overflow rows [slots*(C-H)] in loc_win (row 0 =
        # dummy). 2 gathers for shallow buckets' worth of memory even
        # when the worst bucket is C deep. Slots are (tgt, win) lane
        # pairs, or ONE pk lane each when dense[4] = slot_bits > 0.
        # dense[2]/dense[3] flag pair-packed head/overflow rows.
        # u64 variant: meta = [flo, fhi, count, ovf_idx] (both lanes
        # verified after the gather — the bucket index matched low-32).
        hsl = dense[1]
        hpack = len(dense) > 2 and dense[2]
        opack = len(dense) > 3 and dense[3]
        slot_bits = dense[4] if len(dense) > 4 else 0
        nx = 2 if wide else 1
        rows = half_gather(loc_tgt, idx_c) if hpack else loc_tgt[idx_c]
        found = _meta_match(rows, flat, wide)
        cnt = jnp.where(found, rows[:, nx], 0)
        hit = j < cnt[:, None]
        ow = c - hsl
        oidx = jnp.where(found, rows[:, nx + 1], 0)
        orow = half_gather(loc_win, oidx) if opack else loc_win[oidx]
        hb = nx + 2
        if slot_bits:
            pks = jnp.concatenate(
                [rows[:, hb:hb + hsl], orow[:, :ow]], axis=1)
            pks = jnp.where(hit, pks, I32_MAX)
        else:
            tgts = jnp.concatenate(
                [rows[:, hb:hb + hsl], orow[:, :ow]], axis=1)
            wins = jnp.concatenate(
                [rows[:, hb + hsl:hb + 2 * hsl], orow[:, ow:2 * ow]],
                axis=1)
            tgts = jnp.where(hit, tgts, I32_MAX)
            wins = jnp.where(hit, wins, I32_MAX)
    elif dense:
        if isinstance(dense, str) and dense.startswith("u64pk"):
            # u64 dense rows [flo, fhi, count, pk*C]
            slot_bits = int(dense[5:].rstrip("p"))
            rows = half_gather(loc_tgt, idx_c) \
                if dense.endswith("p") else loc_tgt[idx_c]
        elif isinstance(dense, str) and dense.startswith("pk"):
            # "pk<bits>" / "pk<bits>p" (pair-packed): dense rows with
            # packed slots [feat, count, pk*C]
            slot_bits = int(dense[2:].rstrip("p"))
            rows = half_gather(loc_tgt, idx_c) \
                if dense.endswith("p") else loc_tgt[idx_c]
        else:
            rows = half_gather(loc_tgt, idx_c) if dense == "packed" \
                else loc_tgt[idx_c]                 # ONE gather
        nx = 2 if wide else 1
        found = _meta_match(rows, flat, wide)
        cnt = jnp.where(found, rows[:, nx], 0)
        hit = j < cnt[:, None]
        sb = nx + 1
        if slot_bits:
            pks = jnp.where(hit, rows[:, sb:sb + c], I32_MAX)
        else:
            tgts = jnp.where(hit, rows[:, sb:sb + c], I32_MAX)
            wins = jnp.where(hit, rows[:, sb + c:sb + 2 * c], I32_MAX)
    else:
        assert idx_pre is None, \
            "prefetched probe needs a fused-row layout (CSR recomputes)"
        cnt = jnp.where(
            found,
            (table_offsets[idx_c + 1] -
             table_offsets[idx_c]).astype(jnp.int32),
            0)
        cnt = jnp.minimum(cnt, c)
        hit = j < cnt[:, None]
        off = jnp.where(found, table_offsets[idx_c], 0).astype(jnp.int32)
        li = jnp.minimum(off[:, None] + j, max(loc_tgt.shape[0] - 1, 0))
        tgts = jnp.where(hit, loc_tgt[li], I32_MAX)
        wins = jnp.where(hit, loc_win[li], I32_MAX)
    if pks is not None and not pack_bits:
        # caller wants (tgt, win) from slot-packed storage: unpack
        pad_ = pks == I32_MAX
        tgts = jnp.where(pad_, I32_MAX,
                         jax.lax.shift_right_logical(pks, jnp.int32(slot_bits)))
        wins = jnp.where(pad_, I32_MAX, pks & ((1 << slot_bits) - 1))
    if pack_bits:
        if pks is None:
            pk = jnp.where(tgts != I32_MAX, (tgts << pack_bits) | wins,
                           I32_MAX)
        elif slot_bits == pack_bits:
            pk = pks
        else:
            # re-base the storage encoding onto the caller's wbits
            pk = jnp.where(
                pks == I32_MAX, I32_MAX,
                (jax.lax.shift_right_logical(pks, jnp.int32(slot_bits))
                 << jnp.int32(pack_bits)) | (pks & ((1 << slot_bits) - 1)))
        pk = pk.reshape(b, f * c)
        return pk, pk
    return tgts.reshape(b, f * c), wins.reshape(b, f * c)


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature",
                     "windows_per_query", "max_candidates",
                     "prefix_bits", "prefix_steps", "num_parts", "dense",
                     "walk_elems", "dedup_walk", "fast_top2", "emit_hits",
                     "pack_bits"))
def query_step_rows_multipart(windows, valid, mwir,
                              part_feats, part_offsets, part_ltgt,
                              part_lwin, merge_tax_of_target, lineages,
                              hits_min, hits_diff_frac, highest_rank,
                              merge_rank, part_prefix,
                              *, k: int, sketchlen: int,
                              slots_per_feature: tuple,
                              windows_per_query: int, max_candidates: int,
                              prefix_bits=16,
                              prefix_steps: tuple = (),
                              num_parts: int = 1,
                              dense: tuple = (),
                              walk_elems: int = 0,
                              dedup_walk: int = 0,
                              fast_top2: bool = False,
                              emit_hits: bool = True,
                              pack_bits: int = 0) -> QueryResult:
    """Row-layout query over a multi-part database: sketch once, probe
    every part, concatenate per-query slot rows (reference probes every
    DB part and merge-sorts matches, src/host_hashmap.hpp:695-723)."""
    b, wq, w = windows.shape
    feats = sketch_windows(windows.reshape(b * wq, w),
                           valid.reshape(b * wq), k=k, sketchlen=sketchlen)
    feats = feats.reshape(b, wq * sketchlen)
    tgts, wins_ = [], []
    for p in range(num_parts):
        bits = prefix_bits[p] if isinstance(prefix_bits, tuple) \
            else prefix_bits
        t, wn = probe_rows(feats, part_feats[p], part_offsets[p],
                           part_ltgt[p], part_lwin[p],
                           slots_per_feature[p], part_prefix[p],
                           bits, prefix_steps[p], dense[p],
                           pack_bits=pack_bits)
        tgts.append(t)
        wins_.append(wn)
    tgt = jnp.concatenate(tgts, axis=1)
    win = jnp.concatenate(wins_, axis=1)
    return rows_to_result(
        tgt, win, mwir, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=emit_hits,
        pack_bits=pack_bits)


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature",
                     "windows_per_query", "max_candidates",
                     "prefix_bits", "prefix_steps", "dense",
                     "walk_elems", "dedup_walk", "fast_top2", "emit_hits",
                     "pack_bits"))
def query_step_rows(windows, valid, mwir,
                    table_feats, table_offsets, loc_tgt, loc_win,
                    merge_tax_of_target, lineages,
                    hits_min, hits_diff_frac, highest_rank, merge_rank,
                    prefix_starts=None,
                    *, k: int, sketchlen: int, slots_per_feature: int,
                    windows_per_query: int, max_candidates: int,
                    prefix_bits: int = 16, prefix_steps: int = 0,
                    dense: bool = False,
                    walk_elems: int = 0,
                    dedup_walk: int = 0,
                    fast_top2: bool = False,
                    emit_hits: bool = True,
                    pack_bits: int = 0) -> QueryResult:
    """Row-layout classification step.

    windows: (B, Wq, W) u8 — every query padded to Wq windows;
    valid: (B, Wq) i32 chars per window (0 = padding window);
    mwir: (B,) i32 contiguous-range length per query.
    """
    b, wq, w = windows.shape
    feats = sketch_windows(windows.reshape(b * wq, w),
                           valid.reshape(b * wq), k=k, sketchlen=sketchlen)
    feats = feats.reshape(b, wq * sketchlen)
    tgt, win = probe_rows(feats, table_feats, table_offsets, loc_tgt,
                          loc_win, slots_per_feature, prefix_starts,
                          prefix_bits, prefix_steps, dense,
                          pack_bits=pack_bits)
    return rows_to_result(
        tgt, win, mwir, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=emit_hits,
        pack_bits=pack_bits)


def _roll1(a):
    return jnp.concatenate([a[1:], a[:1]])


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature",
                     "windows_per_query", "max_candidates",
                     "prefix_bits", "prefix_steps", "dense",
                     "walk_elems", "dedup_walk", "fast_top2", "pack_bits",
                     "infeed_packed", "prefetch"))
def query_step_rows_scan(windows_k, valid_k, mwir_k,
                         table_feats, table_offsets, loc_tgt, loc_win,
                         merge_tax_of_target, lineages,
                         hits_min, hits_diff_frac, highest_rank,
                         merge_rank, prefix_starts,
                         *, k: int, sketchlen: int,
                         slots_per_feature: int, windows_per_query: int,
                         max_candidates: int, prefix_bits: int = 16,
                         prefix_steps: int = 0, dense: bool = False,
                         walk_elems: int = 0,
                         dedup_walk: int = 0,
                         fast_top2: bool = False,
                         pack_bits: int = 0,
                         infeed_packed: bool = False,
                         prefetch: bool = False):
    """K stacked row batches classified inside one device dispatch via
    lax.scan — one compile and one host round-trip per K*B reads (the
    infeed shape; host<->device latency amortizes K-fold). Returns
    (K, B) classified taxon ids only (the summary fast path needs no
    candidate details).

    ``infeed_packed``: windows_k holds 2-bit-packed codes (4 bases per
    byte, N-free reads only — the host routes reads containing
    ambiguous characters through the unpacked path); unpacked on
    device. Quarters the host->device transfer.

    ``prefetch``: software-pipeline the scan — iteration i classifies
    batch i from a (sketch, bucket-probe) stage computed in iteration
    i-1, so that stage's gather can overlap the row gathers and
    candidates of the previous batch. Requires a fused-row layout
    (bucket-row prefix index). Results are identical to the plain
    scan."""
    kk, b, wq, w = windows_k.shape[0], windows_k.shape[1], \
        windows_k.shape[2], windows_k.shape[3]
    if infeed_packed:
        w = w * 4

    def stage1(wmat, vmat):
        vmat = vmat.astype(jnp.int32)
        if infeed_packed:
            # (b, wq, w/4) u8 -> (b, wq, w) codes 0..3; content past a
            # window's valid length is ignored by the sketcher
            shifts = jnp.arange(4, dtype=jnp.uint8) * 2
            wmat = ((wmat[..., None] >> shifts) &
                    jnp.uint8(3)).reshape(b, wq, w)
        feats = sketch_windows(wmat.reshape(b * wq, w),
                               vmat.reshape(b * wq), k=k,
                               sketchlen=sketchlen)
        return feats.reshape(b, wq * sketchlen)

    def stage2(feats, mw, idx_pre=None):
        mw = mw.astype(jnp.int32)
        tgt, win = probe_rows(feats, table_feats, table_offsets, loc_tgt,
                              loc_win, slots_per_feature, prefix_starts,
                              prefix_bits, prefix_steps, dense,
                              pack_bits=pack_bits, idx_pre=idx_pre)
        res = rows_to_result(
            tgt, win, mw, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=False,
            pack_bits=pack_bits)
        return res.cls_tax

    if prefetch and prefix_starts is not None and dense:
        from .probe import probe_bucket, probe_bucket_classed
        nf = table_feats.shape[0]
        classed = isinstance(dense, tuple) and dense[0] == "classed"

        def bucket(feats):
            if classed:
                pidx, _ = probe_bucket_classed(feats.reshape(-1),
                                               prefix_starts,
                                               prefix_bits)
                return pidx
            if _tag_wide(dense):
                from .probe import probe_bucket64
                idx_w, _ = probe_bucket64(feats.reshape(-1),
                                          prefix_starts, prefix_bits)
                return jnp.clip(idx_w, 0, None)
            idx_c, _ = probe_bucket(feats.reshape(-1), prefix_starts,
                                    prefix_bits)
            return jnp.clip(idx_c, 0, nf - 1)

        f0 = stage1(windows_k[0], valid_k[0])
        i0 = bucket(f0)

        def body(carry, xs):
            feats, idx_c, mw_prev = carry
            wmat, vmat, mw = xs
            cls = stage2(feats, mw_prev, idx_pre=idx_c)
            f2 = stage1(wmat, vmat)
            return (f2, bucket(f2), mw), cls

        _, cls_k = jax.lax.scan(
            body, (f0, i0, mwir_k[0]),
            (_roll1(windows_k), _roll1(valid_k), _roll1(mwir_k)))
        return cls_k

    def body(carry, xs):
        wmat, vmat, mw = xs
        return carry, stage2(stage1(wmat, vmat), mw)

    _, cls_k = jax.lax.scan(body, 0, (windows_k, valid_k, mwir_k))
    return cls_k


@functools.partial(
    jax.jit,
    static_argnames=("sketchlen", "slots_per_feature",
                     "max_candidates", "prefix_bits", "dense",
                     "walk_elems", "dedup_walk", "fast_top2",
                     "pack_bits"))
def query_step_rows_redo(feats, idx_c, mwir,
                         table_feats, table_offsets, loc_tgt, loc_win,
                         merge_tax_of_target, lineages,
                         hits_min, hits_diff_frac, highest_rank,
                         merge_rank,
                         *, sketchlen: int, slots_per_feature: int,
                         max_candidates: int, prefix_bits: int,
                         dense: tuple,
                         walk_elems: int = 0,
                         dedup_walk: int = 0,
                         fast_top2: bool = True,
                         pack_bits: int = 0):
    """Escalation phase 2 on PRE-SKETCHED queries.

    `feats` (B, F) u32 and `idx_c` (B*F,) i32 come straight from phase
    1's outputs (device-resident; the host only ships row indices when
    rebatching flagged reads at full occupancy) — the redo step then
    skips both the sketch and the bucket-row gather, the two stages
    whose results phase 1 already paid for. The reference GPU never
    pays them twice either: its per-thread loop simply keeps probing
    deeper (gpu_hashmap_operations.cuh:841-1043).
    """
    b, f = feats.shape
    mwir = mwir.astype(jnp.int32)
    tgt, win = probe_rows(feats, table_feats, table_offsets, loc_tgt,
                          loc_win, slots_per_feature, None,
                          prefix_bits, 0, dense, pack_bits=pack_bits,
                          idx_pre=idx_c)
    res = rows_to_result(
        tgt, win, mwir, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=False,
        pack_bits=pack_bits)
    return res.cls_tax


@functools.partial(
    jax.jit,
    static_argnames=("sketchlen", "slots_per_feature",
                     "max_candidates", "prefix_bits", "dense",
                     "walk_elems", "dedup_walk", "fast_top2",
                     "pack_bits"))
def query_step_rows_redo_scan(feats_k, idx_k, mwir_k,
                              table_feats, table_offsets, loc_tgt,
                              loc_win, merge_tax_of_target, lineages,
                              hits_min, hits_diff_frac, highest_rank,
                              merge_rank,
                              *, sketchlen: int, slots_per_feature: int,
                              max_candidates: int, prefix_bits: int,
                              dense: tuple,
                              walk_elems: int = 0,
                              dedup_walk: int = 0,
                              fast_top2: bool = True,
                              pack_bits: int = 0):
    """K stacked phase-2 redo batches in one dispatch (see
    query_step_rows_redo); feats_k (K, B, F) u32, idx_k (K, B, F) i32,
    mwir_k (K, B). Returns (K, B) classified taxa."""
    kk, b, f = feats_k.shape
    body = _redo_body(table_feats, table_offsets, loc_tgt, loc_win,
                      merge_tax_of_target, lineages, hits_min,
                      hits_diff_frac, highest_rank, merge_rank,
                      slots_per_feature=slots_per_feature,
                      max_candidates=max_candidates,
                      prefix_bits=prefix_bits, dense=dense,
                      walk_elems=walk_elems, dedup_walk=dedup_walk,
                      fast_top2=fast_top2, pack_bits=pack_bits)
    return jax.lax.scan(
        lambda c, xs: (c, body(*xs)), 0, (feats_k, idx_k, mwir_k))[1]


def _redo_body(table_feats, table_offsets, loc_tgt, loc_win,
               merge_tax_of_target, lineages, hits_min, hits_diff_frac,
               highest_rank, merge_rank, *, slots_per_feature,
               max_candidates, prefix_bits, dense, walk_elems,
               dedup_walk, fast_top2, pack_bits):
    """Full-depth classification of pre-sketched, pre-probed queries —
    the escalation phase-2 step body (see query_step_rows_redo)."""
    def body(feats, idx_c, mw):
        b, f = feats.shape
        mw = mw.astype(jnp.int32)
        tgt, win = probe_rows(feats, table_feats, table_offsets,
                              loc_tgt, loc_win, slots_per_feature,
                              None, prefix_bits, 0, dense,
                              pack_bits=pack_bits,
                              idx_pre=idx_c.reshape(-1))
        res = rows_to_result(
            tgt, win, mw, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=False,
            pack_bits=pack_bits)
        return res.cls_tax

    return body


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature",
                     "max_candidates", "prefix_bits", "dense",
                     "walk_elems", "fast_top2", "pack_bits",
                     "infeed_packed"))
def query_step_rows_scan_head_fused(windows_k, valid_k, mwir_k,
                                    redo_feats_k, redo_idx_k,
                                    redo_mwir_k,
                                    table_feats, table_offsets, loc_tgt,
                                    loc_win, merge_tax_of_target,
                                    lineages, hits_min, hits_diff_frac,
                                    highest_rank, merge_rank,
                                    prefix_starts,
                                    *, k: int, sketchlen: int,
                                    slots_per_feature: int,
                                    max_candidates: int,
                                    prefix_bits: int, dense: tuple,
                                    walk_elems: int = 0,
                                    fast_top2: bool = True,
                                    pack_bits: int = 0,
                                    infeed_packed: bool = False):
    """Escalation phases 1 AND 2 fused into ONE scan dispatch.

    Iteration i classifies fresh batch i head-only (prefetched sketch +
    bucket probe, as query_step_rows_scan_head) AND re-classifies a
    host-fed slice of earlier flagged reads at full depth
    (redo_feats_k/redo_idx_k (K, B2, F) from phase-1's saved outputs).
    The two streams are data-independent inside each iteration, so the
    scheduler can interleave phase 2's candidates sort with phase 1's
    row gathers — the single-dispatch analog of the
    reference GPU's per-thread loop simply continuing into deep buckets
    (gpu_hashmap_operations.cuh:841-1043).

    -> (cls1 (K, B), over_bits (K, B/32), feats (K, B, F),
        idx (K, B, F), cls2 (K, B2)).
    """
    kk, b = windows_k.shape[0], windows_k.shape[1]
    wq, w = windows_k.shape[2], windows_k.shape[3]
    assert wq == 1, "escalation is the short-read scan path"
    if infeed_packed:
        w = w * 4
    from .probe import probe_bucket, probe_bucket_classed
    classed = dense[0] == "classed"

    def stage1(wmat, vmat):
        vmat = vmat.astype(jnp.int32)
        if infeed_packed:
            shifts = jnp.arange(4, dtype=jnp.uint8) * 2
            wmat = ((wmat[..., None] >> shifts) &
                    jnp.uint8(3)).reshape(b, wq, w)
        feats = sketch_windows(wmat.reshape(b * wq, w),
                               vmat.reshape(b * wq), k=k,
                               sketchlen=sketchlen)
        return feats.reshape(b, wq * sketchlen)

    def bucket(feats):
        if classed:
            pidx, _ = probe_bucket_classed(feats.reshape(-1),
                                           prefix_starts, prefix_bits)
            return pidx
        if _tag_wide(dense):
            from .probe import probe_bucket64
            idx_w, _ = probe_bucket64(feats.reshape(-1),
                                      prefix_starts, prefix_bits)
            return jnp.clip(idx_w, 0, None)
        idx_c, _ = probe_bucket(feats.reshape(-1), prefix_starts,
                                prefix_bits)
        return jnp.clip(idx_c, 0, None)

    def stage2_head(feats, mw, idx_c):
        mw = mw.astype(jnp.int32)
        pk, over = probe_rows_head(feats, loc_tgt, prefix_starts,
                                   prefix_bits, dense,
                                   pack_bits=pack_bits, idx_pre=idx_c)
        res = rows_to_result(
            pk, pk, mw, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            fast_top2=fast_top2, emit_hits=False, pack_bits=pack_bits)
        ob = over.reshape(b // 32, 32).astype(jnp.int32)
        obits = (ob << jax.lax.broadcasted_iota(
            jnp.int32, (b // 32, 32), 1)).sum(axis=1, dtype=jnp.int32)
        return res.cls_tax, obits

    redo = _redo_body(table_feats, table_offsets, loc_tgt, loc_win,
                      merge_tax_of_target, lineages, hits_min,
                      hits_diff_frac, highest_rank, merge_rank,
                      slots_per_feature=slots_per_feature,
                      max_candidates=max_candidates,
                      prefix_bits=prefix_bits, dense=dense,
                      walk_elems=walk_elems, dedup_walk=0,
                      fast_top2=fast_top2, pack_bits=pack_bits)

    f0 = stage1(windows_k[0], valid_k[0])
    i0 = bucket(f0)

    def body(carry, xs):
        feats, idx_c, mw_prev = carry
        wmat, vmat, mw, rf, ri, rm = xs
        cls1, obits = stage2_head(feats, mw_prev, idx_c)
        cls2 = redo(rf, ri, rm)
        out = (cls1, obits,
               feats, idx_c.reshape(b, wq * sketchlen), cls2)
        f2 = stage1(wmat, vmat)
        return (f2, bucket(f2), mw), out

    _, outs = jax.lax.scan(
        body, (f0, i0, mwir_k[0]),
        (_roll1(windows_k), _roll1(valid_k), _roll1(mwir_k),
         redo_feats_k, redo_idx_k, redo_mwir_k))
    return outs


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketchlen", "slots_per_feature",
                     "max_candidates", "prefix_bits", "dense",
                     "walk_elems", "dedup_walk", "fast_top2", "pack_bits",
                     "infeed_packed", "prefetch", "return_feats"))
def query_step_rows_scan_head(windows_k, valid_k, mwir_k,
                              table_feats, table_offsets, loc_tgt,
                              loc_win, merge_tax_of_target, lineages,
                              hits_min, hits_diff_frac, highest_rank,
                              merge_rank, prefix_starts,
                              *, k: int, sketchlen: int,
                              slots_per_feature: int,
                              max_candidates: int, prefix_bits: int,
                              dense: tuple,
                              walk_elems: int = 0,
                              dedup_walk: int = 0,
                              fast_top2: bool = True,
                              pack_bits: int = 0,
                              infeed_packed: bool = False,
                              prefetch: bool = False,
                              return_feats: bool = False):
    """Escalation phase 1: head-only probe over a two-tier layout.

    Like query_step_rows_scan but with ONE row gather per probe (the
    overflow gather is skipped — the two-tier hot path's second memory
    access) and a much smaller candidate sort (L = f * head instead of
    f * spf). Returns (cls (K, B) i32,
    over (K, B/32) i32 bitmask): queries whose bit is set touched a
    bucket deeper than the head and MUST be reclassified through the
    full-depth step; the rest are exact.

    The adaptive-depth counterpart of the reference GPU's data-dependent
    per-thread loops (gpu_hashmap_operations.cuh:841-1043): static
    shapes otherwise pay worst-case bucket depth for every read.
    """
    kk, b = windows_k.shape[0], windows_k.shape[1]
    wq, w = windows_k.shape[2], windows_k.shape[3]
    assert not return_feats or prefetch, \
        "return_feats reuses the prefetch carry's (feats, idx) pair"
    if infeed_packed:
        w = w * 4

    def stage1(wmat, vmat):
        vmat = vmat.astype(jnp.int32)
        if infeed_packed:
            shifts = jnp.arange(4, dtype=jnp.uint8) * 2
            wmat = ((wmat[..., None] >> shifts) &
                    jnp.uint8(3)).reshape(b, wq, w)
        feats = sketch_windows(wmat.reshape(b * wq, w),
                               vmat.reshape(b * wq), k=k,
                               sketchlen=sketchlen)
        return feats.reshape(b, wq * sketchlen)

    def stage2(feats, mw, idx_pre=None):
        mw = mw.astype(jnp.int32)
        pk, over = probe_rows_head(feats, loc_tgt, prefix_starts,
                                   prefix_bits, dense,
                                   pack_bits=pack_bits,
                                   idx_pre=idx_pre)
        res = rows_to_result(
            pk, pk, mw, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk,
            fast_top2=fast_top2, emit_hits=False, pack_bits=pack_bits)
        # pack the over flags 32/word so the d2h fetch stays tiny
        ob = over.reshape(b // 32, 32).astype(jnp.int32)
        obits = (ob << jax.lax.broadcasted_iota(
            jnp.int32, (b // 32, 32), 1)).sum(axis=1, dtype=jnp.int32)
        return res.cls_tax, obits

    if prefetch:
        from .probe import probe_bucket, probe_bucket_classed
        classed = dense[0] == "classed"

        def bucket(feats):
            if classed:
                pidx, _ = probe_bucket_classed(feats.reshape(-1),
                                               prefix_starts,
                                               prefix_bits)
                return pidx
            if _tag_wide(dense):
                from .probe import probe_bucket64
                idx_w, _ = probe_bucket64(feats.reshape(-1),
                                          prefix_starts, prefix_bits)
                return jnp.clip(idx_w, 0, None)
            idx_c, _ = probe_bucket(feats.reshape(-1), prefix_starts,
                                    prefix_bits)
            return jnp.clip(idx_c, 0, None)

        f0 = stage1(windows_k[0], valid_k[0])
        i0 = bucket(f0)

        def body(carry, xs):
            feats, idx_c, mw_prev = carry
            wmat, vmat, mw = xs
            out = stage2(feats, mw_prev, idx_pre=idx_c)
            if return_feats:
                # emit phase 1's sketches + bucket probes so a redo of
                # flagged reads (query_step_rows_redo) never recomputes
                # them; stays device-resident unless actually used
                out = out + (feats, idx_c.reshape(b, wq * sketchlen))
            f2 = stage1(wmat, vmat)
            return (f2, bucket(f2), mw), out

        _, outs = jax.lax.scan(
            body, (f0, i0, mwir_k[0]),
            (_roll1(windows_k), _roll1(valid_k), _roll1(mwir_k)))
        return outs

    def body(carry, xs):
        wmat, vmat, mw = xs
        out = stage2(stage1(wmat, vmat), mw)
        return carry, out

    outs = jax.lax.scan(body, 0, (windows_k, valid_k, mwir_k))[1]
    return outs
