"""Feature probing with a prefix index.

Features are uniform 32-bit hashes, so the top `bits` of a feature index a
precomputed prefix table of row offsets into the sorted unique-feature
array: the binary search then only runs inside one small prefix span
(~log2(F / 2^bits) steps instead of log2(F)). This plays the role of the
reference's hash-table bucket addressing (open addressing over
hash(feature), src/hash_multimap.hpp:135-175) for the CSR layout: every
search step is one data-dependent gather, so fewer steps mean fewer
dependent memory round trips per probe.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .stage import stage

DEFAULT_BITS = 20


def make_prefix_index(features: np.ndarray, bits: int = DEFAULT_BITS):
    """-> (prefix_starts (2^bits + 1,) i32, search_steps int)."""
    nbuckets = 1 << bits
    bounds = (np.arange(nbuckets, dtype=np.uint64) <<
              np.uint64(32 - bits)).astype(np.uint32)
    starts = np.searchsorted(features, bounds).astype(np.int32)
    starts = np.append(starts, np.int32(len(features)))
    max_span = int(np.max(np.diff(starts))) if len(features) else 0
    # binary search over a span of s elements needs floor(log2(s)) + 1
    # halving steps to fully converge (s.bit_length()); one short silently
    # misses features when the span is an exact power of two
    steps = max(1, int(max_span).bit_length())
    return starts, steps


def make_bucket_index(features: np.ndarray, bits: int | None = None):
    """-> ((2^bits, 1+S) i32 bucket rows, bits).

    Row h = [start, f_0 .. f_{S-1}]: the sorted features whose top `bits`
    equal h, padded with 0xFFFFFFFF, plus their start offset in the
    feature array. A probe then needs ONE row gather + an in-lane compare
    instead of a multi-step binary search of dependent gathers.
    S is the max bucket span rounded up to a power of two; `bits` defaults
    to ~log2(F) - 2 (avg span ~4) within [12, 24].
    """
    nf = len(features)
    if bits is None:
        bits = min(24, max(12, int(max(nf, 1)).bit_length() - 2))
    nbuckets = 1 << bits
    bounds = (np.arange(nbuckets, dtype=np.uint64) <<
              np.uint64(32 - bits)).astype(np.uint32)
    starts = np.searchsorted(features, bounds).astype(np.int64)
    ends = np.append(starts[1:], np.int64(nf))
    spans = ends - starts
    max_span = int(spans.max()) if nf else 1
    s = 1 << max(0, int(max_span - 1).bit_length())
    s = max(s, 1)
    w = 1 + s
    if w < 64 and nbuckets * 64 * 4 <= (1 << 30):
        w = 64          # the logical row width of ops.table_device's index
    rows = np.full((nbuckets, w), -1, np.int32)
    rows[:, 0] = starts.astype(np.int32)
    if nf:
        h = (features >> np.uint32(32 - bits)).astype(np.int64)
        col = np.arange(nf, dtype=np.int64) - starts[h]
        rows[h, 1 + col] = features.view(np.int32)
    return rows, bits


def make_bucket_index64(features: np.ndarray, bits: int | None = None):
    """u64-feature bucket-row index: row h (hash = top `bits` of the
    64-bit feature) = [start, low32(f_0) .. low32(f_{S-1})].

    The probe compares only the LOW 32 bits in-lane and verifies the
    full feature against the fused head row's two meta lanes — exact as
    long as no two features in one bucket share their low 32 bits.
    Returns None when such a collision exists (callers fall back to the
    searchsorted CSR probe; at realistic span widths the probability is
    ~1e-6 per database)."""
    nf = len(features)
    assert features.dtype == np.uint64
    if bits is None:
        bits = min(24, max(12, int(max(nf, 1)).bit_length() - 2))
    while True:
        nbuckets = 1 << bits
        bounds = (np.arange(nbuckets, dtype=np.uint64)
                  << np.uint64(64 - bits))
        starts = np.searchsorted(features, bounds).astype(np.int64)
        ends = np.append(starts[1:], np.int64(nf))
        max_span = int((ends - starts).max()) if nf else 1
        if max_span <= 63 or bits >= 26:
            break
        bits += 1
    if max_span > 63:
        return None
    low = (features & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h = (features >> np.uint64(64 - bits)).astype(np.int64)
    # collision check: duplicate low-32 within one bucket
    if nf:
        order = np.lexsort((low, h))
        hl, ll = h[order], low[order]
        if bool(((hl[1:] == hl[:-1]) & (ll[1:] == ll[:-1])).any()):
            return None
    w = max(64, 1 + (1 << max(0, int(max_span - 1).bit_length())))
    rows = np.full((nbuckets, w), -1, np.int32)
    rows[:, 0] = starts.astype(np.int32)
    if nf:
        col = np.arange(nf, dtype=np.int64) - starts[h]
        rows[h, 1 + col] = low.view(np.int32)
    return rows, bits


@stage("bucket_probe")
def probe_bucket64(flat: jax.Array, bucket_rows: jax.Array, bits: int):
    """u64 variant of probe_bucket: hash = top `bits` of the 64-bit
    feature, in-lane match on the LOW 32 bits (make_bucket_index64
    guarantees per-bucket uniqueness); the caller verifies the full
    feature against the head row's two meta lanes."""
    h = (flat >> jnp.uint64(64 - bits)).astype(jnp.int32)
    if bucket_rows.shape[1] == 128:
        row2 = bucket_rows[h >> 1]
        row = jnp.where((h & 1)[:, None] == 1, row2[:, 64:],
                        row2[:, :64])
    else:
        row = bucket_rows[h]                   # ONE row gather
    lo_i32 = jax.lax.bitcast_convert_type(
        (flat & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32), jnp.int32)
    match = row[:, 1:] == lo_i32[:, None]
    lanes = jax.lax.broadcasted_iota(jnp.int32, match.shape, 1)
    local = jnp.where(match, lanes, 0).sum(axis=1, dtype=jnp.int32)
    idx = row[:, 0] + local
    found = match.any(axis=1) & \
        (flat != jnp.uint64(0xFFFFFFFFFFFFFFFF))
    return idx, found


@stage("bucket_probe")
def probe_bucket(flat: jax.Array, bucket_rows: jax.Array, bits: int):
    """-> (idx i32, found bool) via one bucket-row gather + lane match.

    A 128-wide bucket_rows array is the pair-packed device layout
    (ops.table_device: logical rows 2p/2p+1 in lanes 0-63/64-127 of
    physical row p; host widths are 64, 65 or 1+2^k — never 128)."""
    h = (flat >> (32 - bits)).astype(jnp.int32)
    if bucket_rows.shape[1] == 128:
        row2 = bucket_rows[h >> 1]
        row = jnp.where((h & 1)[:, None] == 1, row2[:, 64:],
                        row2[:, :64])
    else:
        row = bucket_rows[h]                   # ONE row gather
    flat_i32 = jax.lax.bitcast_convert_type(flat, jnp.int32)
    match = row[:, 1:] == flat_i32[:, None]
    lanes = jax.lax.broadcasted_iota(jnp.int32, match.shape, 1)
    local = jnp.where(match, lanes, 0).sum(axis=1, dtype=jnp.int32)
    idx = row[:, 0] + local
    found = match.any(axis=1) & (flat != jnp.uint32(0xFFFFFFFF))
    return idx, found


@stage("bucket_probe")
def probe_bucket_classed(flat: jax.Array, brows: jax.Array, bits: int):
    """Classed bucket-row probe -> (pidx i32, found bool).

    brows row h (logical 64 lanes, pair-packed) =
    [a16_A, a16_B, a16_C, 61 x packed-entry lanes]; each lane holds TWO
    entries (low/high 16 bits), entry = (cls << 14 | feat_low) + 1 and
    0 = empty (ops.table_device._brows_build_classed). The classed-cell
    address is a16_cls + (#earlier same-class entries) * w16(cls);
    ``pidx`` packs it with the class: (addr16 << 2) | cls.
    """
    h = (flat >> (32 - bits)).astype(jnp.int32)
    row2 = brows[h >> 1]
    row = jnp.where((h & 1)[:, None] == 1, row2[:, 64:], row2[:, :64])
    key_low = (flat & jnp.uint32((1 << (32 - bits)) - 1)) \
        .astype(jnp.int32)
    ent = row[:, 3:64]
    lanes = jax.lax.broadcasted_iota(jnp.int32, ent.shape, 1)

    def half(x, idx2):
        valid = x != 0
        e = x - 1
        m = valid & ((e & 0x3FFF) == key_low[:, None])
        return m, e >> 14, valid, idx2

    halves = (half(ent & 0xFFFF, lanes * 2),
              half(jax.lax.shift_right_logical(ent, jnp.int32(16)),
                   lanes * 2 + 1))
    found = jnp.zeros(flat.shape, bool)
    j = jnp.zeros(flat.shape, jnp.int32)
    cls = jnp.zeros(flat.shape, jnp.int32)
    for m, c, _v, idx2 in halves:
        found = found | m.any(axis=1)
        j = j + jnp.where(m, idx2, 0).sum(axis=1, dtype=jnp.int32)
        cls = cls + jnp.where(m, c, 0).sum(axis=1, dtype=jnp.int32)
    pre = jnp.zeros(flat.shape, jnp.int32)
    for m, c, v, idx2 in halves:
        # explicit i32: .sum() promotes to i64 under jax x64 mode
        pre = pre + (v & (c == cls[:, None]) &
                     (idx2 < j[:, None])).sum(axis=1, dtype=jnp.int32)
    w16 = jnp.where(cls == 0, 1, jnp.where(cls == 1, 2, 4))
    base = jnp.where(cls == 0, row[:, 0],
                     jnp.where(cls == 1, row[:, 1], row[:, 2]))
    addr16 = base + pre * w16
    found = found & (flat != jnp.uint32(0xFFFFFFFF))
    pidx = jnp.where(found, (addr16 << 2) | cls, 0)
    return pidx, found


def probe_features(flat: jax.Array, table_feats: jax.Array,
                   prefix_starts: jax.Array, bits: int, steps: int,
                   check: bool = True):
    """-> (idx i32, found bool): position of each feature in the table.

    With check=False the final membership gather is skipped (callers that
    fetch a fused row containing the feature value verify it themselves;
    `found` is then merely "not a sentinel").
    """
    nf = table_feats.shape[0]
    if nf == 0:
        z = jnp.zeros(flat.shape, jnp.int32)
        return z, jnp.zeros(flat.shape, bool)
    hi_bits = (flat >> (32 - bits)).astype(jnp.int32)
    lo = prefix_starts[hi_bits]
    hi = prefix_starts[hi_bits + 1]
    for _ in range(steps):
        mid = jax.lax.div(lo + hi, jnp.int32(2))
        v = table_feats[jnp.minimum(mid, nf - 1)]
        less = v < flat
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    idx = jnp.minimum(lo, nf - 1)
    if not check:
        return idx, flat != jnp.uint32(0xFFFFFFFF)
    found = (table_feats[idx] == flat) & (flat != jnp.uint32(0xFFFFFFFF))
    return idx, found
