"""Size-classed head layout: parity vs the two-tier layout.

The classed layout (ops.table_device CLASS_LADDER) stores each bucket's
head in a 16/32/64-lane cell of one unified array — memory ~ actual
bucket depth class instead of one fixed head width per feature — and
the bucket index carries (low-bits, class) entries plus per-class cell
bases. Probing it must produce exactly the same slots as the two-tier
layout over the same CSR stream.

Reference for what this layout replaces: the fixed-slot-count GPU
hash table (src/gpu_hashmap.cuh bucket_size_bits / fixed slots).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from metacache_tpu.ops.probe import probe_bucket_classed
from metacache_tpu.ops.rows import probe_rows, probe_rows_head
from metacache_tpu.ops.table_device import device_layout_from_csr


def _csr(rng, nf=800, ntgt=60, maxwin=200):
    """CSR stream with a skewed depth mix (1..100, cap later)."""
    feats = np.unique(rng.integers(0, 2**32, nf, dtype=np.uint64)
                      .astype(np.uint32))
    depth = rng.choice([1, 2, 3, 8, 14, 20, 40, 70, 100],
                       size=len(feats),
                       p=[.3, .2, .15, .1, .08, .07, .05, .03, .02])
    offs = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    n = int(offs[-1])
    ltgt = rng.integers(0, ntgt, n).astype(np.int32)
    lwin = rng.integers(0, maxwin, n).astype(np.int32)
    # in-bucket (tgt, win) ascending like a sequential build
    for i in range(len(feats)):
        a, b = offs[i], offs[i + 1]
        o = np.lexsort((lwin[a:b], ltgt[a:b]))
        ltgt[a:b], lwin[a:b] = ltgt[a:b][o], lwin[a:b][o]
    return feats, offs, ltgt, lwin


@pytest.fixture(scope="module")
def tables(monkeypatch_module=None):
    rng = np.random.default_rng(17)
    feats, offs, ltgt, lwin = _csr(rng)
    import os
    os.environ["MC_CLASSED"] = "1"
    dt_c = device_layout_from_csr(feats, offs, ltgt, lwin, cap=254,
                                  budget_bytes=4 << 20,
                                  allow_dense=False)
    os.environ["MC_CLASSED"] = "0"
    dt_t = device_layout_from_csr(feats, offs, ltgt, lwin, cap=254,
                                  budget_bytes=64 << 20,
                                  allow_dense=False)
    os.environ.pop("MC_CLASSED", None)
    assert dt_c.classed and not dt_t.classed
    assert dt_c.slot_bits == dt_t.slot_bits != 0
    return feats, offs, ltgt, lwin, dt_c, dt_t


def _tag(dt):
    if dt.classed:
        return ("classed", dt.head_slots, False, dt.ovf_packed,
                dt.slot_bits)
    return ("two_tier", dt.head_slots, dt.packed, dt.ovf_packed,
            dt.slot_bits)


def _probe(dt, qf):
    pk, _ = probe_rows(
        jnp.asarray(qf), dt.uniq, dt.offsets, dt.head, dt.ovf,
        dt.spf, dt.brows, dt.bbits, 0, _tag(dt),
        pack_bits=dt.slot_bits)
    return np.asarray(pk)


def _queries(rng, feats, b=64, f=16):
    qf = rng.choice(feats, (b, f)).astype(np.uint32)
    miss = rng.integers(0, 2**32, (b, f), dtype=np.uint64) \
        .astype(np.uint32)
    take_miss = rng.random((b, f)) < 0.3
    qf = np.where(take_miss, miss, qf)
    qf[0, :] = 0xFFFFFFFF          # all-sentinel query row
    return qf


def test_classed_full_probe_matches_two_tier(tables):
    feats, offs, ltgt, lwin, dt_c, dt_t = tables
    rng = np.random.default_rng(23)
    qf = _queries(rng, feats)
    np.testing.assert_array_equal(_probe(dt_c, qf), _probe(dt_t, qf))


def test_classed_head_probe(tables):
    """Head-only classed probe = full probe truncated to 61 slots;
    over flags exactly the buckets deeper than the head."""
    feats, offs, ltgt, lwin, dt_c, dt_t = tables
    rng = np.random.default_rng(29)
    qf = _queries(rng, feats)
    b, f = qf.shape
    hsl = dt_c.head_slots
    pk_h, over = probe_rows_head(
        jnp.asarray(qf), dt_c.head, dt_c.brows, dt_c.bbits,
        _tag(dt_c), pack_bits=dt_c.slot_bits)
    pk_h = np.asarray(pk_h).reshape(b, f, hsl)
    full = _probe(dt_t, qf).reshape(b, f, dt_t.spf)
    # expected: first min(cnt, hsl) slots of the full bucket
    sizes = np.diff(offs)
    smap = {int(fv): min(int(s), dt_t.spf)
            for fv, s in zip(feats, sizes)}
    exp_over = np.zeros(b, bool)
    for i in range(b):
        for j in range(f):
            cnt = smap.get(int(qf[i, j]), 0)
            exp = full[i, j].copy()
            exp[min(cnt, hsl):] = np.int32(2**31 - 1)
            np.testing.assert_array_equal(pk_h[i, j], exp[:hsl])
            if cnt > hsl:
                exp_over[i] = True
    np.testing.assert_array_equal(np.asarray(over), exp_over)


def test_classed_export_roundtrip(tables):
    from metacache_tpu.ops.table_device import export_csr
    feats, offs, ltgt, lwin, dt_c, dt_t = tables
    uniq, offs2, locs = export_csr(dt_c)
    np.testing.assert_array_equal(uniq, feats)
    sizes_capped = np.minimum(np.diff(offs), dt_c.spf)
    np.testing.assert_array_equal(np.diff(offs2), sizes_capped)
    tgt = (locs >> np.uint64(32)).astype(np.int32)
    win = (locs & np.uint64(0xFFFFFFFF)).astype(np.int32)
    for i in range(len(feats)):
        a, b = offs[i], offs[i + 1]
        c = min(int(b - a), dt_c.spf)
        a2 = offs2[i]
        np.testing.assert_array_equal(tgt[a2:a2 + c], ltgt[a:a + c])
        np.testing.assert_array_equal(win[a2:a2 + c], lwin[a:a + c])


def test_classed_bucket_probe_addresses(tables):
    """probe_bucket_classed finds every stored feature (found=True) and
    misses absent ones."""
    feats, offs, ltgt, lwin, dt_c, dt_t = tables
    rng = np.random.default_rng(31)
    present = rng.choice(feats, 200).astype(np.uint32)
    absent = np.setdiff1d(
        rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32),
        feats)
    pidx, found = probe_bucket_classed(
        jnp.asarray(np.concatenate([present, absent])),
        dt_c.brows, dt_c.bbits)
    found = np.asarray(found)
    assert found[:200].all()
    assert not found[200:].any()
