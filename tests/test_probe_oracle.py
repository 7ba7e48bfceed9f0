"""The probe stages of ops.rows (bucket-row probe, row gathers and their
decode; plain XLA) against a host CSR lookup: every probed feature must
yield exactly its bucket's (target, window) locations, in bucket order,
for the dense, two-tier and size-classed layouts; the head-only probe
must yield the head of each bucket and flag exactly the queries that
touched a deeper bucket."""
import functools
import os

import numpy as np
import pytest

import jax.numpy as jnp

from metacache_tpu.ops.rows import I32_MAX, probe_rows, probe_rows_head
from metacache_tpu.ops.table_device import device_layout_from_csr

CAP = 254
B, F = 48, 16


def _csr(rng, nf=900, ntgt=60, maxwin=200):
    """CSR stream with a skewed bucket depth mix up to 300 (> CAP)."""
    feats = np.unique(rng.integers(0, 2**32 - 1, nf, dtype=np.uint64)
                      .astype(np.uint32))
    depth = rng.choice([1, 2, 3, 8, 14, 20, 40, 70, 100, 300],
                       size=len(feats),
                       p=[.3, .2, .15, .1, .08, .06, .05, .03, .02, .01])
    offs = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    n = int(offs[-1])
    ltgt = rng.integers(0, ntgt, n).astype(np.int32)
    lwin = rng.integers(0, maxwin, n).astype(np.int32)
    for i in range(len(feats)):
        a, b = offs[i], offs[i + 1]
        o = np.lexsort((lwin[a:b], ltgt[a:b]))
        ltgt[a:b], lwin[a:b] = ltgt[a:b][o], lwin[a:b][o]
    return feats, offs, ltgt, lwin


def _tag(dt):
    if dt.dense:
        return f"pk{dt.slot_bits}" + ("p" if dt.packed else "")
    if dt.classed:
        return ("classed", dt.head_slots, False, dt.ovf_packed,
                dt.slot_bits)
    return ("two_tier", dt.head_slots, dt.packed, dt.ovf_packed,
            dt.slot_bits)


@functools.lru_cache(maxsize=None)
def _layout(kind):
    rng = np.random.default_rng(17)
    csr = _csr(rng)
    old = os.environ.get("MC_CLASSED")
    os.environ["MC_CLASSED"] = "1" if kind == "classed" else "0"
    try:
        dt = device_layout_from_csr(
            *csr, cap=CAP,
            budget_bytes=(4 << 20) if kind == "classed" else (256 << 20),
            allow_dense=kind == "dense")
    finally:
        if old is None:
            os.environ.pop("MC_CLASSED")
        else:
            os.environ["MC_CLASSED"] = old
    assert dt.dense == (kind == "dense")
    assert dt.classed == (kind == "classed")
    assert dt.slot_bits
    q = rng.choice(csr[0], (B, F)).astype(np.uint32)
    miss = rng.integers(0, 2**32, (B, F), dtype=np.uint64).astype(np.uint32)
    q = np.where(rng.random((B, F)) < 0.3, miss, q)
    q[0, :] = 0xFFFFFFFF                       # all-sentinel query
    return csr, dt, q


def _bucket(csr, f):
    feats, offs, ltgt, lwin = csr
    j = np.searchsorted(feats, f)
    if j == len(feats) or feats[j] != f or f == 0xFFFFFFFF:
        return []
    a, b = offs[j], min(offs[j + 1], offs[j] + CAP)
    return list(zip(ltgt[a:b].tolist(), lwin[a:b].tolist()))


def _decode(seg, bits):
    seg = seg[seg != I32_MAX].astype(np.int64)
    return list(zip((seg >> bits).tolist(), (seg & ((1 << bits) - 1))
                    .tolist()))


@pytest.mark.parametrize("kind", ["dense", "two_tier", "classed"])
def test_full_probe_matches_csr(kind):
    csr, dt, q = _layout(kind)
    pk, _ = probe_rows(jnp.asarray(q), dt.uniq, dt.offsets, dt.head,
                       dt.ovf, dt.spf, dt.brows, dt.bbits, 0, _tag(dt),
                       pack_bits=dt.slot_bits)
    pk = np.asarray(pk).reshape(B, F, -1)
    for i in range(B):
        for j in range(F):
            assert _decode(pk[i, j], dt.slot_bits) == \
                _bucket(csr, q[i, j]), (kind, i, j)


@pytest.mark.parametrize("kind", ["two_tier", "classed"])
def test_head_probe_matches_csr(kind):
    csr, dt, q = _layout(kind)
    hsl = dt.head_slots
    pk, over = probe_rows_head(jnp.asarray(q), dt.head, dt.brows, dt.bbits,
                               _tag(dt), pack_bits=dt.slot_bits)
    pk = np.asarray(pk).reshape(B, F, hsl)
    want_over = np.zeros(B, bool)
    for i in range(B):
        for j in range(F):
            full = _bucket(csr, q[i, j])
            assert _decode(pk[i, j], dt.slot_bits) == full[:hsl], (i, j)
            want_over[i] |= len(full) > hsl
    np.testing.assert_array_equal(np.asarray(over), want_over)
