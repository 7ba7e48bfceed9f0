"""ops.rows.rows_to_result (per-row sort, window-range sweep, top-k; plain
XLA) against the NumPy oracle core.candidates.generate_candidates: the
range walk and the dedup walk, the two-array and the packed single-key
slot encodings, at a short-read width and a deep-bucket width, plus
adversarial top-k ties."""
import numpy as np
import pytest

import jax.numpy as jnp

from metacache_tpu.core.candidates import (CandidateGenerationRules,
                                           generate_candidates)
from metacache_tpu.ops.rows import I32_MAX, rows_to_result

NR = 21
MAXCAND = 2


def _lineages(ntgt):
    lin = np.zeros((ntgt, NR), np.int32)
    lin[:, 0] = -np.arange(ntgt) - 1
    lin[:, 4] = np.arange(ntgt) // 2 + 100
    lin[:, 20] = 1
    return lin


def _random_slots(rng, b, l, ntgt, nwin, fill=0.6):
    tgt = np.full((b, l), I32_MAX, np.int32)
    win = np.full((b, l), I32_MAX, np.int32)
    for i in range(b):
        n = int(rng.integers(0, int(l * fill) + 1))
        tgt[i, :n] = rng.integers(0, ntgt, n)
        win[i, :n] = rng.integers(0, nwin, n)
    return tgt, win


def _with_duplicates(rng, tgt, win):
    """Duplicate (tgt, win) runs, as overlapping window sketches give."""
    dup = rng.random(tgt.shape) < 0.5
    pad = tgt == I32_MAX
    tgt = np.where(pad, tgt, np.where(dup, np.roll(tgt, 1, axis=1), tgt))
    win = np.where(pad, win, np.where(dup, np.roll(win, 1, axis=1), win))
    return tgt, win


def _pack(tgt, win, wbits):
    pk = (tgt.astype(np.int64) << wbits) | win
    return np.where(tgt == I32_MAX, I32_MAX, pk).astype(np.int32)


def _oracle(tgt, win, mwir, merge_tax):
    out = []
    for t, w, m in zip(tgt, win, mwir):
        keep = t != I32_MAX
        matches = sorted(zip(t[keep].tolist(), w[keep].tolist()))
        rules = CandidateGenerationRules(
            max_windows_in_range=int(m), max_candidates=MAXCAND,
            taxon_of_target=lambda x: int(merge_tax[x]))
        out.append([(c.tgt, c.hits, c.pos.beg, c.pos.end)
                    for c in generate_candidates(matches, rules)])
    return out


def _check(tgt, win, mwir, ntgt, pack_bits=0, **kw):
    lin = _lineages(ntgt)
    merge_tax = lin[:, 0].copy()
    if pack_bits:
        a = b = jnp.asarray(_pack(tgt, win, pack_bits))
    else:
        a, b = jnp.asarray(tgt), jnp.asarray(win)
    res = rows_to_result(
        a, b, jnp.asarray(mwir), jnp.asarray(merge_tax), jnp.asarray(lin),
        jnp.int32(1), jnp.float32(0.5), jnp.int32(19), jnp.int32(0),
        max_candidates=MAXCAND, fast_top2=True, emit_hits=False,
        pack_bits=pack_bits, **kw)
    ct, ch, cb, ce = (np.asarray(x) for x in (
        res.cand_tgt, res.cand_hits, res.cand_beg, res.cand_end))
    for i, want in enumerate(_oracle(tgt, win, mwir, merge_tax)):
        got = [(int(ct[i, j]), int(ch[i, j]), int(cb[i, j]), int(ce[i, j]))
               for j in range(MAXCAND) if ch[i, j] > 0]
        assert got == want, f"row {i}: {got} != {want}"


SHAPES = [(64, 192, 12, 40), (16, 1536, 40, 500)]   # short read, deep


@pytest.mark.parametrize("packed", [False, True], ids=["pair", "packed"])
@pytest.mark.parametrize("b,l,ntgt,nwin", SHAPES, ids=["short", "deep"])
def test_walk_matches_oracle(b, l, ntgt, nwin, packed):
    rng = np.random.default_rng(11 + l + packed)
    wbits = (2 * (nwin - 1)).bit_length() if packed else 0
    for _ in range(2):
        tgt, win = _random_slots(rng, b, l, ntgt, nwin)
        mwir = np.full(b, 3, np.int32)
        _check(tgt, win, mwir, ntgt, pack_bits=wbits, walk_elems=12)


@pytest.mark.parametrize("packed", [False, True], ids=["pair", "packed"])
@pytest.mark.parametrize("b,l,ntgt,nwin,dwalk",
                         [(64, 192, 12, 18, 6), (16, 960, 40, 60, 8)],
                         ids=["short", "long_read"])
def test_dedup_walk_matches_oracle(b, l, ntgt, nwin, dwalk, packed):
    rng = np.random.default_rng(23 + l + packed)
    wbits = (2 * (nwin - 1)).bit_length() if packed else 0
    for _ in range(2):
        tgt, win = _with_duplicates(
            rng, *_random_slots(rng, b, l, ntgt, nwin, fill=0.7))
        mwir = np.full(b, dwalk, np.int32)
        _check(tgt, win, mwir, ntgt, pack_bits=wbits, dedup_walk=dwalk)


def _tie_rows(l, ntgt):
    rows = []

    def row():
        t = np.full(l, I32_MAX, np.int32)
        w = np.full(l, I32_MAX, np.int32)
        rows.append((t, w))
        return t, w
    t, w = row()                 # 8 groups with identical best hits
    for g in range(8):
        t[g * 6:(g + 1) * 6] = g
        w[g * 6:(g + 1) * 6] = 50
    t, w = row()                 # every group ties at hits=1
    t[:ntgt] = np.arange(ntgt)
    w[:ntgt] = np.arange(ntgt) * 7
    t, w = row()                 # a single group
    t[:10] = 3
    w[:10] = np.arange(10)
    t, w = row()                 # the later group has more hits
    t[:4], w[:4] = 1, 9
    t[4:12], w[4:12] = 14, 9
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


@pytest.mark.parametrize("packed", [False, True], ids=["pair", "packed"])
def test_topk_ties_match_oracle(packed):
    """Equal-hit candidates keep the oracle's insertion order: the
    winner is the group whose best range sorts first."""
    ntgt = 16
    tgt, win = _tie_rows(192, ntgt)
    wbits = int(2 * win[win != I32_MAX].max()).bit_length() \
        if packed else 0
    _check(tgt, win, np.full(len(tgt), 3, np.int32), ntgt,
           pack_bits=wbits, walk_elems=12)


def test_empty_rows_give_no_candidates():
    tgt = np.full((8, 192), I32_MAX, np.int32)
    _check(tgt, tgt.copy(), np.full(8, 3, np.int32), 4, walk_elems=12)
