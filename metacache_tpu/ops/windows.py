"""Host-side (NumPy) window extraction and batch shaping.

Converts variable-length sequences into fixed-shape window matrices for the
device sketcher — the equivalent of the reference's host-side
read windowing (query_batch::add_paired_read, src/query_batch.cuh:85-209
and sequence_batch::add_target, src/sequence_batch.cuh:132-195).

Window semantics follow for_each_window (src/hash_dna.hpp:54-90): full
windows at offsets 0, stride, ...; one trailing partial window while
characters remain; windows shorter than kmerlen produce no sketch and are
assigned no window id (they are simply not emitted here).
"""
from __future__ import annotations

import numpy as np

from ..config import SketchingOptions
from ..core.encoding import encode_ascii

PAD_CODE = np.uint8(4)  # padding char: "ambiguous" (>= 4)


def window_starts(length: int, winlen: int, stride: int) -> np.ndarray:
    """Start offsets of all windows (incl. trailing partial)."""
    if length <= winlen:
        return np.zeros(1, dtype=np.int64)
    nfull = (length - winlen) // stride + 1
    starts = np.arange(nfull, dtype=np.int64) * stride
    if nfull * stride < length:
        starts = np.append(starts, nfull * stride)
    return starts


def sequence_windows(codes: np.ndarray, opt: SketchingOptions):
    """One coded sequence -> (windows (nw, winlen) u8, valid (nw,) i32).

    Only windows with >= kmerlen chars are returned; their row index IS the
    reference window id (shorter trailing windows get no id).
    """
    opt = opt.resolved()
    length = len(codes)
    starts = window_starts(length, opt.winlen, opt.winstride)
    lens = np.minimum(length - starts, opt.winlen).astype(np.int32)
    keep = lens >= opt.kmerlen
    starts, lens = starts[keep], lens[keep]
    nw = len(starts)
    out = np.full((nw, opt.winlen), PAD_CODE, dtype=np.uint8)
    if nw == 0:
        return out, lens
    # full windows in one strided copy; at most one trailing partial
    nfull = nw - (1 if lens[-1] < opt.winlen else 0)
    if nfull > 0:
        strided = np.lib.stride_tricks.as_strided(
            codes, shape=(nfull, opt.winlen),
            strides=(codes.strides[0] * opt.winstride, codes.strides[0]))
        out[:nfull] = strided
    if nfull < nw:
        s, ln = starts[-1], lens[-1]
        out[-1, :ln] = codes[s:s + ln]
    return out, lens


def num_windows(length: int, opt: SketchingOptions) -> int:
    opt = opt.resolved()
    starts = window_starts(length, opt.winlen, opt.winstride)
    lens = np.minimum(length - starts, opt.winlen)
    return int(np.count_nonzero(lens >= opt.kmerlen))


def batch_windows(seqs: list[bytes | np.ndarray], opt: SketchingOptions,
                  pad_to: int | None = None):
    """A batch of sequences -> flat window matrix with query segment info.

    Returns:
      windows: (T, winlen) u8  (T = total windows, padded to `pad_to`)
      valid:   (T,) i32 chars per window (0 for padding rows)
      qid:     (T,) i32 query index of each window (num_queries for padding)
    """
    opt = opt.resolved()
    mats, lens, qids = [], [], []
    for qi, s in enumerate(seqs):
        codes = encode_ascii(s) if isinstance(s, (bytes, bytearray)) else s
        if len(codes) == 0:
            continue
        m, ln = sequence_windows(codes, opt)
        if len(m):
            mats.append(m)
            lens.append(ln)
            qids.append(np.full(len(m), qi, dtype=np.int32))
    if mats:
        windows = np.concatenate(mats, axis=0)
        valid = np.concatenate(lens)
        qid = np.concatenate(qids)
    else:
        windows = np.zeros((0, opt.winlen), dtype=np.uint8)
        valid = np.zeros(0, dtype=np.int32)
        qid = np.zeros(0, dtype=np.int32)
    t = len(windows)
    if pad_to is not None and t < pad_to:
        pad = pad_to - t
        windows = np.concatenate(
            [windows, np.full((pad, opt.winlen), PAD_CODE, np.uint8)])
        valid = np.concatenate([valid, np.zeros(pad, np.int32)])
        qid = np.concatenate([qid, np.full(pad, len(seqs), np.int32)])
    return windows, valid, qid
