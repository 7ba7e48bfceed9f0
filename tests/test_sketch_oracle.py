"""The device sketcher (ops.sketch_jax.sketch_windows, plain XLA) against
the NumPy oracle core.sketch.sketch_codes, bit for bit: the reference's
window widths (127 default, 255 "small" preset, 511, and an odd 200),
k 12 and 16, ambiguous runs, short and sub-k windows, and windows whose
k-mers hash to duplicate features."""
import numpy as np
import pytest

import jax.numpy as jnp

from metacache_tpu.config import FEATURE_SENTINEL, SketchingOptions
from metacache_tpu.core.sketch import sketch_codes
from metacache_tpu.ops.sketch_jax import sketch_windows

SKETCHLEN = 16


def _oracle(codes, valid, k):
    opt = SketchingOptions(kmerlen=k, sketchlen=SKETCHLEN,
                           winlen=codes.shape[1])
    out = np.full((len(codes), SKETCHLEN), FEATURE_SENTINEL, np.uint32)
    for i, (row, n) in enumerate(zip(codes, valid)):
        sk = sketch_codes(row[:n], opt)
        if sk is not None:
            out[i, :len(sk)] = sk
    return out


def _check(codes, valid, k):
    got = np.asarray(sketch_windows(jnp.asarray(codes), jnp.asarray(valid),
                                    k=k, sketchlen=SKETCHLEN))
    np.testing.assert_array_equal(got, _oracle(codes, valid, k))


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("winlen", [127, 200, 255, 511])
def test_sketch_matches_oracle(winlen, k):
    rng = np.random.default_rng(winlen * 100 + k)
    n = 64
    codes = rng.integers(0, 4, (n, winlen)).astype(np.uint8)
    codes[3, 10:winlen // 2] = 4       # long ambiguous run
    codes[4, :] = 4                    # fully ambiguous
    codes[5, ::17] = 4                 # scattered ambiguous bases
    valid = np.full(n, winlen, np.int32)
    valid[7] = 40                      # short window
    valid[9] = k - 1                   # below kmerlen: all sentinel
    valid[11] = k                      # exactly one k-mer
    valid[13] = winlen - 1
    valid[15:30] = rng.integers(0, winlen + 1, 15)
    codes[np.arange(winlen)[None, :] >= valid[:, None]] = 4   # padding
    _check(codes, valid, k)


@pytest.mark.parametrize("k", [12, 16])
def test_sketch_duplicate_features_count_once(k):
    """A periodic window repeats its k-mers: each feature counts once
    and the sketch holds fewer than sketchlen features."""
    codes = np.tile(np.frombuffer(b"\x00\x01\x02\x03" * 32, np.uint8)[:127],
                    (32, 1))
    codes[16:] = np.tile(
        np.frombuffer(b"\x00\x00\x01\x01\x03" * 26, np.uint8)[:127],
        (16, 1))
    valid = np.full(32, 127, np.int32)
    _check(codes, valid, k)
