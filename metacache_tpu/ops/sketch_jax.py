"""Device (JAX/XLA) windowed min-hash sketcher.

Device re-design of the reference's sketching hot loop
(single_function_unique_min_hasher::for_each_sketch, src/hash_dna.hpp:207-255
and the GPU twin warp_make_sketch, src/gpu_hashmap_operations.cuh:385-453).

Instead of a scalar insertion-sort per window, a whole batch of windows is
processed at once:

  codes (N, W) u8  ->  k-mers (N, P) u32 via k shifted accumulations
                   ->  canonical via bit-twiddled reverse complement
                   ->  feature hash (thomas_mueller, exact integer math)
                   ->  per-window sort + adjacent-dedup + re-sort
                   ->  (N, s) smallest unique features, sentinel-padded

This mirrors the GPU's sort128 + unique_sketch approach (identical result
set as the CPU's insertion sort) and is bit-exact with the NumPy oracle in
metacache_tpu.core — duplicate hashes count once, ambiguous k-mers are
excluded, sketches of short windows are limited to n-k+1 features.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FEATURE_SENTINEL
from .stage import stage

SENTINEL = np.uint32(FEATURE_SENTINEL)


def thomas_mueller_hash(x: jax.Array) -> jax.Array:
    """u32 mixing hash, exact wraparound semantics (src/hash_int.hpp:41-48)."""
    x = x.astype(jnp.uint32)
    x = ((x >> 16) ^ x) * jnp.uint32(0x45D9F3B)
    x = ((x >> 16) ^ x) * jnp.uint32(0x45D9F3B)
    x = (x >> 16) ^ x
    return x


def revcomp_2bit(s: jax.Array, k: int) -> jax.Array:
    """Bit-twiddled reverse complement (src/dna_encoding.hpp:169-177)."""
    s = s.astype(jnp.uint32)
    s = ((s >> 2) & jnp.uint32(0x33333333)) | ((s & jnp.uint32(0x33333333)) << 2)
    s = ((s >> 4) & jnp.uint32(0x0F0F0F0F)) | ((s & jnp.uint32(0x0F0F0F0F)) << 4)
    s = ((s >> 8) & jnp.uint32(0x00FF00FF)) | ((s & jnp.uint32(0x00FF00FF)) << 8)
    s = ((s >> 16) & jnp.uint32(0x0000FFFF)) | ((s & jnp.uint32(0x0000FFFF)) << 16)
    return (jnp.uint32(0xFFFFFFFF) - s) >> (32 - (k << 1))


def canonical_2bit(s: jax.Array, k: int) -> jax.Array:
    return jnp.minimum(s.astype(jnp.uint32), revcomp_2bit(s, k))


def murmur3_fmix64(x: jax.Array) -> jax.Array:
    """u64 murmur3 finalizer (src/hash_int.hpp:80-89) — the feature
    hash of the 64-bit kmer config. Requires jax x64 mode."""
    x = x.astype(jnp.uint64)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(0xFF51AFD7ED558CCD)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> 33)
    return x


def revcomp_2bit_u64(s: jax.Array, k: int) -> jax.Array:
    """u64 bit-twiddled reverse complement (src/dna_encoding.hpp:157-165)."""
    s = s.astype(jnp.uint64)
    s = ((s >> 2) & jnp.uint64(0x3333333333333333)) | \
        ((s & jnp.uint64(0x3333333333333333)) << 2)
    s = ((s >> 4) & jnp.uint64(0x0F0F0F0F0F0F0F0F)) | \
        ((s & jnp.uint64(0x0F0F0F0F0F0F0F0F)) << 4)
    s = ((s >> 8) & jnp.uint64(0x00FF00FF00FF00FF)) | \
        ((s & jnp.uint64(0x00FF00FF00FF00FF)) << 8)
    s = ((s >> 16) & jnp.uint64(0x0000FFFF0000FFFF)) | \
        ((s & jnp.uint64(0x0000FFFF0000FFFF)) << 16)
    s = (s >> 32) | (s << 32)
    return (jnp.uint64(0xFFFFFFFFFFFFFFFF) - s) >> (64 - (k << 1))


def window_kmers(codes: jax.Array, k: int):
    """(N, W) u8 codes -> ((N, P) kmers, (N, P) bool ambig), P = W-k+1.

    Kmers are u32 for k <= 16, u64 for k <= 32 (needs jax x64 mode,
    enabled by utils.platform.ensure_feature_width)."""
    n, w = codes.shape
    p = w - k + 1
    kdt = jnp.uint32 if k <= 16 else jnp.uint64
    if kdt == jnp.uint64:
        import jax as _jax
        if not _jax.config.jax_enable_x64:
            raise RuntimeError(
                "k > 16 needs 64-bit features: call "
                "utils.platform.ensure_feature_width(kmerlen) first")
    ambig_char = codes >= 4
    two_bit = jnp.where(ambig_char, 0, codes).astype(kdt)
    kmers = jnp.zeros((n, p), dtype=kdt)
    ambig = jnp.zeros((n, p), dtype=bool)
    for j in range(k):
        kmers = (kmers << 2) | jax.lax.dynamic_slice_in_dim(two_bit, j, p, 1)
        ambig = ambig | jax.lax.dynamic_slice_in_dim(ambig_char, j, p, 1)
    return kmers, ambig


@functools.partial(jax.jit, static_argnames=("k", "sketchlen"))
@stage("sketch")
def sketch_windows(codes: jax.Array, valid_lens: jax.Array,
                   k: int, sketchlen: int) -> jax.Array:
    """Sketch a batch of windows.

    Args:
      codes: (N, W) u8, 0..3 bases / >=4 ambiguous; padding chars beyond
        ``valid_lens`` may hold anything >= 4.
      valid_lens: (N,) i32 number of real characters per window.
      k, sketchlen: sketching parameters (static).

    Returns:
      (N, sketchlen) u32 features, ascending per row, SENTINEL-padded.
      Windows with valid_lens < k yield all-sentinel rows.
    """
    n, w = codes.shape
    p = w - k + 1
    kmers, ambig = window_kmers(codes, k)
    # positions whose k-mer would extend past the valid window length
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, p), 1)
    nvalid = jnp.maximum(valid_lens.astype(jnp.int32) - (k - 1), 0)
    invalid = ambig | (pos >= nvalid[:, None])

    if k <= 16:
        canon = canonical_2bit(kmers, k)
        feats = thomas_mueller_hash(canon)
        sent = SENTINEL
    else:
        canon = jnp.minimum(kmers, revcomp_2bit_u64(kmers, k))
        feats = murmur3_fmix64(canon)
        sent = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    feats = jnp.where(invalid, sent, feats)

    # s smallest unique: sort, kill adjacent duplicates, sort again
    feats = jnp.sort(feats, axis=-1)
    dup = jnp.concatenate(
        [jnp.zeros((n, 1), bool), feats[:, 1:] == feats[:, :-1]], axis=-1)
    feats = jnp.where(dup, sent, feats)
    feats = jnp.sort(feats, axis=-1)[:, :sketchlen]

    # a short window contributes at most n-k+1 features
    # (s = min(sketchlen, n-k+1), src/hash_dna.hpp:224)
    out_pos = jax.lax.broadcasted_iota(jnp.int32, (n, sketchlen), 1)
    feats = jnp.where(out_pos >= nvalid[:, None], sent, feats)
    return feats
