"""Query execution: stream reads, classify on device, produce output.

The device counterpart of the reference's query driver stack
(query_database / query_batched, src/database_query.hpp:126-366 and
map_queries_to_targets_default, src/classification.cpp:747-860):

- reads stream from FASTA/FASTQ files in one of 3 pairing modes;
- queries accumulate into fixed-shape window batches (the reference's
  batch_executor measures batch size in windows too,
  src/database_query.hpp:214-231);
- one jitted device step per batch does sketch -> probe -> sort ->
  candidates -> LCA (ops.pipeline.query_step);
- host post-processing: ground truth, statistics, output formatting,
  hits-per-target accumulation, optional coverage-percentile
  re-classification, abundance tables, summary.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import (ClassificationOptions, SketchingOptions,
                      max_windows_in_range)
from ..db.database import Database
from ..ops import windows as win_ops
from ..ops.pipeline import query_step
from ..ops.table import unpack_locations
from ..native import decode_header as _decode_header
from ..seqio.reader import PairingMode, QueryRecord, read_queries
from ..taxonomy.model import NUM_RANKS, Rank, Taxon
from . import abundance as abd
from . import classification as cls_mod
from . import output as out_mod
from .output import MapViewMode, OutputFormatting, cpp_num
from .stats import ClassificationStatistics


@functools.cache
def _pack_result_jit():
    """Concatenate a QueryResult's candidate arrays on device so the
    per-batch d2h is ONE fetch instead of six (each fetch pays a fixed
    cost)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def pack(tgt, tax, hits, beg, end, cls):
        return jnp.concatenate(
            [tgt, tax, hits, beg, end, cls[:, None]], axis=1)

    return pack


@functools.cache
def _pack_result_slim_jit():
    """Like _pack_result_jit without the candidate window ranges: when
    no consumer needs beg/end (no -locations/-align/-hits-per-ref/
    -cov-percentile), the per-read d2h shrinks from 5k+1 to 3k+1
    words."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def pack(tgt, tax, hits, cls):
        return jnp.concatenate([tgt, tax, hits, cls[:, None]], axis=1)

    return pack


@functools.cache
def _rank_hist_masked_jit():
    """_rank_hist_jit variant that also EXCLUDES reads flagged in a
    packed overflow bitmask (escalation phase 1: flagged reads are
    reclassified by the full-depth phase 2 and counted there)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def hist(cls, n, over_bits, taxid_sorted, rank_of):
        kk, b = cls.shape
        bits = over_bits.reshape(-1)
        over = ((bits[:, None] >> jax.lax.broadcasted_iota(
            jnp.int32, (bits.shape[0], 32), 1)) & 1).reshape(-1) == 1
        cls = cls.reshape(-1)
        m = cls.shape[0]
        nt = taxid_sorted.shape[0]
        pos = jnp.searchsorted(taxid_sorted, cls).astype(jnp.int32)
        pos = jnp.minimum(pos, nt - 1)
        found = (taxid_sorted[pos] == cls) & (cls != 0)
        ranks = jnp.where(found, rank_of[pos].astype(jnp.int32),
                          jnp.int32(NUM_RANKS))
        valid = (jax.lax.broadcasted_iota(jnp.int32, (m,), 0) < n) \
            & ~over
        ranks = jnp.where(valid, ranks, jnp.int32(NUM_RANKS + 1))
        return jnp.bincount(ranks, length=NUM_RANKS + 2)[:NUM_RANKS + 1]

    return hist


@functools.cache
def _rank_hist_jit():
    """Summary rank histogram ON DEVICE: d2h shrinks from one i32 per
    read to NUM_RANKS+1 ints per scan dispatch. Bit-identical to the
    host math in QueryRunner._accumulate_summary."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def hist(cls, n, taxid_sorted, rank_of):
        cls = cls.reshape(-1)
        m = cls.shape[0]
        nt = taxid_sorted.shape[0]
        pos = jnp.searchsorted(taxid_sorted, cls).astype(jnp.int32)
        pos = jnp.minimum(pos, nt - 1)
        found = (taxid_sorted[pos] == cls) & (cls != 0)
        ranks = jnp.where(found, rank_of[pos].astype(jnp.int32),
                          jnp.int32(NUM_RANKS))       # Rank.NONE
        valid = jax.lax.broadcasted_iota(jnp.int32, (m,), 0) < n
        ranks = jnp.where(valid, ranks, jnp.int32(NUM_RANKS + 1))
        return jnp.bincount(ranks, length=NUM_RANKS + 2)[:NUM_RANKS + 1]

    return hist


@dataclasses.dataclass
class AnalysisOptions:
    """Reference: classification_analysis_options (src/options.hpp)."""
    show_top_hits: bool = False
    show_all_hits: bool = False
    show_locations: bool = False
    show_hits_per_target: bool = False
    target_mappings_file: str = ""
    show_tax_abundances: bool = False
    abundance_file: str = ""
    abundance_per: Rank = Rank.NONE
    show_alignment: bool = False


@dataclasses.dataclass
class EvaluationOptions:
    precision: bool = False
    taxon_coverage: bool = False
    # -ground-truth sets both; -precision/-taxon-coverage only determine
    # (reference: options.cpp:1093-1112 — showGroundTruth is a separate
    # flag from determineGroundTruth)
    determine_ground_truth: bool = False
    show_ground_truth: bool = False


@dataclasses.dataclass
class OutputOptions:
    format: OutputFormatting = dataclasses.field(
        default_factory=OutputFormatting)
    analysis: AnalysisOptions = dataclasses.field(
        default_factory=AnalysisOptions)
    evaluate: EvaluationOptions = dataclasses.field(
        default_factory=EvaluationOptions)

    # convenience accessors used by the formatting layer
    @property
    def show_ground_truth(self):
        return self.evaluate.show_ground_truth

    @property
    def show_all_hits(self):
        return self.analysis.show_all_hits

    @property
    def show_top_hits(self):
        return self.analysis.show_top_hits

    @property
    def show_locations(self):
        return self.analysis.show_locations


@dataclasses.dataclass
class QueryOptions:
    sketching: SketchingOptions | None = None    # None -> use database's
    classify: ClassificationOptions = dataclasses.field(
        default_factory=ClassificationOptions)
    pairing: PairingMode = PairingMode.NONE
    output: OutputOptions = dataclasses.field(default_factory=OutputOptions)
    batch_windows: int = 4096
    num_replicas: int = 1      # -replicate: data-parallel devices (0=all)
    table_shards: int = 1      # -table-shards: feature-range DB shards
    query_limit: int = -1
    min_read_length: int = 0
    max_read_length: int = 0   # 0 = unlimited
    num_threads: int = 1
    show_summary: bool = True
    show_query_params: bool = True


def rank_from_string(s: str) -> Rank:
    from ..taxonomy.model import rank_from_name
    return rank_from_name(s)


_DECODE_LUT = np.frombuffer(b"ACGTN" + b"N" * 251, dtype=np.uint8)


class _CodedQuery:
    """QueryRecord-compatible view over one row of a coded batch;
    headers/sequences decode lazily (only when output needs them)."""

    __slots__ = ("_codes", "_len", "_hdr", "_codes2", "_len2")

    def __init__(self, codes, length, hdr_raw, codes2=None, len2=0):
        self._codes = codes
        self._len = int(length)
        self._hdr = hdr_raw
        self._codes2 = codes2
        self._len2 = int(len2)

    @property
    def header(self) -> str:
        return _decode_header(self._hdr)

    @property
    def seq1(self) -> bytes:
        n = min(self._len, len(self._codes))
        return _DECODE_LUT[self._codes[:n]].tobytes()

    @property
    def seq2(self) -> bytes:
        if self._codes2 is None:
            return b""
        n = min(self._len2, len(self._codes2))
        return _DECODE_LUT[self._codes2[:n]].tobytes()


class _CodedBatch:
    def __init__(self, codes, lens, headers, codes2=None, lens2=None):
        self.codes = codes
        self.lens = lens
        self.headers = headers
        self.codes2 = codes2
        self.lens2 = lens2

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i):
        if self.codes2 is None:
            return _CodedQuery(self.codes[i], self.lens[i],
                               self.headers[i])
        return _CodedQuery(self.codes[i], self.lens[i], self.headers[i],
                           self.codes2[i], self.lens2[i])

    def __iter__(self):
        for i in range(len(self.lens)):
            yield self[i]


class _ShardedRows:
    """Row-order adapter over a sharded QueryResult.

    sharded_query_step_rows emits rows data-major then table-subset-major
    (block (d, p) holds original rows [d*b_loc + p*bsub, ... + bsub));
    per-row fields are re-permuted to original order and the flat hit
    arrays' local query ids are rebased to global rows on first access."""

    def __init__(self, res, rows, nd, nt):
        self._res = res
        self.rows = rows
        b_loc, bsub = rows // nd, rows // (nd * nt)
        d, p, loc = np.meshgrid(np.arange(nd), np.arange(nt),
                                np.arange(bsub), indexing="ij")
        self._orig = (d * b_loc + p * bsub + loc).reshape(-1)
        self._inv = np.empty(rows, np.int64)
        self._inv[self._orig] = np.arange(rows)
        self._bases = (d * b_loc + p * bsub)[:, :, 0].reshape(-1)
        self._bsub = bsub

    def __getattr__(self, name):
        v = np.asarray(getattr(self._res, name))
        if name in ("hit_qid", "hit_tgt", "hit_win"):
            if name == "hit_qid":
                nb = len(self._bases)
                per = len(v) // nb
                base = np.repeat(self._bases, per)
                v = np.where(v >= self._bsub, self.rows, v + base)
            return v
        if v.ndim and v.shape[0] == self.rows:
            v = v[self._inv]
        return v



def _device_dense_tag(dtab):
    """probe_rows `dense` static tag for a DeviceTable layout."""
    import numpy as _np
    wide = dtab.uniq.dtype == _np.uint64
    if dtab.dense:
        if wide:
            return (f"u64pk{dtab.slot_bits}" +
                    ("p" if dtab.packed else ""))
        if dtab.slot_bits:
            return f"pk{dtab.slot_bits}" + ("p" if dtab.packed else "")
        return "packed" if dtab.packed else True
    if getattr(dtab, "classed", False):
        return ("classed", dtab.head_slots, False, dtab.ovf_packed,
                dtab.slot_bits)
    return (("u64_two_tier" if wide else "two_tier"), dtab.head_slots,
            dtab.packed, dtab.ovf_packed, dtab.slot_bits)


class _ShardedRowsEsc:
    """Sharded escalation adapter (summary path: only cls_tax is read).

    Phase 1 (head-only across shards) classifies every read; reads
    whose OR-reduced over flags are set re-run through the full-depth
    sharded step, padded to the mesh batch shape. The merge happens
    lazily on first cls_tax access."""

    def __init__(self, res1, over, redo, wmat, vmat, mwir, nd, nt):
        self._r1 = _ShardedRows(res1, len(mwir), nd, nt)
        self._over = over
        self._redo = redo
        self._w, self._v, self._m = wmat, vmat, mwir
        self._nd, self._nt = nd, nt
        self._cls = None

    @property
    def cls_tax(self):
        if self._cls is None:
            cls = np.asarray(self._r1.cls_tax).copy()
            over = np.asarray(self._over)
            # undo the data-major/table-subset row order of `over`
            rows = len(self._m)
            b_loc, bsub = rows // self._nd, rows // (self._nd * self._nt)
            d, p, loc = np.meshgrid(
                np.arange(self._nd), np.arange(self._nt),
                np.arange(bsub), indexing="ij")
            inv = np.empty(rows, np.int64)
            inv[(d * b_loc + p * bsub + loc).reshape(-1)] = \
                np.arange(rows)
            over = over[inv]
            idx = np.nonzero(over)[0]
            if len(idx):
                sel = np.resize(idx, rows)       # pad to the mesh shape
                r2 = _ShardedRows(
                    self._redo(self._w[sel], self._v[sel],
                               self._m[sel]),
                    rows, self._nd, self._nt)
                cls[idx] = np.asarray(r2.cls_tax)[:len(idx)]
            self._cls = cls
            self._w = self._v = None
        return self._cls


class QueryRunner:
    """Holds device-resident database state across query runs."""

    def __init__(self, db: Database, opt: QueryOptions):
        import jax.numpy as jnp
        from ..utils.platform import ensure_feature_width
        self.db = db
        self.opt = opt
        self.sketching = self._adapt_sketching()
        # 64-bit feature config (k > 16): u64 device arrays need x64
        ensure_feature_width(db.sketching.kmerlen)
        self._wide_features = db.sketching.kmerlen > 16
        self.hits_min = opt.classify.resolve_hits_min(
            db.sketching.sketchlen)
        self._line_writer = None   # lazy MappingLineWriter (memo per run)

        db.taxa.update()
        lin64 = db.taxa.target_lineages_array()  # (num_targets, R) int64
        self.lineages = np.clip(
            lin64, -2**31 + 1, 2**31 - 1).astype(np.int32)
        lowest = rank_from_string(opt.classify.lowest_rank)
        self.merge_rank = int(lowest)
        merge_tax = np.zeros(max(db.target_count, 1), dtype=np.int32)
        for r in range(self.merge_rank, NUM_RANKS):
            fill = (merge_tax == 0) & (self.lineages[:, r] != 0) \
                if db.target_count else np.zeros(1, bool)
            merge_tax[fill] = self.lineages[:, r][fill]
        self.merge_tax = merge_tax
        self.highest_rank = int(rank_from_string(opt.classify.highest_rank))
        # fast_top2 candidate path (ops.rows._fast_top2_result): valid
        # only without taxon merging (merge_rank == 0, i.e. -lowest
        # sequence, the default) and when every target has a nonzero
        # sequence-level taxon — then candidate taxa are unique per
        # target and the merge sort is a no-op the fast path may skip
        self._fast_top2 = (
            self.merge_rank == 0 and opt.classify.max_candidates <= 4
            and db.target_count > 0 and bool(np.all(merge_tax != 0)))

        # data-parallel device replication (-replicate; the reference
        # replicates the DB across GPU groups and splits each query batch
        # between the replicas, src/query_batch.cu:464-527 — here the
        # replica split is a sharding annotation and GSPMD runs the same
        # jitted step SPMD with zero collectives)
        import jax as _jax
        nrep = opt.num_replicas
        ndev = len(_jax.devices())
        if nrep <= 0:
            nrep = ndev
        nrep = min(nrep, ndev)
        while nrep & (nrep - 1):   # pow2 so pow2 row counts shard evenly
            nrep -= 1
        self._mesh = None
        self._nrep = 1
        self._tmesh = None             # ("data","table") mesh
        self._ntab = 1
        ntab = opt.table_shards
        if ntab > 1 and nrep * ntab <= ndev and len(db.parts) == 1:
            # feature-range table shards over the "table" axis (reference
            # P2/P3: one DB part per GPU with P2P sketch forwarding,
            # src/query_batch.cu:464-527 — here a single all_to_all
            # trades slot columns for row subsets)
            from jax.sharding import Mesh, NamedSharding
            from jax.sharding import PartitionSpec as _P
            devs = np.asarray(_jax.devices()[:nrep * ntab]).reshape(
                nrep, ntab)
            self._tmesh = Mesh(devs, ("data", "table"))
            self._nrep = nrep
            self._ntab = ntab
            self._tm_batch = NamedSharding(self._tmesh, _P("data"))
            self._tm_table = NamedSharding(self._tmesh, _P("table"))
            self._tm_repl = NamedSharding(self._tmesh, _P())
        elif nrep > 1:
            from jax.sharding import Mesh, NamedSharding
            from jax.sharding import PartitionSpec as _P
            self._mesh = Mesh(np.asarray(_jax.devices()[:nrep]), ("data",))
            self._rep_shard = NamedSharding(self._mesh, _P("data"))
            self._rep_repl = NamedSharding(self._mesh, _P())
            self._nrep = nrep

        def _dev(a):
            a = jnp.asarray(a)
            if self._tmesh is not None:
                a = _jax.device_put(a, self._tm_repl)
            elif self._mesh is not None:
                a = _jax.device_put(a, self._rep_repl)
            return a

        # device table arrays (all parts merged into one probe sequence —
        # single-part fast path; multi-part probes loop over parts).
        # Probing uses the bucket-row index: ONE row gather + in-lane
        # match instead of a multi-step binary search.
        from ..ops.probe import make_bucket_index
        self._prefix_bits: list = []   # per-part bucket bits
        self._tables = []
        self._prefix = []
        self._dense = []
        self._shard_table = None
        if self._tmesh is not None:
            import os as _os_
            from ..parallel.rows_mesh import shard_row_table
            st = shard_row_table(db.parts[0], self._ntab,
                                 db.max_locations_per_feature,
                                 layout=_os_.environ.get(
                                     "MC_SHARD_LAYOUT", "auto"))
            put_t = lambda a: _jax.device_put(jnp.asarray(a),
                                              self._tm_table)
            self._shard_table = (
                put_t(st.features), put_t(st.offsets),
                put_t(st.loc_tgt2d), put_t(st.loc_win2d),
                put_t(st.prefix), st.slots_per_feature,
                st.prefix_bits, st.prefix_steps,
                st.slot_bits, st.head_slots)
        # probe layout per part, chosen against the measured device
        # memory budget (reference sizes GPU tables from free VRAM minus
        # a reserve, src/gpu_hashmap.cu:1101-1141): dense fused rows
        # (1 gather/probe) when they fit, two-tier head+overflow rows
        # (2 gathers) for skewed RefSeq-scale tables, CSR as last resort.
        # MC_DENSE_LIMIT caps only the dense option (testing hook).
        import os as _os
        from ..utils.platform import hbm_budget_bytes
        remaining = hbm_budget_bytes()
        dense_cap = None
        try:
            dense_cap = int(_os.environ.get("MC_DENSE_LIMIT", 0)) or None
        except ValueError:
            pass
        # parts already built device-resident (build+query fast path)
        if getattr(db, "device_parts", None):
            if self._tmesh is not None or self._mesh is not None:
                raise RuntimeError(
                    "device-resident build does not support -replicate/"
                    "-table-shards yet; use a saved database")
            for dtab in db.device_parts:
                self._tables.append((dtab.uniq, dtab.offsets, dtab.head,
                                     dtab.ovf, dtab.spf))
                self._dense.append(_device_dense_tag(dtab))
                self._prefix.append((dtab.brows, 0))
                self._prefix_bits.append(dtab.bbits)
        use_dev_layout = (
            _os.environ.get("MC_DEVICE_LAYOUT", "1") != "0"
            and self._mesh is None and self._tmesh is None)
        for p in (db.parts if self._tmesh is None else []):
            spf = min(p.max_bucket_size, db.max_locations_per_feature) or 1
            if self._wide_features:
                # u64 features: fused rows carry [flo, fhi, ...] meta
                # and the bucket index matches low-32 in-lane
                # (exactness: two-lane verify after the gather +
                # collision-checked index). Falls back to device
                # binary search + CSR gathers when the index can't be
                # built (low-32 collision, unpackable locations).
                if use_dev_layout and p.num_features:
                    try:
                        from ..ops.table_device import \
                            device_layout_from_csr
                        ltgt, lwin = unpack_locations(p.locations)
                        dtab = device_layout_from_csr(
                            p.unique_features, p.offsets, ltgt, lwin,
                            cap=db.max_locations_per_feature or 254,
                            budget_bytes=remaining)
                        remaining -= dtab.layout_bytes
                        self._tables.append((
                            dtab.uniq, dtab.offsets, dtab.head,
                            dtab.ovf, dtab.spf))
                        self._dense.append(_device_dense_tag(dtab))
                        self._prefix.append((dtab.brows, 0))
                        self._prefix_bits.append(dtab.bbits)
                        continue
                    except MemoryError:
                        pass                  # CSR fallback below
                ltgt, lwin = unpack_locations(p.locations)
                self._tables.append((
                    _dev(p.unique_features),
                    _dev(p.offsets.astype(np.int32)),
                    _dev(ltgt.astype(np.int32)),
                    _dev(lwin.astype(np.int32)), spf))
                self._dense.append(False)
                self._prefix.append((None, 0))
                self._prefix_bits.append(0)
                continue
            allow_dense = dense_cap is None or \
                p.layout_bytes("dense", 0, spf) <= dense_cap
            if use_dev_layout and p.num_features:
                # build the probe rows ON DEVICE from the CSR stream
                # (12 B/location crosses the host link instead of the
                # padded rows)
                try:
                    from ..ops.table_device import device_layout_from_csr
                    ltgt, lwin = unpack_locations(p.locations)
                    dtab = device_layout_from_csr(
                        p.unique_features, p.offsets, ltgt, lwin,
                        cap=db.max_locations_per_feature or 254,
                        budget_bytes=remaining,
                        allow_dense=allow_dense)
                    remaining -= dtab.layout_bytes
                    self._tables.append((
                        dtab.uniq, dtab.offsets, dtab.head, dtab.ovf,
                        dtab.spf))
                    self._dense.append(_device_dense_tag(dtab))
                    self._prefix.append((dtab.brows, 0))
                    self._prefix_bits.append(dtab.bbits)
                    continue
                except MemoryError:
                    pass                      # CSR fallback below
            kind, hsl = p.choose_layout(spf, remaining, allow_dense)
            remaining -= p.layout_bytes(kind, hsl, spf)
            if kind == "dense":
                fused = p.fused_rows(spf)
                dummy = _dev(jnp.zeros((1,), jnp.int32))
                self._tables.append((
                    _dev(p.unique_features),
                    _dev(p.offsets.astype(np.int32)),
                    _dev(fused), dummy, spf))
                self._dense.append(True)
            elif kind == "two_tier":
                # two-tier: dense head rows + overflow rows for the rare
                # deep buckets — memory ~ actual locations, still row
                # gathers instead of CSR per-slot gathers
                head, ovf = p.fused_rows_two_tier(spf, hsl)
                self._tables.append((
                    _dev(p.unique_features),
                    _dev(p.offsets.astype(np.int32)),
                    _dev(head), _dev(ovf), spf))
                self._dense.append(("two_tier", hsl))
            else:
                ltgt, lwin = unpack_locations(p.locations)
                self._tables.append((
                    _dev(p.unique_features),
                    _dev(p.offsets.astype(np.int32)),
                    _dev(ltgt.astype(np.int32)),
                    _dev(lwin.astype(np.int32)), spf))
                self._dense.append(False)
            brows, bits = make_bucket_index(p.unique_features)
            self._prefix.append((_dev(brows), 0))
            self._prefix_bits.append(bits)
        self._lineages_dev = _dev(
            self.lineages if db.target_count else
            np.zeros((1, NUM_RANKS), np.int32))
        self._merge_tax_dev = _dev(merge_tax)

        import os as _os

        # packed single-i32 slot encoding pk = (tgt << wbits) | win:
        # halves the candidate sort's data movement (one key array
        # instead of two) and collapses the sweep's same-target +
        # window-range test into one compare. Valid while the largest
        # packed value fits i32 (I32_MAX reserved for padding); wbits
        # carries one extra bit so the inter-target gap exceeds any
        # (clamped) mwir.
        self._pack_bits = 0
        if (_os.environ.get("MC_PACK_SLOTS", "1") != "0"
                and self._mesh is None and self._tmesh is None
                and db.target_count > 0):
            maxwin = 0
            for dtab in (getattr(db, "device_parts", None) or []):
                maxwin = max(maxwin, int(dtab.max_win))
            for p in db.parts:
                if p.num_locations:
                    maxwin = max(maxwin, int(
                        (p.locations & np.uint64(0xFFFFFFFF)).max()))
            wbits = max(1, (2 * maxwin).bit_length())
            pkmax = ((db.target_count - 1) << wbits) | maxwin
            if pkmax < 2**31 - 1:
                self._pack_bits = wbits

        # 2-bit packed infeed for the single-end scan path (a quarter
        # of the host->device bytes); MC_PACK_INFEED=0 disables
        self._infeed_packed = (
            _os.environ.get("MC_PACK_INFEED", "1") != "0"
            and self._mesh is None and self._tmesh is None)

        # taxid -> rank lookup for the vectorized summary-only fast path
        ids, ranks = [], []
        for t in db.taxa.taxonomy.taxa.values():
            ids.append(t.id)
            ranks.append(int(t.rank))
        for t in db.taxa.taxonomy.targets.values():
            ids.append(t.id)
            ranks.append(int(t.rank))
        order = np.argsort(ids) if ids else np.zeros(0, np.int64)
        self._taxid_sorted = np.asarray(ids, np.int64)[order] \
            if ids else np.zeros(0, np.int64)
        self._rank_of_taxid = np.asarray(ranks, np.uint8)[order] \
            if ids else np.zeros(0, np.uint8)
        # device copies for the on-device summary histogram (taxon ids
        # always fit i32 here because classified taxa come from the
        # i32-clipped lineage arrays)
        self._hist_dev = None
        if len(self._taxid_sorted) and \
                int(np.abs(self._taxid_sorted).max()) < 2**31:
            self._hist_dev = (
                _dev(self._taxid_sorted.astype(np.int32)),
                _dev(self._rank_of_taxid.astype(np.int32)))

    @property
    def _row_quantum(self) -> int:
        """Batch row counts must be divisible by the device grid."""
        return self._nrep * self._ntab

    def _put(self, a):
        """Move a batch array to device; leading dim sharded over the
        replica mesh when -replicate is active."""
        import jax
        import jax.numpy as jnp
        if self._tmesh is not None:
            return jax.device_put(a, self._tm_batch)
        if self._mesh is None:
            return jnp.asarray(a)
        return jax.device_put(a, self._rep_shard)

    # Sweep-strategy thresholds: each masked lane shift of the walk is
    # one elementwise pass over the (B, L) rows, while the rank-join
    # alternative costs two double-width (2L-lane) sorts; the dedup walk
    # adds one extra per-row sort, so its bound is lower. Not yet
    # re-measured on the GPU.
    MAX_WALK_ELEMS = 64
    MAX_DEDUP_WALK = 48

    def _sweep_params(self, mwir, wq: int) -> dict:
        """Pick the range-sweep strategy for rows_to_result: lane-walk
        over raw slots when the per-range slot bound (max mwir *
        sketchlen * windows_per_query) is tiny, dedup+walk over distinct
        entries when only max(mwir) is small (long reads), else the
        rank-join sorts."""
        if len(mwir) == 0:
            return {}
        m = int(np.max(mwir))
        e = m * self.sketching.sketchlen * wq
        if e <= self.MAX_WALK_ELEMS:
            return {"walk_elems": e}
        if m <= self.MAX_DEDUP_WALK:
            return {"dedup_walk": m}
        return {}

    # escalation (head-only phase 1 + full-depth redo) serves
    # deep-bucket databases only: rows of at least this many slots
    ESC_MIN_SLOTS = 1024

    def _hits_flags(self) -> dict:
        """Skip the per-hit list outputs when -allhits is off."""
        if self.opt.output.analysis.show_all_hits:
            return {}
        return {"emit_hits": False}

    def _fast_flag(self, total_slots: int) -> dict:
        """Enable the fast_top2 candidate path; the packed-key scan uses
        int32 while L * next_pow2(L)^2 < 2^31 and widens to int64 beyond
        that (deep-bucket databases), see ops.rows._fast_top2_result."""
        if not self._fast_top2 or total_slots <= 0:
            return {}
        return {"fast_top2": True}

    def _adapt_sketching(self) -> SketchingOptions:
        """Reference: adapt_options_to_database (src/querying.cpp:225-266)."""
        dbs = self.db.sketching
        qs = self.opt.sketching
        if qs is None:
            return dbs
        kmerlen = dbs.kmerlen
        sketchlen = qs.sketchlen if qs.sketchlen >= 1 else dbs.sketchlen
        winlen = qs.winlen if qs.winlen >= 1 else dbs.winlen
        winstride = qs.winstride if qs.winstride >= 1 else \
            winlen - kmerlen + 1
        return SketchingOptions(kmerlen, sketchlen, winlen, winstride)

    # ------------------------------------------------------------------
    def run_queries(self, queries, results: "ClassificationResults"):
        """Classify an iterable of QueryRecord into `results`.

        One batch of device work stays in flight while the host prepares
        the next batch and formats the previous results — the double-
        buffered overlap the reference gets from its producer/consumer
        batch_executor (src/batch_processing.hpp:23-306), expressed
        through JAX async dispatch.
        """
        batch: List[QueryRecord] = []
        nwin_total = 0
        pending = None  # (batch, dispatched-but-unfetched device results)
        opt = self.opt
        for q in queries:
            ln = len(q.seq1) + len(q.seq2)
            if ln < opt.min_read_length:
                continue
            if opt.max_read_length and ln > opt.max_read_length:
                continue
            nw = (win_ops.num_windows(len(q.seq1), self.sketching) +
                  win_ops.num_windows(len(q.seq2), self.sketching))
            batch.append(q)
            nwin_total += max(nw, 1)
            if nwin_total >= opt.batch_windows:
                dispatched = self._dispatch_batch(batch)
                if pending is not None:
                    self._collect_batch(*pending, results)
                pending = (batch, dispatched)
                batch, nwin_total = [], 0
        if batch:
            dispatched = self._dispatch_batch(batch)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = (batch, dispatched)
        if pending is not None:
            self._collect_batch(*pending, results)

    # ------------------------------------------------------------------
    def run_file_native(self, path: str,
                        results: "ClassificationResults") -> bool:
        """Vectorized single-end ingestion through the native C++ reader.

        Short reads (<= winlen, the headline workload) bypass all
        per-query Python: the reader's coded (B, max_len) matrix IS the
        window matrix. Long reads in the batch fall back to the per-query
        path. Returns False when the native library is unavailable
        (caller uses the generic QueryRecord path).
        """
        from .. import native
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        sk = self.sketching
        scan = native.scan_file(path)
        if scan is None or scan[0] == 0:
            return False
        max_len = max(1024, scan[1])
        if max_len > (1 << 20):
            # beyond ~1 Mbp per read the fixed-width coded matrix wastes
            # too much host memory; stream per-query instead
            return False
        try:
            reader = native.NativeFastxReader(path, max_len=max_len)
        except (FileNotFoundError, RuntimeError):
            return False
        opt = self.opt
        # cap the coded read matrix at ~128 MB so long-read files don't
        # blow up host memory (batch row counts are re-bucketed by window
        # count before launch, so a smaller reader chunk only affects
        # reader-call frequency)
        batch_reads = max(opt.batch_windows, 1024)
        if max_len > 1024:
            batch_reads = max(256, min(batch_reads,
                                       (128 << 20) // max_len))
        if not self._summary_only() and max_len <= 1024:
            # per-read output path: one packed result matrix is fetched
            # per dispatched batch; larger batches amortize each fetch's
            # fixed cost (64k reads = ~2 MB h2d and <= 1.8 MB d2h per
            # cycle)
            batch_reads = max(batch_reads, 65536)
        scan_k = 0
        if (self._summary_only() and len(self._tables) == 1
                and self._mesh is None):
            # summary-only runs need nothing per read but the classified
            # taxon: fuse MC_SCAN_K batches into one lax.scan dispatch to
            # amortize host<->device round-trips (the production infeed
            # shape; bench.py measures the same protocol)
            import os as _os
            try:
                scan_k = int(_os.environ.get("MC_SCAN_K", "8"))
            except ValueError:
                scan_k = 8
        if scan_k > 1 and self._infeed_packed:
            # the C++ reader emits the exact 2-bit packed device infeed;
            # zero per-read host transforms remain on the hot path.
            # 32 stacked batches make each h2d transfer ~8 MB
            import os as _os
            import jax as _jax
            if _os.environ.get("MC_SCAN_K") is None:
                scan_k = 32
            bsz = batch_reads
            if _jax.devices()[0].platform != "cpu":
                bsz = max(bsz, 8192)
            # -threads N: N byte-range readers parse the file in
            # parallel (summary path only — per-read output order is
            # not defined across ranges; reference P1 reader threads,
            # src/building.cpp:337-461). gz can't seek: single reader.
            extra = []
            T = max(1, int(getattr(opt, "num_threads", 1) or 1))
            if T > 1 and not path.endswith(".gz"):
                try:
                    fsz = _os.path.getsize(path)
                    cuts = [fsz * i // T for i in range(T + 1)]
                    rngs = [native.NativeFastxReader(
                        path, max_len=max_len,
                        start=cuts[i], end=cuts[i + 1])
                        for i in range(T)]
                    reader.close()
                    reader, extra = rngs[0], rngs[1:]
                except (ValueError, RuntimeError, OSError):
                    extra = []
            try:
                self._run_scan_native_packed(reader, bsz, scan_k,
                                             results,
                                             extra_readers=extra)
                return True
            finally:
                reader.close()
                for rd_ in extra:
                    rd_.close()
        pending = None
        buf: list = []      # (codes, lens) short-read chunks for the scan
        nbuf = 0
        while True:
            codes, lens, headers = reader.read_batch_raw(batch_reads)
            if len(lens) == 0:
                break
            # length filter (reference: database_query.hpp:271-281)
            if opt.min_read_length > 0 or opt.max_read_length:
                keep = lens >= opt.min_read_length
                if opt.max_read_length:
                    keep &= lens <= opt.max_read_length
                codes, lens, headers = codes[keep], lens[keep], \
                    headers[keep]
                if len(lens) == 0:
                    continue
            if scan_k > 1:
                short = lens <= self.sketching.winlen
                if self._infeed_packed and short.any():
                    # reads with ambiguous chars (code 4) cannot 2-bit
                    # pack: send them through the unpacked path
                    wl = self.sketching.winlen
                    pos = np.arange(min(codes.shape[1], wl))
                    has_n = ((codes[:, :wl] >= 4) &
                             (pos[None, :] < lens[:, None])).any(axis=1)
                    short = short & ~has_n
                if not short.all():
                    dispatched = self._dispatch_coded(
                        codes[~short], lens[~short], headers[~short])
                    if pending is not None:
                        self._collect_batch(*pending, results)
                    pending = dispatched
                    codes, lens = codes[short], lens[short]
                    if len(lens) == 0:
                        continue
                buf.append((codes, lens))
                nbuf += len(lens)
                while nbuf >= scan_k * batch_reads:
                    codes_a = np.concatenate([c for c, _ in buf])
                    lens_a = np.concatenate([l for _, l in buf])
                    take = scan_k * batch_reads
                    dispatched = ("scan", (take, self._dispatch_scan(
                        codes_a[:take], lens_a[:take], scan_k,
                        batch_reads)))
                    if pending is not None:
                        self._collect_batch(*pending, results)
                    pending = (None, dispatched)
                    buf = [(codes_a[take:], lens_a[take:])]
                    nbuf -= take
                continue
            dispatched = self._dispatch_coded(codes, lens, headers)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = dispatched
        if nbuf:
            # leftover short reads (< one full scan stack): plain dispatch
            codes_a = np.concatenate([c for c, _ in buf])
            lens_a = np.concatenate([l for _, l in buf])
            hdr_a = np.asarray([b""] * len(lens_a), dtype=object)
            dispatched = self._dispatch_coded(codes_a, lens_a, hdr_a)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = dispatched
        if pending is not None:
            self._collect_batch(*pending, results)
        reader.close()
        return True

    def _run_scan_native_packed(self, reader, batch_reads: int,
                                scan_k: int, results,
                                extra_readers=None):
        """Summary fast path fed by the native packed reader.

        Clean short reads arrive from C++ already in the device infeed
        layout (2-bit packed rows); the host only buffers, length-filters
        and stacks them. Long/ambiguous reads ride the generic coded
        path. The scan remainder pads to a full stack; its payload
        carries the real read count so padded rows never enter the
        summary."""
        import collections as _cl
        import os as _os
        opt = self.opt
        wl = self.sketching.winlen
        pending: _cl.deque = _cl.deque()
        DEPTH = 3   # in-flight dispatches (h2d overlaps device compute)
        take = scan_k * batch_reads
        esc = self._escalation_ok() and self._hist_dev is not None
        self._esc_redo = []      # (rows, lens) chunks from _collect_batch
        self._esc_nredo = 0
        # fused escalation: phase 2 rides inside the phase-1 scan so the
        # scheduler can interleave its sort with phase 1's row gathers
        # (MC_ESC_FUSED=0 restores the separate redo)
        esc_fused = (esc and bool(self._prefetch_flag()) and
                     _os.environ.get("MC_ESC_FUSED", "1") == "1")
        try:
            esc_b2 = int(_os.environ.get("MC_ESC_B2",
                                         str(batch_reads // 2)))
        except ValueError:
            esc_b2 = batch_reads // 2

        def flush(dispatched):
            while len(pending) >= DEPTH:
                self._collect_batch(*pending.popleft(), results)
            pending.append(dispatched)

        def scan_dispatch(pa, la, n):
            # crop rows to the stack's max read length (8-byte quantum
            # -> few static shapes): reads shorter than winlen shrink
            # the h2d transfer proportionally
            q = min(-(-int(la.max(initial=0)) // 16) * 4, pa.shape[1]) \
                if n else 4
            pac = np.ascontiguousarray(pa[:, :max(q, 4)])
            if esc:
                if esc_fused and \
                        self._esc_nredo >= (scan_k * esc_b2) // 2:
                    rf, ri, rlens, got = self._carve_redo(
                        scan_k * esc_b2)
                    out = self._dispatch_scan_head_fused(
                        pac, la, scan_k, batch_reads,
                        rf, ri, rlens, esc_b2)
                    return (None, ("scanesc2", (n, out, pac, la, got)))
                out = self._dispatch_scan_head(
                    pac, la, scan_k, batch_reads)
                if len(out) == 4:      # prefetch mode: feats+idx kept
                    cls, over, fk, ik = out
                else:
                    (cls, over), fk, ik = out, None, None
                return (None, ("scanesc", (n, cls, over, pac, la,
                                           fk, ik)))
            return (None, ("scan", (n, self._dispatch_scan(
                pac, la, scan_k, batch_reads, prepacked=True))))

        def flush_redo(final: bool = False):
            # full-depth phase 2 for reads that touched overflowing
            # buckets in phase 1 (exact for everyone else)
            while self._esc_nredo >= take or (final and self._esc_nredo):
                if self._esc_redo and len(self._esc_redo[0]) == 3:
                    # feats-reuse chunks (phase 1 ran with prefetch):
                    # the redo consumes phase 1's device-resident
                    # sketches + bucket probes — no re-sketch, no
                    # bucket-row gather, no re-shipping of read rows
                    rf, ri, rlens, got = self._carve_redo(take)
                    flush((None, ("scan", (got, self._dispatch_redo(
                        rf, ri, rlens, scan_k, batch_reads)))))
                    continue
                wmax = max(r.shape[1] for r, _ in self._esc_redo)
                rows = np.zeros((take, wmax), np.uint8)
                lens2 = np.zeros(take, np.int32)
                got = 0
                left = []
                for r, l in self._esc_redo:
                    use = min(len(l), take - got)
                    rows[got:got + use] = np.pad(
                        r[:use], ((0, 0), (0, wmax - r.shape[1])))
                    lens2[got:got + use] = l[:use]
                    got += use
                    if use < len(l):
                        left.append((r[use:], l[use:]))
                self._esc_redo = left
                self._esc_nredo -= got
                flush((None, ("scan", (got, self._dispatch_scan(
                    rows, lens2, scan_k, batch_reads,
                    prepacked=True)))))

        buf: list = []
        nbuf = 0
        # producer thread(s): the C parser releases the GIL, so file
        # parsing fully overlaps device dispatch/transfer; -threads N
        # adds byte-range readers over the same file (reference P1:
        # N reader threads, src/building.cpp:337-461)
        import queue as _q
        import threading as _th
        readers = [reader] + list(extra_readers or [])
        chunks: _q.Queue = _q.Queue(maxsize=2 + 2 * len(readers))
        done = _th.Lock()
        live = [len(readers)]

        def _produce(rd):
            try:
                while True:
                    item = rd.read_batch_packed(4 * batch_reads, wl)
                    if item[5] == 0:
                        break
                    chunks.put(item)
            finally:
                with done:
                    live[0] -= 1
                    if live[0] == 0:
                        chunks.put(None)

        ths = [_th.Thread(target=_produce, args=(rd,), daemon=True)
               for rd in readers]
        for th in ths:
            th.start()
        while True:
            item = chunks.get()
            if item is None:
                break
            packed, plens, scodes, slens, sheaders, _ = item
            if opt.min_read_length > 0 or opt.max_read_length:
                keep = plens >= opt.min_read_length
                if opt.max_read_length:
                    keep &= plens <= opt.max_read_length
                packed, plens = packed[keep], plens[keep]
                skeep = slens >= opt.min_read_length
                if opt.max_read_length:
                    skeep &= slens <= opt.max_read_length
                scodes, slens = scodes[skeep], slens[skeep]
                sheaders = sheaders[skeep]
            if len(slens):
                flush(self._dispatch_coded(scodes, slens, sheaders))
            if len(plens):
                buf.append((packed, plens))
                nbuf += len(plens)
            while nbuf >= take:
                pa = np.concatenate([c for c, _ in buf])
                la = np.concatenate([l for _, l in buf])
                flush(scan_dispatch(pa[:take], la[:take], take))
                buf = [(pa[take:], la[take:])]
                nbuf -= take
                flush_redo()
        if nbuf:
            pa = np.concatenate([c for c, _ in buf])
            la = np.concatenate([l for _, l in buf])
            n = len(la)
            pa = np.concatenate(
                [pa, np.zeros((take - n, pa.shape[1]), np.uint8)])
            la = np.concatenate([la, np.zeros(take - n, np.int32)])
            flush(scan_dispatch(pa, la, n))
        while pending:
            self._collect_batch(*pending.popleft(), results)
        flush_redo(final=True)
        while pending:
            self._collect_batch(*pending.popleft(), results)
        for th in ths:
            th.join()

    def run_pair_files_native(self, path1: str, path2: str,
                              results: "ClassificationResults") -> bool:
        """Vectorized paired-end ingestion through the native C++ reader.

        Two readers advance in lockstep and each pair classifies from the
        union of both mates' windows (reference: sequence_pair_reader,
        src/sequence_io.cpp:246-450, consumed with stride 2 by
        query_database, src/database_query.hpp:256-284). Returns False
        (caller falls back to the per-record Python path) when the native
        library is unavailable or the files disagree on record count.
        """
        from .. import native
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        s1 = native.scan_file(path1)
        s2 = native.scan_file(path2)
        if (s1 is None or s2 is None or s1[0] == 0 or s1[0] != s2[0]):
            return False
        max_len = max(1024, s1[1], s2[1])
        if max_len > (1 << 20):
            return False
        try:
            r1 = native.NativeFastxReader(path1, max_len=max_len)
            r2 = native.NativeFastxReader(path2, max_len=max_len)
        except (FileNotFoundError, RuntimeError):
            return False
        opt = self.opt
        batch_reads = max(opt.batch_windows // 2, 1024)
        if max_len > 1024:
            batch_reads = max(256, min(batch_reads,
                                       (64 << 20) // max_len))
        scan_k = 0
        if (self._summary_only() and len(self._tables) == 1
                and self._mesh is None):
            # same fused-scan summary path as single-end reads, with
            # two windows per query (mate 1 + mate 2)
            import os as _os
            try:
                scan_k = int(_os.environ.get("MC_SCAN_K", "8"))
            except ValueError:
                scan_k = 8
        pending = None
        wl = self.sketching.winlen
        buf: list = []
        nbuf = 0
        # paired escalation (head-only phase 1 + feats-reuse redo):
        # valid only with the prefetch carry (the redo consumes phase
        # 1's device-resident sketches)
        esc = (scan_k > 1 and self._escalation_ok(wq=2) and
               self._hist_dev is not None and
               bool(self._prefetch_flag()))
        self._esc_redo = []
        self._esc_nredo = 0
        take_total = scan_k * batch_reads if scan_k else 0

        def pair_dispatch(c1a, l1a, c2a, l2a, take):
            if not esc:
                return ("scan", (take, self._dispatch_scan_pair(
                    c1a[:take], l1a[:take], c2a[:take], l2a[:take],
                    scan_k, batch_reads)))
            cls, over, fk, ik = self._dispatch_scan_head_pair(
                c1a[:take], l1a[:take], c2a[:take], l2a[:take],
                scan_k, batch_reads)
            lens_sum = (l1a[:take].astype(np.int64) +
                        l2a[:take]).astype(np.int32)
            return ("scanesc", (take, cls, over, None, lens_sum,
                                fk, ik))

        while True:
            c1, l1, h1 = r1.read_batch_raw(batch_reads)
            c2, l2, h2 = r2.read_batch_raw(batch_reads)
            n = min(len(l1), len(l2))
            if n == 0:
                break
            c1, l1, h1 = c1[:n], l1[:n], h1[:n]
            c2, l2 = c2[:n], l2[:n]
            # length filter on the combined length
            # (reference: database_query.hpp:271-281)
            if opt.min_read_length > 0 or opt.max_read_length:
                ln = l1.astype(np.int64) + l2
                keep = ln >= opt.min_read_length
                if opt.max_read_length:
                    keep &= ln <= opt.max_read_length
                c1, l1, h1 = c1[keep], l1[keep], h1[keep]
                c2, l2 = c2[keep], l2[keep]
                if len(l1) == 0:
                    continue
            if scan_k > 1:
                short = (l1 <= wl) & (l2 <= wl)
                if not short.all():
                    dispatched = self._dispatch_coded_pair(
                        c1[~short], l1[~short], c2[~short], l2[~short],
                        h1[~short])
                    if pending is not None:
                        self._collect_batch(*pending, results)
                    pending = dispatched
                    c1, l1 = c1[short], l1[short]
                    c2, l2 = c2[short], l2[short]
                    if len(l1) == 0:
                        continue
                buf.append((c1, l1, c2, l2))
                nbuf += len(l1)
                while nbuf >= scan_k * batch_reads:
                    take = scan_k * batch_reads
                    c1a = np.concatenate([x[0] for x in buf])
                    l1a = np.concatenate([x[1] for x in buf])
                    c2a = np.concatenate([x[2] for x in buf])
                    l2a = np.concatenate([x[3] for x in buf])
                    dispatched = pair_dispatch(c1a, l1a, c2a, l2a, take)
                    if pending is not None:
                        self._collect_batch(*pending, results)
                    pending = (None, dispatched)
                    buf = [(c1a[take:], l1a[take:], c2a[take:],
                            l2a[take:])]
                    nbuf -= take
                    while esc and self._esc_nredo >= take_total:
                        rf, ri, rlens, got = self._carve_redo(
                            take_total)
                        if pending is not None:
                            self._collect_batch(*pending, results)
                        pending = (None, ("scan", (
                            got, self._dispatch_redo(
                                rf, ri, rlens, scan_k, batch_reads))))
                continue
            dispatched = self._dispatch_coded_pair(c1, l1, c2, l2, h1)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = dispatched
        if nbuf:
            c1a = np.concatenate([x[0] for x in buf])
            l1a = np.concatenate([x[1] for x in buf])
            c2a = np.concatenate([x[2] for x in buf])
            l2a = np.concatenate([x[3] for x in buf])
            # the buffered-scan path is only entered under _summary_only()
            # (headers never printed); placeholder headers are safe here
            assert self._summary_only(), \
                "scan remainder flush requires summary-only output"
            hdr_a = np.asarray([b""] * len(l1a), dtype=object)
            dispatched = self._dispatch_coded_pair(c1a, l1a, c2a, l2a,
                                                   hdr_a)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = dispatched
        if pending is not None:
            self._collect_batch(*pending, results)
        while esc and self._esc_nredo:
            rf, ri, rlens, got = self._carve_redo(take_total)
            self._collect_batch(None, ("scan", (
                got, self._dispatch_redo(rf, ri, rlens, scan_k,
                                         batch_reads))), results)
        r1.close()
        r2.close()
        return True

    def _dispatch_scan_pair(self, c1, l1, c2, l2, scan_k: int,
                            bsz: int):
        """Fused lax.scan dispatch over scan_k stacked short-PAIR
        batches (two windows per query); returns (scan_k, bsz) taxa."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_scan
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        n = len(l1)
        wmat = np.empty((n, 2, wl), np.uint8)
        wmat[:, 0] = c1[:, :wl]
        wmat[:, 1] = c2[:, :wl]
        wmat = wmat.reshape(scan_k, bsz, 2, wl)
        vmat = np.stack([np.where(l1 >= sk.kmerlen, l1, 0),
                         np.where(l2 >= sk.kmerlen, l2, 0)],
                        axis=1).astype(np.int32).reshape(scan_k, bsz, 2)
        mwir = (2 + np.maximum(l1.astype(np.int64) + l2,
                               opt.classify.insert_size_max)
                // stride).astype(np.int32).reshape(scan_k, bsz)
        tf, to, lt, lw, spf = self._tables[0]
        ps, steps = self._prefix[0]
        return query_step_rows_scan(
            jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank), ps,
            k=sk.kmerlen, sketchlen=sk.sketchlen, slots_per_feature=spf,
            windows_per_query=2,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], prefix_steps=steps,
            dense=self._dense[0],
            pack_bits=self._pack_bits,
            **self._sweep_params(mwir.reshape(-1), 2),
            **self._fast_flag(2 * sk.sketchlen * spf),
            **self._prefetch_flag())

    def run_pair_seq_native(self, path: str,
                            results: "ClassificationResults") -> bool:
        """Vectorized consecutive-record pairing (-pairseq) through the
        native reader: records 2i and 2i+1 form one query (reference:
        sequence_pair_reader single-file mode, src/sequence_io.cpp:345-383).
        """
        from .. import native
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        scan = native.scan_file(path)
        if scan is None or scan[0] == 0:
            return False
        max_len = max(1024, scan[1])
        if max_len > (1 << 20):
            return False
        try:
            reader = native.NativeFastxReader(path, max_len=max_len)
        except (FileNotFoundError, RuntimeError):
            return False
        opt = self.opt
        batch_reads = 2 * max(opt.batch_windows // 2, 1024)
        if max_len > 1024:
            batch_reads = 2 * max(128, min(batch_reads // 2,
                                           (64 << 20) // max_len))
        pending = None
        carry = None        # odd leftover record from the previous batch
        while True:
            codes, lens, headers = reader.read_batch_raw(batch_reads)
            if len(lens) == 0:
                if carry is not None:
                    # odd final record: a pair with an empty second mate
                    # (reference sequence_pair_reader yields exactly this
                    # when the stream ends mid-pair)
                    c1 = carry[0][None]
                    dispatched = self._dispatch_coded_pair(
                        c1, np.asarray([carry[1]], np.int32),
                        np.zeros_like(c1), np.asarray([0], np.int32),
                        carry[2][None])
                    if pending is not None:
                        self._collect_batch(*pending, results)
                    pending = dispatched
                    carry = None
                break
            if carry is not None:
                codes = np.concatenate([carry[0][None], codes])
                lens = np.concatenate(
                    [np.asarray([carry[1]], lens.dtype), lens])
                headers = np.concatenate([carry[2][None], headers])
                carry = None
            if len(lens) % 2:
                carry = (codes[-1].copy(), lens[-1],
                         headers[-1].copy())
                codes, lens, headers = (codes[:-1], lens[:-1],
                                        headers[:-1])
                if len(lens) == 0:
                    continue
            c1, l1, h1 = codes[0::2], lens[0::2], headers[0::2]
            c2, l2 = codes[1::2], lens[1::2]
            if opt.min_read_length > 0 or opt.max_read_length:
                ln = l1.astype(np.int64) + l2
                keep = ln >= opt.min_read_length
                if opt.max_read_length:
                    keep &= ln <= opt.max_read_length
                c1, l1, h1 = c1[keep], l1[keep], h1[keep]
                c2, l2 = c2[keep], l2[keep]
                if len(l1) == 0:
                    continue
            dispatched = self._dispatch_coded_pair(c1, l1, c2, l2, h1)
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = dispatched
        if pending is not None:
            self._collect_batch(*pending, results)
        reader.close()
        return True

    def _dispatch_coded_pair(self, c1, l1, c2, l2, headers):
        """Dispatch a coded paired batch; mirrors _dispatch_coded with
        each query's windows = mate-1 windows then mate-2 windows."""
        sk = self.sketching
        opt = self.opt
        k = opt.classify.max_candidates
        wl = sk.winlen
        stride = self.db.sketching.winstride

        short = (l1 <= wl) & (l2 <= wl)
        launched = []
        if short.any():
            idxs = np.nonzero(short)[0]
            rows = max(_round_up_pow2(len(idxs)), self._row_quantum)
            wmat = np.full((rows, 2, wl), win_ops.PAD_CODE, np.uint8)
            wmat[:len(idxs), 0, :] = c1[idxs, :wl]
            wmat[:len(idxs), 1, :] = c2[idxs, :wl]
            vmat = np.zeros((rows, 2), np.int32)
            vmat[:len(idxs), 0] = np.where(l1[idxs] >= sk.kmerlen,
                                           l1[idxs], 0)
            vmat[:len(idxs), 1] = np.where(l2[idxs] >= sk.kmerlen,
                                           l2[idxs], 0)
            mwir = np.full(rows, 2, np.int32)
            mwir[:len(idxs)] = 2 + np.maximum(
                l1[idxs].astype(np.int64) + l2[idxs],
                opt.classify.insert_size_max) // stride
            launched.append((idxs.tolist(), rows,
                             self._launch_rows(wmat, vmat, mwir, 2, k)))
        if (~short).any():
            lbuckets: Dict[int, list] = {}
            for i in np.nonzero(~short)[0]:
                i = int(i)
                nw = (win_ops.num_windows(int(l1[i]), sk) +
                      win_ops.num_windows(int(l2[i]), sk))
                lbuckets.setdefault(_bucket_wq(max(nw, 1)), []).append(i)
            for wq, idxs in sorted(lbuckets.items()):
                rows = max(_round_up_pow2(len(idxs)), self._row_quantum)
                wmat = np.full((rows, wq, wl), win_ops.PAD_CODE, np.uint8)
                vmat = np.zeros((rows, wq), np.int32)
                mwir = np.full(rows, 2, np.int32)
                for r, i in enumerate(idxs):
                    w1, v1 = win_ops.sequence_windows(c1[i, :l1[i]], sk)
                    w2, v2 = win_ops.sequence_windows(c2[i, :l2[i]], sk)
                    w = np.concatenate([w1, w2])
                    v = np.concatenate([v1, v2])
                    wmat[r, :len(w)] = w
                    vmat[r, :len(v)] = v
                    mwir[r] = 2 + max(
                        int(l1[i]) + int(l2[i]),
                        opt.classify.insert_size_max) // stride
                launched.append((idxs, rows,
                                 self._launch_rows(wmat, vmat, mwir,
                                                   wq, k)))
        batch = _CodedBatch(c1, l1, headers, c2, l2)
        return (batch, ("rows", launched))

    def _dispatch_coded(self, codes, lens, headers):
        """Dispatch a coded (B, max_len) read batch; returns
        (batch_descr, dispatched) like _dispatch_batch."""
        import jax.numpy as jnp
        from .. import native
        sk = self.sketching
        opt = self.opt
        k = opt.classify.max_candidates
        n = len(lens)
        wl = sk.winlen
        stride = self.db.sketching.winstride

        short = lens <= wl
        launched = []
        if short.any():
            idxs = np.nonzero(short)[0]
            rows = max(_round_up_pow2(len(idxs)), self._row_quantum)
            wmat = np.full((rows, 1, wl), win_ops.PAD_CODE, np.uint8)
            wmat[:len(idxs), 0, :] = codes[idxs, :wl]
            vmat = np.zeros((rows, 1), np.int32)
            vmat[:len(idxs), 0] = np.where(lens[idxs] >= sk.kmerlen,
                                           lens[idxs], 0)
            mwir = np.full(rows, 2, np.int32)
            mwir[:len(idxs)] = 2 + np.maximum(
                lens[idxs], opt.classify.insert_size_max) // stride
            launched.append((idxs.tolist(), rows,
                             self._launch_rows(wmat, vmat, mwir, 1, k)))
        if (~short).any():
            # long reads: bucket by padded window count and launch dense
            # multi-read batches (one launch per BUCKET, not per read —
            # the reference packs long reads into the same GPU query
            # batches as short ones, src/query_batch.cuh:85-209)
            lbuckets: Dict[int, list] = {}
            for i in np.nonzero(~short)[0]:
                nw = win_ops.num_windows(int(lens[i]), sk)
                lbuckets.setdefault(_bucket_wq(nw), []).append(int(i))
            for wq, idxs in sorted(lbuckets.items()):
                rows = max(_round_up_pow2(len(idxs)), self._row_quantum)
                wmat = np.full((rows, wq, wl), win_ops.PAD_CODE, np.uint8)
                vmat = np.zeros((rows, wq), np.int32)
                mwir = np.full(rows, 2, np.int32)
                for r, i in enumerate(idxs):
                    w, v = win_ops.sequence_windows(codes[i, :lens[i]], sk)
                    wmat[r, :len(w)] = w
                    vmat[r, :len(v)] = v
                    mwir[r] = 2 + max(
                        int(lens[i]),
                        opt.classify.insert_size_max) // stride
                launched.append((idxs, rows,
                                 self._launch_rows(wmat, vmat, mwir,
                                                   wq, k)))
        batch = _CodedBatch(codes, lens, headers)
        return (batch, ("rows", launched))

    def _launch_rows(self, wmat, vmat, mwir, wq, k):
        import jax.numpy as jnp
        sk = self.sketching
        opt = self.opt
        tail = (self._merge_tax_dev, self._lineages_dev,
                jnp.int32(self.hits_min),
                jnp.float32(opt.classify.hits_diff_fraction),
                jnp.int32(self.highest_rank), jnp.int32(self.merge_rank))
        if self._tmesh is not None:
            from ..parallel.rows_mesh import (
                sharded_query_step_rows, sharded_query_step_rows_head)
            (tf, to, lt2, lw2, ps, spf, pbits, psteps, sbits, shsl) = \
                self._shard_table
            kw = dict(
                mesh=self._tmesh, k=sk.kmerlen, sketchlen=sk.sketchlen,
                slots_per_feature=spf, windows_per_query=wq,
                max_candidates=k, prefix_bits=pbits,
                prefix_steps=psteps, pack_bits=sbits, head_slots=shsl)
            import os as _os
            esc = (sbits > 0 and 0 < shsl < spf and wq == 1
                   and self._summary_only()
                   and _os.environ.get("MC_ESCALATE", "1") != "0")
            if esc:
                # head-only phase 1 across shards; flagged reads redo
                # through the full-depth step (same two-phase structure
                # as the single-chip summary loop)
                res1, over = sharded_query_step_rows_head(
                    self._put(wmat), self._put(vmat), self._put(mwir),
                    tf, to, lt2, lw2, ps, *tail, **kw)

                def redo(wsel, vsel, msel):
                    return sharded_query_step_rows(
                        self._put(wsel), self._put(vsel),
                        self._put(msel), tf, to, lt2, lw2, ps, *tail,
                        **kw)
                return _ShardedRowsEsc(res1, over, redo,
                                       wmat, vmat, mwir,
                                       self._nrep, self._ntab)
            res = sharded_query_step_rows(
                self._put(wmat), self._put(vmat), self._put(mwir),
                tf, to, lt2, lw2, ps, *tail, **kw)
            return _ShardedRows(res, len(mwir), self._nrep, self._ntab)
        if len(self._tables) == 1:
            from ..ops.rows import query_step_rows
            tf, to, lt, lw, spf = self._tables[0]
            ps, steps = self._prefix[0]
            return query_step_rows(
                self._put(wmat), self._put(vmat), self._put(mwir),
                tf, to, lt, lw, *tail, ps,
                k=sk.kmerlen, sketchlen=sk.sketchlen,
                slots_per_feature=spf, windows_per_query=wq,
                max_candidates=k, prefix_bits=self._prefix_bits[0],
                prefix_steps=steps, dense=self._dense[0],
                pack_bits=self._pack_bits,
                **self._sweep_params(mwir, wq),
                **self._fast_flag(wq * sk.sketchlen * spf),
                **self._hits_flags())
        from ..ops.rows import query_step_rows_multipart
        return query_step_rows_multipart(
            self._put(wmat), self._put(vmat), self._put(mwir),
            tuple(t[0] for t in self._tables),
            tuple(t[1] for t in self._tables),
            tuple(t[2] for t in self._tables),
            tuple(t[3] for t in self._tables),
            *tail, tuple(p[0] for p in self._prefix),
            k=sk.kmerlen, sketchlen=sk.sketchlen,
            slots_per_feature=tuple(t[4] for t in self._tables),
            windows_per_query=wq, max_candidates=k,
            prefix_bits=tuple(self._prefix_bits),
            prefix_steps=tuple(p[1] for p in self._prefix),
            num_parts=len(self._tables), dense=tuple(self._dense),
            pack_bits=self._pack_bits,
            **self._sweep_params(mwir, wq),
            **self._fast_flag(
                wq * sk.sketchlen * sum(t[4] for t in self._tables)),
            **self._hits_flags())

    # ------------------------------------------------------------------
    def _dispatch_batch(self, batch: List[QueryRecord]):
        """Launch the device work for one batch (async).

        Single-part databases use the row-layout fast path: queries are
        bucketed by (padded) window count so each bucket is a dense
        (rows, Wq) matrix processed with per-row sorts
        (ops.rows.query_step_rows). Multi-part databases fall back to the
        flat pipeline with part-merged matches.
        """
        return ("rows", self._dispatch_batch_rows(batch))

    def _collect_batch(self, batch, dispatched, results):
        kind, payload = dispatched
        if kind == "scanesc2":
            # fused escalation dispatch: phase-1 stats for the fresh
            # batch (flagged reads excluded + requeued) AND phase-2
            # stats for the redone slice it carried
            import jax.numpy as jnp
            n, out, pa, la, got = payload
            cls_dev, over_dev, fk, ik, cls2 = out
            if got:
                hist2 = np.asarray(_rank_hist_jit()(
                    cls2, jnp.int32(got), *self._hist_dev))
                results.statistics.assigned_ += hist2.astype(np.int64)
                results.query_count += got
            payload = (n, cls_dev, over_dev, pa, la, fk, ik)
            kind = "scanesc"
        if kind == "scanesc":
            # escalation phase 1: count non-overflowing reads, queue the
            # flagged ones for the full-depth phase 2
            import jax.numpy as jnp
            n, cls_dev, over_dev, pa, la, fk, ik = payload
            hist = np.asarray(_rank_hist_masked_jit()(
                cls_dev, jnp.int32(n), over_dev, *self._hist_dev))
            bits = np.asarray(over_dev).reshape(-1)
            mask = (((bits[:, None] >> np.arange(32)) & 1)
                    .astype(bool).reshape(-1))
            mask[n:] = False
            idxs = np.nonzero(mask)[0]
            if len(idxs):
                if fk is not None:
                    # keep phase 1's sketches + bucket probes for the
                    # flagged rows (device gather; the big stack arrays
                    # free here) — phase 2 skips sketch + brows gather
                    F = fk.shape[-1]
                    selj = jnp.asarray(idxs.astype(np.int32))
                    self._esc_redo.append((fk.reshape(-1, F)[selj],
                                           ik.reshape(-1, F)[selj],
                                           la[idxs]))
                else:
                    self._esc_redo.append((pa[idxs], la[idxs]))
                self._esc_nredo += len(idxs)
            results.statistics.assigned_ += hist.astype(np.int64)
            results.query_count += n - len(idxs)
            return
        if kind == "scan":
            n, cls_dev = payload
            if self._hist_dev is not None:
                import jax.numpy as jnp
                hist = np.asarray(_rank_hist_jit()(
                    cls_dev, jnp.int32(n), *self._hist_dev))
                results.statistics.assigned_ += hist.astype(np.int64)
                results.query_count += n
            else:
                self._accumulate_summary(
                    np.asarray(cls_dev).reshape(-1)[:n], results)
            return
        self._collect_batch_rows(batch, payload, results)

    def _prefetch_flag(self) -> dict:
        """Software-pipelined scan (ops.rows: stage-1 sketch + bucket
        probe of batch i+1 overlaps batch i's gathers and sorts) — valid
        for fused-row layouts with a bucket-row index; identical
        results. MC_PREFETCH=0 disables."""
        import os as _os
        if (_os.environ.get("MC_PREFETCH", "1") != "0"
                and bool(self._dense[0])
                and self._prefix[0][0] is not None):
            return {"prefetch": True}
        return {}

    def _escalation_ok(self, wq: int = 1) -> bool:
        """Escalation (head-only phase 1 + full-depth redo) is valid for
        slot-packed two-tier single-part layouts on the fast_top2 path;
        it pays off when buckets can exceed the head. MC_ESCALATE=0
        disables."""
        import os as _os
        if _os.environ.get("MC_ESCALATE", "1") == "0" or \
                len(self._tables) != 1 or not self._fast_top2 or \
                not self._pack_bits:
            return False
        d = self._dense[0]
        sk = self.sketching
        stride = self.db.sketching.winstride
        m = 2 + max(wq * sk.winlen,
                    self.opt.classify.insert_size_max) // stride
        sweep_ok = (m * sk.sketchlen * wq <= self.MAX_WALK_ELEMS or
                    m <= self.MAX_DEDUP_WALK)
        return (isinstance(d, tuple) and len(d) > 4 and
                d[0] in ("two_tier", "classed") and
                d[4] == self._pack_bits and
                self._tables[0][4] > d[1] and sweep_ok and
                wq * sk.sketchlen * self._tables[0][4] >=
                self.ESC_MIN_SLOTS)

    def _dispatch_scan_head(self, codes, lens, scan_k: int, bsz: int):
        """Escalation phase 1 (head-only probe) over prepacked rows;
        -> (cls (K,B), over_bits (K,B/32)) device arrays."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_scan_head
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        wmat = np.ascontiguousarray(codes).reshape(
            scan_k, bsz, 1, codes.shape[1])
        mwir_max = 2 + max(wl, opt.classify.insert_size_max) // stride
        vdt = np.uint8 if wl < 256 else np.int32
        mdt = np.uint8 if mwir_max < 256 else np.int32
        vmat = np.where(lens >= sk.kmerlen, lens, 0).astype(
            vdt).reshape(scan_k, bsz, 1)
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(mdt).reshape(scan_k, bsz)
        tf, to, lt, lw, spf = self._tables[0]
        ps, _steps = self._prefix[0]
        return query_step_rows_scan_head(
            jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank),
            ps,
            k=sk.kmerlen, sketchlen=sk.sketchlen,
            slots_per_feature=spf,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], dense=self._dense[0],
            pack_bits=self._pack_bits, infeed_packed=True,
            walk_elems=int(mwir.max()) * sk.sketchlen,
            fast_top2=True,
            return_feats=bool(self._prefetch_flag()),
            **self._prefetch_flag())

    def _carve_redo(self, need: int):
        """Take `need` flagged rows (feats, idx, lens) from the feats
        redo buffer, padding with sentinel features when short.
        -> (feats (need, F) dev, idx (need, F) dev, lens (need,) np,
            real_count)."""
        import jax.numpy as jnp
        fparts, iparts, lparts = [], [], []
        got = 0
        left = []
        for f_, i_, l_ in self._esc_redo:
            use = min(len(l_), need - got)
            if use:
                fparts.append(f_[:use])
                iparts.append(i_[:use])
                lparts.append(l_[:use])
                got += use
            if use < len(l_):
                left.append((f_[use:], i_[use:], l_[use:]))
        self._esc_redo = left
        self._esc_nredo -= got
        pad = need - got
        F = fparts[0].shape[1] if fparts else self.sketching.sketchlen
        if pad:
            fparts.append(jnp.full((pad, F), 0xFFFFFFFF, jnp.uint32))
            iparts.append(jnp.zeros((pad, F), jnp.int32))
            lparts.append(np.zeros(pad, np.int32))
        return (jnp.concatenate(fparts) if len(fparts) > 1
                else fparts[0],
                jnp.concatenate(iparts) if len(iparts) > 1
                else iparts[0],
                np.concatenate(lparts) if len(lparts) > 1
                else lparts[0], got)

    def _dispatch_scan_head_pair(self, c1, l1, c2, l2, scan_k: int,
                                 bsz: int):
        """Escalation phase 1 over short PAIRS (two windows per query);
        -> (cls (K,B), over_bits (K,B/32), feats (K,B,2F), idx) device
        arrays (always prefetch + return_feats: the paired redo reuses
        phase-1 sketches)."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_scan_head
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        n = len(l1)
        wmat = np.empty((n, 2, wl), np.uint8)
        wmat[:, 0] = c1[:, :wl]
        wmat[:, 1] = c2[:, :wl]
        wmat = wmat.reshape(scan_k, bsz, 2, wl)
        vmat = np.stack([np.where(l1 >= sk.kmerlen, l1, 0),
                         np.where(l2 >= sk.kmerlen, l2, 0)],
                        axis=1).astype(np.int32).reshape(scan_k, bsz, 2)
        mwir = (2 + np.maximum(l1.astype(np.int64) + l2,
                               opt.classify.insert_size_max)
                // stride).astype(np.int32).reshape(scan_k, bsz)
        tf, to, lt, lw, spf = self._tables[0]
        ps, _steps = self._prefix[0]
        return query_step_rows_scan_head(
            jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank),
            ps,
            k=sk.kmerlen, sketchlen=sk.sketchlen,
            slots_per_feature=spf,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], dense=self._dense[0],
            pack_bits=self._pack_bits,
            **self._sweep_params(mwir.reshape(-1), 2),
            fast_top2=True,
            prefetch=True, return_feats=True)

    def _dispatch_scan_head_fused(self, codes, lens, scan_k: int,
                                  bsz: int, rfeats, ridx, rlens,
                                  b2: int):
        """One dispatch running phase 1 on fresh reads AND phase 2 on
        a slice of earlier flagged reads (query_step_rows_scan_head_
        fused) so the scheduler can interleave the two streams."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_scan_head_fused
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        wmat = np.ascontiguousarray(codes).reshape(
            scan_k, bsz, 1, codes.shape[1])
        mwir_max = 2 + max(wl, opt.classify.insert_size_max) // stride
        vdt = np.uint8 if wl < 256 else np.int32
        mdt = np.uint8 if mwir_max < 256 else np.int32
        vmat = np.where(lens >= sk.kmerlen, lens, 0).astype(
            vdt).reshape(scan_k, bsz, 1)
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(mdt).reshape(scan_k, bsz)
        rmwir = (2 + np.maximum(rlens, opt.classify.insert_size_max)
                 // stride).astype(np.int32).reshape(scan_k, b2)
        F = sk.sketchlen
        tf, to, lt, lw, spf = self._tables[0]
        ps, _steps = self._prefix[0]
        return query_step_rows_scan_head_fused(
            jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
            rfeats.reshape(scan_k, b2, F), ridx.reshape(scan_k, b2, F),
            jnp.asarray(rmwir),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank),
            ps,
            k=sk.kmerlen, sketchlen=sk.sketchlen,
            slots_per_feature=spf,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], dense=self._dense[0],
            pack_bits=self._pack_bits, infeed_packed=True,
            walk_elems=int(max(mwir.max(), rmwir.max(initial=2)))
            * sk.sketchlen,
            fast_top2=True)

    def _dispatch_redo(self, feats, idx, lens, scan_k: int, bsz: int):
        """Escalation phase 2 over phase-1's device-resident sketches
        (query_step_rows_redo_scan): full-depth probe + candidates with
        no re-sketch and no bucket-row gather. `lens` is the combined
        query length (sum of mates for pairs); F infers wq."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_redo_scan
        sk = self.sketching
        opt = self.opt
        stride = self.db.sketching.winstride
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(np.int32)
        F = feats.shape[-1]
        wq = max(F // sk.sketchlen, 1)
        tf, to, lt, lw, spf = self._tables[0]
        return query_step_rows_redo_scan(
            feats.reshape(scan_k, bsz, F), idx.reshape(scan_k, bsz, F),
            jnp.asarray(mwir.reshape(scan_k, bsz)),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank),
            sketchlen=sk.sketchlen, slots_per_feature=spf,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], dense=self._dense[0],
            pack_bits=self._pack_bits,
            **self._sweep_params(mwir, wq),
            fast_top2=True)

    def _dispatch_scan(self, codes, lens, scan_k: int, bsz: int,
                       prepacked: bool = False):
        """One fused lax.scan dispatch over scan_k stacked short-read
        batches; returns the (scan_k, bsz) classified-taxon device array.

        ``prepacked``: codes already hold the 2-bit packed infeed rows
        (4 bases/byte) as emitted by the native packed reader."""
        import jax.numpy as jnp
        from ..ops.rows import query_step_rows_scan
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        if prepacked:
            # rows may be cropped to the batch's max read length
            # (quantized) — the unpacked window narrows with them, which
            # is fine: the sketcher masks by valid length and pads lanes
            wmat = np.ascontiguousarray(codes).reshape(
                scan_k, bsz, 1, codes.shape[1])
            mwir_max = 2 + max(wl, opt.classify.insert_size_max) // stride
            vdt = np.uint8 if wl < 256 else np.int32
            mdt = np.uint8 if mwir_max < 256 else np.int32
            vmat = np.where(lens >= sk.kmerlen, lens, 0).astype(
                vdt).reshape(scan_k, bsz, 1)
            mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                    // stride).astype(mdt).reshape(scan_k, bsz)
            tf, to, lt, lw, spf = self._tables[0]
            ps, steps = self._prefix[0]
            import jax.numpy as jnp
            return query_step_rows_scan(
                jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
                tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
                jnp.int32(self.hits_min),
                jnp.float32(opt.classify.hits_diff_fraction),
                jnp.int32(self.highest_rank), jnp.int32(self.merge_rank),
                ps,
                k=sk.kmerlen, sketchlen=sk.sketchlen,
                slots_per_feature=spf, windows_per_query=1,
                max_candidates=opt.classify.max_candidates,
                prefix_bits=self._prefix_bits[0], prefix_steps=steps,
                dense=self._dense[0],
                pack_bits=self._pack_bits,
                infeed_packed=True,
                **self._sweep_params(
                    mwir.reshape(-1).astype(np.int32), 1),
                **self._fast_flag(sk.sketchlen * spf),
                **self._prefetch_flag())
        elif self._infeed_packed:
            # 2-bit pack (4 bases/byte): quarters the h2d transfer.
            # Callers route reads containing ambiguous characters
            # through the unpacked per-batch path.
            wl4 = -(-wl // 4)
            c4 = np.zeros((len(lens), wl4 * 4), np.uint8)
            c4[:, :wl] = codes[:, :wl] & 3
            wmat = (c4[:, 0::4] | (c4[:, 1::4] << 2) |
                    (c4[:, 2::4] << 4) | (c4[:, 3::4] << 6)).reshape(
                        scan_k, bsz, 1, wl4)
        else:
            wmat = np.ascontiguousarray(codes[:, :wl]).reshape(
                scan_k, bsz, 1, wl)
        vmat = np.where(lens >= sk.kmerlen, lens, 0).astype(
            np.int32).reshape(scan_k, bsz, 1)
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(np.int32).reshape(scan_k, bsz)
        tf, to, lt, lw, spf = self._tables[0]
        ps, steps = self._prefix[0]
        return query_step_rows_scan(
            jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
            tf, to, lt, lw, self._merge_tax_dev, self._lineages_dev,
            jnp.int32(self.hits_min),
            jnp.float32(opt.classify.hits_diff_fraction),
            jnp.int32(self.highest_rank), jnp.int32(self.merge_rank), ps,
            k=sk.kmerlen, sketchlen=sk.sketchlen, slots_per_feature=spf,
            windows_per_query=1,
            max_candidates=opt.classify.max_candidates,
            prefix_bits=self._prefix_bits[0], prefix_steps=steps,
            dense=self._dense[0],
            pack_bits=self._pack_bits,
            infeed_packed=self._infeed_packed,
            **self._sweep_params(mwir, 1),
            **self._fast_flag(sk.sketchlen * spf),
            **self._prefetch_flag())

    def _accumulate_summary(self, cls: np.ndarray, results):
        """Vectorized per-rank statistics from classified taxon ids."""
        pos = np.searchsorted(self._taxid_sorted, cls)
        pos = np.minimum(pos, max(len(self._taxid_sorted) - 1, 0))
        found = (len(self._taxid_sorted) > 0) & \
            (self._taxid_sorted[pos] == cls) & (cls != 0)
        ranks = np.where(found, self._rank_of_taxid[pos],
                         np.uint8(int(Rank.NONE)))
        results.statistics.assigned_ += np.bincount(
            ranks, minlength=NUM_RANKS + 1).astype(np.int64)
        results.query_count += len(cls)

    def _query_windows(self, q: QueryRecord):
        """All windows of one query (seq1 then seq2)."""
        sk = self.sketching
        w1, v1 = win_ops.sequence_windows(
            win_ops.encode_ascii(q.seq1), sk)
        if q.seq2:
            w2, v2 = win_ops.sequence_windows(
                win_ops.encode_ascii(q.seq2), sk)
            if len(w1) and len(w2):
                return np.concatenate([w1, w2]), np.concatenate([v1, v2])
            if len(w2):
                return w2, v2
        return w1, v1

    def _mwir(self, q: QueryRecord) -> int:
        return max_windows_in_range(
            len(q.seq1) + len(q.seq2),
            self.opt.classify.insert_size_max, self.db.sketching.winstride)

    def _dispatch_batch_rows(self, batch):
        import jax.numpy as jnp
        opt = self.opt
        sk = self.sketching
        k = opt.classify.max_candidates

        # bucket queries by padded window count (pow2)
        buckets: Dict[int, list] = {}
        wins_of = []
        for i, q in enumerate(batch):
            w, v = self._query_windows(q)
            wins_of.append((w, v))
            wq = _bucket_wq(len(w))
            buckets.setdefault(wq, []).append(i)

        launched = []
        for wq, idxs in sorted(buckets.items()):
            rows = max(_round_up_pow2(len(idxs)), self._row_quantum)
            wmat = np.full((rows, wq, sk.winlen), win_ops.PAD_CODE,
                           np.uint8)
            vmat = np.zeros((rows, wq), np.int32)
            mwir = np.full(rows, 2, np.int32)
            for r, i in enumerate(idxs):
                w, v = wins_of[i]
                wmat[r, :len(w)] = w
                vmat[r, :len(v)] = v
                mwir[r] = self._mwir(batch[i])
            launched.append((idxs, rows,
                             self._launch_rows(wmat, vmat, mwir, wq, k)))
        return launched

    def _summary_only(self):
        """True when per-query host work can be skipped entirely."""
        o = self.opt.output
        return (o.format.map_view_mode == MapViewMode.NONE and
                not o.evaluate.precision and
                not o.evaluate.determine_ground_truth and
                not o.analysis.show_hits_per_target and
                not o.analysis.show_tax_abundances and
                o.analysis.abundance_per == Rank.NONE and
                self.opt.classify.cov_percentile <= 0)

    def _collect_batch_rows(self, batch, launched, results):
        opt = self.opt
        if self._summary_only():
            # vectorized statistics only — no per-query Python loop
            for (idxs, rows, res) in launched:
                self._accumulate_summary(
                    np.asarray(res.cls_tax)[:len(idxs)], results)
            return
        k = opt.classify.max_candidates
        n = len(batch)
        cand_tgt = np.full((n, k), -1, np.int32)
        cand_tax = np.zeros((n, k), np.int32)
        cand_hits = np.zeros((n, k), np.int32)
        cand_beg = np.zeros((n, k), np.int32)
        cand_end = np.zeros((n, k), np.int32)
        cls_tax = np.zeros(n, np.int32)
        allhits_of: Dict[int, tuple] = {}
        need_allhits = opt.output.analysis.show_all_hits

        oa = opt.output.analysis
        slim = not (oa.show_locations or oa.show_alignment or
                    oa.show_hits_per_target or need_allhits or
                    opt.classify.cov_percentile > 0)
        # the DEFAULT mapping mode (one line per read, no -tophits)
        # prints only the classification: fetch cls alone — 1 word/read
        # instead of 3k+1 (the d2h link bounds the per-read path)
        micro = slim and not oa.show_top_hits
        import jax as _jax
        for (idxs, rows, res) in launched:
            sel = np.asarray(idxs)
            if isinstance(res.cand_tgt, _jax.Array):
                kk = res.cand_tgt.shape[1]
                if micro:
                    cls_tax[sel] = np.asarray(res.cls_tax)[:len(idxs)]
                    continue
                if slim:
                    packed = np.asarray(_pack_result_slim_jit()(
                        res.cand_tgt, res.cand_tax, res.cand_hits,
                        res.cls_tax))[:len(idxs)]
                    cand_tgt[sel] = packed[:, 0 * kk:1 * kk]
                    cand_tax[sel] = packed[:, 1 * kk:2 * kk]
                    cand_hits[sel] = packed[:, 2 * kk:3 * kk]
                    cls_tax[sel] = packed[:, 3 * kk]
                    continue
                packed = np.asarray(_pack_result_jit()(
                    res.cand_tgt, res.cand_tax, res.cand_hits,
                    res.cand_beg, res.cand_end,
                    res.cls_tax))[:len(idxs)]
                cand_tgt[sel] = packed[:, 0 * kk:1 * kk]
                cand_tax[sel] = packed[:, 1 * kk:2 * kk]
                cand_hits[sel] = packed[:, 2 * kk:3 * kk]
                cand_beg[sel] = packed[:, 3 * kk:4 * kk]
                cand_end[sel] = packed[:, 4 * kk:5 * kk]
                cls_tax[sel] = packed[:, 5 * kk]
            else:
                cand_tgt[sel] = np.asarray(res.cand_tgt)[:len(idxs)]
                cand_tax[sel] = np.asarray(res.cand_tax)[:len(idxs)]
                cand_hits[sel] = np.asarray(res.cand_hits)[:len(idxs)]
                cand_beg[sel] = np.asarray(res.cand_beg)[:len(idxs)]
                cand_end[sel] = np.asarray(res.cand_end)[:len(idxs)]
                cls_tax[sel] = np.asarray(res.cls_tax)[:len(idxs)]
            if need_allhits:
                hq = np.asarray(res.hit_qid)
                ht = np.asarray(res.hit_tgt)
                hw = np.asarray(res.hit_win)
                order = np.argsort(hq, kind="stable")
                hq, ht, hw = hq[order], ht[order], hw[order]
                bounds = np.searchsorted(hq, np.arange(rows + 1))
                for r, i in enumerate(idxs):
                    lo, hi = bounds[r], bounds[r + 1]
                    allhits_of[i] = (ht[lo:hi], hw[lo:hi])

        self._postprocess_arrays(batch, cand_tgt, cand_tax, cand_hits,
                                 cand_beg, cand_end, cls_tax, allhits_of,
                                 results)

    # ------------------------------------------------------------------
    def _postprocess_arrays(self, batch, cand_tgt, cand_tax, cand_hits,
                            cand_beg, cand_end, cls_tax, allhits_of,
                            results):
        db = self.db
        opt = self.opt
        oopt = opt.output
        need_allhits = oopt.analysis.show_all_hits
        make_truth = oopt.evaluate.precision or \
            oopt.evaluate.determine_ground_truth
        if self._line_writer is None:
            self._line_writer = out_mod.MappingLineWriter(
                db.taxa, oopt, db.sketching)
        writer = self._line_writer
        write = results.per_read_out.write

        # hoisted loop invariants — this loop runs once per read
        taxa = db.taxa
        targets_get = taxa.taxonomy.targets.get
        taxa_get = taxa.taxonomy.taxa.get

        def find(tid):
            return targets_get(tid) if tid < 0 else taxa_get(tid)

        precision = oopt.evaluate.precision
        track_matches = (oopt.analysis.show_hits_per_target or
                         opt.classify.cov_percentile > 0)
        save_mappings = opt.classify.cov_percentile > 0
        show_align = oopt.analysis.show_alignment
        hits_min = self.hits_min
        tax_counts = results.tax_counts
        tgt_matches = results.tgt_matches
        stats = results.statistics
        # batch the per-rank assigned counters (precision path keeps the
        # full per-read bookkeeping)
        rank_counts = [0] * (NUM_RANKS + 1) if not precision else None

        import os as _os
        raw_hdrs = getattr(batch, "headers", None)
        fast_ok = (raw_hdrs is not None and not need_allhits
                   and not make_truth and not track_matches
                   and not save_mappings and not show_align
                   and rank_counts is not None
                   and not writer.show_gt and not writer.show_allhits
                   and not writer.show_locations
                   and _os.environ.get("MC_NATIVE_FMT", "1") != "0")
        if fast_ok:
            # native whole-batch formatter (see MappingLineWriter
            # .lines_batch): the per-read Python loop below assembles
            # strings per read; this path is one C call + vectorized
            # stats
            blob = b"" if writer.suppressed else writer.lines_batch(
                raw_hdrs, cand_tgt, cand_tax, cand_hits, cls_tax,
                results.query_count + 1, find)
            if blob is not None:
                if blob:
                    write(blob.decode("utf-8", "replace"))
                uc, ucnt = np.unique(cls_tax, return_counts=True)
                for ci, cn in zip(uc.tolist(), ucnt.tolist()):
                    best = find(ci) if ci != 0 else None
                    if best is not None:
                        tax_counts[best] = tax_counts.get(best, 0) + cn
                        rank_counts[best.rank] += cn
                    else:
                        rank_counts[Rank.NONE] += cn
                results.query_count += len(batch)
                stats.assigned_ += np.asarray(rank_counts, np.int64)
                return

        k = cand_tgt.shape[1]
        tgt_l = cand_tgt.tolist()
        tax_l = cand_tax.tolist()
        hits_l = cand_hits.tolist()
        beg_l = cand_beg.tolist()
        end_l = cand_end.tolist()
        cls_l = cls_tax.tolist()
        qid0 = results.query_count
        # native batches carry raw header rows: decode in place instead
        # of constructing a _CodedQuery per read
        raw_hdrs = getattr(batch, "headers", None)
        line = writer.line
        lines: list = []
        for i in range(len(batch)):
            qid_out = qid0 + i + 1
            header = _decode_header(raw_hdrs[i]) if raw_hdrs is not None \
                else batch[i].header
            ti = tgt_l[i]
            cands = []
            for j in range(k):
                tj = ti[j]
                if tj < 0:
                    break
                cands.append((find(tax_l[i][j]), tj, hits_l[i][j],
                              beg_l[i][j], end_l[i][j]))
            ci = cls_l[i]
            best = find(ci) if ci != 0 else None
            truth = cls_mod.ground_truth(taxa, header) \
                if make_truth else None

            if track_matches:
                for (tax, tgt, hits, beg, end) in cands:
                    if tax is not None and hits >= hits_min:
                        tgt_matches.setdefault(tgt, []).append(
                            (qid_out, beg, end, hits))
            if save_mappings:
                results.saved_mappings.append((qid_out, header, cands))
                continue

            if best is not None:
                tax_counts[best] = tax_counts.get(best, 0) + 1
                if rank_counts is not None:
                    rank_counts[best.rank] += 1
            elif rank_counts is not None:
                rank_counts[Rank.NONE] += 1
            if rank_counts is None:
                cls_mod.evaluate_classification(
                    best, truth, taxa, precision,
                    oopt.evaluate.taxon_coverage, stats)

            allhits = []
            if need_allhits and i in allhits_of:
                ht, hw = allhits_of[i]
                allhits = list(zip(ht.tolist(), hw.tolist()))
            align_text = ""
            if show_align and best is not None and cands:
                align_text = self._make_alignment_text(batch[i], cands[0])
            lines.append(line(qid_out, header, best, truth, cands,
                              allhits, align_text))
        if lines:
            write("".join(lines))
        results.query_count += len(batch)
        if rank_counts is not None:
            stats.assigned_ += np.asarray(rank_counts, np.int64)

    # ------------------------------------------------------------------
    def _make_alignment_text(self, q, cand) -> str:
        """Align the query to the top candidate's window range
        (reference: show_alignment, src/classification.cpp:384-427)."""
        from .alignment import make_semi_global_alignment
        from ..seqio.reader import read_sequences
        (tax, _tgt, _hits, beg, end) = cand
        if tax is None or tax.rank != Rank.SEQUENCE or tax.source is None:
            return ""
        sk = self.db.sketching
        try:
            it = read_sequences(tax.source.filename)
            rec = None
            for r in it:
                if r.index == tax.source.index:
                    rec = r
                    break
            if rec is None:
                return ""
            w = sk.winstride
            subject = rec.seq[w * beg: w * end + sk.winlen]
            (score, aq, asub), best_score = make_semi_global_alignment(
                q.seq1, q.seq2, subject)
            c = self.opt.output.format.tokens.comment
            return (f"\n{c}  score  {best_score}"
                    f"  aligned to {tax.source.filename} #{tax.source.index}"
                    f" in range [{w * beg},{w * end + w}]\n"
                    f"{c}  query  {aq.decode()}\n"
                    f"{c}  target {asub.decode()}")
        except OSError as e:
            # the subject sequence is re-read from its source file at
            # query time (reference: src/classification.cpp:384-426);
            # a missing/unreadable file skips the alignment display but
            # must not fail silently
            from ..utils import info as info_mod
            info_mod.error(f"WARNING: could not align against "
                           f"{tax.source.filename}: {e}")
            return ""

    # ------------------------------------------------------------------
    def redo_saved_classification(self, results: "ClassificationResults"):
        """Coverage-percentile second pass (reference:
        filter_targets_by_coverage + redo_classification_batched,
        src/classification.cpp:591-721)."""
        db = self.db
        opt = self.opt
        oopt = opt.output
        filter_targets_by_coverage(db.taxa, results.tgt_matches,
                                   opt.classify.cov_percentile)
        for (qid_out, header, cands) in results.saved_mappings:
            cands = [c for c in cands if c[1] in results.tgt_matches]
            host_cands = [cls_mod.HostCandidate(tax, tgt, hits, beg, end)
                          for (tax, tgt, hits, beg, end) in cands]
            best = cls_mod.classify(
                db.taxa, opt.classify, self.hits_min, host_cands,
                Rank(self.merge_rank), Rank(self.highest_rank))
            truth = (cls_mod.ground_truth(db.taxa, header)
                     if (oopt.evaluate.precision or
                         oopt.evaluate.determine_ground_truth) else None)
            if best is not None:
                results.tax_counts[best] = \
                    results.tax_counts.get(best, 0) + 1
            cls_mod.evaluate_classification(
                best, truth, db.taxa, oopt.evaluate.precision,
                oopt.evaluate.taxon_coverage, results.statistics)
            results.per_read_out.write(out_mod.show_query_mapping(
                db.taxa, oopt, db.sketching, qid_out, header, best, truth,
                cands, []))
        results.saved_mappings = []


def filter_targets_by_coverage(taxonomy, tgt_matches: Dict[int, list],
                               percentile: float):
    """Reference: filter_targets_by_coverage
    (src/classification.cpp:591-634)."""
    cov = []
    total = 0.0
    for tgt, cands in tgt_matches.items():
        tax = taxonomy.cached_taxon_of_target(tgt)
        nwin = tax.source.windows if tax and tax.source else 1
        hit_windows = set()
        for (_qid, beg, end, _hits) in cands:
            hit_windows.update(range(beg, end + 1))
        p = len(hit_windows) / nwin
        total += p
        cov.append((tgt, p))
    cov.sort(key=lambda tp: tp[1])
    part = 0.0
    for tgt, p in cov:
        part += p
        if part > percentile * total:
            break
        del tgt_matches[tgt]


def _bucket_wq(x: int) -> int:
    """Window-count bucket: exact up to 8, multiples of 4 to 32, then
    pow2 — tighter than pow2 because slot lanes (and probe count) scale
    linearly with the padded window count (a 5-window 480bp read in an
    8-window bucket pays 60% extra probes and sort lanes)."""
    x = max(x, 1)
    if x <= 8:
        return x
    if x <= 32:
        return (x + 3) // 4 * 4
    return _round_up_pow2(x)


def _round_up_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


class ClassificationResults:
    def __init__(self, per_read_out=None, per_target_out=None,
                 per_taxon_out=None, status=None):
        self.per_read_out = per_read_out or sys.stdout
        self.per_target_out = per_target_out or self.per_read_out
        self.per_taxon_out = per_taxon_out or self.per_read_out
        self.status = status or sys.stderr
        self.statistics = ClassificationStatistics()
        self.tax_counts: Dict[Taxon, float] = {}
        self.tgt_matches: Dict[int, list] = {}
        self.saved_mappings: list = []
        self.query_count = 0
        self.time_ms = 0.0


def map_queries_to_targets(infiles: List[str], db: Database,
                           opt: QueryOptions,
                           results: ClassificationResults):
    """Reference: map_queries_to_targets (src/classification.cpp:870-881)."""
    runner = QueryRunner(db, opt)
    oopt = opt.output
    if oopt.format.map_view_mode != MapViewMode.NONE:
        results.per_read_out.write(
            out_mod.show_query_mapping_header(oopt))

    t0 = time.monotonic()
    # announce + stream each input file (pair) in order
    # (reference: query_database, src/database_query.hpp:345-360)
    comment = oopt.format.tokens.comment
    stride = 2 if opt.pairing == PairingMode.FILES else 1
    import itertools
    for i in range(0, len(infiles), stride):
        group = infiles[i:i + stride]
        if opt.pairing == PairingMode.FILES and len(group) == 2:
            results.per_read_out.write(
                f"{comment}{group[0]} + {group[1]}\n")
        else:
            results.per_read_out.write(f"{comment}{group[0]}\n")
        if opt.pairing == PairingMode.NONE and \
                runner.run_file_native(group[0], results):
            continue
        if opt.pairing == PairingMode.FILES and len(group) == 2 and \
                runner.run_pair_files_native(group[0], group[1], results):
            continue
        if opt.pairing == PairingMode.SEQUENCES and \
                runner.run_pair_seq_native(group[0], results):
            continue
        queries = read_queries(group, opt.pairing)
        if opt.query_limit >= 0:
            # the limit applies per sequence source
            # (reference: performance_tuning_options.queryLimit,
            # src/options.hpp:234-235)
            queries = itertools.islice(queries, opt.query_limit)
        runner.run_queries(queries, results)

    if opt.classify.cov_percentile > 0:
        runner.redo_saved_classification(results)
    results.time_ms = (time.monotonic() - t0) * 1000.0

    if oopt.analysis.show_hits_per_target:
        ordered = {t: sorted(v, key=lambda c: (c[1], c[2], c[0]))
                   for t, v in results.tgt_matches.items()}
        results.per_target_out.write(out_mod.show_matches_per_targets(
            db.taxa, db.sketching, ordered, oopt.format))

    if oopt.analysis.show_tax_abundances:
        results.per_taxon_out.write(out_mod.show_abundances(
            abd.sort_tax_counts(results.tax_counts), results.statistics,
            oopt.format))

    if oopt.analysis.abundance_per != Rank.NONE:
        est = abd.estimate_abundance(db.taxa, results.tax_counts,
                                     oopt.analysis.abundance_per)
        results.per_taxon_out.write(out_mod.show_abundance_estimates(
            oopt.analysis.abundance_per, abd.sort_tax_counts(est),
            results.statistics, oopt.format))
    return results
