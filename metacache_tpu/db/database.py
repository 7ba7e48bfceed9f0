"""The database: feature store + taxonomy + sketching metadata.

Re-design of the reference `database` class (src/database.hpp:119-532,
src/database.cpp:36-375) around the CSR feature table:

- add_target sketches all windows of a reference sequence (on device, in
  batches) and accumulates (feature, location) pairs;
- finalize() sort-builds the CSR table (the XLA-natural equivalent of the
  hash-multimap insert path) honoring max_locations_per_feature;
- on-disk format: `<db>.meta` (JSON header mirroring the reference's .meta
  version/type-width/sketching gates), `<db>.tax.npz` (taxonomy + target
  metadata), `<db>.cache<p>.npz` (table arrays per part);
- partitioned databases keep one FeatureTable per part (reference: "parts",
  database.hpp:274-314); queries probe every part and merge matches.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..config import (DB_FORMAT_VERSION, FEATURE_SENTINEL,
                      MAX_SUPPORTED_LOCATIONS_PER_FEATURE, SketchingOptions)
from ..ops import windows as win_ops
from ..ops.table import FeatureTable, pack_locations
from ..taxonomy.model import (FileSource, Rank, Taxon, TaxonomyCache,
                              Taxonomy, NUM_RANKS)

MAX_TARGETS = 2**32 - 2
MAX_WINDOWS_PER_TARGET = 2**32 - 1


class TargetLimitExceeded(RuntimeError):
    pass


class Database:
    def __init__(self, sketching: SketchingOptions | None = None):
        self.sketching = (sketching or SketchingOptions()).resolved()
        self.taxa = TaxonomyCache()
        self.parts: list[FeatureTable] = []
        self.max_locations_per_feature = MAX_SUPPORTED_LOCATIONS_PER_FEATURE
        # build-time accumulators, one per part
        self._device_build = False
        self.device_parts: list = []     # ops.table_device.DeviceTable
        self._pending = [self._new_accumulator()]
        self._use_device_sketcher = True

    def _new_accumulator(self):
        s = self.sketching
        if self._device_build:
            from .sketch_exec import DeviceSketchAccumulator
            return DeviceSketchAccumulator(s.kmerlen, s.sketchlen)
        from .sketch_exec import SketchAccumulator
        return SketchAccumulator(s.kmerlen, s.sketchlen)

    def enable_device_build(self):
        """Keep the whole build on device: sketches feed
        ops.table_device.build_device_table directly (no host CSR, no
        padded-row staging). For query-only databases (build+query):
        save/modify/merge/culls need the host tables and are rejected.
        """
        assert not self.parts and len(self._pending) == 1
        self._device_build = True
        self._pending = [self._new_accumulator()]

    # -- properties ------------------------------------------------------
    @property
    def target_count(self) -> int:
        return self.taxa.target_count

    @property
    def part_count(self) -> int:
        return max(len(self.parts), len(self._pending))

    @property
    def feature_count(self) -> int:
        return (sum(p.num_features for p in self.parts) +
                sum(p.nf for p in self.device_parts))

    @property
    def location_count(self) -> int:
        return (sum(p.num_locations for p in self.parts) +
                sum(p.num_locations for p in self.device_parts))

    def initialize_parts(self, n: int):
        self._pending = [self._new_accumulator() for _ in range(max(1, n))]

    # -- building --------------------------------------------------------
    def add_target(self, seq: bytes, seqid: str, parent_taxid: int,
                   source: FileSource, part: int = 0) -> Optional[Taxon]:
        """Sketch + insert one reference sequence
        (reference: database::add_target, src/database.cpp:36-82)."""
        if self.target_count >= MAX_TARGETS:
            raise TargetLimitExceeded()
        if len(seq) == 0:
            return None
        tid = self.target_count
        codes = win_ops.encode_ascii(seq)
        wm, vl = win_ops.sequence_windows(codes, self.sketching)
        if self._use_device_sketcher:
            self._pending[part].add_target(wm, vl, tid)
        else:
            feats, wins = self._sketch_host(wm, vl)
            acc = self._pending[part]
            acc.features.append(feats)
            acc.locations.append(pack_locations(
                np.full(len(feats), tid, np.uint32), wins))
        nwin = win_ops.num_windows(len(seq), self.sketching)
        source.windows = nwin
        if parent_taxid < 0:
            parent_taxid = 0
        return self.taxa.emplace_target_taxon(tid, parent_taxid, seqid,
                                              source)

    def _sketch_host(self, wm: np.ndarray, vl: np.ndarray):
        """Host (oracle) sketcher fallback for one window matrix."""
        s = self.sketching
        from ..core import sketch as osk
        fdt = np.uint32 if s.kmerlen <= 16 else np.uint64
        sent = fdt(np.iinfo(fdt).max)
        feats = np.full((len(wm), s.sketchlen), sent, fdt)
        for i in range(len(wm)):
            sk = osk.sketch_codes(wm[i][:vl[i]], s)
            feats[i, :len(sk)] = sk
        wid = np.broadcast_to(
            np.arange(len(wm), dtype=np.uint32)[:, None], feats.shape)
        mask = feats != sent
        return feats[mask], wid[mask]

    def finalize(self):
        """Build CSR tables from accumulated pairs.

        Existing parts (a loaded database being modified) are kept; newly
        built tables are appended, to be merged down by merge_parts()
        (reference: modify mode = incremental build resume,
        src/mode_build.cpp:74-87).
        """
        if self._device_build:
            from ..ops.table_device import build_device_table_chunked
            for acc in self._pending:
                chunks = acc.finish_chunks()
                if chunks:
                    self.device_parts.append(build_device_table_chunked(
                        chunks, cap=self.max_locations_per_feature))
                del chunks
            self._pending = [self._new_accumulator()
                             for _ in self._pending]
            return
        new_parts = []
        for acc in self._pending:
            feats, locs = acc.finish()
            if len(feats):
                new_parts.append(FeatureTable.build(
                    feats, locs, self.max_locations_per_feature,
                    presorted_within_feature=True))
        if self.parts and new_parts:
            self.parts = self.parts + new_parts
        elif new_parts:
            self.parts = new_parts
        elif not self.parts:
            self.parts = [FeatureTable.build(
                np.zeros(0, np.uint32), np.zeros(0, np.uint64),
                self.max_locations_per_feature)]
        self._pending = [self._new_accumulator() for _ in self._pending]

    def merge_parts(self, max_parts: int, max_part_bytes: int = 0):
        """Merge down to at most `max_parts` tables, never letting a
        merged part exceed `max_part_bytes` (reference:
        merge_reduce_max_parts_max_bytes, src/host_hashmap.hpp:260-372 and
        -max-part-size, src/options.cpp:588-596)."""
        def nbytes(p):
            return p.num_features * 12 + p.num_locations * 8
        while len(self.parts) > max(1, max_parts):
            a = self.parts.pop()
            b = self.parts.pop()
            if max_part_bytes and nbytes(a) + nbytes(b) > max_part_bytes:
                # keep both; no pair fits under the cap once the two
                # smallest (last) exceed it
                self.parts.extend([b, a])
                break
            self.parts.append(b.merge(a))

    def set_max_locations_per_feature(self, n: int):
        """Shrink existing buckets when lowering the cap
        (reference: host_hashmap::max_locations_per_feature,
        src/host_hashmap.hpp:454-466)."""
        n = max(1, min(n, MAX_SUPPORTED_LOCATIONS_PER_FEATURE))
        if n < self.max_locations_per_feature:
            for p in self.parts:
                p.shrink_all(n)
        self.max_locations_per_feature = n
        for p in self.parts:
            p.max_locations_per_feature = n

    # -- feature culls (reference: host_hashmap.hpp:480-541) -------------
    def remove_features_with_more_locations_than(self, n: int) -> int:
        return sum(p.remove_features_with_more_locations_than(n)
                   for p in self.parts)

    def remove_ambiguous_features(self, rank: Rank, max_taxa: int) -> int:
        lin = self.taxa.target_lineages_array()
        # taxon of each target at `rank` (or first above)
        tax_at = np.zeros(self.target_count, dtype=np.int64)
        for r in range(int(rank), NUM_RANKS):
            fill = (tax_at == 0) & (lin[:self.target_count, r] != 0)
            tax_at[fill] = lin[:self.target_count, r][fill]
        return sum(p.remove_ambiguous_features(max_taxa, tax_at)
                   for p in self.parts)

    # -- persistence -----------------------------------------------------
    def save(self, path: str):
        from ..utils import info as info_mod
        if self.device_parts:
            # stream device tables back as CSR parts (12 B/location
            # fetched once) so device-resident builds persist in
            # device-build time + serialization, not host-sketch time
            from ..ops.table_device import export_csr
            info_mod.status("Exporting device tables ...")
            for dtab in self.device_parts:
                uniq, offs, locs = export_csr(dtab)
                self.parts.append(FeatureTable(
                    uniq, offs, locs, self.max_locations_per_feature))
            self.device_parts = []
        info_mod.status(f"Writing database to {path} ...")
        from ..config import feature_bits
        meta = {
            "format": "metacache_tpu",
            "db_version": DB_FORMAT_VERSION,
            "kmer_bits": feature_bits(self.sketching.kmerlen),
            "target_id_bits": 32,
            "window_id_bits": 32,
            "bucket_size_bits": 8,
            "sketching": {
                "kmerlen": self.sketching.kmerlen,
                "sketchlen": self.sketching.sketchlen,
                "winlen": self.sketching.winlen,
                "winstride": self.sketching.winstride,
            },
            "max_locations_per_feature": self.max_locations_per_feature,
            "target_count": self.target_count,
            "part_count": len(self.parts),
        }
        with open(path + ".meta", "w") as f:
            json.dump(meta, f, indent=1)
        self._save_taxonomy(path + ".tax.npz")
        for i, p in enumerate(self.parts):
            np.savez(path + f".cache{i}.npz",
                     features=p.unique_features, offsets=p.offsets,
                     locations=p.locations)

    def _save_taxonomy(self, path: str):
        tx = self.taxa.taxonomy
        taxa = sorted(tx.taxa.values(), key=lambda t: t.id)
        np.savez(
            path,
            tax_ids=np.array([t.id for t in taxa], np.int64),
            tax_parents=np.array([t.parent_id for t in taxa], np.int64),
            tax_ranks=np.array([int(t.rank) for t in taxa], np.uint8),
            tax_names=np.array(
                json.dumps([t.name for t in taxa]).encode()),
            tgt_parents=np.array(
                [t.parent_id if t else 0 for t in self.taxa.target_taxa],
                np.int64),
            tgt_names=np.array(json.dumps(
                [t.name if t else "" for t in self.taxa.target_taxa]
            ).encode()),
            tgt_sources=np.array(json.dumps(
                [[t.source.filename, t.source.index, t.source.windows]
                 if t and t.source else ["", 0, 0]
                 for t in self.taxa.target_taxa]).encode()),
        )

    @staticmethod
    def load(path: str, metadata_only: bool = False,
             part: int | None = None) -> "Database":
        from .mcformat import is_reference_db, load_reference_db
        if is_reference_db(path):
            # database written by the reference MetaCache binary
            # (binary .meta + .cacheN) — loads transparently
            return load_reference_db(path, metadata_only, part)
        if not metadata_only:
            from ..utils import info as info_mod
            info_mod.status(f"Reading database from {path} ...")
        with open(path + ".meta") as f:
            meta = json.load(f)
        if meta.get("db_version") != DB_FORMAT_VERSION:
            raise IOError(
                f"incompatible database version {meta.get('db_version')}")
        sk = meta["sketching"]
        from ..utils.platform import ensure_feature_width
        ensure_feature_width(sk.get("kmerlen", 16))
        db = Database(SketchingOptions(**sk))
        db.max_locations_per_feature = meta["max_locations_per_feature"]
        db._load_taxonomy(path + ".tax.npz")
        if not metadata_only:
            nparts = meta["part_count"]
            idxs = list(range(nparts)) if part is None else [part]

            def _load_part(i):
                z = np.load(path + f".cache{i}.npz")
                return FeatureTable(
                    z["features"], z["offsets"], z["locations"],
                    db.max_locations_per_feature)
            if len(idxs) > 1:
                # concurrent part loading (reference: one reader thread
                # per .cache part, src/database.cpp:204-237); np.load IO
                # releases the GIL
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(min(len(idxs), 8)) as ex:
                    db.parts.extend(ex.map(_load_part, idxs))
            else:
                db.parts.extend(_load_part(i) for i in idxs)
        return db

    def _load_taxonomy(self, path: str):
        z = np.load(path)
        tx = Taxonomy()
        names = json.loads(bytes(z["tax_names"]).decode())
        for i, n in zip(
                range(len(z["tax_ids"])), names):
            tx.emplace(int(z["tax_ids"][i]), int(z["tax_parents"][i]), n,
                       Rank(int(z["tax_ranks"][i])))
        self.taxa = TaxonomyCache(tx)
        tnames = json.loads(bytes(z["tgt_names"]).decode())
        tsources = json.loads(bytes(z["tgt_sources"]).decode())
        for tid, (name, parent, src) in enumerate(
                zip(tnames, z["tgt_parents"], tsources)):
            t = self.taxa.taxonomy.emplace(
                -tid - 1, int(parent), name, Rank.SEQUENCE,
                FileSource(src[0], int(src[1]), int(src[2])))
            self.taxa.name2tax[name] = t
            self.taxa.target_taxa.append(t)
        self.taxa._outdated = True

    # -- taxonomy application (reference: building.cpp:470-518) ----------
    def apply_taxonomy(self, taxonomy: Taxonomy):
        cache = TaxonomyCache(taxonomy)
        # re-attach existing targets
        for t in self.taxa.target_taxa:
            if t is not None:
                taxonomy.emplace(t.id, t.parent_id, t.name, t.rank, t.source)
                cache.name2tax[t.name] = t
        cache.target_taxa = self.taxa.target_taxa
        self.taxa = cache
        self.taxa._outdated = True
