"""Reference-binary database WRITER: round-trip + reverse parity oracle.

save_reference_db writes .meta/.cacheN files in the muellan/metacache
binary format (field order: database::write_meta, src/database.cpp:
247-291; hash_multimap::serialize, src/hash_multimap.hpp:1037-1082).
The strongest check runs the actual reference binary against a database
BUILT AND WRITTEN HERE and demands byte-identical classification output
vs the committed golden the reference produced from its own database
(tests/data/golden/refdb_import.txt).

The binary oracle needs the reference CPU binary: set METACACHE_BIN, or
build it out-of-tree (`cp -r /root/reference /tmp/refbuild && make -C
/tmp/refbuild -j`) — /tmp/refbuild/metacache is picked up automatically.
Without a binary those tests skip; the pure-Python round-trips always
run.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")
REPO = os.path.dirname(HERE)

QUERY_FLAGS = ["-mapped-only", "-precision", "-ground-truth",
               "-tophits"]


def _ref_bin():
    cand = os.environ.get("METACACHE_BIN", "/tmp/refbuild/metacache")
    return cand if os.path.exists(cand) else None


def _strip(text: str):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    return [l for l in text.splitlines()
            if not any(d in l for d in drop)]


def _golden(name: str):
    with open(os.path.join(GOLD, name)) as f:
        return _strip(f.read())


def test_writer_roundtrip_through_our_reader(tmp_path):
    """load(reference fixture) -> save_reference_db -> load: identical
    CSR tables, taxonomy, and sketching metadata."""
    from metacache_tpu.db.database import Database
    from metacache_tpu.db.mcformat import (load_reference_db,
                                           save_reference_db)
    db = Database.load(f"{DATA}/refdb/refdb")
    out = str(tmp_path / "rt")
    save_reference_db(db, out)
    db2 = load_reference_db(out)
    assert db2.target_count == db.target_count
    assert db2.sketching == db.sketching
    assert db2.max_locations_per_feature == db.max_locations_per_feature
    p, q = db.parts[0], db2.parts[0]
    np.testing.assert_array_equal(p.unique_features, q.unique_features)
    np.testing.assert_array_equal(p.offsets, q.offsets)
    np.testing.assert_array_equal(p.locations, q.locations)
    for t, u in zip(db.taxa.target_taxa, db2.taxa.target_taxa):
        assert (t.id, t.parent_id, t.name) == (u.id, u.parent_id, u.name)
        assert (t.source.filename, t.source.index, t.source.windows) \
            == (u.source.filename, u.source.index, u.source.windows)


def test_build_ref_format_flag(tmp_path):
    """`build -ref-format` writes a binary .meta our loader detects."""
    from metacache_tpu.db.mcformat import is_reference_db
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    db = str(tmp_path / "ourdb")
    r = subprocess.run(
        [sys.executable, "-m", "metacache_tpu", "build", db,
         f"{DATA}/genomes.fa", "-taxonomy", f"{DATA}/taxonomy",
         "-parts", "1", "-ref-format"],
        capture_output=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert is_reference_db(db)
    # loads back through the transparent reference-format path
    from metacache_tpu.db.database import Database
    db2 = Database.load(db)
    assert db2.target_count == 6
    assert db2.parts[0].num_features > 0


@pytest.mark.skipif(_ref_bin() is None,
                    reason="reference binary not available "
                           "(set METACACHE_BIN)")
def test_reference_binary_queries_written_db(tmp_path):
    """REVERSE parity oracle: the reference binary loads a database
    round-tripped through our writer and classifies byte-identically
    to the golden it produced from its own database."""
    from metacache_tpu.db.database import Database
    from metacache_tpu.db.mcformat import save_reference_db
    db = Database.load(f"{DATA}/refdb/refdb")
    out = str(tmp_path / "rt")
    save_reference_db(db, out)
    r = subprocess.run(
        [_ref_bin(), "query", out, f"{DATA}/reads_single.fa"]
        + QUERY_FLAGS, capture_output=True, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _strip(r.stdout.decode()) == _golden("refdb_import.txt")


@pytest.mark.skipif(_ref_bin() is None,
                    reason="reference binary not available "
                           "(set METACACHE_BIN)")
def test_reference_binary_queries_our_build(tmp_path):
    """STRONGEST oracle: a database built BY THIS FRAMEWORK (sketch,
    table, taxonomy — the full build path) and written in reference
    format classifies byte-identically under the reference binary."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    db = str(tmp_path / "ourdb")
    r = subprocess.run(
        [sys.executable, "-m", "metacache_tpu", "build", db,
         f"{DATA}/genomes.fa", "-taxonomy", f"{DATA}/taxonomy",
         "-parts", "1", "-ref-format"],
        capture_output=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    r = subprocess.run(
        [_ref_bin(), "query", db, f"{DATA}/reads_single.fa"]
        + QUERY_FLAGS, capture_output=True, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _strip(r.stdout.decode()) == _golden("refdb_import.txt")


def test_writer_multipart_roundtrip(tmp_path):
    """A multi-part database writes one .cacheN per part and loads
    back with identical content per part."""
    from metacache_tpu.db.build import BuildOptions, build_database
    from metacache_tpu.db.mcformat import (load_reference_db,
                                           save_reference_db)
    db = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"],
        taxonomy_dir=f"{DATA}/taxonomy", parts=2))
    assert len(db.parts) == 2
    out = str(tmp_path / "mp")
    save_reference_db(db, out)
    assert os.path.exists(out + ".cache0")
    assert os.path.exists(out + ".cache1")
    db2 = load_reference_db(out)
    assert len(db2.parts) == 2
    for p, q in zip(db.parts, db2.parts):
        np.testing.assert_array_equal(p.unique_features,
                                      q.unique_features)
        np.testing.assert_array_equal(p.offsets, q.offsets)
        np.testing.assert_array_equal(p.locations, q.locations)
