"""Database build modes: multi-part, modify (incremental), save/load,
and the native I/O layer."""
import io
import os

import numpy as np
import pytest

from metacache_tpu.classify.runner import (ClassificationResults,
                                           QueryOptions,
                                           map_queries_to_targets)
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.db.database import Database
from metacache_tpu.seqio.reader import read_sequences

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")


def _query_output(db) -> str:
    out = io.StringIO()
    map_queries_to_targets([f"{DATA}/reads_single.fa"], db, QueryOptions(),
                           ClassificationResults(out))
    return out.getvalue()


@pytest.fixture(scope="module")
def full_db():
    return build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"],
        taxonomy_dir=f"{DATA}/taxonomy"))


def test_multipart_build_query_equivalence(full_db):
    db2 = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"],
        taxonomy_dir=f"{DATA}/taxonomy", parts=2))
    assert len(db2.parts) == 2
    assert _query_output(db2) == _query_output(full_db)


def test_save_load_roundtrip(full_db, tmp_path):
    path = str(tmp_path / "db")
    full_db.save(path)
    loaded = Database.load(path)
    assert loaded.target_count == full_db.target_count
    np.testing.assert_array_equal(loaded.parts[0].unique_features,
                                  full_db.parts[0].unique_features)
    np.testing.assert_array_equal(loaded.parts[0].locations,
                                  full_db.parts[0].locations)
    assert _query_output(loaded) == _query_output(full_db)


def test_modify_equivalence(full_db, tmp_path):
    recs = list(read_sequences(f"{DATA}/genomes.fa"))

    def write(path, rs):
        with open(path, "w") as f:
            for r in rs:
                f.write(f">{r.header}\n{r.seq.decode()}\n")

    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    write(a, recs[:3])
    write(b, recs[3:])
    half = build_database(BuildOptions(
        infiles=[a], taxonomy_dir=f"{DATA}/taxonomy"))
    half.save(str(tmp_path / "half"))
    loaded = Database.load(str(tmp_path / "half"))
    mod = build_database(BuildOptions(
        infiles=[b], taxonomy_dir=f"{DATA}/taxonomy",
        sketching=loaded.sketching), loaded)
    assert np.array_equal(mod.parts[0].unique_features,
                          full_db.parts[0].unique_features)
    assert np.array_equal(mod.parts[0].locations,
                          full_db.parts[0].locations)
    assert _query_output(mod) == _query_output(full_db)


def test_native_reader_parity():
    native = pytest.importorskip("metacache_tpu.native")
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    from metacache_tpu.core.encoding import encode_ascii
    py = list(read_sequences(f"{DATA}/reads_single.fa"))
    r = native.NativeFastxReader(f"{DATA}/reads_single.fa", max_len=256)
    codes, lens, hdrs = r.read_batch(1000)
    assert len(hdrs) == len(py)
    for i, rec in enumerate(py):
        assert hdrs[i] == rec.header
        np.testing.assert_array_equal(codes[i, :lens[i]],
                                      encode_ascii(rec.seq))
    # fastq with same content
    r2 = native.NativeFastxReader(f"{DATA}/reads_single.fq", max_len=256)
    c2, l2, h2 = r2.read_batch(1000)
    assert h2 == hdrs
    np.testing.assert_array_equal(c2, codes)


def test_native_window_extraction_matches_python():
    native = pytest.importorskip("metacache_tpu.native")
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    from metacache_tpu.config import SketchingOptions
    from metacache_tpu.ops import windows as W
    rng = np.random.default_rng(5)
    opt = SketchingOptions().resolved()
    lens = rng.integers(10, 900, 50).astype(np.int32)
    codes = rng.integers(0, 5, (50, 900)).astype(np.uint8)
    w, v, q, n = native.extract_windows_batch(
        codes, lens, opt.winlen, opt.winstride, opt.kmerlen, 4096)
    # python reference
    seqs = [codes[i, :lens[i]] for i in range(50)]
    pw, pv, pq = W.batch_windows(seqs, opt)
    assert n == len(pw)
    np.testing.assert_array_equal(w[:n], pw)
    np.testing.assert_array_equal(v[:n], pv)
    np.testing.assert_array_equal(q[:n], pq)


def test_help_mode():
    for mode in ("query", "build", "merge", "info"):
        r = _run(["help", mode])
        assert r.returncode == 0
        assert mode in r.stdout.decode()
    r = _run(["help"])
    assert r.returncode == 0 and "USAGE" in r.stdout.decode()


def _run(args):
    import subprocess
    import sys as _sys
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([_sys.executable, "-m", "metacache_tpu"] + args,
                          capture_output=True, env=env,
                          cwd=os.path.dirname(HERE), timeout=120)


def test_scan_fusion_summary_identical(tmp_path):
    """Summary-only native runs fuse MC_SCAN_K batches into one lax.scan
    dispatch; statistics must match the unfused path exactly."""
    import subprocess
    import sys as _sys
    db = str(tmp_path / "db")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0, r.stderr.decode()[-800:]
    many = tmp_path / "many.fa"
    many.write_bytes(open(f"{DATA}/reads_single.fa", "rb").read() * 21)

    def run_k(k):
        env = dict(os.environ, JAX_PLATFORMS="cpu", MC_SCAN_K=str(k))
        env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
            env.get("PYTHONPATH", "")
        r = subprocess.run(
            [_sys.executable, "-m", "metacache_tpu", "query", db,
             str(many), "-no-map", "-batch-size", "1024"],
            capture_output=True, env=env, cwd=os.path.dirname(HERE),
            timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-800:]
        return [l for l in r.stdout.decode().splitlines()
                if "time" not in l and "speed" not in l]

    assert run_k(0) == run_k(2)


def test_max_part_size_keeps_parts_apart(tmp_path):
    """-max-part-size caps merged part bytes (reference:
    merge_reduce_max_parts_max_bytes); with a tiny cap and two input
    files the two virtual parts must stay separate, and query output
    must be unchanged."""
    import subprocess
    import sys as _sys
    import json
    # split the fixture into two files
    recs = open(f"{DATA}/genomes.fa").read().split(">")[1:]
    half = len(recs) // 2
    (tmp_path / "a.fa").write_text("".join(">" + r for r in recs[:half]))
    (tmp_path / "b.fa").write_text("".join(">" + r for r in recs[half:]))
    db = str(tmp_path / "db")
    r = _run(["build", db, str(tmp_path / "a.fa"), str(tmp_path / "b.fa"),
              "-taxonomy", f"{DATA}/taxonomy",
              "-max-part-size", "0.00001"])
    assert r.returncode == 0, r.stderr.decode()[-800:]
    meta = json.load(open(db + ".meta"))
    assert meta["part_count"] == 2
    r1 = _run(["query", db, f"{DATA}/reads_single.fa", "-tophits",
               "-no-summary", "-no-query-params"])
    db1 = str(tmp_path / "db1")
    r = _run(["build", db1, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0
    r2 = _run(["query", db1, f"{DATA}/reads_single.fa", "-tophits",
               "-no-summary", "-no-query-params"])
    assert r1.stdout == r2.stdout


def test_two_tier_layout_end_to_end(tmp_path):
    """MC_DENSE_LIMIT=1 forces the two-tier head+overflow layout; query
    output must be byte-identical to the dense layout."""
    import subprocess
    import sys as _sys
    db = str(tmp_path / "db")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0, r.stderr.decode()[-800:]

    def q(extra_env):
        env = dict(os.environ, JAX_PLATFORMS="cpu", **extra_env)
        env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
            env.get("PYTHONPATH", "")
        r = subprocess.run(
            [_sys.executable, "-m", "metacache_tpu", "query", db,
             f"{DATA}/reads_single.fa", "-tophits", "-allhits",
             "-no-summary", "-no-query-params"],
            capture_output=True, env=env, cwd=os.path.dirname(HERE),
            timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-800:]
        return r.stdout

    assert q({}) == q({"MC_DENSE_LIMIT": "1"})


def test_pairseq_odd_records_and_batch_carry(tmp_path):
    """-pairseq with an ODD record count (trailing unpaired mate) and a
    batch size that forces the native reader's odd-leftover carry: the
    native fast path must equal the per-record Python reader."""
    import subprocess
    import sys as _sys
    db = str(tmp_path / "db")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0, r.stderr.decode()[-800:]

    src = open(f"{DATA}/reads_pairseq.fa").read().strip().split("\n")
    recs = ["\n".join(src[i:i + 2]) for i in range(0, len(src), 2)]
    odd = tmp_path / "odd.fa"
    # 3x the records + one extra -> odd count, crosses batch boundaries
    odd.write_text("\n".join(recs * 3 + recs[:1]) + "\n")

    def run(native):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   MC_NATIVE="0" if not native else "1")
        env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
            env.get("PYTHONPATH", "")
        r = subprocess.run(
            [_sys.executable, "-m", "metacache_tpu", "query", db,
             str(odd), "-pairseq", "-tophits",
             "-batch-size", "64"],
            capture_output=True, env=env, cwd=os.path.dirname(HERE),
            timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-800:]
        return [l for l in r.stdout.decode().splitlines()
                if "time" not in l and "speed" not in l
                and str(tmp_path) not in l]

    assert run(True) == run(False)


def test_scan_fusion_summary_identical_paired(tmp_path):
    """The fused-scan summary path for -pairfiles must match the
    unfused paired dispatch exactly."""
    import subprocess
    import sys as _sys
    db = str(tmp_path / "db")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0, r.stderr.decode()[-800:]
    m1, m2 = tmp_path / "m1.fa", tmp_path / "m2.fa"
    # enough pairs that the scan path actually fires (scan_k=3 stacks
    # of batch_reads=1024) plus a leftover tail
    m1.write_bytes(open(f"{DATA}/reads_pair1.fa", "rb").read() * 150)
    m2.write_bytes(open(f"{DATA}/reads_pair2.fa", "rb").read() * 150)

    def run_k(k):
        env = dict(os.environ, JAX_PLATFORMS="cpu", MC_SCAN_K=str(k))
        env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
            env.get("PYTHONPATH", "")
        r = subprocess.run(
            [_sys.executable, "-m", "metacache_tpu", "query", db,
             str(m1), str(m2), "-pairfiles", "-no-map",
             "-batch-size", "512"],
            capture_output=True, env=env, cwd=os.path.dirname(HERE),
            timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-800:]
        return [l for l in r.stdout.decode().splitlines()
                if "time" not in l and "speed" not in l
                and str(tmp_path) not in l]

    assert run_k(0) == run_k(3)


def test_device_layout_staging_identical(tmp_path):
    """query over a SAVED database staged via device CSR construction
    (MC_DEVICE_LAYOUT=1, default) must byte-match host staging (=0)."""
    import subprocess
    import sys as _sys
    db = str(tmp_path / "db")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy"])
    assert r.returncode == 0, r.stderr.decode()[-800:]

    def run(dev):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   MC_DEVICE_LAYOUT=dev)
        env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
            env.get("PYTHONPATH", "")
        r = subprocess.run(
            [_sys.executable, "-m", "metacache_tpu", "query", db,
             f"{DATA}/reads_single.fa", "-tophits", "-allhits"],
            capture_output=True, env=env, cwd=os.path.dirname(HERE),
            timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-800:]
        return [l for l in r.stdout.decode().splitlines()
                if "time" not in l and "speed" not in l]

    assert run("1") == run("0")
