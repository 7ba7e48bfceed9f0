"""End-to-end parity vs the reference CPU binary's golden outputs.

Builds the database once from the synthetic fixture, then runs the CLI
with the exact flag sets used by tests/make_goldens.sh and diffs the
output line by line (the cases live in tests/golden_cases.py, which
chip_smoke.py runs too). Each CLI run is a subprocess; with
``--device gpu`` the subprocesses run on the GPU, one at a time.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import golden_cases as G

REPO = os.path.dirname(G.HERE)


@pytest.fixture(scope="module")
def cli(cli_env):
    def run(args, stdin=None):
        r = subprocess.run(
            [sys.executable, "-m", "metacache_tpu"] + list(args),
            input=stdin.encode() if stdin is not None else None,
            capture_output=True, env=cli_env, cwd=REPO, timeout=1200)
        return (r.returncode, r.stdout.decode(),
                r.stderr.decode(errors="replace"))
    return run


@pytest.fixture
def multi_device(device):
    if device == "gpu":
        pytest.skip("needs 8 devices; chip_smoke.py --multi runs the "
                    "multi-card path")


@pytest.fixture(scope="module")
def dbfile(cli, tmp_path_factory):
    db = str(tmp_path_factory.mktemp("db") / "testdb")
    G.build(cli, db)
    return db


@pytest.mark.parametrize("golden,args", G.CASES,
                         ids=[c[0].split(".")[0] for c in G.CASES])
def test_classification_parity(cli, dbfile, golden, args):
    G.check_classification(cli, dbfile, golden, args)


@pytest.mark.parametrize("i", range(len(G.FMT_FLAGS)))
def test_formatting_matrix_parity(cli, dbfile, i):
    G.check_fmt(cli, dbfile, i)


def test_partitioned_merge_parity(cli, tmp_path):
    G.check_partitioned_merge(cli, str(tmp_path))


def test_align_parity(cli, dbfile):
    G.check_align(cli, dbfile)


def test_covpercentile_parity(cli, dbfile):
    G.check_covpercentile(cli, dbfile)


def test_custom_sketch_parity(cli, dbfile):
    G.check_custom_sketch(cli, dbfile)


def test_build_query_parity(cli):
    G.check_build_query(cli)


def test_locations_parity(cli, dbfile):
    G.check_locations(cli, dbfile)


def test_repl_parity(cli, dbfile):
    G.check_repl(cli, dbfile)


def test_highest_rank_parity(cli, dbfile):
    G.check_highest_rank(cli, dbfile)


def test_insertsize_parity(cli, dbfile):
    G.check_insertsize(cli, dbfile)


def test_replicate_matches_golden(cli, dbfile, multi_device):
    """-replicate 8 (data-parallel over the virtual 8-device mesh) must
    produce byte-identical mapping output to the single-device run
    (reference: gpu replication changes throughput, never results)."""
    args = G.data_args(G.ALL_OUTPUTS_ARGS)
    ours = G.canon(G.query(cli, dbfile, args + ["-replicate", "8"]))
    assert ours == G.canon(G.golden("classified_single_fa.txt"))


def test_replicate_all_devices_long_reads(cli, dbfile):
    G.check_replicate_all_devices(cli, dbfile)


def test_table_shards_matches_golden(cli, dbfile, multi_device):
    """-table-shards N (feature-range shards + all_to_all over the
    virtual mesh) must be byte-identical, alone and with -replicate."""
    args = G.data_args(G.ALL_OUTPUTS_ARGS)
    want = G.canon(G.golden("classified_single_fa.txt"))
    ours = G.canon(G.query(cli, dbfile, args + ["-table-shards", "4"]))
    assert ours == want
    ours = G.canon(G.query(cli, dbfile, args + ["-replicate", "2",
                                                "-table-shards", "4"]))
    assert ours == want


def test_table_shards_long_reads(cli, dbfile, multi_device):
    ours = G.query(cli, dbfile, [f"{G.DATA}/reads_long.fa", "-precision",
                                 "-ground-truth", "-tophits",
                                 "-table-shards", "2"])
    assert ours == G.golden("classified_long_fa.txt")


def test_info_config_parity(cli, dbfile):
    G.check_info(cli, dbfile)


# --- 64-bit kmer config (k = 18): goldens from the reference binary
# compiled with -DMC_KMER_TYPE=uint64_t (see make_goldens.sh) ----------
@pytest.fixture(scope="module")
def dbfile_k18(cli, tmp_path_factory):
    db = str(tmp_path_factory.mktemp("db18") / "testdb18")
    G.build(cli, db, "-kmerlen", "18")
    return db


@pytest.mark.parametrize("golden,args", G.K18_CASES)
def test_k18_parity(cli, dbfile_k18, golden, args):
    G.check_k18(cli, dbfile_k18, golden, args)


def test_k18_info_statistics(cli, dbfile_k18):
    G.check_k18_info(cli, dbfile_k18)


def test_reference_db_import_parity(cli):
    G.check_reference_db_import(cli)


def test_reference_db_import_contents():
    from metacache_tpu.db.database import Database
    db = Database.load(f"{G.DATA}/refdb/refdb")
    assert db.sketching.kmerlen == 16 and db.sketching.winlen == 127
    assert db.target_count == 6
    assert db.parts[0].num_features == 40016
    assert db.parts[0].num_locations == 40017
    # bucket invariant: locations ascending within each bucket
    p = db.parts[0]
    starts = p.offsets[:-1]
    inner = np.ones(len(p.locations), bool)
    inner[starts] = False
    assert (p.locations[1:][inner[1:]] >=
            p.locations[:-1][inner[1:]]).all()


def test_formatting_matrix_144_repl(cli, dbfile):
    G.check_fmt_matrix_144(cli, dbfile)
