"""A/B parity for the native per-read line formatter.

The native path (native/format.cpp + MappingLineWriter.lines_batch)
must be byte-identical to the per-read Python writer for every flag
combination it claims; combinations it does not handle must fall back
(covered implicitly: the fallback IS the Python writer).

Reference behavior under test: show_query_mapping layout,
src/classification.cpp:470-533.
"""
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def dbfile(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("db") / "testdb")
    r = _run(["build", db, f"{DATA}/genomes.fa",
              "-taxonomy", f"{DATA}/taxonomy", "-parts", "1"], "1")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return db


def _run(args, native_fmt: str):
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu",
               MC_NATIVE_FMT=native_fmt)
    return subprocess.run([sys.executable, "-m", "metacache_tpu"] + args,
                          capture_output=True, env=env, cwd=REPO,
                          timeout=600)


def _strip(text: str):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    return [l for l in text.splitlines()
            if not any(d in l for d in drop)]


COMBOS = [
    [],                                       # plain mapping
    ["-tophits"],
    ["-tophits", "-queryids"],
    ["-mapped-only", "-tophits"],
    ["-taxids-only", "-tophits"],
    ["-lowest", "sequence", "-tophits"],
    ["-lowest", "genus", "-tophits", "-queryids"],
    ["-separator", " :: ", "-tophits"],
    ["-lineage", "-tophits"],
    ["-abundances", "-tophits"],              # keeps per-read lines on
]


@pytest.mark.parametrize("combo", COMBOS,
                         ids=["_".join(c) or "plain" for c in COMBOS])
def test_native_format_matches_python(dbfile, combo):
    a = _run(["query", dbfile, f"{DATA}/reads_single.fa"] + combo, "1")
    b = _run(["query", dbfile, f"{DATA}/reads_single.fa"] + combo, "0")
    assert a.returncode == 0, a.stderr.decode()[-2000:]
    assert b.returncode == 0, b.stderr.decode()[-2000:]
    assert _strip(a.stdout.decode()) == _strip(b.stdout.decode())
