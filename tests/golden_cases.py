"""The golden lane: CLI runs over the synthetic fixture whose output must
equal the reference binary's (tests/data/golden, made by make_goldens.sh).

Shared by tests/test_golden_parity.py, which starts each CLI run as a
subprocess, and chip_smoke.py, which runs them in its own process on the
GPU. A runner is a callable ``run(args, stdin=None) -> (returncode,
stdout, stderr)``; every check raises AssertionError on a mismatch.
Timing, thread and path lines are stripped before comparing, as in the
reference's own test/run_tests.
"""
import os
import re
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")

CASES = [
    ("classified_single_fa.txt", ["reads_single.fa", "-precision",
     "-ground-truth", "-tophits", "-allhits", "-hits-per-ref",
     "-abundances", "-abundance-per", "species"]),
    ("classified_single_fq.txt", ["reads_single.fq", "-precision",
     "-ground-truth", "-tophits"]),
    ("classified_long_fa.txt", ["reads_long.fa", "-precision",
     "-ground-truth", "-tophits"]),
    ("classified_pairfiles.txt", ["reads_pair1.fa", "reads_pair2.fa",
     "-pairfiles", "-precision", "-ground-truth", "-tophits"]),
    ("classified_pairseq.txt", ["reads_pairseq.fa", "-pairseq",
     "-precision", "-ground-truth", "-tophits"]),
]

FMT_FLAGS = [
    [],
    ["-lineage"],
    ["-taxids"],
    ["-taxids-only"],
    ["-taxids-only", "-omit-ranks"],
    ["-omit-ranks"],
    ["-taxids", "-omit-ranks"],
    ["-separate-cols"],
    ["-taxids", "-separate-cols"],
    ["-taxids-only", "-separate-cols", "-omit-ranks"],
    ["-queryids"],
    ["-queryids", "-lineage"],
    ["-mapped-only"],
    ["-separator", ":::"],
    ["-lowest", "species"],
    ["-lowest", "genus", "-taxids"],
    ["-hitmin", "8"],
    ["-hitdiff", "50"],
    ["-maxcand", "4", "-tophits"],
]

K18_CASES = [
    ("k18_single.txt", ["reads_single.fa", "-mapped-only", "-precision",
                        "-ground-truth", "-tophits"]),
    ("k18_long.txt", ["reads_long.fa", "-precision", "-ground-truth",
                      "-tophits"]),
    ("k18_pairfiles.txt", ["reads_pair1.fa", "reads_pair2.fa",
                           "-pairfiles", "-precision", "-tophits"]),
]

# the arguments of the replication and table-shard checks
ALL_OUTPUTS_ARGS = ["reads_single.fa", "-precision", "-ground-truth",
                    "-tophits", "-allhits", "-hits-per-ref",
                    "-abundances", "-abundance-per", "species"]


def data_args(args):
    """Prefix the fixture's read files with their directory."""
    return [f"{DATA}/{a}" if a.startswith("reads_") else a for a in args]


def strip(text: str):
    """Drop timing, thread and path lines; the goldens name the fixture
    by the path of the checkout they were made in."""
    drop = ("# time:", "# speed:", "threads", DATA, "tests/data/", "/tmp",
            tempfile.gettempdir())
    return [l for l in text.splitlines()
            if not any(d in l for d in drop)]


def golden(name: str):
    with open(os.path.join(GOLD, name)) as f:
        return strip(f.read())


def canon(lines):
    """Sort the hits-per-ref block (reference iterates an unordered_map)."""
    out, block, in_block = [], [], False
    for l in lines:
        if l.startswith("sequence:") and "\t|\t" in l:
            in_block = True
            block.append(l)
        else:
            if in_block and block:
                out.extend(sorted(block))
                block = []
                in_block = False
            out.append(l)
    if block:
        out.extend(sorted(block))
    return out


def from_mappings(lines):
    """Query-result section only (build+query prepends build narration)."""
    for i, l in enumerate(lines):
        if l.startswith("# Reporting"):
            return lines[i:]
    return lines


def ok(run, args, stdin=None) -> str:
    """Run the CLI, require exit code 0, return its stdout."""
    rc, out, err = run(args, stdin)
    assert rc == 0, f"{args}: rc={rc}\n{err[-2000:]}"
    return out


def query(run, db, args):
    return strip(ok(run, ["query", db] + args))


def build(run, db, *extra):
    ok(run, ["build", db, f"{DATA}/genomes.fa", "-taxonomy",
             f"{DATA}/taxonomy", "-parts", "1", *extra])


# --- checks ---------------------------------------------------------------
def check_classification(run, db, name, args):
    assert canon(query(run, db, data_args(args))) == canon(golden(name))


def check_fmt(run, db, i):
    ours = query(run, db, [f"{DATA}/reads_single.fa"] + FMT_FLAGS[i])
    assert ours == golden(f"fmt_{i}.txt"), f"flags: {FMT_FLAGS[i]}"


def check_partitioned_merge(run, tmp):
    """Partitioned build -> per-partition query -> merge == reference."""
    from metacache_tpu.seqio.reader import read_sequences
    recs = list(read_sequences(f"{DATA}/genomes.fa"))
    a, b = os.path.join(tmp, "a.fa"), os.path.join(tmp, "b.fa")
    for name, rs in [(a, recs[:3]), (b, recs[3:])]:
        with open(name, "w") as f:
            for r in rs:
                f.write(f">{r.header}\n{r.seq.decode()}\n")
    dba, dbb = os.path.join(tmp, "dbA"), os.path.join(tmp, "dbB")
    ok(run, ["build", dba, a, "-taxonomy", f"{DATA}/taxonomy"])
    ok(run, ["build", dbb, b, "-taxonomy", f"{DATA}/taxonomy"])
    qargs = ["-lowest", "species", "-queryids", "-tophits", "-no-summary"]
    ra = os.path.join(tmp, "partition_resA.txt")
    rb = os.path.join(tmp, "partition_resB.txt")
    for db, out in [(dba, ra), (dbb, rb)]:
        ok(run, ["query", db, f"{DATA}/reads_single.fa"] + qargs +
           ["-out", out])
    # per-partition outputs must equal the reference's
    for ours, name in [(ra, "partition_resA.txt"),
                       (rb, "partition_resB.txt")]:
        with open(ours) as f:
            assert strip(f.read()) == golden(name)
    out = ok(run, ["merge", ra, rb, "-taxonomy", f"{DATA}/taxonomy",
                   "-lowest", "species", "-abundances"])

    def keep(lines):
        return [l for l in lines if "resA" not in l and "resB" not in l
                and not l.startswith("Reading")]
    assert keep(strip(out)) == keep(golden("merged.txt"))


_ALIGN_BLOCK = ("#   score", "#   query", "#   target")


def check_align(run, db):
    """-align display vs the reference golden.

    The reference binary's -align is broken: target_candidate.source.index
    is stored 0-based but show_alignment skips `index-1` records with an
    UNSIGNED index (src/classification.cpp:399, sequence_io.cpp:147-149),
    so the first record of a file underflows (no alignment shown at all —
    the common one-genome-per-file layout never aligns anything) and every
    other read is aligned against the record BEFORE its true target.
    We align against the true top candidate, so the check is (a) all
    non-alignment lines match the golden byte-for-byte and (b) our blocks
    satisfy the correctness the reference intended: one block per
    sequence-classified read, true 1-based source index, near-full score.
    """
    txt = ok(run, ["query", db, f"{DATA}/reads_single.fa", "-align",
                   "-tophits"]).replace(DATA, "DATA")
    lines = strip(txt)
    assert [l for l in lines if not l.startswith(_ALIGN_BLOCK)] == \
        [l for l in golden("align.txt") if not l.startswith(_ALIGN_BLOCK)]

    # our alignment blocks: correct subject, near-perfect score
    mapped = [l for l in lines
              if not l.startswith("#") and "\t|\t" in l]
    score_lines = [l for l in lines if l.startswith("#   score")]
    assert len(score_lines) == len(mapped)   # every classified read
    order = [l.split("_r")[0] for l in mapped]
    with open(f"{DATA}/genomes.fa") as f:
        genomes = [h.split()[0][1:] for h in f if h.startswith(">")]
    for hdr, sl in zip(order, score_lines):
        m = re.match(r"#   score  (\d+)  aligned to (\S+) #(\d+) "
                     r"in range \[(\d+),(\d+)\]", sl)
        assert m, sl
        score, fname, idx = int(m.group(1)), m.group(2), int(m.group(3))
        assert fname == "DATA/genomes.fa"
        assert genomes[idx - 1] == hdr      # true 1-based source index
        assert score > 50                   # positive, right neighborhood


def check_covpercentile(run, db):
    assert query(run, db, [f"{DATA}/reads_single.fa", "-cov-percentile",
                           "50", "-precision", "-ground-truth",
                           "-tophits"]) == golden("covpct.txt")


def check_custom_sketch(run, db):
    assert query(run, db, [f"{DATA}/reads_single.fa", "-sketchlen", "8",
                           "-winlen", "96"]) == golden("custom_sketch.txt")


def check_build_query(run):
    out = ok(run, ["build+query", "-targets", f"{DATA}/genomes.fa",
                   "-taxonomy", f"{DATA}/taxonomy", "-query",
                   f"{DATA}/reads_single.fa", "-tophits"])
    assert from_mappings(strip(out)) == \
        from_mappings(golden("buildquery.txt"))


def check_locations(run, db):
    assert query(run, db, [f"{DATA}/reads_single.fa", "-locations",
                           "-queryids"]) == golden("locations.txt")


def check_repl(run, db):
    """Interactive REPL: options + file per stdin line (the reference's
    test/run_tests drives its fmt matrix this way); mapping rows only."""
    out = ok(run, ["query", db],
             f"{DATA}/reads_single.fa -tophits -no-summary\n")

    def rows(lines):
        return [l for l in lines if "\t|\t" in l
                or l.startswith("# TABLE_LAYOUT")]
    assert rows(strip(out)) == rows(golden("repl.txt"))


def check_highest_rank(run, db):
    assert query(run, db, [f"{DATA}/reads_single.fa", "-highest",
                           "genus", "-taxids"]) == \
        golden("highest_genus.txt")


def check_insertsize(run, db):
    assert query(run, db, [f"{DATA}/reads_pair1.fa",
                           f"{DATA}/reads_pair2.fa", "-pairfiles",
                           "-insertsize", "1000", "-tophits"]) == \
        golden("insertsize.txt")


def check_replicate_all_devices(run, db):
    """-replicate 0 = all devices; long reads exercise the padded
    single-query row path under sharding."""
    assert query(run, db, [f"{DATA}/reads_long.fa", "-precision",
                           "-ground-truth", "-tophits",
                           "-replicate", "0"]) == \
        golden("classified_long_fa.txt")


def check_info(run, db):
    """`info <db>` must be byte-identical to the reference binary's
    output on the same fixture DB (reference: show_database_config,
    src/mode_info.cpp:57-67)."""
    out = ok(run, ["info", db])
    with open(os.path.join(GOLD, "info_basic.txt")) as f:
        assert out.splitlines() == f.read().splitlines()


def check_k18(run, db18, name, args):
    assert query(run, db18, data_args(args)) == golden(name)


def check_k18_info(run, db18):
    # "buckets" counts the reference allocator's internal slots
    # (location lists span multiple chunks in its open-addressing
    # table) — an implementation detail with no CSR equivalent
    drop = ("buckets ",)
    got = [l for l in strip(ok(run, ["info", db18, "statistics"]))
           if not l.startswith(drop)]
    want = [l for l in golden("k18_info_stats.txt")
            if not l.startswith(drop)]
    assert got == want


def check_reference_db_import(run):
    """A database written by the reference binary (binary .meta +
    .cache0, committed under tests/data/refdb/) loads transparently
    and classifies with byte-identical output."""
    assert query(run, f"{DATA}/refdb/refdb",
                 [f"{DATA}/reads_single.fa", "-mapped-only",
                  "-precision", "-ground-truth", "-tophits"]) == \
        golden("refdb_import.txt")


def check_fmt_matrix_144(run, db):
    """The reference run_tests' full 144-combo formatting matrix
    ({base,-lineage,-separate-cols,both} x {,-taxids,-taxids-only} x
    {,-omit-ranks,-queryids,both} x {,-mapped-only,-separator /%/}),
    driven through the REPL exactly as test/run_tests:84-143 does."""
    with open(os.path.join(DATA, "fmt_matrix.txt")) as f:
        stdin = f.read().replace("tests/data/", f"{DATA}/")
    out = ok(run, ["query", db], stdin)
    ours = [l for l in out.splitlines() if "NC_" in l]
    with open(os.path.join(GOLD, "fmt_matrix.txt")) as f:
        want = f.read().splitlines()
    assert len(ours) == len(want), (len(ours), len(want))
    # first mismatching combo (200 lines per combo) for a useful message
    for i, (a, b) in enumerate(zip(ours, want)):
        assert a == b, f"line {i} (combo ~{i // 200}): {a!r} != {b!r}"


def single_device_checks(db, tmp):
    """Every golden check that needs one device, as (name, thunk(run))
    pairs; the k=18 (64-bit feature) checks come last because their
    database switches JAX to 64-bit mode for the rest of a process."""
    db18 = os.path.join(tmp, "testdb18")
    checks = [(f"classification:{n}",
               lambda run, n=n, a=a: check_classification(run, db, n, a))
              for n, a in CASES]
    checks += [(f"fmt_{i}", lambda run, i=i: check_fmt(run, db, i))
               for i in range(len(FMT_FLAGS))]
    checks += [
        ("partitioned_merge",
         lambda run: check_partitioned_merge(run, tmp)),
        ("align", lambda run: check_align(run, db)),
        ("covpercentile", lambda run: check_covpercentile(run, db)),
        ("custom_sketch", lambda run: check_custom_sketch(run, db)),
        ("build_query", check_build_query),
        ("locations", lambda run: check_locations(run, db)),
        ("repl", lambda run: check_repl(run, db)),
        ("highest_rank", lambda run: check_highest_rank(run, db)),
        ("insertsize", lambda run: check_insertsize(run, db)),
        ("replicate_all_devices",
         lambda run: check_replicate_all_devices(run, db)),
        ("info", lambda run: check_info(run, db)),
        ("reference_db_import", check_reference_db_import),
        ("fmt_matrix_144", lambda run: check_fmt_matrix_144(run, db)),
        ("build_k18", lambda run: build(run, db18, "-kmerlen", "18")),
    ]
    checks += [(f"k18:{n}",
                lambda run, n=n, a=a: check_k18(run, db18, n, a))
               for n, a in K18_CASES]
    checks.append(("k18_info", lambda run: check_k18_info(run, db18)))
    return checks
