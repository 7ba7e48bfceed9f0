#!/usr/bin/env python
"""Smoke check of the classifier on NVIDIA GPUs, through the CLI.

    python chip_smoke.py            # one GPU: device, golden, scale
    python chip_smoke.py --multi    # four GPUs: 1 card vs -table-shards 4
                                    # vs -replicate 4, and nothing else
    python chip_smoke.py --trace DIR
                                    # device and scale, then a profiler
                                    # trace of a warm summary query

Phases (one process; every CLI call runs in it, so one process holds
the card; any failure raises and the exit code is non-zero):

1. device: platform, device kind and count, the allocator's bytes_limit,
   the card's name and power limit from nvidia-smi, the JAX version and
   whether the native C++ reader is active. Fails unless JAX runs on a
   GPU.
2. golden: the fixture database of tests/data built through the CLI,
   then every single-device case of the golden lane
   (tests/golden_cases.py), compared with the reference binary's output
   byte for byte.
3. scale: a 944 Mbp RefSeq-skew reference set made from --seed
   (bench.REFSEQ_SKEW), written as FASTA with an NCBI-style taxonomy in
   which the strains of one base genome share a species; `build`; a
   summary `query` of 1M 100 bp reads with ~1% errors and -abundances;
   a per-read `query` of 65,536 of them, whose first 4,096 lines must
   equal a NumPy oracle on the saved database exactly. With --trace,
   a warm summary query of the 65,536 reads is traced into DIR with
   XLA's command buffers off (so each kernel keeps its scope name), and
   tools/stage_times.py's device time per query stage is printed.

The timings printed are cold (compilation included): a smoke, not a
benchmark. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

import bench  # noqa: E402
import golden_cases as G  # noqa: E402
from metacache_tpu.cli import main as cli  # noqa: E402

SPEC = bench.REFSEQ_SKEW    # (bases, strains per base, mutation rate)
GLEN = 1_000_000            # bp per generated genome
READ_LEN = 100
N_READS = 1_000_000         # summary query
N_MAPPED = 65_536           # per-read query
N_ORACLE = 4_096            # per-read lines checked against the oracle
ERROR_RATE = 0.01
MULTI_COUNT = 4
NO_CMD_BUFFER = "--xla_gpu_enable_command_buffer="
ACGT = np.frombuffer(b"ACGT", np.uint8)


def log(msg: str):
    print(msg, flush=True)


def run_cli(args, stdin=None):
    """One CLI invocation in this process -> (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main([str(a) for a in args])
    finally:
        sys.stdin = old_stdin
    gc.collect()
    return rc, out.getvalue(), err.getvalue()


# --- 1. device ------------------------------------------------------------
def require_gpu(count: int):
    """The devices JAX runs on; raises unless they are `count` GPUs."""
    from metacache_tpu.utils.platform import force_platform
    force_platform()
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"JAX runs on {devs[0].platform!r}, not a GPU")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


def phase_device(count: int):
    import jax
    from metacache_tpu import native
    devs = require_gpu(count)
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} "
        f"bytes_limit={(d.memory_stats() or {}).get('bytes_limit')}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line}")
    log(f"jax {jax.__version__}; native reader "
        f"{'active' if native.get_lib() is not None else 'NOT built'}")
    return d, len(devs)


# --- 2. golden ------------------------------------------------------------
def phase_golden():
    import jax
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="mc_golden_") as tmp:
        db = os.path.join(tmp, "testdb")
        G.build(run_cli, db)
        checks = G.single_device_checks(db, tmp)
        for name, check in checks:
            t1 = time.time()
            check(run_cli)
            log(f"golden {name}: identical ({time.time() - t1:.1f} s)")
    # the k=18 checks switched JAX to 64-bit mode for this process
    jax.config.update("jax_enable_x64", False)
    log(f"golden: {len(checks)} checks identical "
        f"({time.time() - t0:.1f} s)")


# --- 3. scale -------------------------------------------------------------
def write_taxonomy(path: str, species):
    """NCBI-style dumps: one species per base genome, four species per
    genus, under one family/order/class/phylum/superkingdom."""
    os.makedirs(path, exist_ok=True)
    chain = [(1, 1, "no rank", "root"), (2, 1, "superkingdom", "Bacteria"),
             (3, 2, "phylum", "Synthphylum"), (4, 3, "class", "Synthia"),
             (5, 4, "order", "Synthales"), (6, 5, "family", "Synthaceae")]
    nsp = int(species.max()) + 1
    chain += [(1000 + g, 6, "genus", f"Synthgenus{g}")
              for g in range((nsp + 3) // 4)]
    chain += [(100000 + s, 1000 + s // 4, "species", f"Synthgenus{s // 4} "
               f"species{s}") for s in range(nsp)]
    with open(os.path.join(path, "nodes.dmp"), "w") as f:
        for tid, parent, rank, _ in chain:
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\t\t|\n")
    with open(os.path.join(path, "names.dmp"), "w") as f:
        for tid, _, _, name in chain:
            f.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    open(os.path.join(path, "merged.dmp"), "w").close()


def accession(i: int) -> str:
    return f"NC_{900001 + i:06d}.1"


def write_references(path: str, genomes, species):
    with open(path, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(f">{accession(i)} taxid|{100000 + int(species[i])}| "
                    f"synthetic strain\n".encode())
            f.write(ACGT[g].tobytes())
            f.write(b"\n")


def make_reads(rng, genomes, n: int, glen: int):
    """(n, READ_LEN) codes with ~1% substitutions, half reverse-
    complemented, and the source genome of each read."""
    src = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen - READ_LEN, n)
    reads = np.empty((n, READ_LEN), np.uint8)
    for g in np.unique(src):
        sel = np.nonzero(src == g)[0]
        reads[sel] = genomes[g][pos[sel, None] + np.arange(READ_LEN)]
    mut = rng.random((n, READ_LEN)) < ERROR_RATE
    reads[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    return reads, src


def write_reads(path: str, reads, src):
    with open(path, "wb") as f:
        for c0 in range(0, len(reads), 65536):
            rows = ACGT[reads[c0:c0 + 65536]]
            f.write(b"".join(
                b">%s_r%d\n%s\n" % (accession(int(src[i])).encode(), i,
                                    rows[i - c0].tobytes())
                for i in range(c0, min(c0 + 65536, len(reads)))))


def make_scale_data(work: str, seed: int, spec, glen: int, n_reads: int,
                    n_mapped: int):
    """FASTA references + taxonomy + read files under `work`."""
    t0 = time.time()
    rng = np.random.default_rng(seed)
    genomes, species = bench.make_strain_genomes(rng, spec, glen)
    refs = os.path.join(work, "refs.fa")
    write_references(refs, genomes, species)
    write_taxonomy(os.path.join(work, "taxonomy"), species)
    reads, src = make_reads(rng, genomes, n_reads, glen)
    write_reads(os.path.join(work, "reads.fa"), reads, src)
    write_reads(os.path.join(work, "reads_mapped.fa"), reads[:n_mapped],
                src[:n_mapped])
    log(f"scale data: {len(genomes)} genomes x {glen} bp, {n_reads} reads "
        f"(set-up {time.time() - t0:.1f} s)")
    return refs


def build_scale_db(work: str, refs: str) -> str:
    db = os.path.join(work, "scale_db")
    t0 = time.time()
    G.ok(run_cli, ["build", db, refs, "-taxonomy",
                   os.path.join(work, "taxonomy")])
    log(f"scale build: {time.time() - t0:.1f} s (cold, smoke, not a "
        "benchmark)")
    return db


def oracle_lines(db_path: str, reads_path: str, flags, n: int):
    """Per-read mapping lines of the first n reads from the NumPy
    oracle: core.sketch, a host CSR lookup on the saved database,
    core.candidates.generate_candidates and
    classify.classification.classify."""
    from metacache_tpu.classify import classification as C
    from metacache_tpu.classify.output import show_query_mapping
    from metacache_tpu.classify.runner import rank_from_string
    from metacache_tpu.config import max_windows_in_range
    from metacache_tpu.core.candidates import (CandidateGenerationRules,
                                               generate_candidates)
    from metacache_tpu.core.sketch import all_query_features
    from metacache_tpu.db.database import Database
    from metacache_tpu.seqio.reader import read_sequences
    from metacache_tpu.taxonomy.model import Rank

    db = Database.load(db_path)
    db.taxa.update()
    opt, _, _ = cli.parse_query_options(cli.Args(list(flags)))
    sk = db.sketching
    lowest = rank_from_string(opt.classify.lowest_rank)
    highest = rank_from_string(opt.classify.highest_rank)
    assert lowest == Rank.SEQUENCE, "the oracle merges at sequence level"
    hits_min = opt.classify.resolve_hits_min(sk.sketchlen)
    tables = [(p.unique_features, p.offsets, p.locations) for p in db.parts]
    lines = {}
    for i, rec in enumerate(read_sequences(reads_path)):
        if i == n:
            break
        matches = []
        for f in all_query_features(rec.seq, None, sk):
            for uf, off, locs in tables:
                j = np.searchsorted(uf, f)
                if j < len(uf) and uf[j] == f:
                    loc = locs[off[j]:off[j + 1]]
                    matches += zip((loc >> np.uint64(32)).tolist(),
                                   (loc & np.uint64(0xFFFFFFFF)).tolist())
        matches.sort()
        rules = CandidateGenerationRules(
            max_windows_in_range=max_windows_in_range(
                len(rec.seq), opt.classify.insert_size_max, sk.winstride),
            max_candidates=opt.classify.max_candidates,
            taxon_of_target=db.taxa.cached_taxon_of_target)
        cands = [(c.tax, c.tgt, c.hits, c.pos.beg, c.pos.end)
                 for c in generate_candidates(matches, rules)]
        best = C.classify(db.taxa, opt.classify, hits_min,
                          [C.HostCandidate(*c) for c in cands],
                          lowest, highest)
        header = rec.header.split(" ", 1)[0]
        lines[header] = show_query_mapping(
            db.taxa, opt.output, sk, i, rec.header, best, None, cands, [])
    return lines


def mapping_lines(text: str):
    """header -> mapping line of a per-read CLI output."""
    out = {}
    for line in text.splitlines(keepends=True):
        if line.startswith("#") or "\t|\t" not in line:
            continue
        out[line.split("\t|\t", 1)[0]] = line
    return out


def trace_summary_query(db: str, reads: str, trace_dir: str):
    """Profile a warm summary query; print device time per stage."""
    import jax
    from tools.stage_times import hlo_op_names, newest_xplane, stage_times
    args = ["query", db, reads, "-no-map"]
    G.ok(run_cli, args)
    t0 = time.time()
    with jax.profiler.trace(trace_dir):
        G.ok(run_cli, args)
    r = stage_times(newest_xplane(trace_dir), op_names=hlo_op_names(
        os.path.join(trace_dir, "hlo")))
    log(f"trace: {time.time() - t0:.3f} s wall, device window "
        f"{r['window_ns']} ns, busy {r['busy_ns']} ns, idle share "
        f"{r['idle_share']}")
    for name, ns in r["stages"].items():
        log(f"trace stage {name}: {ns} ns")
    for label, ns in r["top"]:
        log(f"trace kernel {ns} ns: {label}")


def phase_scale(seed: int, spec, glen: int, n_reads: int, n_mapped: int,
                n_oracle: int, trace_dir: str | None = None):
    import jax
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=REPO) as work:
        refs = make_scale_data(work, seed, spec, glen, n_reads, n_mapped)
        db = build_scale_db(work, refs)

        t0 = time.time()
        out = G.ok(run_cli, ["query", db, os.path.join(work, "reads.fa"),
                             "-no-map", "-abundances"])
        dt = time.time() - t0
        summary = [l for l in out.splitlines()
                   if "classified" in l.lower()]
        assert summary, "summary query printed no statistics"
        for l in summary[:4]:
            log(f"scale summary: {l.strip()}")
        log(f"scale query: {n_reads} reads in {dt:.1f} s = "
            f"{n_reads / dt * 60:.0f} reads/min (cold, smoke, not a "
            "benchmark)")

        flags = ["-tophits"]
        mapped = os.path.join(work, "reads_mapped.fa")
        t0 = time.time()
        got = mapping_lines(G.ok(run_cli, ["query", db, mapped] + flags))
        log(f"scale per-read query: {n_mapped} reads in "
            f"{time.time() - t0:.1f} s")
        assert len(got) == n_mapped, (len(got), n_mapped)
        t0 = time.time()
        want = oracle_lines(db, mapped, flags, n_oracle)
        bad = [h for h, line in want.items() if got.get(h) != line]
        assert not bad, (f"{len(bad)} of {len(want)} lines differ from "
                         f"the oracle, first {bad[0]}:\n"
                         f"  got  {got.get(bad[0])!r}\n"
                         f"  want {want[bad[0]]!r}")
        log(f"scale oracle: {len(want)} per-read lines identical "
            f"({time.time() - t0:.1f} s)")
        if trace_dir:
            trace_summary_query(db, mapped, trace_dir)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


# --- 4. four cards --------------------------------------------------------
def phase_multi(seed: int, spec, glen: int, n_mapped: int):
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=REPO) as work:
        refs = make_scale_data(work, seed, spec, glen, n_mapped, n_mapped)
        db = build_scale_db(work, refs)
        mapped = os.path.join(work, "reads_mapped.fa")
        outs = {}
        for name, extra in [("1 card", []),
                            ("-table-shards 4", ["-table-shards", "4"]),
                            ("-replicate 4", ["-replicate", "4"])]:
            t0 = time.time()
            out = G.ok(run_cli, ["query", db, mapped, "-tophits",
                                 "-no-summary"] + extra)
            outs[name] = [l for l in G.strip(out)
                          if "\t|\t" in l and not l.startswith("#")]
            log(f"multi {name}: {len(outs[name])} lines "
                f"({time.time() - t0:.1f} s)")
        ref = outs["1 card"]
        assert len(ref) == n_mapped, (len(ref), n_mapped)
        for name, lines in outs.items():
            assert lines == ref, f"{name} differs from 1 card"
        log(f"multi: per-read lines identical across {list(outs)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="DIR",
                    help="skip the golden phase; trace a warm summary "
                         "query of the scale phase into DIR")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.trace and NO_CMD_BUFFER not in os.environ.get("XLA_FLAGS", ""):
        # XLA reads its flags once, so restart with them set: kernels
        # keep their instruction outside command buffers, and the
        # optimized HLO text maps each instruction to its scope path
        # (compiled afresh, so the dump is written)
        flags = (f"{NO_CMD_BUFFER} --xla_dump_hlo_as_text "
                 "--xla_dump_hlo_module_re=query_step "
                 f"--xla_dump_to={os.path.join(args.trace, 'hlo')}")
        env = dict(os.environ, JAX_ENABLE_COMPILATION_CACHE="false",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " +
                              flags).strip())
        os.execve(sys.executable,
                  [sys.executable, os.path.abspath(__file__)] + argv,
                  env)
    d, count = phase_device(MULTI_COUNT if args.multi else 1)
    if args.multi:
        phase_multi(args.seed, SPEC, GLEN, N_MAPPED)
    else:
        if not args.trace:
            phase_golden()
        phase_scale(args.seed, SPEC, GLEN, N_READS, N_MAPPED, N_ORACLE,
                    args.trace)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
