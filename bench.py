#!/usr/bin/env python
"""Benchmark: classification throughput on one GPU.

Two databases, both built AND staged entirely on device
(ops.table_device — sketches never round-trip the host):

1. toy strain DB (16 base genomes x 4 strains x 1 Mbp, max bucket ~12,
   dense probe layout) — the round-1 headline metric, kept comparable.
2. RefSeq-skew DB (64 unique + 12x52-strain + 1x256-strain x 1 Mbp =
   944 Mbp, >= 1 GiB of locations, buckets saturating the 254 cap,
   memory-budgeted two-tier layout) — the scale-proof metric.

Short 100 bp reads run through the production path: sketch ->
bucket-row probe -> fused-row gather -> per-row candidate sort, sweep
and top-k -> LCA, SCAN_K batches per dispatch.

Baseline: reference MetaCache-GPU ~300 M reads/min on 4x V100
(README.md:7). vs_baseline = ours / 300e6 (single chip vs 4 GPUs).

Prints ONE JSON line.
"""
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

READ_LEN = 100
BATCH_READS = 8192
SCAN_K = 128        # batches fused per device dispatch (lax.scan)
WARMUP = 2
ITERS = 6
# RefSeq-skew reference set, (bases, strains per base, mutation rate) of
# 1 Mbp genomes: 64 unique + 12 x 52 strains + 1 x 256 strains = 944 Mbp,
# over 1 GiB of locations, buckets at the 254 cap
REFSEQ_SKEW = [(64, 1, 0.0), (12, 52, 0.003), (1, 256, 0.003)]


def make_strain_genomes(rng, specs, glen):
    """specs: list of (num_bases, strains_per_base, mutation_rate).
    -> (genomes, species_id per genome) — strains of one base genome
    share a species so ambiguous sibling-strain hits LCA to species."""
    genomes = []
    species = []
    sp = 0
    for bases, strains, mut in specs:
        for b in range(bases):
            base = rng.integers(0, 4, glen, dtype=np.uint8)
            for s in range(strains):
                g = base if s == 0 else base.copy()
                if s and mut:
                    nmut = int(glen * mut)
                    pos = rng.integers(0, glen, nmut)
                    g[pos] = rng.integers(0, 4, nmut, dtype=np.uint8)
                genomes.append(g)
                species.append(sp)
            sp += 1
    return genomes, np.asarray(species, np.int32)


def dense_tag(dt):
    """probe_rows `dense` static tag for a DeviceTable layout."""
    wide = str(dt.uniq.dtype) == "uint64"
    if dt.dense:
        if wide:
            return f"u64pk{dt.slot_bits}" + ("p" if dt.packed else "")
        if dt.slot_bits:
            return f"pk{dt.slot_bits}" + ("p" if dt.packed else "")
        return "packed" if dt.packed else True
    if getattr(dt, "classed", False):
        return ("classed", dt.head_slots, False, dt.ovf_packed,
                dt.slot_bits)
    return (("u64_two_tier" if wide else "two_tier"), dt.head_slots,
            dt.packed, dt.ovf_packed, dt.slot_bits)


def build_db(genomes, opt):
    """Device sketch + on-device table construction."""
    from metacache_tpu.db.sketch_exec import DeviceSketchAccumulator
    from metacache_tpu.ops import windows as W
    from metacache_tpu.ops.table_device import build_device_table_chunked
    t0 = time.time()
    acc = DeviceSketchAccumulator(opt.kmerlen, opt.sketchlen)
    for tid, g in enumerate(genomes):
        wm, vl = W.sequence_windows(g, opt)
        acc.add_target(wm, vl, tid)
    dt = build_device_table_chunked(acc.finish_chunks(), cap=254)
    return dt, time.time() - t0


def main():
    from metacache_tpu.utils.platform import force_platform
    force_platform()
    import jax.numpy as jnp
    from metacache_tpu.config import SketchingOptions

    rng = np.random.default_rng(42)
    opt = SketchingOptions().resolved()
    B = BATCH_READS

    def lineage_arrays(species):
        ntgt = len(species)
        lin = np.zeros((ntgt, 21), np.int32)
        lin[:, 0] = -np.arange(ntgt) - 1
        lin[:, 4] = species + 100
        lin[:, 20] = 1
        return lin, lin[:, 0].copy()

    def measure(dt, genomes, species, glen, iters=ITERS,
                long_reads=False):
        """-> dict of throughput results for one database."""
        ntgt = len(genomes)
        lineages, merge_tax = lineage_arrays(species)
        mt, lg = jnp.asarray(merge_tax), jnp.asarray(lineages)
        spf, bbits = dt.spf, dt.bbits
        dense = dense_tag(dt)
        pkb = dt.slot_bits          # packed slot keys (= storage bits)

        rng2 = np.random.default_rng(7)
        gsel = rng2.integers(0, ntgt, B)
        pos = rng2.integers(0, glen - READ_LEN, B)
        wins = np.full((B, 1, opt.winlen), 4, np.uint8)
        for i in range(B):
            rd = genomes[gsel[i]][pos[i]:pos[i] + READ_LEN].copy()
            nm = rng2.poisson(READ_LEN / 100)
            if nm:
                mp = rng2.integers(0, READ_LEN, nm)
                rd[mp] = rng2.integers(0, 4, nm, dtype=np.uint8)
            wins[i, 0, :READ_LEN] = rd
        valid = np.full((B, 1), READ_LEN, np.int32)
        mwir = np.full(B, 2, np.int32)

        # the PRODUCTION scan step (ops.rows.query_step_rows_scan):
        # software-pipelined probe included
        from metacache_tpu.ops.rows import query_step_rows_scan

        def query_scan(wk, vk, mk, tf, to, la, lb, ps, mt, lg):
            return query_step_rows_scan(
                wk, vk, mk, tf, to, la, lb, mt, lg,
                jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                jnp.int32(0), ps,
                k=opt.kmerlen, sketchlen=opt.sketchlen,
                slots_per_feature=spf, windows_per_query=1,
                max_candidates=2, prefix_bits=bbits, prefix_steps=0,
                dense=dense,
                walk_elems=2 * opt.sketchlen, fast_top2=True,
                pack_bits=pkb,
                prefetch=bool(dense))

        wk = jnp.asarray(np.broadcast_to(
            wins[None], (SCAN_K,) + wins.shape).copy())
        vk = jnp.asarray(np.broadcast_to(
            valid[None], (SCAN_K,) + valid.shape).copy())
        mk = jnp.asarray(np.broadcast_to(
            mwir[None], (SCAN_K,) + mwir.shape).copy())
        targs = (dt.uniq, dt.offsets, dt.head, dt.ovf, dt.brows, mt, lg)

        # timed loop fetches a device-side REDUCTION (the production
        # summary path reduces classifications to rank histograms on
        # device too), so the d2h copy of the raw (K, B) cls matrix
        # stays out of the device time being measured
        import jax as _jax
        qsum = _jax.jit(lambda *a: query_scan(*a).sum())
        cls = np.asarray(query_scan(wk, vk, mk, *targs))
        for _ in range(WARMUP):
            np.asarray(qsum(wk, vk, mk, *targs))
        t0 = time.time()
        prev = None
        for _ in range(iters):
            r = qsum(wk, vk, mk, *targs)
            if prev is not None:
                np.asarray(prev)
            prev = r
        np.asarray(prev)
        dt_s = (time.time() - t0) / (iters * SCAN_K)
        out = {
            "reads_per_min": round(B / dt_s * 60),
            "ms_per_batch": round(dt_s * 1000, 3),
            "classified_fraction": round(float((cls[0] != 0).mean()), 4),
        }

        if not dt.dense and pkb:
            # escalation (head-only phase 1 + full-depth redo of reads
            # that touched overflowing buckets — exact; the production
            # summary loop runs the same two phases). Steady state:
            # every read pays phase 1, a fraction re-pays the redo step
            # at full batch occupancy after host rebatching. The redo
            # consumes phase 1's device-resident sketches + bucket
            # probes (query_step_rows_redo_scan) — no re-sketch, no
            # bucket-row gather.
            from metacache_tpu.ops.rows import (query_step_rows_scan_head,
                                                query_step_rows_redo_scan)

            def query_scan_head(wk, vk, mk, tf, to, la, lb, ps, mt, lg):
                return query_step_rows_scan_head(
                    wk, vk, mk, tf, to, la, lb, mt, lg,
                    jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                    jnp.int32(0), ps,
                    k=opt.kmerlen, sketchlen=opt.sketchlen,
                    slots_per_feature=spf, max_candidates=2,
                    prefix_bits=bbits, dense=dense,
                    walk_elems=2 * opt.sketchlen, pack_bits=pkb,
                    prefetch=True, return_feats=True)

            cls1, over, fk, ik = query_scan_head(wk, vk, mk, *targs)
            nb = np.asarray(over).view(np.uint32)
            mask = np.unpackbits(
                nb.view(np.uint8), bitorder="little").astype(bool)
            frac = float(mask.sum() / (SCAN_K * B))
            np.asarray(cls1)
            hsum = _jax.jit(lambda *a: (
                lambda r: (r[0].sum(), r[1], r[2], r[3]))(
                    query_scan_head(*a)))
            np.asarray(hsum(wk, vk, mk, *targs)[0])
            t0 = time.time()
            prev = None
            for _ in range(iters):
                r = hsum(wk, vk, mk, *targs)
                if prev is not None:
                    np.asarray(prev[0])
                prev = r
            np.asarray(prev[0])
            t1_s = (time.time() - t0) / (iters * SCAN_K)

            # redo step timing at full occupancy: tile the flagged
            # rows' saved (feats, idx) to fill a (SCAN_K, B) stack
            idxs = np.nonzero(mask)[0]
            if len(idxs) == 0:
                idxs = np.arange(B)
            sel = np.resize(idxs, SCAN_K * B).astype(np.int32)
            selj = jnp.asarray(sel)
            F = fk.shape[-1]
            fsel = fk.reshape(-1, F)[selj].reshape(SCAN_K, B, F)
            isel = ik.reshape(-1, F)[selj].reshape(SCAN_K, B, F)
            msel = mk.reshape(SCAN_K * B)[selj].reshape(SCAN_K, B)
            tf, to, la, lb, ps, mt, lg = targs

            def redo(fs, is_, ms, *tbl):
                # tables arrive as ARGS (a closure-captured table would
                # bake into the wrapper jit as a multi-GB constant)
                tf_, to_, la_, lb_, mt_, lg_ = tbl
                return query_step_rows_redo_scan(
                    fs, is_, ms, tf_, to_, la_, lb_, mt_, lg_,
                    jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                    jnp.int32(0),
                    sketchlen=opt.sketchlen, slots_per_feature=spf,
                    max_candidates=2, prefix_bits=bbits, dense=dense,
                    walk_elems=2 * opt.sketchlen, pack_bits=pkb)

            tbl6 = (tf, to, la, lb, mt, lg)
            rsum = _jax.jit(lambda *a: redo(*a).sum())
            np.asarray(rsum(fsel, isel, msel, *tbl6))
            t0 = time.time()
            prev = None
            for _ in range(iters):
                r = rsum(fsel, isel, msel, *tbl6)
                if prev is not None:
                    np.asarray(prev)
                prev = r
            np.asarray(prev)
            tr_s = (time.time() - t0) / (iters * SCAN_K)

            eff = t1_s + frac * tr_s

            # fused dispatch (the runner's default): phase 1 of each
            # fresh batch + a frac*B redo slice in ONE scan iteration,
            # so the redo's sort can interleave with phase 1's row
            # gathers
            from metacache_tpu.ops.rows import (
                query_step_rows_scan_head_fused)
            b2 = max(256, -(-int(np.ceil(frac * B)) // 256) * 256)
            sel2 = jnp.asarray(np.resize(idxs, SCAN_K * b2)
                               .astype(np.int32))
            rfs = fk.reshape(-1, F)[sel2].reshape(SCAN_K, b2, F)
            ris = ik.reshape(-1, F)[sel2].reshape(SCAN_K, b2, F)
            rms = mk.reshape(-1)[sel2].reshape(SCAN_K, b2)

            def fused(wk_, vk_, mk_, rf, ri, rm, tf_, to_, la_,
                      lb_, mt_, lg_, ps_):
                return query_step_rows_scan_head_fused(
                    wk_, vk_, mk_, rf, ri, rm, tf_, to_, la_, lb_,
                    mt_, lg_,
                    jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                    jnp.int32(0), ps_,
                    k=opt.kmerlen, sketchlen=opt.sketchlen,
                    slots_per_feature=spf, max_candidates=2,
                    prefix_bits=bbits, dense=dense,
                    walk_elems=2 * opt.sketchlen, pack_bits=pkb)

            fsum = _jax.jit(lambda *a: (
                lambda r: (r[0].sum(),) + tuple(r[1:]))(fused(*a)))
            fargs = (wk, vk, mk, rfs, ris, rms, tf, to, la, lb, mt,
                     lg, ps)
            np.asarray(fsum(*fargs)[0])
            t0 = time.time()
            prev = None
            for _ in range(iters):
                r = fsum(*fargs)
                if prev is not None:
                    np.asarray(prev[0])
                prev = r
            np.asarray(prev[0])
            tf_s = (time.time() - t0) / (iters * SCAN_K)

            out["escalation"] = {
                "phase1_ms_per_batch": round(t1_s * 1000, 3),
                "redo_ms_per_batch": round(tr_s * 1000, 3),
                "full_ms_per_batch": round(dt_s * 1000, 3),
                "overflow_frac": round(frac, 4),
                "effective_ms_per_batch": round(eff * 1000, 3),
                "fused_ms_per_batch": round(tf_s * 1000, 3),
                "fused_redo_slice": b2,
                "best_mode": "fused" if tf_s < eff else "separate",
                "reads_per_min": round(B / min(eff, tf_s) * 60),
            }
            if min(eff, tf_s) < dt_s:
                best = min(eff, tf_s)
                out["reads_per_min"] = round(B / best * 60)
                out["ms_per_batch"] = round(best * 1000, 3)

        if long_reads:
            out["long"] = measure_long(dt, genomes, glen, mt, lg)
        return out

    def measure_long(dt, genomes, glen, mt, lg):
        """480 bp long reads (5 windows, dedup-walk sweep)."""
        from metacache_tpu.ops.windows import sequence_windows
        LB, LLEN, WQ = 2048, 480, 5
        spf, bbits = dt.spf, dt.bbits
        dense = dense_tag(dt)
        pkb = dt.slot_bits
        rng2 = np.random.default_rng(11)
        lsel = rng2.integers(0, len(genomes), LB)
        lpos = rng2.integers(0, glen - LLEN, LB)
        lwins = np.full((LB, WQ, opt.winlen), 4, np.uint8)
        lvalid = np.zeros((LB, WQ), np.int32)
        for i in range(LB):
            wm, vl = sequence_windows(
                genomes[lsel[i]][lpos[i]:lpos[i] + LLEN], opt)
            lwins[i, :len(wm)] = wm
            lvalid[i, :len(vl)] = vl
        lmwir = np.full(LB, 2 + LLEN // opt.winstride, np.int32)

        from metacache_tpu.ops.rows import query_step_rows_scan

        def query_scan_long(wk, vk, mk, tf, to, la, lb, ps, mt, lg):
            return query_step_rows_scan(
                wk, vk, mk, tf, to, la, lb, mt, lg,
                jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                jnp.int32(0), ps,
                k=opt.kmerlen, sketchlen=opt.sketchlen,
                slots_per_feature=spf, windows_per_query=WQ,
                max_candidates=2, prefix_bits=bbits, prefix_steps=0,
                dense=dense,
                dedup_walk=2 + LLEN // opt.winstride, fast_top2=True,
                pack_bits=pkb,
                prefetch=bool(dense))

        k = SCAN_K
        lwk = jnp.asarray(np.broadcast_to(
            lwins[None], (k,) + lwins.shape).copy())
        lvk = jnp.asarray(np.broadcast_to(
            lvalid[None], (k,) + lvalid.shape).copy())
        lmk = jnp.asarray(np.broadcast_to(
            lmwir[None], (k,) + lmwir.shape).copy())
        targs = (dt.uniq, dt.offsets, dt.head, dt.ovf, dt.brows, mt, lg)
        import jax as _jax
        lcls = np.asarray(query_scan_long(lwk, lvk, lmk, *targs))
        lsum = _jax.jit(lambda *a: query_scan_long(*a).sum())
        np.asarray(lsum(lwk, lvk, lmk, *targs))
        t0 = time.time()
        prev = None
        it = max(ITERS // 2, 2)
        for _ in range(it):
            r = lsum(lwk, lvk, lmk, *targs)
            if prev is not None:
                np.asarray(prev)
            prev = r
        np.asarray(prev)
        ldt = (time.time() - t0) / (it * k)
        return {
            "reads_per_min_480bp": round(LB / ldt * 60),
            "classified_fraction": round(float((lcls[0] != 0).mean()),
                                         4),
        }

    def measure_e2e(genomes, glen):
        """File-to-output throughput: FASTA on disk -> native C++
        reader -> 2-bit packed infeed -> device scan -> summary stats
        (and a -tophits per-read-output variant), through the real CLI
        plumbing (build_database + map_queries_to_targets). This is the
        number comparable to the reference's 110M reads/min (its
        benchmarks are end-to-end from files)."""
        import subprocess
        import tempfile
        from metacache_tpu.cli.main import Args, parse_query_options
        from metacache_tpu.classify.runner import (
            ClassificationResults, map_queries_to_targets)
        from metacache_tpu.db.build import BuildOptions, build_database

        tmp = tempfile.mkdtemp(prefix="mc_e2e_")
        gfa = os.path.join(tmp, "genomes.fa")
        b2a = np.frombuffer(b"ACGT", np.uint8)
        with open(gfa, "wb") as fh:
            for i, g in enumerate(genomes):
                fh.write(b">g%d\n" % i)
                fh.write(b2a[g].tobytes())
                fh.write(b"\n")
        nreads = int(os.environ.get("MC_BENCH_E2E_READS", 2_000_000))
        rfa = os.path.join(tmp, "reads.fa")
        rng3 = np.random.default_rng(13)
        gsel = rng3.integers(0, len(genomes), nreads)
        pos = rng3.integers(0, glen - READ_LEN, nreads)
        with open(rfa, "wb") as fh:
            chunk = 65536
            for c0 in range(0, nreads, chunk):
                rows = []
                for i in range(c0, min(c0 + chunk, nreads)):
                    rd = genomes[gsel[i]][pos[i]:pos[i] + READ_LEN]
                    rows.append(b">r%d\n%s\n" % (i, b2a[rd].tobytes()))
                fh.write(b"".join(rows))

        bopt = BuildOptions(infiles=[gfa], device_tables=True)
        db = build_database(bopt)

        def run(flags, infile, n):
            opt, _, _ = parse_query_options(Args(list(flags)))
            devnull = open(os.devnull, "w")
            results = ClassificationResults(devnull, devnull, devnull)
            t0 = time.time()
            map_queries_to_targets([infile], db, opt, results)
            dt = time.time() - t0
            devnull.close()
            return round(n / dt * 60), dt

        # warm the compile caches (summary, per-read tophits AND
        # default-mapping shapes — the per-read paths run 65536-read
        # batches, so the warm file must reach that batch shape or the
        # compile lands inside the timed run)
        wfa = os.path.join(tmp, "warm.fa")
        with open(rfa, "rb") as src, open(wfa, "wb") as dst:
            for _ in range(2 * 66000):
                dst.write(src.readline())
        run(["-no-map", "-no-summary", "-no-query-params"], wfa, 1)
        run(["-tophits", "-no-summary", "-no-query-params"], wfa, 1)
        run(["-no-summary", "-no-query-params"], wfa, 1)

        rpm_sum, dt_sum = run(
            ["-no-map", "-no-summary", "-no-query-params"], rfa, nreads)
        rpm_sum4, _ = run(
            ["-no-map", "-no-summary", "-no-query-params",
             "-threads", "4"], rfa, nreads)
        ntop = min(nreads, 500_000)
        tfa = os.path.join(tmp, "reads_top.fa")
        with open(rfa, "rb") as src, open(tfa, "wb") as dst:
            for _ in range(2 * ntop):
                dst.write(src.readline())
        rpm_top, dt_top = run(
            ["-tophits", "-no-summary", "-no-query-params"], tfa, ntop)

        # the DEFAULT mode: one mapping line per read written to a file
        # (the reference's 110M reads/min benchmark includes exactly
        # this output)
        mapfile = os.path.join(tmp, "map.out")

        def run_map(flags, infile, n):
            opt2, _, _ = parse_query_options(Args(list(flags)))
            mf = open(mapfile, "w")
            devnull = open(os.devnull, "w")
            results = ClassificationResults(mf, devnull, devnull)
            t0 = time.time()
            map_queries_to_targets([infile], db, opt2, results)
            dtm = time.time() - t0
            mf.close()
            devnull.close()
            return round(n / dtm * 60), dtm
        rpm_map, _ = run_map(["-no-summary", "-no-query-params"],
                             tfa, ntop)

        # decomposition: which stage bounds e2e?
        # 1. reader-only: native parse+pack of the same file, discarded
        from metacache_tpu import native
        wl = db.sketching.winlen
        def read_only(nthreads):
            import threading as _th
            fsz = os.path.getsize(rfa)
            cuts = [fsz * i // nthreads for i in range(nthreads + 1)]
            rds = [native.NativeFastxReader(rfa, max_len=256,
                                            start=cuts[i],
                                            end=cuts[i + 1])
                   for i in range(nthreads)]
            tot = [0] * nthreads

            def work(i):
                while True:
                    item = rds[i].read_batch_packed(32768, wl)
                    if item[5] == 0:
                        break
                    tot[i] += len(item[1]) + len(item[3])
            t0 = time.time()
            ths = [_th.Thread(target=work, args=(i,))
                   for i in range(nthreads)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            dtr = time.time() - t0
            for r in rds:
                r.close()
            return round(sum(tot) / dtr * 60)
        rpm_read = read_only(1)
        rpm_read4 = read_only(4)
        # 2. infeed-only: h2d of the packed infeed layout + a trivial
        # device reduction per batch (no classification work)
        ps = (wl + 3) // 4
        binf = 65536
        arr = np.random.randint(0, 255, (binf, ps), np.uint8)
        import jax as _jax

        @_jax.jit
        def _touch(x):
            return x[0, 0] + x[-1, -1]

        np.asarray(_touch(jnp.asarray(arr)))
        t0 = time.time()
        nb = max(nreads // binf, 8)
        for _ in range(nb):
            np.asarray(_touch(jnp.asarray(arr)))
        rpm_infeed = round(nb * binf / (time.time() - t0) * 60)
        subprocess.run(["rm", "-rf", tmp], check=False)
        return {
            "e2e_reads_per_min": rpm_sum,
            "e2e_seconds": round(dt_sum, 2),
            "e2e_reads": nreads,
            "e2e_tophits_reads_per_min": rpm_top,
            "e2e_tophits_reads": ntop,
            "e2e_map_reads_per_min": rpm_map,
            "e2e_threads4_reads_per_min": rpm_sum4,
            "reader_only_reads_per_min": rpm_read,
            "reader_only_t4_reads_per_min": rpm_read4,
            "infeed_only_reads_per_min": rpm_infeed,
            "infeed_bytes_per_read": ps,
            "d2h_bytes_per_read_map": 4,          # cls only (micro)
            "d2h_bytes_per_read_tophits": 4 * (3 * 2 + 1),
        }

    def _preset_loop(dt, genomes, species, glen, popt, rlen, scan_k=16,
                     iters=3):
        """Device scan-loop throughput for one sketching preset."""
        from metacache_tpu.ops.rows import query_step_rows_scan
        ntgt = len(genomes)
        lineages, merge_tax = lineage_arrays(species)
        mt, lg = jnp.asarray(merge_tax), jnp.asarray(lineages)
        rng2 = np.random.default_rng(17)
        gsel = rng2.integers(0, ntgt, B)
        pos = rng2.integers(0, glen - rlen, B)
        wins = np.full((B, 1, popt.winlen), 4, np.uint8)
        for i in range(B):
            wins[i, 0, :rlen] = genomes[gsel[i]][pos[i]:pos[i] + rlen]
        valid = np.full((B, 1), rlen, np.int32)
        mwir = np.full(B, 2, np.int32)
        dense = dense_tag(dt)

        def qscan(wk, vk, mk, tf, to, la, lb, ps, mt_, lg_):
            # tables as ARGS — closure-captured tables would bake into
            # the qs wrapper jit as constants
            return query_step_rows_scan(
                wk, vk, mk, tf, to, la, lb, mt_, lg_,
                jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                jnp.int32(0), ps,
                k=popt.kmerlen, sketchlen=popt.sketchlen,
                slots_per_feature=dt.spf, windows_per_query=1,
                max_candidates=2, prefix_bits=dt.bbits, prefix_steps=0,
                dense=dense,
                walk_elems=2 * popt.sketchlen, fast_top2=True,
                pack_bits=dt.slot_bits,
                prefetch=bool(dt.dense))

        wk = jnp.asarray(np.broadcast_to(
            wins[None], (scan_k,) + wins.shape).copy())
        vk = jnp.asarray(np.broadcast_to(
            valid[None], (scan_k,) + valid.shape).copy())
        mk = jnp.asarray(np.broadcast_to(
            mwir[None], (scan_k,) + mwir.shape).copy())
        targs = (dt.uniq, dt.offsets, dt.head, dt.ovf, dt.brows,
                 mt, lg)
        import jax as _jax
        cls = np.asarray(qscan(wk, vk, mk, *targs))
        qs = _jax.jit(lambda *a: qscan(*a).sum())
        np.asarray(qs(wk, vk, mk, *targs))
        t0 = time.time()
        prev = None
        for _ in range(iters):
            r = qs(wk, vk, mk, *targs)
            if prev is not None:
                np.asarray(prev)
            prev = r
        np.asarray(prev)
        dt_s = (time.time() - t0) / (iters * scan_k)
        return {
            "reads_per_min": round(B / dt_s * 60),
            "ms_per_batch": round(dt_s * 1000, 3),
            "classified_fraction": round(float((cls[0] != 0).mean()),
                                         4),
            "db_locations": dt.num_locations,
            "max_bucket": dt.spf,
        }

    def measure_preset_w255(rng):
        """Reference "small" preset: winlen 255, 250 bp reads."""
        popt = SketchingOptions(winlen=255).resolved()
        genomes, species = make_strain_genomes(rng, [(16, 4, 0.01)],
                                               GLEN)
        from metacache_tpu.db.sketch_exec import DeviceSketchAccumulator
        from metacache_tpu.ops import windows as W
        from metacache_tpu.ops.table_device import \
            build_device_table_chunked
        acc = DeviceSketchAccumulator(popt.kmerlen, popt.sketchlen)
        for tid, g in enumerate(genomes):
            wm, vl = W.sequence_windows(g, popt)
            acc.add_target(wm, vl, tid)
        dt = build_device_table_chunked(acc.finish_chunks(), cap=254)
        out = _preset_loop(dt, genomes, species, GLEN, popt, rlen=250)
        out["winlen"] = 255
        return out

    def measure_preset_k18(rng):
        """kmerlen 18 (u64 features) through the u64-native fused-row
        device layout ([flo, fhi, ...] meta + low-32 bucket index)."""
        from metacache_tpu.ops.table import (FeatureTable,
                                             unpack_locations)
        from metacache_tpu.ops.table_device import device_layout_from_csr
        from metacache_tpu.db.sketch_exec import SketchAccumulator
        from metacache_tpu.ops import windows as W
        from metacache_tpu.utils.platform import ensure_feature_width
        ensure_feature_width(18)
        popt = SketchingOptions(kmerlen=18).resolved()
        genomes, species = make_strain_genomes(rng, [(8, 4, 0.01)],
                                               GLEN)
        acc = SketchAccumulator(popt.kmerlen, popt.sketchlen)
        for tid, g in enumerate(genomes):
            wm, vl = W.sequence_windows(g, popt)
            acc.add_target(wm, vl, tid)
        bf, bl = acc.finish()
        ft = FeatureTable.build(bf, bl, 254,
                                presorted_within_feature=True)
        ltgt, lwin = unpack_locations(ft.locations)
        dt = device_layout_from_csr(ft.unique_features, ft.offsets,
                                    ltgt, lwin, cap=254)
        out = _preset_loop(dt, genomes, species, GLEN, popt,
                           rlen=READ_LEN)
        out["kmerlen"] = 18
        out["layout"] = "u64_dense" if dt.dense else "u64_two_tier"
        return out

    # ------- 1. toy strain DB (round-1 comparable) ----------------------
    GLEN = 1_000_000
    genomes, species = make_strain_genomes(rng, [(16, 4, 0.01)], GLEN)
    dt_first, build_cold_s = build_db(genomes, opt)
    del dt_first
    gc.collect()
    # steady-state build speed: the first build pays every jit's
    # compile/cache-load (one-time per process — the reference binary
    # is AOT-compiled, so only the warm number is comparable);
    # build_plus_compile_seconds records the one-time cost honestly
    dt_toy, build_toy_s = build_db(genomes, opt)
    toy = measure(dt_toy, genomes, species, GLEN, long_reads=True)
    toy_detail = {
        "db_features": dt_toy.nf,
        "db_locations": dt_toy.num_locations,
        "build_seconds": round(build_toy_s, 1),
        "build_plus_compile_seconds": round(build_cold_s, 1),
        "max_bucket": dt_toy.spf,
        "layout": "dense" if dt_toy.dense else
                  ("classed" if dt_toy.classed else
                   f"two_tier(head={dt_toy.head_slots})"),
    }
    del dt_toy
    gc.collect()
    toy["e2e"] = measure_e2e(genomes, GLEN)
    toy_detail.update(toy)
    del genomes
    gc.collect()

    # ------- 1b. sharding overhead (single chip, 1x1 mesh) --------------
    # quantifies the shard_map + all_to_all(P=1) machinery cost of the
    # -table-shards path relative to the plain step on identical shapes,
    # so multi-chip projections have a measured overhead term
    def measure_sharding_overhead():
        import time as _t

        import jax
        from metacache_tpu.ops.table import FeatureTable, pack_locations
        from metacache_tpu.ops.rows import query_step_rows
        from metacache_tpu.parallel import mesh as M
        from metacache_tpu.parallel.rows_mesh import (
            shard_row_table, sharded_query_step_rows)

        rngs = np.random.default_rng(5)
        f = np.unique(rngs.integers(0, 2**32, 400_000,
                                    dtype=np.uint64).astype(np.uint32))
        t = rngs.integers(0, 64, len(f)).astype(np.uint32)
        w = rngs.integers(0, 500, len(f)).astype(np.uint32)
        ft = FeatureTable.build(f, pack_locations(t, w))
        st = shard_row_table(ft, 1, 254)
        lin = np.zeros((64, 21), np.int32)
        lin[:, 0] = -np.arange(64) - 1
        lin[:, 20] = 1
        mt2, lg2 = jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin)
        wins2 = rng.integers(0, 4, (B, 1, opt.winlen)).astype(np.uint8)
        vm = np.full((B, 1), READ_LEN, np.int32)
        mw = np.full(B, 2, np.int32)
        args_sh = (jnp.asarray(wins2), jnp.asarray(vm), jnp.asarray(mw),
                   jnp.asarray(st.features), jnp.asarray(st.offsets),
                   jnp.asarray(st.loc_tgt2d), jnp.asarray(st.loc_win2d),
                   jnp.asarray(st.prefix), mt2, lg2,
                   jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
                   jnp.int32(0))
        mesh = M.make_mesh(1, 1, devices=jax.devices()[:1])
        kw = dict(k=opt.kmerlen, sketchlen=opt.sketchlen,
                  slots_per_feature=st.slots_per_feature,
                  windows_per_query=1, max_candidates=2,
                  prefix_bits=st.prefix_bits,
                  prefix_steps=st.prefix_steps)

        def timeit(fn, args, it=4):
            np.asarray(fn(*args).cls_tax)
            t0 = _t.time()
            for _ in range(it):
                r = fn(*args)
            np.asarray(r.cls_tax)
            return (_t.time() - t0) / it * 1000

        sh_ms = timeit(lambda *a: sharded_query_step_rows(
            *a, mesh=mesh, **kw), args_sh)
        from metacache_tpu.ops.probe import make_bucket_index
        brows, bits = make_bucket_index(ft.unique_features)
        fused = ft.fused_rows(st.slots_per_feature)
        args_pl = (jnp.asarray(wins2), jnp.asarray(vm), jnp.asarray(mw),
                   jnp.asarray(ft.unique_features),
                   jnp.asarray(ft.offsets.astype(np.int32)),
                   jnp.asarray(fused), jnp.zeros((1,), jnp.int32),
                   mt2, lg2, jnp.int32(5), jnp.float32(1.0),
                   jnp.int32(19), jnp.int32(0), jnp.asarray(brows))
        pl_ms = timeit(lambda *a: query_step_rows(
            *a, k=opt.kmerlen, sketchlen=opt.sketchlen,
            slots_per_feature=st.slots_per_feature, windows_per_query=1,
            max_candidates=2, prefix_bits=bits, prefix_steps=0,
            dense=True), args_pl)
        # all_to_all exchange volume of the sharded step: each device
        # sends (P-1)/P of its (b_loc, slots) pk matrix; the head-only
        # escalation phase exchanges head_slots-wide rows instead
        slots = opt.sketchlen * st.slots_per_feature
        hs = min(61, st.slots_per_feature)
        return {"plain_ms": round(pl_ms, 3),
                "sharded_1x1_ms": round(sh_ms, 3),
                "overhead_pct": round((sh_ms / pl_ms - 1) * 100, 1),
                "all_to_all_bytes_per_read_full": 4 * slots,
                "all_to_all_bytes_per_read_head": 4 * opt.sketchlen *
                hs,
                "sketch_exchange_bytes_per_read": 4 * opt.sketchlen}

    toy_detail["sharding_overhead"] = measure_sharding_overhead()

    # ------- 2. RefSeq-skew DB (scale proof) ----------------------------
    big_detail = {}
    if os.environ.get("MC_BENCH_SMALL") != "1":
        genomes, species = make_strain_genomes(rng, REFSEQ_SKEW, GLEN)
        dt_big, build_big_s = build_db(genomes, opt)
        big = measure(dt_big, genomes, species, GLEN,
                      iters=max(ITERS // 2, 2))
        big_detail = {
            "total_mbp": len(genomes),
            "db_features": dt_big.nf,
            "db_locations": dt_big.num_locations,
            "locations_gib": round(dt_big.num_locations * 8 / 2**30, 2),
            "build_seconds": round(build_big_s, 1),
            "max_bucket": dt_big.spf,
            "layout": "dense" if dt_big.dense else
                      ("classed" if dt_big.classed else
                       f"two_tier(head={dt_big.head_slots})"),
            "layout_gib": round(dt_big.layout_bytes / 2**30, 2),
            "bucket_index_gib": round(
                int(np.prod(dt_big.brows.shape)) * 4 / 2**30, 2),
            **big,
        }
        del dt_big, genomes
        gc.collect()

    # ------- 3. XXL DB: size-classed head layout ------------------------
    # ~2.9x the locations of section 2 under the size-classed head
    # layout (~2.0 resident bytes per location-byte + 0.5 index).
    # Forces MC_CLASSED=1 for this section.
    xxl_detail = {}
    if os.environ.get("MC_BENCH_XXL", "1") == "1" and \
            os.environ.get("MC_BENCH_SMALL") != "1":
        mc_prev = os.environ.get("MC_CLASSED")
        os.environ["MC_CLASSED"] = "1"
        try:
            genomes, species = make_strain_genomes(
                rng, [(96, 1, 0.0), (36, 52, 0.003), (3, 256, 0.003)],
                GLEN)
            dt_x, build_x_s = build_db(genomes, opt)
            xxl = measure(dt_x, genomes, species, GLEN, iters=2)
            xxl_detail = {
                "total_mbp": len(genomes),
                "db_locations": dt_x.num_locations,
                "locations_gib": round(dt_x.num_locations * 8 / 2**30,
                                       2),
                "build_seconds": round(build_x_s, 1),
                "layout": "dense" if dt_x.dense else
                          ("classed" if dt_x.classed else
                           f"two_tier(head={dt_x.head_slots})"),
                "layout_gib": round(dt_x.layout_bytes / 2**30, 2),
                **xxl,
            }
            del dt_x, genomes
        finally:
            if mc_prev is None:
                os.environ.pop("MC_CLASSED", None)
            else:
                os.environ["MC_CLASSED"] = mc_prev

    # ------- 4. reference preset sections -------------------------------
    # winlen 255 (the reference "small" preset, metacache-build-refseq:
    # 57-58) and kmerlen 18 (u64 features, searchsorted+CSR probe). Both
    # device-loop numbers, comparable to the toy section.
    presets = {}
    if os.environ.get("MC_BENCH_SMALL") != "1":
        presets["winlen255"] = measure_preset_w255(rng)
        presets["k18_u64"] = measure_preset_k18(rng)

    out = {
        "metric": "100bp read classification throughput (1 device, "
                  "64x1Mbp strain DB)",
        "value": toy["reads_per_min"],
        "unit": "reads/min",
        "vs_baseline": round(toy["reads_per_min"] / 300e6, 4),
        "detail": {
            "toy_db": toy_detail,
            "bigdb_944mbp_maxbucket254": big_detail,
            "xxl_db_single_chip": xxl_detail,
            "presets": presets,
            "batch_reads": B,
            "scan_batches_per_dispatch": SCAN_K,
            "devices": [str(d) for d in __import__("jax").devices()],
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
