"""fast_top2 candidate path vs the sort-based path: exact parity.

The fast path (ops.rows._fast_top2_result) replaces the best-per-target,
taxon-merge and final-ranking bitonic sorts with one segmented suffix-max
scan when merge_rank == 0 (no taxon merging). These tests drive
rows_to_result directly with randomized slot rows through all three
sweep strategies (rank-join, lane-walk, dedup-walk) and assert the full
QueryResult matches the sorted path element for element.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from metacache_tpu.ops.rows import rows_to_result, I32_MAX

NR = 21


def _random_slots(rng, b, l, ntgt, nwin, fill=0.6, dup=False):
    """(B, L) slot rows: random (tgt, win) matches + I32_MAX padding."""
    tgt = np.full((b, l), I32_MAX, np.int32)
    win = np.full((b, l), I32_MAX, np.int32)
    for i in range(b):
        n = int(rng.integers(0, int(l * fill) + 1))
        t = rng.integers(0, ntgt, n).astype(np.int32)
        w = rng.integers(0, nwin, n).astype(np.int32)
        if dup and n > 4:
            # force duplicate (t, w) runs (the long-read regime)
            reps = rng.integers(0, n, n // 2)
            t[: n // 2] = t[reps]
            w[: n // 2] = w[reps]
        tgt[i, :n] = t
        win[i, :n] = w
    return tgt, win


def _lineages(ntgt):
    lin = np.zeros((ntgt, NR), np.int32)
    lin[:, 0] = -np.arange(ntgt) - 1    # sequence-level taxon ids
    lin[:, 4] = np.arange(ntgt) // 2 + 100
    lin[:, 20] = 1
    return lin


def _run(tgt, win, mwir, lin, maxcand, fast, **sweep):
    merge_tax = lin[:, 0].copy()        # merge_rank == 0
    res = rows_to_result(
        jnp.asarray(tgt), jnp.asarray(win), jnp.asarray(mwir),
        jnp.asarray(merge_tax), jnp.asarray(lin),
        jnp.int32(1), jnp.float32(0.5), jnp.int32(19), jnp.int32(0),
        max_candidates=maxcand, fast_top2=fast, **sweep)
    return {f: np.asarray(getattr(res, f))
            for f in ("cand_tgt", "cand_tax", "cand_hits", "cand_beg",
                      "cand_end", "cls_tax")}


@pytest.mark.parametrize("maxcand", [2, 4])
@pytest.mark.parametrize("sweep", [{}, {"walk_elems": 12},
                                   {"dedup_walk": 6}])
def test_fast_top2_parity(maxcand, sweep):
    rng = np.random.default_rng(42)
    b, l, ntgt = 64, 96, 12
    lin = _lineages(ntgt)
    for trial in range(4):
        dup = bool(sweep.get("dedup_walk"))
        tgt, win = _random_slots(rng, b, l, ntgt, nwin=40, dup=dup)
        if sweep.get("walk_elems"):
            # walk_elems asserts a bound on slots per range: use a small
            # mwir and enough window spread that ranges stay short
            mwir = np.full(b, 3, np.int32)
        elif sweep.get("dedup_walk"):
            mwir = np.full(b, sweep["dedup_walk"], np.int32)
        else:
            mwir = rng.integers(2, 8, b).astype(np.int32)
        slow = _run(tgt, win, mwir, lin, maxcand, False, **sweep)
        fast = _run(tgt, win, mwir, lin, maxcand, True, **sweep)
        for f in slow:
            np.testing.assert_array_equal(
                slow[f], fast[f],
                err_msg=f"trial {trial} sweep {sweep} field {f}")


def test_fast_top2_wide_rows_i64():
    """L large enough that the packed key needs the int64 scan
    (L * next_pow2(L)^2 >= 2^31 — the deep-bucket regime, spf ~ 254)."""
    rng = np.random.default_rng(7)
    b, l, ntgt = 8, 1536, 1200
    lin = _lineages(ntgt)
    # the group-isolation term g*kb must actually exceed int32 range
    # (deep reads hit hundreds of distinct strain targets per row)
    assert ntgt * (1 << l.bit_length()) ** 2 >= 2**31
    tgt, win = _random_slots(rng, b, l, ntgt, nwin=500, fill=0.9)
    mwir = rng.integers(2, 6, b).astype(np.int32)
    slow = _run(tgt, win, mwir, lin, 2, False)
    fast = _run(tgt, win, mwir, lin, 2, True)
    for f in slow:
        np.testing.assert_array_equal(slow[f], fast[f], err_msg=f)


def test_fast_top2_empty_rows():
    lin = _lineages(4)
    tgt = np.full((8, 32), I32_MAX, np.int32)
    win = np.full((8, 32), I32_MAX, np.int32)
    mwir = np.full(8, 3, np.int32)
    fast = _run(tgt, win, mwir, lin, 2, True)
    assert (fast["cand_tgt"] == -1).all()
    assert (fast["cls_tax"] == 0).all()


@pytest.mark.parametrize("sweep", [{}, {"walk_elems": 12},
                                   {"dedup_walk": 6}])
@pytest.mark.parametrize("fast", [False, True])
def test_pack_bits_parity(sweep, fast):
    """rows_to_result(pack_bits=w) over pk slots == unpacked path."""
    rng = np.random.default_rng(67)
    b, l, ntgt, nwin = 48, 192, 12, 40
    wbits = max(1, (2 * (nwin - 1)).bit_length())
    lin = _lineages(ntgt)
    for trial in range(2):
        tgt, win = _random_slots(rng, b, l, ntgt, nwin,
                                 dup="dedup_walk" in sweep)
        mwir = np.full(b, 5, np.int32)
        ref = _run(tgt, win, mwir, lin, 2, fast, **sweep)
        pk = (tgt.astype(np.int64) << wbits) | win
        pk = np.where(tgt == I32_MAX, I32_MAX,
                      pk).astype(np.int32)
        got = _run(pk, pk, mwir, lin, 2, fast, pack_bits=wbits, **sweep)
        for k in ref:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_scan_infeed_packed_parity():
    """query_step_rows_scan(infeed_packed=True) over 2-bit packed codes
    == the unpacked scan on the same reads."""
    import jax.numpy as jnp
    from metacache_tpu.ops.rows import query_step_rows_scan
    from metacache_tpu.ops.table import FeatureTable, pack_locations

    rng = np.random.default_rng(71)
    K, B, WL = 2, 16, 128
    # tiny table from random (feature, tgt, win) stream
    f = rng.integers(0, 2**32, 400, dtype=np.uint32)
    t = np.sort(rng.integers(0, 8, 400)).astype(np.int32)
    w = rng.integers(0, 50, 400).astype(np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(),
                            pack_locations(t[order], w[order]),
                            max_locations_per_feature=16)
    lin = _lineages(8)
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    mwir = np.full((K, B), 2, np.int32)
    c4 = codes.reshape(K, B, 1, WL // 4, 4)
    packed = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4) |
              (c4[..., 3] << 6))
    spf = max(min(ft.max_bucket_size, 16), 1)
    fused = ft.fused_rows(spf)
    args = (jnp.asarray(ft.unique_features),
            jnp.asarray(ft.offsets.astype(np.int32)),
            jnp.asarray(fused), jnp.zeros((1,), jnp.int32),
            jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(1), jnp.float32(0.5), jnp.int32(19),
            jnp.int32(0), None)
    kw = dict(k=16, sketchlen=16, slots_per_feature=spf,
              windows_per_query=1, max_candidates=2, dense=True,
              walk_elems=8, fast_top2=True)
    ref = query_step_rows_scan(jnp.asarray(codes), jnp.asarray(lens),
                               jnp.asarray(mwir), *args, **kw)
    got = query_step_rows_scan(jnp.asarray(packed), jnp.asarray(lens),
                               jnp.asarray(mwir), *args,
                               infeed_packed=True, **kw)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_native_packed_reader_parity(tmp_path):
    """fastx_read_packed == raw reader + host 2-bit packing, and its
    side stream carries exactly the long/ambiguous reads."""
    from metacache_tpu import native
    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "r.fa"
    recs = []
    for i in range(500):
        ln = int(rng.integers(20, 140))
        seq = b2a[rng.integers(0, 4, ln)].tobytes()
        if i % 11 == 0:
            seq = seq[:4] + b"N" + seq[5:]
        if i % 23 == 0:
            seq = b2a[rng.integers(0, 4, 300)].tobytes()
        recs.append(b">r%d x\n" % i + seq + b"\n")
    fa.write_bytes(b"".join(recs))
    wl = 127
    rd = native.NativeFastxReader(str(fa), max_len=512)
    pk, pl, sc, sl, sh, consumed = rd.read_batch_packed(1000, wl)
    rd.close()
    assert consumed == 500
    rd2 = native.NativeFastxReader(str(fa), max_len=512)
    codes, lens, _ = rd2.read_batch_raw(1000)
    rd2.close()
    pos = np.arange(min(codes.shape[1], wl))
    has_n = ((codes[:, :wl] >= 4) &
             (pos[None, :] < lens[:, None])).any(axis=1)
    clean = (lens <= wl) & ~has_n
    assert clean.sum() == len(pl) and (lens[clean] == pl).all()
    assert (~clean).sum() == len(sl) and (lens[~clean] == sl).all()
    wl4 = -(-wl // 4)
    c4 = np.zeros((int(clean.sum()), wl4 * 4), np.uint8)
    c4[:, :wl] = codes[clean, :wl] & 3
    ref = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4) |
           (c4[:, 3::4] << 6))
    np.testing.assert_array_equal(ref, pk)
    np.testing.assert_array_equal(sc[:, :wl], codes[~clean][:, :wl])


def test_scan_native_packed_summary_parity(tmp_path, monkeypatch):
    """The native packed-reader summary loop (device rank histogram)
    produces the same per-rank counts as the unpacked scan path."""
    from metacache_tpu import native
    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    from metacache_tpu.cli.main import Args, parse_query_options
    from metacache_tpu.classify.runner import (ClassificationResults,
                                               map_queries_to_targets)
    from metacache_tpu.db.build import BuildOptions, build_database
    monkeypatch.setenv("MC_SCAN_K", "2")
    rng = np.random.default_rng(9)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    genomes = [rng.integers(0, 4, 20000, dtype=np.uint8)
               for _ in range(4)]
    gfa = tmp_path / "g.fa"
    with open(gfa, "wb") as fh:
        for i, g in enumerate(genomes):
            fh.write(b">g%d\n" % i + b2a[g].tobytes() + b"\n")
    rfa = tmp_path / "r.fa"
    with open(rfa, "wb") as fh:
        for i in range(700):
            gs = int(rng.integers(0, 4))
            p = int(rng.integers(0, 20000 - 160))
            ln = int(rng.integers(60, 160))
            sq = b2a[genomes[gs][p:p + ln]].tobytes()
            if i % 13 == 0:
                sq = sq[:3] + b"N" + sq[4:]
            fh.write(b">r%d\n" % i + sq + b"\n")
    db = build_database(BuildOptions(infiles=[str(gfa)]))

    def run(packed: str):
        monkeypatch.setenv("MC_PACK_INFEED", packed)
        qopt, _, _ = parse_query_options(
            Args(["-no-map", "-no-query-params"]))
        import io
        out = io.StringIO()
        res = ClassificationResults(out, out, out)
        map_queries_to_targets([str(rfa)], db, qopt, res)
        return res.query_count, res.statistics.assigned_.copy()

    qa, ha = run("1")
    qb, hb = run("0")
    assert qa == qb == 700
    np.testing.assert_array_equal(ha, hb)


def test_escalation_summary_parity(tmp_path, monkeypatch):
    """Escalation (head-only phase 1 + full-depth redo) produces the
    same summary as the plain full-depth scan on a deep-bucket DB
    forced into the two-tier layout."""
    from metacache_tpu import native
    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    from metacache_tpu.cli.main import Args, parse_query_options
    from metacache_tpu.classify.runner import (ClassificationResults,
                                               QueryOptions, QueryRunner,
                                               map_queries_to_targets)
    from metacache_tpu.db.build import BuildOptions, build_database
    monkeypatch.setenv("MC_SCAN_K", "2")
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    rng = np.random.default_rng(3)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    genomes = []
    for _ in range(2):
        base = rng.integers(0, 4, 20000, dtype=np.uint8)
        for _s in range(70):      # deep buckets (~70 > any head width)
            g = base.copy()
            pos = rng.integers(0, 20000, 40)
            g[pos] = rng.integers(0, 4, 40)
            genomes.append(g)
    for _ in range(6):
        genomes.append(rng.integers(0, 4, 20000, dtype=np.uint8))
    gfa = tmp_path / "g.fa"
    with open(gfa, "wb") as fh:
        for i, g in enumerate(genomes):
            fh.write(b">g%d\n" % i + b2a[g].tobytes() + b"\n")
    rfa = tmp_path / "r.fa"
    with open(rfa, "wb") as fh:
        for i in range(1500):
            gs = int(rng.integers(0, len(genomes)))
            p = int(rng.integers(0, 20000 - 120))
            ln = int(rng.integers(60, 120))
            fh.write(b">r%d\n" % i +
                     b2a[genomes[gs][p:p + ln]].tobytes() + b"\n")
    db = build_database(BuildOptions(infiles=[str(gfa)]))
    qr = QueryRunner(db, QueryOptions())
    assert qr._escalation_ok(), (qr._dense[0], qr._tables[0][4])

    def run(esc):
        monkeypatch.setenv("MC_ESCALATE", esc)
        qopt, _, _ = parse_query_options(
            Args(["-no-map", "-no-query-params", "-batch-size", "512"]))
        import io
        out = io.StringIO()
        res = ClassificationResults(out, out, out)
        map_queries_to_targets([str(rfa)], db, qopt, res)
        return res.query_count, res.statistics.assigned_.copy()

    qa, ha = run("1")
    qb, hb = run("0")
    assert qa == qb == 1500
    np.testing.assert_array_equal(ha, hb)
    # fused-escalation variant (phase 2 rides inside the phase-1 scan)
    monkeypatch.setenv("MC_ESC_FUSED", "1")
    monkeypatch.setenv("MC_ESC_B2", "256")
    qc, hc = run("1")
    monkeypatch.delenv("MC_ESC_FUSED")
    monkeypatch.delenv("MC_ESC_B2")
    assert qc == 1500
    np.testing.assert_array_equal(ha, hc)


def test_scan_prefetch_parity():
    """query_step_rows_scan(prefetch=True) — the software-pipelined
    scan — returns exactly the plain scan's classifications."""
    import jax.numpy as jnp
    from metacache_tpu.ops.probe import make_bucket_index
    from metacache_tpu.ops.rows import query_step_rows_scan
    from metacache_tpu.ops.table import FeatureTable, pack_locations

    rng = np.random.default_rng(77)
    K, B, WL = 3, 32, 128
    f = rng.integers(0, 2**32, 600, dtype=np.uint32)
    t = np.sort(rng.integers(0, 8, 600)).astype(np.int32)
    w = rng.integers(0, 50, 600).astype(np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(),
                            pack_locations(t[order], w[order]),
                            max_locations_per_feature=16)
    lin = _lineages(8)
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    lens[1, 3] = 0
    mwir = rng.integers(2, 5, (K, B)).astype(np.int32)
    spf = max(min(ft.max_bucket_size, 16), 1)
    fused = ft.fused_rows(spf)
    brows, bits = make_bucket_index(ft.unique_features)
    args = (jnp.asarray(ft.unique_features),
            jnp.asarray(ft.offsets.astype(np.int32)),
            jnp.asarray(fused), jnp.zeros((1,), jnp.int32),
            jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(1), jnp.float32(0.5), jnp.int32(19),
            jnp.int32(0), jnp.asarray(brows))
    kw = dict(k=16, sketchlen=16, slots_per_feature=spf,
              windows_per_query=1, max_candidates=2, dense=True,
              prefix_bits=bits, walk_elems=64, fast_top2=True)
    ref = query_step_rows_scan(jnp.asarray(codes), jnp.asarray(lens),
                               jnp.asarray(mwir), *args, **kw)
    got = query_step_rows_scan(jnp.asarray(codes), jnp.asarray(lens),
                               jnp.asarray(mwir), *args,
                               prefetch=True, **kw)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_redo_scan_matches_full_scan():
    """Escalation phase 2 on phase-1's saved sketches/bucket probes
    (query_step_rows_redo_scan) classifies flagged reads exactly like
    the full-depth scan; phase 1 (return_feats) classifies the rest."""
    import jax.numpy as jnp
    from metacache_tpu.ops.probe import make_bucket_index
    from metacache_tpu.ops.rows import (query_step_rows_redo_scan,
                                        query_step_rows_scan,
                                        query_step_rows_scan_head)
    from metacache_tpu.ops.sketch_jax import sketch_windows
    from metacache_tpu.ops.table import FeatureTable, pack_locations

    rng = np.random.default_rng(5)
    K, B, WL, NTGT = 2, 64, 128, 40
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    mwir = np.full((K, B), 2, np.int32)
    # build the table FROM the reads' own sketches: half the reads'
    # features get deep buckets (8 targets > head), half shallow
    feats_all = np.asarray(sketch_windows(
        jnp.asarray(codes.reshape(K * B, WL)),
        jnp.asarray(lens.reshape(K * B)), k=16,
        sketchlen=16)).reshape(K * B, 16)
    deep_f = np.unique(feats_all[0::2].reshape(-1))
    shal_f = np.setdiff1d(np.unique(feats_all[1::2].reshape(-1)), deep_f)
    deep_f = deep_f[deep_f != 0xFFFFFFFF]
    shal_f = shal_f[shal_f != 0xFFFFFFFF]
    fs, ts, ws = [], [], []
    for i, fv in enumerate(deep_f):
        for j in range(8):
            fs.append(fv); ts.append((i + j) % NTGT); ws.append(j % 30)
    for i, fv in enumerate(shal_f):
        fs.append(fv); ts.append(i % NTGT); ws.append(i % 30)
    f = np.asarray(fs, np.uint32)
    t = np.asarray(ts, np.int32)
    w = np.asarray(ws, np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(),
                            pack_locations(t[order], w[order]),
                            max_locations_per_feature=16)
    spf = max(min(ft.max_bucket_size, 16), 1)
    assert spf > 4
    hsl = 4
    wbits = 8
    head, ovf = ft.fused_rows_two_tier(spf, hsl, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    dense = ("two_tier", hsl, False, False, wbits)
    lin = _lineages(NTGT)
    args = (jnp.asarray(head), jnp.asarray(ovf),
            jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(1), jnp.float32(0.5), jnp.int32(19), jnp.int32(0),
            jnp.asarray(brows))
    tfj = jnp.asarray(ft.unique_features)
    toj = jnp.asarray(ft.offsets.astype(np.int32))
    kw = dict(sketchlen=16, slots_per_feature=spf, max_candidates=2,
              prefix_bits=bits, dense=dense, pack_bits=wbits,
              walk_elems=32, fast_top2=True)
    ref = np.asarray(query_step_rows_scan(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        tfj, toj, *args, k=16, windows_per_query=1, prefix_steps=0,
        **kw))
    cls1, over, fk, ik = query_step_rows_scan_head(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        tfj, toj, *args, k=16, prefetch=True, return_feats=True, **kw)
    cls1 = np.asarray(cls1)
    bits_ = np.asarray(over).reshape(-1)
    mask = (((bits_[:, None] >> np.arange(32)) & 1)
            .astype(bool).reshape(K * B))
    idxs = np.nonzero(mask)[0]
    assert 0 < len(idxs) < K * B          # both phases exercised
    # phase 1 is exact for non-flagged reads
    np.testing.assert_array_equal(ref.reshape(-1)[~mask],
                                  cls1.reshape(-1)[~mask])
    # redo the flagged ones from saved feats/idx at full occupancy
    F = fk.shape[-1]
    take = 1 * len(idxs)
    selj = jnp.asarray(idxs.astype(np.int32))
    fsel = fk.reshape(-1, F)[selj]
    isel = ik.reshape(-1, F)[selj]
    msel = mwir.reshape(-1)[idxs]
    cls2 = np.asarray(query_step_rows_redo_scan(
        fsel.reshape(1, take, F), isel.reshape(1, take, F),
        jnp.asarray(msel.reshape(1, take)),
        tfj, toj, *args[:-1], **kw)).reshape(-1)
    np.testing.assert_array_equal(ref.reshape(-1)[mask], cls2)


def test_fused_escalation_scan_matches_separate():
    """query_step_rows_scan_head_fused == scan_head + redo_scan run
    separately, for both the phase-1 outputs and the redo slice."""
    import jax.numpy as jnp
    from metacache_tpu.ops.probe import make_bucket_index
    from metacache_tpu.ops.rows import (query_step_rows_redo_scan,
                                        query_step_rows_scan_head,
                                        query_step_rows_scan_head_fused)
    from metacache_tpu.ops.sketch_jax import sketch_windows
    from metacache_tpu.ops.table import FeatureTable, pack_locations

    rng = np.random.default_rng(8)
    K, B, WL, NTGT, B2 = 2, 64, 128, 40, 32
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    mwir = np.full((K, B), 2, np.int32)
    feats_all = np.asarray(sketch_windows(
        jnp.asarray(codes.reshape(K * B, WL)),
        jnp.asarray(lens.reshape(K * B)), k=16,
        sketchlen=16)).reshape(K * B, 16)
    deep_f = np.unique(feats_all[0::2].reshape(-1))
    shal_f = np.setdiff1d(np.unique(feats_all[1::2].reshape(-1)), deep_f)
    deep_f = deep_f[deep_f != 0xFFFFFFFF]
    shal_f = shal_f[shal_f != 0xFFFFFFFF]
    fs, ts, ws = [], [], []
    for i, fv in enumerate(deep_f):
        for j in range(8):
            fs.append(fv); ts.append((i + j) % NTGT); ws.append(j % 30)
    for i, fv in enumerate(shal_f):
        fs.append(fv); ts.append(i % NTGT); ws.append(i % 30)
    f = np.asarray(fs, np.uint32)
    t = np.asarray(ts, np.int32)
    w = np.asarray(ws, np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(),
                            pack_locations(t[order], w[order]),
                            max_locations_per_feature=16)
    spf = max(min(ft.max_bucket_size, 16), 1)
    hsl, wbits = 4, 8
    head, ovf = ft.fused_rows_two_tier(spf, hsl, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    dense = ("two_tier", hsl, False, False, wbits)
    lin = _lineages(NTGT)
    args = (jnp.asarray(head), jnp.asarray(ovf),
            jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(1), jnp.float32(0.5), jnp.int32(19), jnp.int32(0),
            jnp.asarray(brows))
    tfj = jnp.asarray(ft.unique_features)
    toj = jnp.asarray(ft.offsets.astype(np.int32))
    kw = dict(sketchlen=16, slots_per_feature=spf, max_candidates=2,
              prefix_bits=bits, dense=dense, pack_bits=wbits,
              walk_elems=32, fast_top2=True)
    cls1, over, fk, ik = query_step_rows_scan_head(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        tfj, toj, *args, k=16, prefetch=True, return_feats=True, **kw)
    # a redo slice from the flagged rows (padded with sentinels)
    bits_ = np.asarray(over).reshape(-1)
    mask = (((bits_[:, None] >> np.arange(32)) & 1)
            .astype(bool).reshape(K * B))
    idxs = np.nonzero(mask)[0][:K * B2]
    F = 16
    sel = jnp.asarray(idxs.astype(np.int32))
    rf = jnp.concatenate([
        fk.reshape(-1, F)[sel],
        jnp.full((K * B2 - len(idxs), F), 0xFFFFFFFF, jnp.uint32)])
    ri = jnp.concatenate([
        ik.reshape(-1, F)[sel],
        jnp.zeros((K * B2 - len(idxs), F), jnp.int32)])
    rm = jnp.asarray(np.full((K, B2), 2, np.int32))
    want_redo = np.asarray(query_step_rows_redo_scan(
        rf.reshape(K, B2, F), ri.reshape(K, B2, F), rm,
        tfj, toj, *args[:-1], **kw))
    out = query_step_rows_scan_head_fused(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        rf.reshape(K, B2, F), ri.reshape(K, B2, F), rm,
        tfj, toj, *args, k=16, **kw)
    cls1_f, over_f, fk_f, ik_f, cls2_f = out
    np.testing.assert_array_equal(np.asarray(cls1), np.asarray(cls1_f))
    np.testing.assert_array_equal(np.asarray(over), np.asarray(over_f))
    np.testing.assert_array_equal(np.asarray(fk), np.asarray(fk_f))
    np.testing.assert_array_equal(np.asarray(ik), np.asarray(ik_f))
    np.testing.assert_array_equal(want_redo, np.asarray(cls2_f))


def test_paired_escalation_summary_parity(tmp_path, monkeypatch):
    """Paired-end escalation (head-only phase 1 + feats-reuse redo over
    both mates' sketches) produces the same summary as the full-depth
    paired scan on a deep-bucket DB."""
    from metacache_tpu import native
    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    from metacache_tpu.cli.main import Args, parse_query_options
    from metacache_tpu.classify.runner import (ClassificationResults,
                                               QueryOptions, QueryRunner,
                                               map_queries_to_targets)
    from metacache_tpu.db.build import BuildOptions, build_database
    monkeypatch.setenv("MC_SCAN_K", "2")
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    rng = np.random.default_rng(4)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    genomes = []
    for _ in range(2):
        base = rng.integers(0, 4, 20000, dtype=np.uint8)
        for _s in range(70):
            g = base.copy()
            pos = rng.integers(0, 20000, 40)
            g[pos] = rng.integers(0, 4, 40)
            genomes.append(g)
    for _ in range(6):
        genomes.append(rng.integers(0, 4, 20000, dtype=np.uint8))
    gfa = tmp_path / "g.fa"
    with open(gfa, "wb") as fh:
        for i, g in enumerate(genomes):
            fh.write(b">g%d\n" % i + b2a[g].tobytes() + b"\n")
    r1 = tmp_path / "r1.fa"
    r2 = tmp_path / "r2.fa"
    with open(r1, "wb") as f1, open(r2, "wb") as f2:
        for i in range(1200):
            gs = int(rng.integers(0, len(genomes)))
            p = int(rng.integers(0, 20000 - 400))
            ln = int(rng.integers(60, 120))
            f1.write(b">r%d/1\n" % i +
                     b2a[genomes[gs][p:p + ln]].tobytes() + b"\n")
            q = p + 200
            f2.write(b">r%d/2\n" % i +
                     b2a[genomes[gs][q:q + ln]].tobytes() + b"\n")
    db = build_database(BuildOptions(infiles=[str(gfa)]))
    qr = QueryRunner(db, QueryOptions())
    assert qr._escalation_ok(wq=2), (qr._dense[0], qr._tables[0][4])

    def run(esc):
        monkeypatch.setenv("MC_ESCALATE", esc)
        qopt, _, _ = parse_query_options(
            Args(["-pairfiles", "-no-map", "-no-query-params",
                  "-batch-size", "512"]))
        import io
        out = io.StringIO()
        res = ClassificationResults(out, out, out)
        map_queries_to_targets([str(r1), str(r2)], db, qopt, res)
        return res.query_count, res.statistics.assigned_.copy()

    qa, ha = run("1")
    qb, hb = run("0")
    assert qa == qb == 1200
    np.testing.assert_array_equal(ha, hb)
