"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip without one.  They
import neither jax nor swipe_tpu, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

import torch_row_cases as rc
from swipe_tpu_torch import trace
from swipe_tpu_torch.batching import pack_stream
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import sw_stream as sw
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunk(dev):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 200, size=3000)]
    ch = pack_stream(seqs, nseqs=1024, max_cols=512)[0]
    m8 = sw.build_matrix8(ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)
    data, start, eb, ln = sw.chunk_tensors(ch.data_t, ch.start,
                                           ch.end_block, ch.lane, dev)
    return torch.from_numpy(m8).to(dev), data, start


def test_dprofile_kernel_matches_plain(chunk):
    m8, data, _ = chunk
    n = trace.launched("swipe_dprofile")
    got = sw.build_dprofile_series(m8, data)
    assert trace.launched("swipe_dprofile") == n + 1
    assert torch.equal(got, sw.build_dprofile_series_plain(m8, data))


@pytest.mark.parametrize("clamp", [None, 50])
def test_stream_kernel_matches_plain(dev, chunk, clamp):
    # the card's K2 looks scores up in the matrix: block profiles raise
    m8, data, start = chunk
    rng = np.random.default_rng(1)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (5, 64, 130)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 160))
    kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
    n = trace.launched("swipe_stream_rows")
    got = sw.sw_scores_stream(qc, ql, m8, data, start, **kw)
    assert trace.launched("swipe_stream_rows") == n + 1
    assert torch.equal(got, sw.sw_scores_stream_plain(qc, ql, m8, data,
                                                      start, **kw))
    with pytest.raises(ValueError):
        sw.sw_scores_stream(qc, ql, m8, data, start,
                            dprof=sw.build_dprofile_series(m8, data), **kw)


@pytest.mark.parametrize("clamp", [None, 50])
@pytest.mark.parametrize("lengths", rc.STREAM_LENGTHS,
                         ids=lambda t: "-".join(map(str, t)))
def test_stream_kernel_at_band_edges(dev, chunk, lengths, clamp):
    # every band height (128, 256, 512 rows, two bands over 512), lanes
    # refilled at column 16, query windows planted across strip and band
    # edges
    m8, data, start = chunk
    rng = np.random.default_rng(sum(lengths))
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in lengths]
    host, st = data.cpu().numpy(), start.cpu().numpy()
    st[1, ::5] = 1
    assert rc.plant_windows(rng, host, st, qs, rc.STREAM_EDGES)
    d, st = torch.from_numpy(host).to(dev), torch.from_numpy(st).to(dev)
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
        qs, -(-max(lengths) // 32) * 32))
    kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
    assert torch.equal(sw.sw_scores_stream(qc, ql, m8, d, st, **kw),
                       sw.sw_scores_stream_plain(qc, ql, m8, d, st, **kw))


def test_hint_kernel_matches_plain(dev, chunk):
    m8 = chunk[0]
    rng = np.random.default_rng(2)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (30, 90)]
    db = np.full((2, 256, 1024), 31, np.int8)
    for b, q in enumerate(qs):
        for j in range(1024):
            s = np.concatenate([q, q]) if j % 2 else rng.integers(
                1, 26, size=int(rng.integers(1, 256)), dtype=np.int8)
            db[b, :len(s), j] = s[:256]
    db[:, :, -40:] = 31                 # empty lanes
    starts = np.zeros((2, 1024), np.int32)
    starts[:, 3::5] = 17
    args = [torch.from_numpy(a).to(dev)
            for a in (*sw.build_qcodes(qs, 128), db, starts)]
    args.insert(2, m8)
    for R in (1, 150):
        got = sw.sw_hint_stream(*args, gapopenextend=R + 11, gapextend=R)
        want = sw.sw_hint_stream_plain(*args, gapopenextend=R + 11,
                                       gapextend=R)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_hint_grid_route_on_card_matches_host_pass(dev):
    from swipe_tpu_torch.ops import align_hint
    rng = np.random.default_rng(4)
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    jobs = []
    for nsub in (1, 5, 33, 70, 16, 2):
        q = rng.integers(1, 26, size=int(rng.integers(20, 200)),
                         dtype=np.int8)
        jobs.append((q, [rng.integers(1, 26, size=int(n), dtype=np.int8)
                         for n in rng.integers(1, 900, size=nsub)]))
    n = trace.launched("swipe_hint")
    got = align_hint.hint_endpoints_grid(jobs, m, 11, 1, device=dev)
    assert trace.launched("swipe_hint") > n
    assert got == align_hint.hint_endpoints_grid(jobs, m, 11, 1)


def test_hint_bin_over_scratch_cap_on_card_matches_host_pass(
        dev, monkeypatch):
    # a 700-nt query (two int8 bands) whose launch cap is one warp of its
    # longest subject: the bin's 70 lanes run on several launches, equal
    # to the host pass
    from swipe_tpu_torch.ops import align_hint
    rng = np.random.default_rng(5)
    m = ScoreMatrix.nucleotide(1, -3, 5, 2).matrix
    q = rng.integers(1, 5, size=700, dtype=np.int8)
    subs = [rng.integers(1, 5, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 3000, size=70)]
    for i in range(0, 70, 7):
        a, b = sorted(rng.integers(0, 700, size=2))
        subs[i] = np.concatenate([subs[i], q[a:b + 1]])
    cap = align_hint.WARP * align_hint._launch_dims(
        [[max(subs, key=len)]])[0]
    monkeypatch.setattr(align_hint, "_LAUNCH_BYTES", cap)
    n = trace.launched("swipe_hint")
    got = align_hint.hint_endpoints_grid([(q, subs)], m, 5, 2, device=dev)
    assert trace.launched("swipe_hint") - n > 1
    assert got == align_hint.hint_endpoints_grid([(q, subs)], m, 5, 2)


def test_engine_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 300, size=500)]
    q = "".join(rng.choice(aa, 150))
    recs[9] = q[10:120]
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    params = dict(descriptions=50, alignments=20)
    hits = []
    for device in (dev, "cpu"):
        eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "aa", title="t"),
                           SearchParams(**params), device=device)
        hl = eng.search(preprocess_query("q", q, 1, 3))
        hits.append([(h.seqno, h.score, h.alignment) for h in hl.hits])
    assert hits[0] == hits[1] and hits[0][0][0] == 9


def _carry_series(dev, flow):
    """A flow series (permuted lanes, narrowing drains) or a compact
    carry series, with its queries."""
    from swipe_tpu_torch.batching import pack_stream_carry, pack_stream_flow
    rng = np.random.default_rng(5 + flow)
    if flow:
        lens = np.concatenate([rng.integers(5, 300, 5000), [3000, 2100],
                               [700] * 1100])
        seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
                for n in lens]
        chunks = pack_stream_flow(seqs, nseqs=2048, max_cols=256,
                                  drain_cols=128)
    else:
        seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
                for n in [9000, 7000] + list(rng.integers(1, 900, 40))]
        # 16 lanes: the short records refill lanes mid-chunk
        chunks = pack_stream_carry(seqs, nseqs=16, max_cols=1024)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (7, 100, 250)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 256))
    return chunks, qc, ql


# queries that end inside a strip, at a strip edge (496), at a band edge
# (512, 1024), take several bands (1,100), and an empty slot
LONG_CARRY_QUERIES = (300, 496, 512, 0, 1024, 1100)
# (lengths, qlen_pad) of the other query sets: the flow form's bands of
# 128 rows (4 a thread) and of 512 (16 a thread) in one band
CARRY_QUERIES = {"long": (LONG_CARRY_QUERIES, 1536),
                 "q128": ((128, 100, 31, 0), 128),
                 "q512": ((512, 300, 129, 1), 512)}


@pytest.mark.parametrize("flow,form,queries,wide,clamp", [
    (True, "flow", "short", False, None),
    (False, "rows", "short", False, None),
    (False, "flow", "short", False, None),
    (False, "rows", "long", False, None),
    (False, "rows", "long", False, 80),
    (False, "rows", "long", True, None),
    (False, "flow", "long", False, 80),
    (True, "flow", "q128", False, 50),
    (True, "flow", "q512", False, None)])
def test_carry_kernel_matches_plain(dev, chunk, flow, form, queries, wide,
                                    clamp):
    # every chunk's dump and carried state, the head without carry-in,
    # the tail without carry-out, no block profiles; the entry point
    # picks the flow form for the flow series (2,048 lanes and drains of
    # 1,024) and the row form for the compact series' few pairs, where
    # the flow form is also called directly (256-row bands, and three of
    # 512 rows with planes between them)
    m8 = chunk[0]
    scale = 100 if wide else 1
    if wide:
        m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix * scale
        m8 = torch.from_numpy(sw.build_matrix_wide(m)).to(dev)
    chunks, qc, ql = _carry_series(dev, flow)
    if queries in CARRY_QUERIES:
        lengths, qlen_pad = CARRY_QUERIES[queries]
        rng = np.random.default_rng(12)
        qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
            [rng.integers(1, 26, size=n, dtype=np.int8)
             for n in lengths], qlen_pad))
    assert len(chunks) > 3
    width = chunks[0].nseqs if flow else 64
    nq, qlen_pad = qc.shape
    got = sw.make_stream_state(nq, qlen_pad, width, dev)
    want = tuple(x.clone() for x in got)
    kernel = getattr(sw, f"sw_scores_stream_carry_{form}")
    fn = sw.sw_scores_stream_carry if flow or form == "rows" else kernel
    n = trace.launched(f"swipe_carry_{form}")
    for i, ch in enumerate(chunks):
        if flow and i:
            src = torch.from_numpy(ch.carry_src).to(dev)
            got = sw.permute_stream_state(*got, src)
            want = sw.permute_stream_state(*want, src)
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        kw = dict(gapopenextend=12 * scale, gapextend=scale, clamp=clamp,
                  carry_in=i > 0, carry_out=i < len(chunks) - 1)
        d1, *got = fn(qc, ql, m8, data, start, *got, **kw)
        d2, *want = sw.sw_scores_stream_carry_plain(qc, ql, m8, data, start,
                                                    *want, **kw)
        assert torch.equal(d1, d2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert trace.launched(f"swipe_carry_{form}") == n + len(chunks)
    if flow:
        # the card's K3 reads no block profiles: both forms raise
        for form_fn in (sw.sw_scores_stream_carry_flow,
                        sw.sw_scores_stream_carry_rows):
            with pytest.raises(ValueError, match="block profiles"):
                form_fn(qc, ql, m8, data, start, *got,
                        dprof=sw.build_dprofile_series(m8, data), **kw)


def test_wavefront_kernel_matches_plain(dev, chunk):
    # three segments of a giant, hits and a gap across the segment cuts:
    # threaded segment by segment (a launch each), and the engine's call
    # (one launch, the giant whole)
    from swipe_tpu_torch.ops import sw_wavefront as wf
    m8 = chunk[0].cpu().numpy()
    rng = np.random.default_rng(6)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (40, 300, 1000)]
    seq = rng.integers(1, 26, size=10000, dtype=np.int8)
    seq[4080:4120] = qs[0]
    seq[8000:8150] = qs[1][:150]
    seq[8160:8310] = qs[1][150:]
    qc, ql = sw.build_qcodes(qs, 1024)
    mq = torch.from_numpy(wf.build_mq(qc, m8)).to(dev)
    n = trace.launched("swipe_wavefront")
    old = wf.SEG_STRIPS
    wf.SEG_STRIPS = 4
    try:
        assert len(wf._segments(len(seq))) == 3
        got = wf.sw_wavefront_scores(mq, seq, gapopenextend=12, gapextend=1)
    finally:
        wf.SEG_STRIPS = old
    assert trace.launched("swipe_wavefront") == n + 3
    state = wf.make_wavefront_state(3, 1024, dev)
    segs = torch.from_numpy(seq).to(dev)
    plain = wf.sw_wavefront_plain(mq, segs, *state, gapopenextend=12,
                                  gapextend=1)
    assert torch.equal(got, plain[2])
    held = wf.hold_giants([seq], dev)
    whole = wf.sw_wavefront_giants(mq, ql, held, overlap=12 * 1024,
                                   gapopenextend=12, gapextend=1)
    assert trace.launched("swipe_wavefront") == n + 4
    assert torch.equal(whole[:, 0], plain[2])
    # one segment: the carried H/E rows too
    a = wf.make_wavefront_state(3, 1024, dev)
    b = wf.make_wavefront_state(3, 1024, dev)
    wf.sw_wavefront(mq, segs[:3072], *a, gapopenextend=12, gapextend=1)
    wf.sw_wavefront_plain(mq, segs[:3072], *b, gapopenextend=12, gapextend=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def wave_giants(dev, chunk):
    """torch_row_cases' three giants, alignments planted across every
    piece cut the plans for 1, 3 and 16 queries make, and the plain
    version's scores of its 16 queries (the first nq are the nq's)."""
    from swipe_tpu_torch.ops import sw_wavefront as wf
    m8 = chunk[0].cpu().numpy()
    rng = np.random.default_rng(21)
    best = 1 + np.argsort(-np.diag(ScoreMatrix.builtin(
        "BLOSUM62", 11, 1).matrix)[1:26], kind="stable")[:4]
    rows, V = rc.WAVE_GIANT_ROWS, rc.WAVE_GIANT_V
    resident = wf.wavefront_resident(rows, dev)
    cuts = {(p.giant, p.own[0]) for nq in (1, 3, 16)
            for p in wf.plan_pieces(rc.WAVE_GIANTS, nq, rows, V, resident)
            if p.own[0]}
    qs, giants = rc.wavefront_giants_case(rng, sorted(cuts), best)
    qc, ql = sw.build_qcodes(qs, rows)
    mq = torch.from_numpy(wf.build_mq(qc, m8)).to(dev)
    held = wf.hold_giants(giants, dev)
    kw = dict(overlap=V, gapopenextend=12, gapextend=1)
    want = wf.sw_wavefront_giants_plain(mq, ql, held, **kw)
    return mq, ql, held, kw, want, resident


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_wavefront_giants_match_plain(wave_giants, nq):
    # the engine's call: every (query, piece) chain in one launch, the
    # giants cut where the chains alone leave the card idle
    from swipe_tpu_torch.ops import sw_wavefront as wf
    mq, ql, held, kw, want, resident = wave_giants
    pieces = wf.plan_pieces(held.lengths, nq, rc.WAVE_GIANT_ROWS,
                            kw["overlap"], resident)
    assert len(pieces) > 3
    before = trace.counters()
    got = wf.sw_wavefront_giants(mq[:nq].contiguous(), ql[:nq], held, **kw)
    after = trace.counters()

    def moved(name):
        return after.get(name, 0) - before.get(name, 0)

    assert moved("launch.swipe_wavefront") == 1
    assert moved("wavefront.chains") == nq * len(pieces)
    assert moved("wavefront.cells_walked") == int(ql[:nq].sum()) * sum(
        p.walk[1] - p.walk[0] for p in pieces)
    assert torch.equal(got, want[:nq])
    assert (want[:2] > 500).all()


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_wavefront_kernel_across_slab_edges(dev, chunk, nq):
    # torch_row_cases' giant: alignments with horizontal gaps of 1,100 and
    # 700 columns across slab edges and segment cuts, segment by segment
    # (every segment's state), then a 1,024-column tail segment
    from swipe_tpu_torch.ops import sw_wavefront as wf
    m8 = chunk[0].cpu().numpy()
    rng = np.random.default_rng(7)
    qs, seq = rc.wavefront_case(rng)
    qs += [rng.integers(1, 26, size=int(n), dtype=np.int8)
           for n in rng.integers(1, 1025, size=13)]
    mq = torch.from_numpy(wf.build_mq(sw.build_qcodes(qs[:nq], 1024)[0],
                                      m8)).to(dev)
    db = torch.from_numpy(seq).to(dev)
    kw = dict(gapopenextend=12, gapextend=1)
    got = wf.make_wavefront_state(nq, 1024, dev)
    want = tuple(x.clone() for x in got)
    for pos in range(0, len(seq), rc.WAVE_SEGMENT):
        wf.sw_wavefront(mq, db[pos:pos + rc.WAVE_SEGMENT], *got, **kw)
        wf.sw_wavefront_plain(mq, db[pos:pos + rc.WAVE_SEGMENT], *want, **kw)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    for x, y in zip(wf.sw_wavefront(mq, db[:1024], *want, **kw),
                    wf.sw_wavefront_plain(mq, db[:1024], *got, **kw)):
        assert torch.equal(x, y)


def _engine_hits(fasta, dbtype, q, symtype, params, device, **kw):
    attrs = kw.pop("attrs", {})
    eng = SearchEngine(FastaDatabase(io.StringIO(fasta), dbtype, title="t"),
                       SearchParams(symtype=symtype, **params),
                       device=device, **kw)
    for k, v in attrs.items():
        setattr(eng, k, v)
    hl = eng.search(preprocess_query("q", q, symtype, 3))
    return eng, [(h.seqno, h.score, h.dstrand, h.dframe, h.alignment)
                 for h in hl.hits]


@pytest.mark.parametrize("route", ["flow", "segmented", "wavefront",
                                   "carry"])
def test_engine_routes_on_card_match_cpu(dev, route):
    # a flow-routed and a giant-routed search on the card against the
    # same search on the CPU
    rng = np.random.default_rng(8)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    q = "".join(rng.choice(aa, 60))        # a span bound that segments
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 300, size=400)]
    recs[9] = "".join(rng.choice(aa, 2500)) + q[10:50]
    recs[30] = "".join(rng.choice(aa, 5000)) + q + "".join(rng.choice(aa, 9))
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    params = dict(descriptions=30, alignments=5)
    kw = dict(attrs={"FLOW_MIN_AVG_LANE": 0}, nseqs=1024) \
        if route == "flow" else dict(max_cols=2048)
    if route == "wavefront":
        kw["attrs"] = {"SEGMENT_GIANTS": False}
    if route == "carry":
        kw["attrs"] = {"SEGMENT_GIANTS": False, "WAVEFRONT_MAX_GIANTS": 0}
    # the flow series' launches take K3's flow form, the giants' carry
    # series (few pairs) its row form
    counted = {"flow": "swipe_carry_flow",
               "carry": "swipe_carry_rows"}.get(route, "swipe_stream_rows")
    n = trace.launched(counted)
    eng, on_card = _engine_hits(fasta, "aa", q, 1, params, dev, **kw)
    assert trace.launched(counted) > n
    if route == "flow":
        assert eng._flow_cols(1024) is not None
    else:
        assert eng._giant_ids.size >= 1
    _, on_cpu = _engine_hits(fasta, "aa", q, 1, params, "cpu", **kw)
    assert on_card == on_cpu and on_card[0][0] == 30


@pytest.mark.parametrize("clamp", [None, 50])
def test_tile_kernel_matches_plain(dev, chunk, clamp):
    # three 512-row passes: queries ending inside tile 1, inside tile 2,
    # at the edge of tile 1, and an empty slot; dump and planes each pass
    m8, data, start = chunk
    rng = np.random.default_rng(9)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8)
          for n in (700, 1300, 1024, 0)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 1536))
    kw = dict(gapopenextend=12, gapextend=1, tile_rows=512, clamp=clamp)
    got = sw._tile_planes(4, data.shape[0], data.shape[1], dev)
    want = tuple(x.clone() for x in got)
    n = trace.launched("swipe_stream_tile")
    for t in range(3):
        sw.stream_tile_pass(qc, ql, t, m8, data, start, *got, **kw)
        sw.stream_tile_pass_plain(qc, ql, t, m8, data, start, *want, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert trace.launched("swipe_stream_tile") == n + 3
    # one pass over all rows (K2) gives the same dump
    kw2 = {k: v for k, v in kw.items() if k != "tile_rows"}
    assert torch.equal(got[2], sw.sw_scores_stream(qc, ql, m8, data, start,
                                                   **kw2))


@pytest.mark.parametrize("clamp", [None, 50])
def test_tile_kernel_at_strip_and_tile_edges_matches_plain(dev, chunk,
                                                           clamp):
    # torch_row_cases' tile queries at 512-row tiles (one row into tile
    # 3, one strip into tile 2 and inside its second strip, a row short
    # of a tile, a whole tile, an empty slot), lanes holding copies of
    # query windows across those edges: dump and planes each pass
    m8, data, start = chunk
    rng = np.random.default_rng(15)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8)
          for n in rc.tile_lengths(512)]
    host = data.cpu().numpy()
    assert len(rc.plant_windows(rng, host, start.cpu().numpy(), qs,
                                (16, 511, 512, 1024, 1040, 1047, 1536))) \
        >= 50
    data = torch.from_numpy(host).to(dev)
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 2048))
    kw = dict(gapopenextend=12, gapextend=1, tile_rows=512, clamp=clamp)
    got = sw._tile_planes(len(qs), data.shape[0], data.shape[1], dev)
    want = tuple(x.clone() for x in got)
    n = trace.launched("swipe_stream_tile")
    for t in range(4):
        sw.stream_tile_pass(qc, ql, t, m8, data, start, *got, **kw)
        sw.stream_tile_pass_plain(qc, ql, t, m8, data, start, *want, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert trace.launched("swipe_stream_tile") == n + 4
    assert int(got[2].max()) == clamp if clamp else int(got[2].max()) > 150


@pytest.mark.parametrize("case", list(rc.HINT_CASES))
def test_hint_kernel_on_hard_bins_matches_plain(dev, case):
    # torch_row_cases' hint bins: queries at and around strip and band
    # edges, over one band and over 1,100 rows, ties across strip edges,
    # tails before a first tracked column, empty subjects and lanes
    lengths, go, ge, scale = rc.HINT_CASES[case]
    mat = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix.astype(np.int64) \
        * scale
    rng = np.random.default_rng(80 + len(case))
    bins, tails = rc.hint_bins(rng, lengths, nsub=60, maxlen=600)
    starts = rc.hint_starts(rng, bins, tails, 64)
    cols = -(-max(len(s) for _, subs in bins for s in subs) // 16) * 16
    m = (sw.build_matrix_wide if scale > 1 else sw.build_matrix8)(mat)
    args = [torch.from_numpy(a).to(dev) for a in (
        *sw.build_qcodes([q for q, _ in bins], max(lengths)), m,
        rc.hint_dense(bins, cols, 64), starts)]
    kw = dict(gapopenextend=go + ge, gapextend=ge)
    n = trace.launched("swipe_hint")
    got = sw.sw_hint_stream(*args, **kw)
    assert trace.launched("swipe_hint") == n + 1
    for g, w in zip(got, sw.sw_hint_stream_plain(*args, **kw)):
        assert torch.equal(g, w)
    assert (got[1] == -1).any() and (got[1] >= 512).any() == (
        max(lengths) > 512)
    # no columns at all: every lane (0, -1, 0), as the plain version
    args[3] = args[3][:, :0].contiguous()
    for g, w in zip(sw.sw_hint_stream(*args, **kw),
                    sw.sw_hint_stream_plain(*args, **kw)):
        assert torch.equal(g, w)


def _chip_smoke():
    """chip_smoke.py as a module (its plant_cuts, cut_matters and
    plain_tiles)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                       "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return sys.modules["chip_smoke"]


# (query index in LONG_CARRY_QUERIES, row x): x is a band's first row plus
# its strip height.  K3's two forms lay their bands from the query's end
# (the row form 512 rows int8, 256 int32; the flow form 512 at qlen_pad
# 1,536, and 256 at qlen_pad 256: FLOW_SHORT_PLANTS), K6 from each
# tile's top.
CUT_PLANTS = {("rows", False): [(5, 604), (4, 16)],
              ("rows", True): [(5, 340), (4, 264)],
              ("flow", False): [(5, 604), (4, 16), (2, 16)],
              (512, False): [(5, 528), (4, 16), (2, 16)],
              (256, False): [(5, 272), (4, 528), (1, 272)]}
# the flow form's 256-row bands (8 rows a thread): queries of 256 and 250
# rows at qlen_pad 256, planted at the second strip of the first (rows
# 0-255) and the third of the second (from row -6)
FLOW_SHORT_QUERIES = (256, 250, 100, 7, 0)
FLOW_SHORT_PLANTS = [(0, 8), (1, 10)]


@pytest.mark.parametrize("kernel,wide", list(CUT_PLANTS))
def test_carry_cut_into_a_band_matches_plain(dev, chunk, kernel, wide):
    # lanes planted across chunk cuts, so that a best alignment runs from
    # the last row of a band's first strip at one chunk's last column
    # into the first row of its second strip at the next chunk's first
    # column: the diagonal that thread 1 takes from thread 0's carried H
    # before the first shuffle.  The planted chunks' dumps depend on it
    # (checked on the plain version); every chunk's dump and state.
    cs = _chip_smoke()
    m8 = chunk[0]
    scale = 100 if wide else 1
    if wide:
        m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix * scale
        m8 = torch.from_numpy(sw.build_matrix_wide(m)).to(dev)
    chunks, _, _ = _carry_series(dev, False)
    rng = np.random.default_rng(14)
    runs = [(LONG_CARRY_QUERIES, 1536, CUT_PLANTS[kernel, wide])]
    if kernel == "flow":
        runs.append((FLOW_SHORT_QUERIES, 256, FLOW_SHORT_PLANTS))
    for lengths, qlen_pad, plants in runs:
        qs, where = cs.plant_cuts(chunks, [
            rng.integers(1, 26, size=n, dtype=np.int8) for n in lengths],
            plants)
        qc, ql = (torch.from_numpy(a).to(dev)
                  for a in sw.build_qcodes(qs, qlen_pad))
        if kernel in ("rows", "flow"):
            # the compact series' 64 lanes take the row form at the entry
            # point; the flow form is called directly
            fn = sw.sw_scores_stream_carry if kernel == "rows" \
                else sw.sw_scores_stream_carry_flow
            plain, tiles = sw.sw_scores_stream_carry_plain, {}
            counted = f"swipe_carry_{kernel}"
            got = sw.make_stream_state(len(qs), qlen_pad, 64, dev)
        else:
            fn = sw.sw_scores_stream_carry_long
            counted, tiles = "swipe_stream_tile_carry", dict(
                tile_rows=kernel)

            def plain(*a, **k):
                return cs.plain_tiles(sw.sw_scores_stream_carry_long, *a,
                                      **k)

            got = sw.make_stream_state_long(len(qs), qlen_pad, 64, kernel,
                                            dev)
        want = tuple(x.clone() for x in got)
        n, planted = trace.launched(counted), 0
        for i, ch in enumerate(chunks):
            data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                                 ch.end_block, ch.lane, dev)
            kw = dict(gapopenextend=12 * scale, gapextend=scale,
                      carry_in=i > 0, carry_out=i < len(chunks) - 1, **tiles)
            args = (qc, ql, m8, data, start)
            if any(c == i for c, _, _ in where):
                assert cs.cut_matters(plain, where, i, args, want, kw)
                planted += 1
            d1, *got = fn(*args, *got, **kw)
            d2, *want = plain(*args, *want, **kw)
            assert torch.equal(d1, d2), f"chunk {i}: dumps differ"
            for g, w in zip(got, want):
                assert torch.equal(g, w), f"chunk {i}: state differs"
        assert planted >= 1 and trace.launched(counted) > n


@pytest.mark.parametrize("tile_rows,clamp", [(256, None), (256, 50),
                                             (512, None), (512, 50)])
def test_tile_carry_kernel_matches_plain(dev, chunk, tile_rows, clamp):
    # a compact carry series in tile passes: every chunk's dump and
    # carried (h, e, s, bh0c), no carry-in at its head, no carry-out at
    # its tail; queries that end inside a strip, at a strip edge (272,
    # 496), at a tile or band edge (512), in the third tile, and an empty
    # slot
    m8 = chunk[0]
    chunks, _, _ = _carry_series(dev, False)
    rng = np.random.default_rng(10)
    qlen_pad = 3 * tile_rows
    qs = [rng.integers(1, 26, size=min(n, qlen_pad), dtype=np.int8)
          for n in (300, 700, 0, 512, 272, 496, 1100)]
    qc, ql = (torch.from_numpy(a).to(dev)
              for a in sw.build_qcodes(qs, qlen_pad))
    got = sw.make_stream_state_long(len(qs), qlen_pad, 64, tile_rows, dev)
    want = tuple(x.clone() for x in got)
    n = trace.launched("swipe_stream_tile_carry")
    saved = sw.stream_tile_carry_pass
    for i, ch in enumerate(chunks):
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        kw = dict(gapopenextend=12, gapextend=1, tile_rows=tile_rows,
                  clamp=clamp, carry_in=i > 0, carry_out=i < len(chunks) - 1)
        d1, *got = sw.sw_scores_stream_carry_long(qc, ql, m8, data, start,
                                                  *got, **kw)
        sw.stream_tile_carry_pass = sw.stream_tile_carry_pass_plain
        try:
            d2, *want = sw.sw_scores_stream_carry_long(qc, ql, m8, data,
                                                       start, *want, **kw)
        finally:
            sw.stream_tile_carry_pass = saved
        assert torch.equal(d1, d2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert trace.launched("swipe_stream_tile_carry") == n + 3 * len(chunks)


@pytest.mark.parametrize("route", ["plain_pack", "giant"])
def test_engine_long_query_on_card_matches_cpu(dev, route):
    # a query over 1024 rows: the plain pack in tile passes (K5), and a
    # giant on the carry series in tile passes (K6), against the same
    # search on the CPU
    rng = np.random.default_rng(11)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    q = "".join(rng.choice(aa, 1100))
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 300, size=300)]
    recs[9] = q[10:120]
    # the CPU's plain passes walk every lane of a chunk as high as its
    # longest member: the plain pack's planted record stays short
    recs[30] = "".join(rng.choice(aa, 5000 if route == "giant" else 600)) \
        + q[400:700] + "".join(rng.choice(aa, 9))
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    params = dict(descriptions=30, alignments=5)
    kw = dict(max_cols=2048) if route == "giant" else {}
    counted = ("swipe_stream_tile_carry" if route == "giant"
               else "swipe_stream_tile")
    n = trace.launched(counted)
    eng, on_card = _engine_hits(fasta, "aa", q, 1, params, dev, **kw)
    assert trace.launched(counted) > n
    assert eng._giant_ids.size == (route == "giant")
    _, on_cpu = _engine_hits(fasta, "aa", q, 1, params, "cpu", **kw)
    assert on_card == on_cpu and on_card[0][0] == 30


# the segment kernels' cases: (query lengths, qlen_pad, the lanes, the
# records' length range, the records of at most one block)
SEGMENT_CASES = {
    # segments of mixed widths and padded ones, one band
    "mixed": ((64, 150, 300), 320, 512, (5, 400), 0),
    # a query over 512 rows (two int8 bands, three int32 ones with
    # planes between them) beside one under 64
    "long": ((20, 700), 768, 512, (5, 400), 0),
    # 128-row bands: a one-row query, one at a band edge
    "short": ((1, 20, 64, 128), 128, 512, (5, 400), 0),
    # one-block (32-column) segments after wider ones, a lane count that
    # leaves the last block of warps part empty; 256-row bands
    "narrow": ((37, 64, 200), 256, 100, (33, 200), 400)}


def _segment_chunk(dev, wide, case="mixed"):
    """A pack_database chunk with padded segments (SEGMENT_CASES), and
    its queries as an int8 profile (BLOSUM62) or an int32 one (blastn
    +200/-300)."""
    from swipe_tpu_torch.batching import SEG_BLK, pack_database
    from swipe_tpu_torch.ops.sw_segmented import build_qpt
    qlens, qlen_pad, nseqs, (lo, hi_len), short = SEGMENT_CASES[case]
    rng = np.random.default_rng(11 + wide)
    hi = 15 if wide else 26
    seqs = [rng.integers(1, hi, size=int(n), dtype=np.int8)
            for n in list(rng.integers(lo, hi_len, size=nseqs * 10))
            + list(rng.integers(1, SEG_BLK + 1, size=short))]
    ch = pack_database(seqs, nseqs=nseqs, max_cols=16384)[0]
    assert ch.nsegs > int(ch.seg_ids.max()) + 1       # padded segments
    if short:                                        # one-block segments
        widths = np.bincount(ch.seg_ids[:-1])
        assert (widths[:-1] == 1).sum() >= 2
    m = (ScoreMatrix.nucleotide(200, -300, 400, 200) if wide else
         ScoreMatrix.builtin("BLOSUM62", 11, 1))
    qs = [rng.integers(1, hi, size=n, dtype=np.int8) for n in qlens]
    qpt = build_qpt(qs, m.matrix, qlen_pad,
                    dtype=np.int32 if wide else np.int8)
    args = [torch.from_numpy(a).to(dev) for a in (qpt, ch.data, ch.seg_ids)]
    kw = dict(nsegs=ch.nsegs, gapopenextend=m.gapopen + m.gapextend,
              gapextend=m.gapextend)
    return args, kw


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
@pytest.mark.parametrize("kernel", ["segmented_int8", "segmented_int32",
                                    "tiled"])
def test_segment_kernels_match_plain(dev, kernel, case):
    from swipe_tpu_torch.ops import sw_segmented as seg
    from swipe_tpu_torch.ops import sw_tiled as tiled
    args, kw = _segment_chunk(dev, kernel == "segmented_int32", case)
    fn = tiled.sw_scores_tiled if kernel == "tiled" \
        else seg.sw_scores_segmented
    entry = "swipe_segment_tiled" if kernel == "tiled" else "swipe_segment"
    n = trace.launched(entry)
    got = fn(*args, **kw)
    assert trace.launched(entry) == n + 1
    assert torch.equal(got, seg.sw_scores_segmented_plain(*args, **kw))
    # the walker needs a gap open penalty of at least 0
    with pytest.raises(ValueError, match="negative gap open"):
        fn(*args, **dict(kw, gapopenextend=kw["gapextend"] - 1))


@pytest.mark.parametrize("kernel", ["segmented_int8", "segmented_int32",
                                    "tiled"])
def test_segment_kernels_split_queries_over_launches(dev, kernel,
                                                     monkeypatch):
    """The planes' cap cut to one query's planes: "long"'s two queries
    (one over 512 rows) take a launch each, with the same scores."""
    from swipe_tpu_torch.ops import sw_segmented as seg
    from swipe_tpu_torch.ops import sw_tiled as tiled
    args, kw = _segment_chunk(dev, kernel == "segmented_int32", "long")
    monkeypatch.setattr(sw, "_STREAM_PLANE_BYTES", 8 * args[1].numel())
    fn = tiled.sw_scores_tiled if kernel == "tiled" \
        else seg.sw_scores_segmented
    entry = "swipe_segment_tiled" if kernel == "tiled" else "swipe_segment"
    n = trace.launched(entry)
    got = fn(*args, **kw)
    assert trace.launched(entry) == n + 2
    assert torch.equal(got, seg.sw_scores_segmented_plain(*args, **kw))


def test_wide_carry_and_hint_kernels_match_plain(dev):
    from swipe_tpu_torch.batching import pack_stream_carry
    m = ScoreMatrix.nucleotide(200, -300, 400, 200).matrix
    mw = torch.from_numpy(sw.build_matrix_wide(m)).to(dev)
    rng = np.random.default_rng(13)
    seqs = [rng.integers(1, 15, size=int(n), dtype=np.int8)
            for n in [9000, 7000] + list(rng.integers(1, 900, 40))]
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=1024)
    qs = [rng.integers(1, 15, size=n, dtype=np.int8) for n in (7, 100, 1100)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 1152))
    got = sw.make_stream_state(3, 1152, 64, dev)
    want = tuple(x.clone() for x in got)
    for i, ch in enumerate(chunks):
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        kw = dict(gapopenextend=600, gapextend=200, carry_in=i > 0,
                  carry_out=i < len(chunks) - 1)
        d1, *got = sw.sw_scores_stream_carry(qc, ql, mw, data, start, *got,
                                             **kw)
        d2, *want = sw.sw_scores_stream_carry_plain(qc, ql, mw, data, start,
                                                    *want, **kw)
        assert torch.equal(d1, d2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the wide hint kernel on pieces with first tracked columns
    db = np.full((1, 2048, 64), 31, np.int8)
    for j in range(60):
        s = seqs[0][j * 100: j * 100 + int(rng.integers(100, 2048))]
        db[0, :len(s), j] = s
    starts = np.zeros((1, 64), np.int32)
    starts[0, 1:] = 300
    hargs = [torch.from_numpy(a).to(dev)
             for a in (*sw.build_qcodes(qs[1:2], 128), db, starts)]
    hargs.insert(2, mw)
    n = trace.launched("swipe_hint")
    got = sw.sw_hint_stream(*hargs, gapopenextend=600, gapextend=200)
    assert trace.launched("swipe_hint") == n + 1
    for g, w in zip(got, sw.sw_hint_stream_plain(*hargs, gapopenextend=600,
                                                  gapextend=200)):
        assert torch.equal(g, w)


def test_peak_kernel_matches_plain(dev):
    from swipe_tpu_torch.ops import peak
    rng = np.random.default_rng(14)
    for chains, block in ((8, 256), (1, 32)):
        x = torch.from_numpy(rng.integers(-1000, 1000, size=(chains, 1024),
                                          dtype=np.int32)).to(dev)
        for dpx in (False, True):
            got = peak.peak_chain(x, 3, dpx=dpx, block=block)
            assert torch.equal(got, peak.peak_chain_plain(
                x, 3 * peak.PEAK_STEPS))


def test_engine_pallas_on_card_matches_stream(dev):
    from swipe_tpu_torch.ops import sw_tiled as tiled
    rng = np.random.default_rng(15)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 600, size=3000)]
    q = "".join(rng.choice(aa, 150))
    recs[9] = q[10:120]
    recs.append("".join(rng.choice(aa, 20000)) + q)     # a giant
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    hits = []
    for backend in ("pallas", "stream"):
        eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "aa", title="t"),
                           SearchParams(descriptions=100, alignments=20),
                           device=dev, backend=backend)
        n = trace.launched("swipe_segment_tiled")
        hl = eng.search(preprocess_query("q", q, 1, 3))
        assert (trace.launched("swipe_segment_tiled") > n) \
            == (backend == "pallas")
        hits.append([(h.seqno, h.score, h.alignment) for h in hl.hits])
    assert hits[0] == hits[1] and hits[0][0][0] == 3000


def test_hint_endpoint_on_card_matches_host_pass(dev):
    """One subject a call on the card against its NumPy pass, ties
    planted: each subject, small as it is, takes one launch of the hint
    kernel (int8 and int32 matrices) and no lane the host pass."""
    from swipe_tpu_torch.ops.align_hint import hint_endpoints_grid
    rng = np.random.default_rng(16)
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    q = rng.integers(1, 24, size=1000, dtype=np.int8)
    for i, size in enumerate((3000, 3000, 2000)):
        d = rng.integers(1, 24, size=size, dtype=np.int8)
        if i != 1:
            # the same window twice: tied endpoints
            d[100:300] = d[size - 400:size - 200] = q[20:220]
        for mat, go, ge in ((m, 11, 1), (m * 100, 1100, 100)):
            n, host = (trace.launched("swipe_hint"),
                       trace.counter("hint.lanes_host"))
            got = hint_endpoints_grid([(q, [d])], mat, go, ge, dev)
            assert trace.launched("swipe_hint") == n + 1
            assert trace.counter("hint.lanes_host") == host
            assert got == hint_endpoints_grid([(q, [d])], mat, go, ge)


def test_hint_grid_takes_every_bin_to_the_card(dev):
    """hint_endpoints_grid on the card, one launch a call whatever the
    bins' size: bins of 1, 4 and 100 subjects (the last at single-query
    blastp's shape: 333 rows, subjects of 60-5,000 with planted ties), a
    blastn bin that mixes a chromosome-scale subject (over GIANT_HINT_MIN:
    its overlapped pieces) with genes, and two such bins in one call.
    Equal to the NumPy pass; no lane takes the host pass."""
    from swipe_tpu_torch.ops import align_hint
    rng = np.random.default_rng(31)
    aa = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    nt = ScoreMatrix.nucleotide(1, -3, 5, 2).matrix

    def subject(q, n, hi):
        d = rng.integers(1, hi, size=n, dtype=np.int8)
        w = min(len(q) // 2, n // 3)
        if w >= 10 and rng.random() < 0.5:
            # the same window twice: tied endpoints
            d[5:5 + w] = d[n - w - 5:n - 5] = q[:w]
        return d

    def aa_bin(nsub, qlen):
        q = rng.integers(1, 24, size=qlen, dtype=np.int8)
        return q, [subject(q, int(n), 24)
                   for n in rng.integers(60, 5001, size=nsub)]

    def nt_bin(n):
        q = rng.integers(1, 5, size=500, dtype=np.int8)
        giant = rng.integers(1, 5, size=n, dtype=np.int8)
        for pos in (2048 * 50 + 10, 2048 * 120 + 300):  # piece heads
            giant[pos:pos + 500] = q
        return q, [subject(q, int(k), 5)
                   for k in rng.integers(200, 3001, size=6)] + [giant]

    assert align_hint.GIANT_HINT_MIN < 400_000
    nt1, nt2 = nt_bin(400_000), nt_bin(450_000)
    cases = [([aa_bin(1, 200)], aa, 11, 1), ([aa_bin(4, 120)], aa, 11, 1),
             ([aa_bin(100, 333)], aa, 11, 1), ([nt1], nt, 5, 2),
             ([nt1, nt2], nt, 5, 2)]
    want = {}
    for bins, mat, go, ge in cases:
        n, host = (trace.launched("swipe_hint"),
                   trace.counter("hint.lanes_host"))
        got = align_hint.hint_endpoints_grid(bins, mat, go, ge, device=dev)
        assert trace.launched("swipe_hint") == n + 1
        assert trace.counter("hint.lanes_host") == host
        for (q, subs), res in zip(bins, got):
            key = (id(q), go)
            if key not in want:
                want[key] = align_hint.hint_endpoints_grid(
                    [(q, subs)], mat, go, ge)[0]
            assert res == want[key]
    assert want[(id(nt1[0]), 5)][-1][2] == 2048 * 50 + 10 + 499


def test_lax_lane_pack_on_card_matches_plain(dev, chunk):
    """The multi-host "lax" route on the card: K2 for an int8 matrix and
    K3's row form from a fresh state for an int32 one, against the
    plain versions; for the int8 matrix the row form gives K2's dump."""
    from swipe_tpu_torch.parallel.multihost import _scores_lax
    m8, data, start = chunk
    rng = np.random.default_rng(17)
    qs = [rng.integers(1, 24, size=n, dtype=np.int8) for n in (7, 130, 300)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 384))
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    for mat, kw in ((m8, dict(gapopenextend=12, gapextend=1)),
                    (torch.from_numpy(sw.build_matrix_wide(m * 100)).to(dev),
                     dict(gapopenextend=1200, gapextend=100))):
        got = _scores_lax(qc, ql, mat, data, start, **kw)
        want = _scores_lax(qc.cpu(), ql.cpu(), mat.cpu(), data.cpu(),
                           start.cpu(), **kw)
        assert torch.equal(got.cpu(), want)
    h, e, s = sw.make_stream_state(3, 384, data.shape[1], dev)
    rows = sw.sw_scores_stream_carry_rows(
        qc, ql, m8, data, start, h, e, s, carry_in=False, carry_out=False,
        gapopenextend=12, gapextend=1)[0]
    assert torch.equal(rows, sw.sw_scores_stream(
        qc, ql, m8, data, start, gapopenextend=12, gapextend=1))


def test_mesh_and_multihost_engine_on_card(dev):
    """parallel.distributed on two cells of the card against the CPU's
    plain versions, and a one-rank MultiHostEngine on two cells of the
    card against SearchEngine (hit lists and alignments)."""
    from swipe_tpu_torch.parallel import distributed as dm
    from swipe_tpu_torch.parallel.multihost import MultiHostEngine
    rng = np.random.default_rng(18)
    seqs = [rng.integers(1, 24, size=int(n), dtype=np.int8)
            for n in rng.integers(5, 300, size=2000)]
    qs = [rng.integers(1, 24, size=int(n), dtype=np.int8)
          for n in (40, 120, 200, 250)]
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    ch = pack_stream(seqs, nseqs=512)[0]
    qc, ql = sw.build_qcodes(qs, 256)
    kw = dict(gapopenextend=12, gapextend=1, k=32)
    got, want = (dm.sharded_stream_topk(
        dm.make_mesh(2, 2, [d] * 4), qc, ql, sw.build_matrix8(m), ch.data,
        ch.start, *dm.shard_stream_chunk(ch, 2), **kw)
        for d in (dev, torch.device("cpu")))
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
    assert got[2] == want[2] == len(seqs) * len(qs)

    aa = list("ARNDCQEGHILKMFPSTWYV")
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 400, size=1500)]
    q = "".join(rng.choice(aa, 150))
    recs[9] = q[10:120]
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    params = SearchParams(descriptions=60, alignments=20)
    queries = [preprocess_query(f"q{i}", q[i:], 1, 3) for i in range(6)]
    hits = []
    for eng in (MultiHostEngine(FastaDatabase(io.StringIO(fasta), "aa"),
                                params, devices=[dev, dev]),
                SearchEngine(FastaDatabase(io.StringIO(fasta), "aa"), params,
                             device=dev)):
        hits.append([[(h.seqno, h.score, h.alignment) for h in hl.hits]
                     for hl in eng.search_batch(queries)])
    assert hits[0] == hits[1] and hits[0][0][0][0] == 9
