"""The port's spans and counters (``swipe_tpu_torch.trace``): nesting and
ids, the ring, counter changes a request, the copy counters, the shared
clock with ``torch.profiler``, and the spans of a search.

The last case needs a CUDA device and skips without one; the file imports
neither jax nor swipe_tpu, so it runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import io
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.ops import sw_stream as sw
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams
from swipe_tpu_torch.report import Reporter

AA = "ARNDCQEGHILKMFPSTWYV"


def test_spans_nest_with_parent_and_request_ids():
    m = trace.mark()
    with trace.span("setup.x", lanes=8) as a:
        with trace.span("setup.y"):
            pass
    with trace.request(queries=2) as root:
        with trace.span("scoring") as sc:
            with trace.span("scoring.group", slots=4):
                pass
        with trace.span("align"):
            pass
    got = trace.spans(since=m)
    assert [s.name for s in got] == ["setup.x", "setup.y", "search",
                                     "scoring", "scoring.group", "align"]
    ids = [s.id for s in got]
    assert ids == list(range(m, m + 6))
    assert [s.parent for s in got] == [-1, a.id, -1, root.id, sc.id,
                                       root.id]
    assert [s.request for s in got] == [-1, -1] + [root.id] * 4
    assert got[0].attrs == {"lanes": 8} and root.attrs == {"queries": 2}
    for s in got:
        assert 0 < s.start <= s.end
    # a child lies inside its parent
    assert root.start <= sc.start <= got[4].start <= got[4].end <= sc.end \
        <= got[5].start <= got[5].end <= root.end


def test_ring_overflow_counts_dropped_and_keeps_the_newest():
    try:
        trace.reset(capacity=4)
        d = trace.counter("trace.dropped")
        m = trace.mark()
        for i in range(10):
            with trace.span("s", i=i):
                pass
        assert trace.counter("trace.dropped") - d == 6
        assert [s.attrs["i"] for s in trace.spans()] == [6, 7, 8, 9]
        assert trace.spans(since=m + 8)[0].attrs["i"] == 8
    finally:
        trace.reset(capacity=trace.RING)


def test_request_records_counter_changes():
    trace.count("test.before", 5)
    with trace.request() as root:
        trace.count("test.a")
        trace.count("test.a", 2)
        trace.count("test.b", 7)
        with trace.span("scoring"):
            trace.count("test.b")
    trace.count("test.a", 100)          # after the request: not its own
    assert root.counts == {"test.a": 3, "test.b": 8}
    assert trace.spans(since=root.id)[1].counts is None


class _OnCard:
    """A stand-in for a tensor on the card: its ``cpu()`` is the copy."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)

    def cpu(self):
        return self.t.clone()


def test_copies_count_only_across_devices():
    x = np.arange(12, dtype=np.int32)
    before = trace.counters()
    m = trace.mark()
    t = trace.to_device(x, "cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
    assert trace.to_host(t) is t
    assert trace.to_device(t, torch.device("cpu")) is t
    assert trace.counters() == before and trace.spans(since=m) == []
    # a host array to another device counts its bytes once
    meta = trace.to_device(x, "meta")
    assert meta.device.type == "meta"
    assert trace.counter("h2d_copies") - before.get("h2d_copies", 0) == 1
    assert trace.counter("h2d_bytes") - before.get("h2d_bytes", 0) == 48
    # a copy back to the host is a sync span
    out = trace.to_host(_OnCard(torch.ones(3, 5, dtype=torch.int64)))
    assert out.shape == (3, 5)
    assert trace.counter("d2h_copies") - before.get("d2h_copies", 0) == 1
    assert trace.counter("d2h_bytes") - before.get("d2h_bytes", 0) == 120
    assert [s.name for s in trace.spans(since=m)] == ["sync"]


def _kineto(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_spans_share_the_profiler_clock():
    """A program span opened inside a record_function range lies within
    that range's interval on the trace, and the range within the host
    clock's reads around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = []
        for i in range(5):
            t0 = time.time_ns()
            with record_function(f"probe{i}"):
                with trace.span("probe") as sp:
                    time.sleep(0.002)
            got.append((t0, sp, time.time_ns()))
    for i, (t0, sp, t1) in enumerate(got):
        (lo, hi), = _kineto(prof, f"probe{i}")
        assert t0 <= lo <= sp.start < sp.end <= hi <= t1


def _fasta(recs):
    return "".join(f">s{i} record {i}\n{s}\n" for i, s in enumerate(recs))


def test_search_spans_and_counters():
    """A CPU search: the set-up steps, then per request search > scoring
    > scoring.group > scoring.enter, finalize, align > align.fetch /
    align.hint / align.traceback, and the report.  The plain versions
    run (here counted by a spy) and launch nothing, and nothing crosses
    devices."""
    rng = np.random.default_rng(5)
    qs = ["".join(rng.choice(list(AA), n)) for n in (70, 90, 80)]
    recs = ["".join(rng.choice(list(AA), int(rng.integers(20, 120))))
            for _ in range(120)]
    for i, q in enumerate(qs):
        recs[7 + 11 * i] = recs[7 + 11 * i][:10] + q[5:35]
    m = trace.mark()
    db = FastaDatabase(io.StringIO(_fasta(recs)), "aa", title="t")
    eng = SearchEngine(db, SearchParams(symtype=1, descriptions=20,
                                        alignments=5, expect=1e3),
                       device="cpu", nseqs=1024)
    setup = [s.name for s in trace.spans(since=m)]
    assert setup == ["setup.db", "setup.units", "setup.pack"]
    calls = []
    plain = sw.sw_scores_stream_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    queries = [preprocess_query(f"q{i}", q, 1, 3)
               for i, q in enumerate(qs)]
    sw.sw_scores_stream_plain = spy
    try:
        m = trace.mark()
        hls = eng.search_batch(queries)
    finally:
        sw.sw_scores_stream_plain = plain
    Reporter(io.StringIO(), 0, 1, eng.matrix.matrix,
             query=queries[0]).show(hls[0], "t")
    got = trace.spans(since=m)
    by_id = {s.id: s for s in got}

    def path(s):
        out = [s.name]
        while s.parent in by_id:
            s = by_id[s.parent]
            out.append(s.name)
        return "/".join(reversed(out))

    root = got[0]
    assert root.name == "search" and root.attrs == {"queries": 3}
    paths = [path(s) for s in got]
    # the first group uploads the plain pack
    assert paths == [
        "search", "search/scoring", "search/scoring/scoring.group",
        "search/scoring/scoring.group/setup.upload",
        "search/scoring/scoring.group/scoring.enter",
        "search/finalize", "search/align", "search/align/align.fetch",
        "search/align/align.hint", "search/align/align.traceback",
        "report"]
    assert all(s.request == root.id for s in got[:-1])
    assert got[-1].request == -1
    group = got[2].attrs
    assert group == {"qlen_pad": 96, "nseqs": 1024, "long": False,
                     "slots": 3, "route": "stream"}
    assert got[8].name == "align.hint" and got[8].attrs["bins"] == 3
    assert calls and not any(k.startswith(("launch.", "d2h", "h2d"))
                             for k in root.counts)
    # a second search finds the pack on the device: no set-up span
    m = trace.mark()
    eng.search_batch(queries[:1])
    assert not [s for s in trace.spans(since=m)
                if s.name.startswith("setup.")]


@pytest.mark.parametrize("route", ["segment", "giants"])
def test_other_routes_open_their_groups(route):
    """The segment-packed route's group, and the giants' group after a
    plain group's, each with their host work on hits inside."""
    rng = np.random.default_rng(8)
    q = "".join(rng.choice(list(AA), 60))
    recs = ["".join(rng.choice(list(AA), int(rng.integers(20, 100))))
            for _ in range(60)]
    recs[3] = "".join(rng.choice(list(AA), 400)) + q[5:50]
    # records over 256 columns are giants
    kw = dict(backend="pallas_v1") if route == "segment" \
        else dict(nseqs=1024)
    eng = SearchEngine(FastaDatabase(io.StringIO(_fasta(recs)), "aa"),
                       SearchParams(symtype=1, descriptions=10,
                                    alignments=2, expect=1e3),
                       device="cpu", max_cols=256, **kw)
    m = trace.mark()
    hl, = eng.search_batch([preprocess_query("q", q, 1, 3)])
    assert hl.hits[0].seqno == 3
    groups = [s for s in trace.spans(since=m) if s.name == "scoring.group"]
    want = ["segment", "giants"] if route == "segment" \
        else ["stream", "giants"]
    assert [g.attrs["route"] for g in groups] == want
    enters = [s for s in trace.spans(since=m) if s.name == "scoring.enter"]
    assert sorted({s.parent for s in enters}) == [g.id for g in groups]


def _device_ops(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


@pytest.mark.cuda
def test_card_work_lies_within_its_program_span():
    """On the card: K2 launched and its scores copied back inside a
    program span lie, on the device trace, within that span, and the
    copy ends inside its sync span, which waits for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from swipe_tpu_torch.batching import pack_stream
    from swipe_tpu_torch.matrices import ScoreMatrix
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 200, size=3000)]
    ch = pack_stream(seqs, nseqs=1024, max_cols=512)[0]
    m8 = trace.to_device(sw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix), dev)
    data, start, eb, ln = sw.chunk_tensors(ch.data_t, ch.start,
                                           ch.end_block, ch.lane, dev)
    qc, ql = sw.build_qcodes([rng.integers(1, 21, size=150)
                              for _ in range(4)], 160)
    qc, ql = trace.to_device(qc, dev), trace.to_device(ql, dev)

    def step():
        out = sw.sw_scores_stream(qc, ql, m8, data, start, gapopenextend=12,
                                  gapextend=1)
        return trace.to_host(sw.gather_scores(out, eb, ln))

    step()                              # build and load the kernel
    torch.cuda.synchronize()
    n = trace.launched("swipe_stream_rows")
    copies = trace.counter("d2h_copies")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        with trace.span("probe") as sp:
            step()
        time.sleep(0.01)
    assert trace.launched("swipe_stream_rows") > n
    assert trace.counter("d2h_copies") == copies + 1
    sync, = [s for s in trace.spans(since=sp.id) if s.name == "sync"]
    ops = _device_ops(prof)
    kernels = [o for o in ops if "stream_rows_kernel" in o[0]]
    copies = [o for o in ops if "DtoH" in o[0]]
    assert kernels and copies
    for _, s, e in kernels + copies:
        assert sp.start <= s and e <= sp.end
    for _, s, e in copies:
        assert sync.start < e <= sync.end
