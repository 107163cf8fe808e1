"""The program_span metrics and the idle split by program step, on
synthetic span rings and timelines."""

import sys
from types import SimpleNamespace

import pytest

from portbench import program_spans, timeline, workload
from portbench.harness import Request, Run

MS = 10**6
NAMES = ("align_fetch_ms", "align_hint_ms", "align_traceback_ms",
         "scoring_host_ms", "syncs_per_query", "h2d_mb_per_query",
         "engine_setup_s")


def reader(name):
    return workload.load_module("metrics", name).read


class Ring:
    """Spans built in id order, as the program's ring holds them."""

    def __init__(self):
        self.spans = []
        self.open = []

    def add(self, name, start, end, counts=None, **attrs):
        parent = self.open[-1] if self.open else None
        s = SimpleNamespace(
            id=len(self.spans), name=name, start=start * MS, end=end * MS,
            parent=parent.id if parent else -1,
            request=parent.request if parent else -1, attrs=attrs,
            counts=counts)
        if name == "search":
            s.request = s.id
        s.ns = s.end - s.start
        self.spans.append(s)
        return s

    def __call__(self, name, start, end, counts=None, **attrs):
        """A span whose children are added inside the ``with``."""
        ring = self

        class Open:
            def __enter__(self):
                self.s = ring.add(name, start, end, counts, **attrs)
                ring.open.append(self.s)
                return self.s

            def __exit__(self, *exc):
                ring.open.pop()

        return Open()


def request(ring, t, queries, counts):
    """One request at t ms: scoring 10 ms (a group with a 2-ms wait in
    it, a 1-ms wait outside it), then align 6 ms (fetch 1, hint 3,
    traceback 2)."""
    with ring("search", t, t + 20, counts=counts, queries=queries):
        with ring("scoring", t, t + 10):
            with ring("scoring.group", t, t + 8):
                ring.add("sync", t + 5, t + 7)
            ring.add("sync", t + 8.5, t + 9.5)
        ring.add("finalize", t + 10, t + 11)
        with ring("align", t + 11, t + 17):
            ring.add("align.fetch", t + 11, t + 12)
            with ring("align.hint", t + 12, t + 15):
                ring.add("sync", t + 14, t + 15)
            ring.add("align.traceback", t + 15, t + 17)


def synthetic(window=(100, 160)):
    """Set-up before the window, then three requests of which the window
    (100-160 ms) holds the last two and half of the first's align."""
    ring = Ring()
    ring.add("setup.db", 0, 10)
    with ring("setup.pack", 10, 30, route="stream"):
        ring.add("setup.upload", 20, 30)            # nested: not twice
    ring.add("setup.units", 30, 35)
    request(ring, 85, 16, {"d2h_copies": 99, "h2d_bytes": 7})
    request(ring, 110, 2, {"d2h_copies": 3, "h2d_bytes": 2_000_000,
                           "launch.swipe_stream_rows": 9})
    request(ring, 135, 2, {"d2h_copies": 5})
    ops = [("K2", 112 * MS, 115 * MS), ("K4", 125 * MS, 126 * MS)]
    tl = timeline.Timeline((window[0] * MS, window[1] * MS), ops, {})
    reqs = [Request(0, 1, queries=2), Request(1, 2, queries=2)]
    return ring, Run(reqs, tl)


@pytest.fixture
def ring(monkeypatch):
    ring, run = synthetic()
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    return ring, run


def test_metrics_read_the_known_values(ring):
    _, run = ring
    got = {n: reader(n)(run) for n in NAMES}
    # the first request's align (96-102) is clipped at 100: its
    # traceback (100-102) counts, its fetch and hint do not
    assert got["align_fetch_ms"] == pytest.approx(2 / 4)
    assert got["align_hint_ms"] == pytest.approx(6 / 4)
    assert got["align_traceback_ms"] == pytest.approx((2 + 2 + 2) / 4)
    # scoring 10 ms a request less its 3 ms of waits, two requests
    assert got["scoring_host_ms"] == pytest.approx(2 * 7 / 4)
    # the roots inside the window: 3 + 5 copies, 2 MB over 4 queries
    assert got["syncs_per_query"] == pytest.approx(8 / 4)
    assert got["h2d_mb_per_query"] == pytest.approx(2 / 4)
    # db, pack (its upload inside it) and units, all before 100 ms
    assert got["engine_setup_s"] == pytest.approx(0.035)


def test_metrics_read_nothing_without_a_window_or_a_program_ring(ring,
                                                                 monkeypatch):
    _, run = ring
    bare = Run(run.requests)
    assert all(reader(n)(bare) is None for n in NAMES)
    monkeypatch.setattr(program_spans, "ring", lambda: None)
    assert all(reader(n)(run) is None for n in NAMES)


def test_metrics_read_nothing_for_a_program_without_trace(monkeypatch):
    """Over a program that has no trace module (an older checkout)."""
    import swipe_tpu_torch
    _, run = synthetic()
    monkeypatch.delattr(swipe_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "swipe_tpu_torch.trace", None)
    assert program_spans.ring() is None
    assert all(reader(n)(run) is None for n in NAMES)


def test_dropped_spans_in_the_window_read_nothing(ring, monkeypatch):
    spans, run = ring[0].spans, ring[1]
    # the ring lost its oldest spans, and the oldest kept starts inside
    # the window: a span of the window may be gone
    kept = [s for s in spans if s.start >= 111 * MS]
    monkeypatch.setattr(program_spans, "ring", lambda: (kept, 40))
    assert all(reader(n)(run) is None for n in NAMES)
    # lost only before the window: the window's metrics read, set-up not
    kept = [s for s in spans if s.start >= 40 * MS]
    monkeypatch.setattr(program_spans, "ring", lambda: (kept, 6))
    assert reader("align_hint_ms")(run) == pytest.approx(6 / 4)
    assert reader("syncs_per_query")(run) == pytest.approx(2)
    assert reader("engine_setup_s")(run) is None


def test_absent_spans_read_nothing(monkeypatch):
    ring = Ring()
    ring.add("setup.db", 0, 10)
    ring.add("align.fetch", 1, 2)          # before the window
    ring.add("search", 120, 130, counts={}, queries=1)
    _, run = synthetic()
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    for n in ("align_fetch_ms", "align_hint_ms", "align_traceback_ms",
              "scoring_host_ms"):
        assert reader(n)(run) is None
    # a root with no copies reads 0 copies; set-up reads
    assert reader("syncs_per_query")(run) == 0
    assert reader("h2d_mb_per_query")(run) == 0
    assert reader("engine_setup_s")(run) == pytest.approx(0.01)


def test_idle_by_innermost_program_step(ring):
    r, run = ring
    idle = program_spans.idle_by_step(run.timeline, r.spans)
    # busy 112-115 and 125-126: idle 100-112, 115-125, 126-160
    total = sum(s for s, _ in idle.values())
    assert total == pytest.approx(0.060 - 0.004)
    assert idle["sync in scoring.group"][0] == pytest.approx(0.004)
    assert idle["sync in scoring"][0] == pytest.approx(0.002)
    assert idle["sync in align.hint"][0] == pytest.approx(0.002)
    # the first request's traceback 100-102, the second's 125-127 less
    # the busy 125-126, the third's 150-152
    assert idle["align.traceback"][0] == pytest.approx(0.005)
    # between requests, and after the last one
    assert idle["outside"][0] == pytest.approx(0.015)
    # each gap counts once for each step it fell in: 2 + 1 + (5 + 1) ms
    assert idle["scoring.group"] == (pytest.approx(0.009), 3)


def test_innermost_cuts_the_window_by_the_open_span(ring):
    r, _ = ring
    segs = program_spans.innermost(r.spans, 96 * MS, 112 * MS)
    assert [(a / MS, b / MS, n) for a, b, n in segs] == [
        (96, 97, "align.fetch"), (97, 99, "align.hint"),
        (99, 100, "sync in align.hint"), (100, 102, "align.traceback"),
        (102, 105, "search"), (105, 110, "outside"),
        (110, 112, "scoring.group")]
