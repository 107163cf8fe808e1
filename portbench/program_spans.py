"""The program's own spans (``swipe_tpu_torch.trace``) over a traced
window: what the ``program_span`` metrics read, and the card's idle time
by program step.

The program keeps its spans in a ring in memory, on the clock that
``torch.profiler`` stamps its events with (the Unix epoch in
nanoseconds), so they clip to the trace's window (``run.timeline.window``)
as they are.  A metric reads nothing (None) where the run has no
timeline, where the program has no spans (a version without
``swipe_tpu_torch.trace``), where the ring dropped spans the window may
have held, or where no span of its name fell in the window.

Run as a script, it runs one traced cell as ``run.py --trace 1`` does and
then prints, as a ``program_spans`` line on standard error, the card's
idle seconds by the innermost program span they fell in, and the
program's spans beside the benchmark's own readings of the same steps:

    python3 portbench/program_spans.py --workload NAME --seed N --seconds S
"""

from __future__ import annotations

import json
import os
import sys


def ring():
    """(the program's spans, oldest first; the spans it dropped), or None
    where the program keeps none."""
    try:
        from swipe_tpu_torch import trace
    except ImportError:
        return None
    return trace.spans(), trace.counter("trace.dropped")


def window_spans(run):
    """(the program's spans, the window (lo, hi)), or None where there is
    no window, no span, or a dropped span may have fallen in the
    window."""
    tl = run.timeline
    got = ring()
    if tl is None or tl.window_ns <= 0 or got is None:
        return None
    spans, dropped = got
    lo, hi = tl.window
    # the ring drops its oldest spans first
    if dropped and (not spans or spans[0].start > lo):
        return None
    return spans, (lo, hi)


def clipped(s, lo: int, hi: int) -> int:
    """Nanoseconds of span ``s`` inside [lo, hi)."""
    return max(0, min(s.end, hi) - max(s.start, lo))


def queries(run) -> int:
    return sum(r.queries for r in run.requests)


def named_ms_per_query(run, name: str):
    """Milliseconds a query of the spans named ``name`` in the window."""
    got = window_spans(run)
    n = queries(run)
    if got is None or not n:
        return None
    spans, (lo, hi) = got
    ns = [clipped(s, lo, hi) for s in spans
          if s.name == name and s.end > lo and s.start < hi]
    return sum(ns) / 1e6 / n if ns else None


def ancestor(s, by_id: dict, name: str):
    """The nearest enclosing span of ``s`` named ``name``, or None."""
    while s.parent in by_id:
        s = by_id[s.parent]
        if s.name == name:
            return s
    return None


def host_ms_per_query(run, name: str):
    """Milliseconds a query of the spans named ``name`` in the window,
    less the ``sync`` spans inside them (the host's waits for the
    card)."""
    got = window_spans(run)
    n = queries(run)
    if got is None or not n:
        return None
    spans, (lo, hi) = got
    inside = [s for s in spans if s.end > lo and s.start < hi]
    outer = [s for s in inside if s.name == name]
    if not outer:
        return None
    by_id = {s.id: s for s in spans}
    waits = sum(clipped(s, lo, hi) for s in inside if s.name == "sync"
                and ancestor(s, by_id, name) is not None)
    return (sum(clipped(s, lo, hi) for s in outer) - waits) / 1e6 / n


def per_query_count(run, counter: str, scale: float = 1.0):
    """A counter's change over the window's requests (``search`` roots),
    per query they served."""
    got = window_spans(run)
    if got is None:
        return None
    spans, (lo, hi) = got
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]
    n = sum(s.attrs.get("queries", 0) for s in roots)
    if not n:
        return None
    return sum(s.counts.get(counter, 0) for s in roots) * scale / n


def setup_seconds(run):
    """Seconds of the program's set-up steps (``setup.*`` spans, the
    outermost of each nest) that ended before the window."""
    tl = run.timeline
    got = ring()
    if tl is None or tl.window_ns <= 0 or got is None or got[1]:
        return None
    spans = got[0]
    lo = tl.window[0]
    by_id = {s.id: s for s in spans}

    def outermost(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name.startswith("setup."):
                return False
            p = by_id.get(p.parent)
        return True

    steps = [s for s in spans if s.name.startswith("setup.")
             and 0 < s.end <= lo and outermost(s)]
    return sum(s.end - s.start for s in steps) / 1e9 if steps else None


def label(s, by_id: dict) -> str:
    """A step's name; a wait names the step it waited in."""
    if s.name == "sync" and s.parent in by_id:
        return f"sync in {by_id[s.parent].name}"
    return s.name


def innermost(spans, lo: int, hi: int):
    """[(start, end, label)]: [lo, hi) cut where the innermost open program
    span changes ("outside" where none is open)."""
    by_id = {s.id: s for s in spans}
    out = []
    t = lo

    def emit(a, b, name):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, name))

    stack = []
    for s in sorted((s for s in spans if s.end > lo and s.start < hi),
                    key=lambda s: (s.start, -s.end, s.id)):
        while stack and stack[-1][0] <= s.start:
            end, name = stack.pop()
            emit(t, end, name)
            t = max(t, end)
        emit(t, s.start, stack[-1][1] if stack else "outside")
        t = max(t, s.start)
        stack.append((min(s.end, stack[-1][0]) if stack else s.end,
                      label(s, by_id)))
    while stack:
        end, name = stack.pop()
        emit(t, end, name)
        t = max(t, end)
    emit(t, hi, "outside")
    return out


def idle_by_step(tl, spans) -> dict:
    """{step: (idle seconds, gaps)}: the card's idle time in the window,
    split by the innermost program span the host was in."""
    lo, hi = tl.window
    segs = innermost(spans, lo, hi)
    out: dict = {}
    j = 0
    for a, b in tl.gaps():
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        seen = set()
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            ns = min(b, e) - max(a, s)
            if ns > 0:
                rec = out.setdefault(name, [0.0, 0])
                rec[0] += ns / 1e9
                if name not in seen:
                    rec[1] += 1
                    seen.add(name)
            k += 1
    return {k: tuple(v) for k, v in sorted(out.items(),
                                           key=lambda kv: -kv[1][0])}


def _median(v):
    v = sorted(v)
    return v[len(v) // 2] if v else None


def report(run, setup: dict) -> dict:
    """The traced run's program spans beside the benchmark's readings."""
    from portbench import workload
    spans, (lo, hi) = window_spans(run)
    tl = run.timeline
    n = queries(run)

    def metric(name):
        return workload.load_module("metrics", name).read(run)

    steps = {k: metric(k) for k in ("align_fetch_ms", "align_hint_ms",
                                    "align_traceback_ms")}
    align_ms = metric("align_ms")
    scoring_s = sum(clipped(s, lo, hi) for s in spans
                    if s.name == "scoring") / 1e9
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]
    per_root = {r.id: 0 for r in roots}
    for s in spans:
        if s.request in per_root:
            per_root[s.request] += 1
    adds = [sum(v for k, v in r.counts.items() if k.startswith("launch."))
            + 2 * r.counts.get("d2h_copies", 0)
            + 2 * r.counts.get("h2d_copies", 0) for r in roots]
    by_id = {s.id: s for s in spans}
    packs = [s for s in spans if s.name == "setup.pack"
             and s.attrs.get("route") in ("stream", "pieces")]
    return {
        "queries": n, "requests": len(roots),
        "idle_by_step": idle_by_step(tl, spans),
        "align_steps_ms": steps, "align_ms": align_ms,
        "align_steps_share": sum(steps.values()) / align_ms
        if align_ms and None not in steps.values() else None,
        "scoring_span_s": scoring_s,
        "search_timings_s": sum(r.prog_scoring_s for r in run.requests),
        "setup_db_s": sum(s.ns for s in spans if s.name == "setup.db")
        / 1e9, "fasta_parse_s": setup.get("fasta_parse"),
        "setup_pack_s": sum(s.ns for s in packs) / 1e9,
        "harness_pack_s": sum(v for k, v in setup.items()
                              if k.startswith("pack ")),
        "setup_spans": [(s.name, s.attrs, s.ns / 1e9) for s in spans
                        if s.name.startswith("setup.") and s.end <= lo],
        "setup_in_window": sum(1 for s in spans
                               if s.name.startswith("setup.")
                               and s.end > lo and s.start < hi),
        "spans_per_request": _median(list(per_root.values())),
        "counter_adds_per_request": _median(adds),
        "counts_per_request": {
            k: _median([r.counts.get(k, 0) for r in roots])
            for k in sorted({k for r in roots for k in r.counts})},
        "sync_parents": sorted({by_id[s.parent].name for s in spans
                                if s.name == "sync" and s.parent in by_id}),
    }


def main(argv=None) -> int:
    """One traced run of a cell (run.py's arguments, ``--trace`` fixed to
    1), then the report."""
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    from portbench import harness

    argv = list(sys.argv[1:] if argv is None else argv)
    kept: dict = {}
    make_run, set_up = harness.Run, harness.set_up

    def run_of(*a, **k):
        kept["run"] = make_run(*a, **k)
        return kept["run"]

    def set_up_of(*a, **k):
        kept["setup"] = a[-1]
        return set_up(*a, **k)

    harness.Run, harness.set_up = run_of, set_up_of
    try:
        rc = harness.main(argv + ["--trace", "1"])
    finally:
        harness.Run, harness.set_up = make_run, set_up
    if "run" not in kept or window_spans(kept["run"]) is None:
        print("program_spans: no traced window with program spans",
              file=sys.stderr)
        return rc or 1
    out = report(kept["run"], kept.get("setup", {}))
    print("program_spans " + json.dumps(out, default=str), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
