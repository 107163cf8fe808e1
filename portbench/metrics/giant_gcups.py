"""GCUPS of the giant routes alone: the cells the program counts in
``giant.cells.pieces``, ``.wavefront`` and ``.carry`` (each slot's query
residues times the giants' residues, no padding, no piece overlap) over
the window's requests, the change their ``search`` spans record, over
the seconds of those requests' ``giant.pieces``, ``giant.wavefront`` and
``giant.carry`` spans, each of which covers a route's uploads, kernel
calls and copies back."""

from portbench import program_spans

ROUTES = ("pieces", "wavefront", "carry")


def read(run):
    got = program_spans.window_spans(run)
    if got is None:
        return None
    spans, (lo, hi) = got
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]
    ids = {r.id for r in roots}
    cells = sum(r.counts.get(f"giant.cells.{route}", 0) for r in roots
                for route in ROUTES)
    names = {f"giant.{route}" for route in ROUTES}
    ns = sum(s.ns for s in spans if s.name in names and s.request in ids)
    return cells / ns if cells and ns > 0 else None
