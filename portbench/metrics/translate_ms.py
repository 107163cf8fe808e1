"""Milliseconds a query spends translating database records into
reading frames while it is served: the program's ``db.translate`` spans
inside the window's ``search`` spans (in a translated-db search, the
align phase fetching each shown hit's frame), over the queries those
requests served.  Nothing to read where the database is not translated
or the program has no such span."""

from portbench import program_spans


def read(run):
    got = program_spans.window_spans(run)
    if got is None:
        return None
    spans, (lo, hi) = got
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]
    ids = {r.id for r in roots}
    n = sum(r.attrs.get("queries", 0) for r in roots)
    ns = [s.ns for s in spans if s.name == "db.translate"
          and s.request in ids]
    return sum(ns) / 1e6 / n if ns and n else None
