"""Live query slots a walk of a pack carries: the program's
``scoring.slots.<route>`` counters over its ``scoring.passes.<route>``
counters (route ``stream``, ``flow`` or ``long``; a pass is one slot
group's walk of its pack, and the power-of-two padding slots are not
live), both summed over the window's requests, the change their
``search`` spans record.  Nothing to read where the program has no such
counters."""

from portbench import program_spans

ROUTES = ("stream", "flow", "long")


def read(run):
    got = program_spans.window_spans(run)
    if got is None:
        return None
    spans, (lo, hi) = got
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]

    def total(kind):
        return sum(r.counts.get(f"scoring.{kind}.{route}", 0) for r in roots
                   for route in ROUTES)

    passes = total("passes")
    return total("slots") / passes if passes else None
