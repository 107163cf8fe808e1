"""Share of the traced window in which no kernel, copy or memset runs on
the card, from the trace's own timeline (not from host time around the
profiler)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_ns <= 0 or not tl.ops:
        return None
    busy = sum(e - s for s, e in tl.busy)
    return 100.0 * (1.0 - busy / tl.window_ns)
