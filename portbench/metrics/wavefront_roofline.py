"""The wavefront kernel's (K7's) least time over its busy time, in
percent: its share of its roofline.

Least time: the cells the program counts in ``giant.cells.wavefront``
over the window's requests (each slot's query residues times the
giants' residues, no padding), at ``score_roofline``'s instructions a
cell over its instruction rate: 6 integer instructions a cell of the
recurrence, two cells an instruction in packed 16-bit DPX, at 33.5e12
thread instructions a second (NVIDIA's H100 SXM5 data sheet at its 700 W
power limit).  K7 as written (``csrc/wavefront.cu``) computes a cell in
32-bit registers: four DPX add-max, an add and half of a three-way max,
and a load of the profile from shared memory, about 6.5 instructions
where this bound counts 3, so it cannot pass about 46% of it.

Busy time: the device's ``wavefront_kernel`` launches, merged, that
overlap those requests' ``giant.wavefront`` spans, counted whole (the
trace's device clock may lie up to about half a millisecond off the
host's, so a kernel near a span's end is not cut).  Nothing to read
where the window ran no wavefront kernel or the program has no such
span or counter."""

import bisect

from portbench import program_spans, timeline

KERNEL = "wavefront_kernel"
INSTRUCTIONS_PER_CELL = 6 / 2
INSTRUCTION_RATE = 67e12 / 2    # thread instructions a second


def read(run):
    tl = run.timeline
    got = program_spans.window_spans(run)
    if tl is None or got is None:
        return None
    spans, (lo, hi) = got
    roots = [s for s in spans if s.name == "search" and s.counts is not None
             and lo <= s.start and s.end <= hi]
    ids = {r.id for r in roots}
    cells = sum(r.counts.get("giant.cells.wavefront", 0) for r in roots)
    route = timeline.merge((s.start, s.end) for s in spans
                           if s.name == "giant.wavefront"
                           and s.request in ids)
    if not cells or not route:
        return None
    starts = [s for s, _ in route]

    def inside(s, e):
        k = bisect.bisect_right(starts, e) - 1
        return k >= 0 and route[k][1] >= s

    busy = timeline.measure(timeline.merge(
        (s, e) for name, s, e in tl.ops if KERNEL in name and inside(s, e)))
    if busy <= 0:
        return None
    least_s = cells * INSTRUCTIONS_PER_CELL / INSTRUCTION_RATE
    return 100.0 * least_s / (busy / 1e9)
