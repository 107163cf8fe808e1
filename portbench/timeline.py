"""The device's timeline, read from a ``torch.profiler`` trace.

Device activity is every kernel, copy and memset that the trace puts on
the card; host spans are the benchmark's own ``record_function`` ranges
(``portbench.<name>``).  All times are the trace's nanoseconds, which
kineto puts on one clock for the host and the card.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from functools import cached_property

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
# a gap is named by the innermost benchmark span the host was in
SPAN_ORDER = ("report", "align", "scoring", "search", "request", "window")


def merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def measure(intervals) -> int:
    return sum(e - s for s, e in intervals)


def intersect(a, b):
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


@dataclass
class Timeline:
    """Device activity and host spans of one traced window."""

    window: tuple[int, int]
    ops: list[tuple[str, int, int]]                  # (name, start, end)
    spans: dict[str, list] = field(default_factory=dict)

    @cached_property
    def busy(self):
        """Merged device intervals inside the window."""
        return clip(merge((s, e) for _, s, e in self.ops), *self.window)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_in(self, span: str) -> int:
        """Device nanoseconds inside the host spans named ``span``."""
        return measure(intersect(self.busy,
                                 merge(self.spans.get(span, []))))

    def top_ops(self, n: int = 10):
        """[(name, seconds)] of the device operations that took most time
        in the window, summed by name."""
        lo, hi = self.window
        tot: dict[str, int] = {}
        for name, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                tot[name] = tot.get(name, 0) + e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def gaps(self):
        """Idle intervals of the device inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_span_at(self, t: int) -> str:
        """The innermost benchmark span the host was in at ``t`` (spans of
        one name never overlap)."""
        for name in SPAN_ORDER:
            iv = self.spans.get(name)
            if not iv:
                continue
            k = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if k >= 0 and iv[k][0] <= t < iv[k][1]:
                return name
        return "outside"

    def idle_by_span(self, n: int = 10):
        """[(label, seconds)]: idle time by the host span it fell in, and
        the longest single gaps, at most n entries."""
        tot: dict[str, list] = {}
        gaps = []
        for s, e in self.gaps():
            name = self.host_span_at((s + e) // 2)
            rec = tot.setdefault(name, [0, 0])
            rec[0] += e - s
            rec[1] += 1
            gaps.append((e - s, name))
        out = [[f"{name} ({cnt} gaps)", ns / 1e9]
               for name, (ns, cnt) in sorted(tot.items(),
                                             key=lambda kv: -kv[1][0])]
        for ns, name in sorted(gaps, reverse=True)[:max(n - len(out), 0)]:
            out.append([f"longest gap, in {name}", ns / 1e9])
        return out[:n]


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind())
    dev = str(ev.device_type())
    if dev.endswith("CUDA"):
        return "gpu_user_annotation" if ev.name().startswith(SPAN_PREFIX) \
            else "kernel"
    return "user_annotation" if ev.name().startswith(SPAN_PREFIX) \
        else "cpu_op"


def from_profiler(prof) -> Timeline:
    """Device operations and benchmark spans of a stopped profiler; the
    window is its ``portbench.window`` span."""
    ops, spans = [], {}
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if kind in DEVICE_KINDS:
            ops.append((ev.name(), s, e))
        elif kind == "user_annotation" and ev.name().startswith(SPAN_PREFIX):
            spans.setdefault(ev.name()[len(SPAN_PREFIX):], []).append((s, e))
    for iv in spans.values():
        iv.sort()
    window = spans.get("window", [(0, 0)])[0]
    return Timeline(window, ops, spans)
