"""Spans and counters of the port's host path, always on.

A span is one step of the host's work: a name (``<layer>.<step>``), its
start and end in nanoseconds, the id of the span it was opened in, the id
of its request and a few scalar attributes::

    with trace.span("align.hint", bins=12):
        ...

The clock is ``time.time_ns``, the Unix-epoch clock that
``torch.profiler`` (kineto) stamps its events with, so a span can be laid
over a device trace and each idle gap of the card put down to a step.

``request(**attrs)`` opens a root span, ``search``; its id is the request
id of every span opened inside it, and it records the change of every
counter over its interval (``Span.counts``).  ``count(name, n)`` adds to
one process-wide table of counters: kernel launches (``launch.<C
entry>``, raised by ``ops.sw_stream._launch``), the host-to-device and
device-to-host copies of ``to_device`` and ``to_host`` (``h2d_copies``,
``h2d_bytes``, ``d2h_copies``, ``d2h_bytes``), the hint pass's lanes by
route (``hint.lanes_kernel``, ``hint.lanes_host``: ops.align_hint), the
walks of a pack by one slot group and the live slots they carried, the
power-of-two padding slots left out (``scoring.passes.<route>``,
``scoring.slots.<route>``, route ``stream``, ``flow`` or ``long``:
pipeline), the cells each giant route walked (``giant.cells.pieces``,
``.wavefront``, ``.carry``: pipeline, inside the spans
``giant.<route>``), the wavefront
kernel's chains (``wavefront.chains``: a query through one piece of a
giant) and the cells they walk, overlap and padding included
(``wavefront.cells_walked``: the slots' query residues times the
columns; ops.sw_wavefront.sw_wavefront_giants), the bases of
the reading frames a database translated (``translate.bases``: io.db,
inside the spans ``db.translate``), the align phase's subject fetches on
a nucleotide database (pipeline ``SearchEngine.subject``:
``align.subject.held`` those the engine's memory served,
``align.subject.derived`` the giants' minus strands it made, once each,
``align.subject.db`` those the database served) and ``trace.dropped``.

Spans live in a ring of ``RING`` records, with no I/O: a span opened
when the ring is full takes the oldest record's place and raises
``trace.dropped``.  Spans are opened on one thread (the search's), never
across a ``yield``.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["RING", "Span", "count", "counter", "counters", "launched",
           "mark", "request", "reset", "span", "spans", "to_device",
           "to_host"]

# set-up and a 40-s window of the busiest served mix (about 50 spans a
# request) take under 20,000 records
RING = 1 << 17

_clock = time.time_ns
_ring: list = [None] * RING
_next = 0                       # id of the next span
_stack: list = []               # open spans, innermost last
_counts: dict[str, int] = {}


class Span:
    """One span's record; its own context manager."""

    __slots__ = ("id", "name", "start", "end", "parent", "request", "attrs",
                 "counts")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end = 0
        self.counts = None

    def __enter__(self):
        global _next
        i = self.id = _next
        _next = i + 1
        if _stack:
            top = _stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent = self.request = -1
        if _ring[i % len(_ring)] is not None:
            _counts["trace.dropped"] = _counts.get("trace.dropped", 0) + 1
        _ring[i % len(_ring)] = self
        _stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            _stack.remove(self)

    @property
    def ns(self) -> int:
        return self.end - self.start


class _Request(Span):
    __slots__ = ("_before",)

    def __enter__(self):
        self._before = dict(_counts)
        super().__enter__()
        self.request = self.id
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        before = self._before
        self.counts = {k: v - before.get(k, 0) for k, v in _counts.items()
                       if v != before.get(k, 0)}
        self._before = None


def span(name: str, **attrs) -> Span:
    """A span of ``name`` with scalar ``attrs``, to enter with ``with``."""
    return Span(name, attrs)


def request(**attrs) -> Span:
    """The root span of one search request, ``search``."""
    return _Request("search", attrs)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def counters() -> dict[str, int]:
    """A copy of the counter table."""
    return dict(_counts)


def launched(entry: str) -> int:
    """Launches of the kernel behind C entry ``entry`` so far (take the
    difference over a block)."""
    return _counts.get("launch." + entry, 0)


def spans(since: int = 0) -> list[Span]:
    """The ring's spans with an id of at least ``since``, oldest first."""
    k = _next % len(_ring)
    return [s for s in _ring[k:] + _ring[:k]
            if s is not None and s.id >= since]


def mark() -> int:
    """The id the next span will get (``spans(since=mark())``)."""
    return _next


def reset(capacity: int | None = None) -> None:
    """Empty the ring, at ``capacity`` records when given; the counters
    keep their values."""
    global _ring
    _ring = [None] * (capacity or len(_ring))
    _stack.clear()


def to_device(x, device):
    """``x`` (a tensor or a NumPy array) as a tensor on ``device``; a
    copy from the host counts in ``h2d_copies`` and ``h2d_bytes``."""
    if isinstance(x, np.ndarray):
        import torch
        t = torch.from_numpy(x)
    else:
        t = x
    out = t.to(device)
    if out.device.type != "cpu" and t.device.type == "cpu":
        count("h2d_copies")
        count("h2d_bytes", t.numel() * t.element_size())
    return out


def to_host(t):
    """``t`` on the host.  A copy from the card waits for it: it is a
    ``sync`` span and counts in ``d2h_copies`` and ``d2h_bytes``."""
    if t.device.type == "cpu":
        return t
    with Span("sync", {}):
        out = t.cpu()
    count("d2h_copies")
    count("d2h_bytes", out.numel() * out.element_size())
    return out
