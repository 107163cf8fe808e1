"""Wavefront Smith-Waterman: NQ queries x giant db sequences, a chain of
slabs a (query, run of columns).

Port of ``swipe_tpu/ops/sw_wavefront.py``.  The stream kernels put one db
sequence in each lane, so a lone chromosome-scale unit would run on one
lane of the card.  The wavefront kernel (K7, ``csrc/wavefront.cu``)
parallelises inside the (query, sequence) pair instead: a chain's
columns are cut into slabs of SLAB_COLS, a warp a slab, thread t owning
32 columns and computing row s - t of them at step s (the band walker of
``csrc/rows.cuh`` with rows and columns swapped).  Every chain's slabs
run at once on all the SMs, each a few dozen steps behind the one to its
left, whose right edge it reads row by row through global memory (see
the source's notes).  It serves the few giants whose positive-score span
is too large to cut them into the stream kernel's overlapped pieces (the
engine's routing, pipeline.SearchEngine._iter_carry_scores).

Two entry points launch it:

* ``sw_wavefront``: one segment of one sequence, a chain a query, the
  cross-segment state carried in and out: per query row the H and E of
  the segment's last column (E as the cell's own value, not
  pre-advanced) and the query's running max.  The JAX package keeps the
  same quantities in its TPU edge ring (wavefront_state_from_jax
  converts); ``sw_wavefront_scores`` threads it through a sequence's
  segments.
* ``sw_wavefront_giants``: a query group against every giant at once,
  the engine's call.  One chain walks one query through one piece of
  one giant from a fresh state; ``plan_pieces`` cuts the giants into
  pieces overlapped by the span bound V where one chain a (query,
  giant) would leave the card's resident blocks idle, and the giant's
  score is the max over its pieces (exact: the source's notes).  The
  giants come from one device copy (``hold_giants``).

Both take their plain versions for CPU tensors and count their launches
in ``trace.launched("swipe_wavefront")``; ``sw_wavefront_giants`` counts
the chains it walks in ``wavefront.chains`` and the slots' query residues
times the columns they walk, overlap and padding included, in
``wavefront.cells_walked``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..batching import NEG_INF, PAD_SYMBOL, round_up
from . import sw_stream as _sw

__all__ = ["HeldGiants", "Piece", "SEG_STRIPS", "SLAB_COLS", "STRIP",
           "build_mq", "hold_giants", "make_wavefront_state", "plan_pieces",
           "sw_wavefront", "sw_wavefront_giants", "sw_wavefront_giants_plain",
           "sw_wavefront_plain", "sw_wavefront_scores", "wavefront_resident",
           "wavefront_slabs", "wavefront_state_from_jax"]

STRIP = 1024        # the JAX kernel's strip width: segments are multiples
# segment width for sw_wavefront_scores: long sequences stream through
# equal segments plus a power-of-two-bucketed tail (the JAX package's
# segmentation, so both packages carry state across the same cuts)
SEG_STRIPS = 256
MAX_QLEN = 1024     # the kernel's row cap (the JAX kernel's)
# K7's slab, the columns of a warp: 32 threads x 32 columns
# (csrc/wavefront.cu COLS)
SLAB_COLS = 1024
# steps from a slab's start to the next slab's, 2 * GROUP + 31
# (csrc/wavefront.cu): a chain of R rows keeps (R + 31) / SLAB_LAG warps
# busy
SLAB_LAG = 39
# a piece owns at least this many overlaps of columns
MIN_PIECE_OVERLAPS = 8


def wavefront_slabs(L: int) -> int:
    """The slabs of an L-column segment on the card: one (query, slab) a
    block, every query's slabs running at once over the SMs."""
    if L % SLAB_COLS:
        raise ValueError(f"segment width {L} not a multiple of {SLAB_COLS}")
    return L // SLAB_COLS


def build_mq(qcodes: np.ndarray, matrix8: np.ndarray) -> np.ndarray:
    """[NQ, QLEN, 32] int8 per-row score columns: mq[n, i] =
    matrix8[q_i].  PAD query rows pick matrix8[PAD] = all -128, so rows
    beyond a query's true length decay and never raise S."""
    return np.asarray(matrix8, dtype=np.int8)[np.asarray(qcodes)]


def make_wavefront_state(nq: int, qlen_pad: int, device=None):
    """Fresh cross-segment state (h, e, s): h/e [NQ, QLEN] int32 (the
    virtual column -1: H = 0, E = -inf), s [NQ] int32."""
    h = torch.zeros((nq, qlen_pad), dtype=torch.int32, device=device)
    return (h, torch.full_like(h, NEG_INF),
            torch.zeros(nq, dtype=torch.int32, device=device))


# the JAX kernel's edge ring: row i at slot i + RING_OFF of
# [NQ, QLEN + RING_PAD, 128], every lane holding the same value
_RING_OFF, _RING_PAD = 8, 24


def wavefront_state_from_jax(eh, ee, s):
    """The JAX wavefront state (eh/ee [NQ, QLEN + 24, 128] edge ring, s
    [NQ, 8, 128]) in this module's layout, as CPU tensors.  Takes
    anything numpy can read."""
    eh, ee, s = (np.asarray(x, dtype=np.int32) for x in (eh, ee, s))
    qlen_pad = eh.shape[1] - _RING_PAD
    rows = slice(_RING_OFF, _RING_OFF + qlen_pad)
    return (torch.from_numpy(eh[:, rows, 0].copy()),
            torch.from_numpy(ee[:, rows, 0].copy()),
            torch.from_numpy(s.max(axis=(1, 2)).astype(np.int32)))


def sw_wavefront_plain(mq, db, h, e, s, *, gapopenextend: int,
                       gapextend: int):
    """Plain version of sw_wavefront: a column loop with the query rows
    vectorized (the stream kernels' plain column step)."""
    nq, qlen_pad, _ = mq.shape
    iota = torch.arange(qlen_pad, dtype=torch.int32, device=mq.device)[None]
    prof = mq.to(torch.int32)
    h2, e2, s2 = h, e, s
    for sym in db.tolist():
        h2, e2 = _sw._column(h2, e2, prof[:, :, sym & 31], gapopenextend,
                             gapextend, iota, None)
        s2 = torch.maximum(s2, h2.amax(dim=1))
    h.copy_(h2)
    e.copy_(e2)
    s.copy_(s2)
    return h, e, s


def sw_wavefront(mq: torch.Tensor, db: torch.Tensor, h: torch.Tensor,
                 e: torch.Tensor, s: torch.Tensor, *, gapopenextend: int,
                 gapextend: int):
    """Score NQ queries against one segment of a db sequence, carrying
    the state across segments.

    mq: [NQ, QLEN, 32] int8 (build_mq, QLEN <= 1024); db: [L] int8
    segment; h/e [NQ, QLEN] and s [NQ] int32: the state left by the
    previous segment of the same sequence (make_wavefront_state for the
    first), updated IN PLACE and returned as (h, e, s).  s holds each
    query's running max score.  On the card L is a multiple of SLAB_COLS
    (the JAX kernel's strip) and gapopenextend >= gapextend."""
    dev = mq.device
    for name, t, dtype, ndim in (("mq", mq, torch.int8, 3),
                                 ("db", db, torch.int8, 1),
                                 ("h", h, torch.int32, 2),
                                 ("e", e, torch.int32, 2),
                                 ("s", s, torch.int32, 1)):
        _sw._check(name, t, dtype, ndim, dev)
    nq, qlen_pad, nsym = mq.shape
    if nsym != 32 or tuple(h.shape) != (nq, qlen_pad) \
            or e.shape != h.shape or tuple(s.shape) != (nq,):
        raise ValueError("sw_wavefront: inconsistent shapes mq "
                         f"{tuple(mq.shape)} h {tuple(h.shape)} "
                         f"e {tuple(e.shape)} s {tuple(s.shape)}")
    if not 0 < qlen_pad <= MAX_QLEN:
        raise ValueError(f"qlen_pad {qlen_pad} not in 1..{MAX_QLEN}")
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend)
    if dev.type != "cuda":
        return sw_wavefront_plain(mq, db, h, e, s, **kw)
    # a chain a query over the whole segment, its state carried
    nslabs = wavefront_slabs(db.shape[0])
    chains = np.zeros((nq, 4), dtype=np.int64)
    chains[:, 1] = chains[:, 2] = np.arange(nq)
    chains[:, 3] = nslabs
    _launch(mq, db, chains, h, e, s, carry=True, **kw)
    return h, e, s


def _launch(mq, db, chains, h, e, s, *, carry: bool, gapopenextend: int,
            gapextend: int) -> None:
    """Launch K7 over ``chains`` (int64 [n, 4]: first column in ``db``,
    query, slot in ``s``, slabs), every chain's slabs at once.  The
    chains go in sorted by slabs, most first, with the tickets before
    each slab, so that slab j's tickets are a prefix of the chains (the
    source's notes); the ring of edges and the ticket counter are zeroed
    on the launch's stream."""
    dev = mq.device
    _sw._check_gaps(gapopenextend, gapextend)
    if db.data_ptr() % 4 or mq.data_ptr() % 16 or np.any(chains[:, 0] % 4):
        raise ValueError("sw_wavefront: db and its chains must be 4-byte "
                         "and mq 16-byte aligned")
    chains = chains[np.argsort(-chains[:, 3], kind="stable")]
    nslab = int(chains[0, 3]) if len(chains) else 0
    if nslab == 0:
        return
    # the chains with more than j slabs, for each slab j; the tickets
    # before each slab are their running sum
    busy = len(chains) - np.cumsum(np.bincount(chains[:, 3],
                                               minlength=nslab))[:nslab]
    first = np.concatenate([[0], np.cumsum(busy)]).astype(np.int64)
    if first[-1] >= 1 << 31:
        raise ValueError(f"sw_wavefront: {first[-1]} tickets")
    plan = trace.to_device(np.concatenate([chains.ravel(), first]), dev)
    qlen_pad = mq.shape[1]
    edge = torch.zeros((len(chains), 2, -(-qlen_pad // 64) * 64, 4),
                       dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _sw._launch("swipe_wavefront", dev, _sw._ptr(mq), _sw._ptr(db),
                _sw._ptr(plan), plan.data_ptr() + 8 * chains.size,
                len(chains), nslab, _sw._ptr(h), _sw._ptr(e), _sw._ptr(s),
                _sw._ptr(edge), _sw._ptr(ticket), int(first[-1]), qlen_pad,
                int(gapopenextend), int(gapextend), int(carry))


def _segments(n: int) -> list[tuple[int, int]]:
    """(start, padded width) of each segment of an n-column sequence:
    SEG_STRIPS-wide segments, the tail bucketed to a power of two of
    strips."""
    segw = SEG_STRIPS * STRIP
    out = []
    for pos in range(0, n, segw):
        left = n - pos
        width = segw
        if left < segw:
            nst = 1
            while nst * STRIP < left:
                nst *= 2
            width = nst * STRIP
        out.append((pos, width))
    return out


def sw_wavefront_scores(mq: torch.Tensor, seq: np.ndarray, *,
                        gapopenextend: int, gapextend: int) -> torch.Tensor:
    """[NQ] int32 scores of NQ queries (mq on the device) against one
    sequence of any length: one sw_wavefront launch per segment with the
    state threaded between them.  The sequence is uploaded once,
    PAD-padded to its last segment's width."""
    nq, qlen_pad, _ = mq.shape
    seq = np.asarray(seq, dtype=np.int8)
    segs = _segments(len(seq))
    state = make_wavefront_state(nq, qlen_pad, mq.device)
    if not segs:
        return state[2]
    padded = np.full(segs[-1][0] + segs[-1][1], PAD_SYMBOL, np.int8)
    padded[:len(seq)] = seq
    dbd = trace.to_device(padded, mq.device)
    for pos, width in segs:
        state = sw_wavefront(mq, dbd[pos:pos + width], *state,
                             gapopenextend=gapopenextend, gapextend=gapextend)
    return state[2]


# ---- every giant at once ---------------------------------------------------

class HeldGiants(NamedTuple):
    """Giants on the device: ``db`` their codes, each from ``starts[g]``
    (a multiple of SLAB_COLS) for ``lengths[g]`` columns and PAD-filled
    to the next multiple of SLAB_COLS."""
    db: torch.Tensor
    starts: tuple
    lengths: tuple


def hold_giants(seqs, device) -> HeldGiants:
    """One device copy of the giants ``seqs`` (one upload)."""
    lengths = tuple(len(x) for x in seqs)
    widths = [round_up(n, SLAB_COLS) for n in lengths]
    starts = tuple(int(x) for x in np.cumsum([0] + widths[:-1]))
    codes = np.full(sum(widths), PAD_SYMBOL, dtype=np.int8)
    for x, at in zip(seqs, starts):
        codes[at:at + len(x)] = x
    return HeldGiants(trace.to_device(codes, device), starts, lengths)


class Piece(NamedTuple):
    """A piece of giant ``giant``: it owns the columns [own[0], own[1])
    and walks [walk[0], walk[1]), whole slabs that may run into the
    giant's PAD tail."""
    giant: int
    own: tuple
    walk: tuple


def plan_pieces(lengths, nq: int, qlen_pad: int, overlap: int | None,
                resident: int | None) -> list[Piece]:
    """The pieces K7 walks the giants of ``lengths`` in, for nq queries
    of qlen_pad rows on a card that holds ``resident`` blocks at once.

    A chain, one query through one piece, keeps about (qlen_pad + 31) /
    SLAB_LAG warps busy.  Where nq x the giants leave resident blocks
    idle, the giants are cut into the fewest pieces that fill them, in
    proportion to their lengths, each owning at least
    MIN_PIECE_OVERLAPS x ``overlap`` columns; each piece after a giant's
    first starts ``overlap`` columns (the span bound V) before the first
    column it owns, rounded down to a slab.  One piece a giant where
    ``overlap`` or ``resident`` is None (free gap extension, the CPU) or
    the chains already fill the card."""
    lengths = [int(n) for n in lengths]
    cuts = [1] * len(lengths)
    if overlap is not None and resident and lengths:
        need = -(-resident * SLAB_LAG // (qlen_pad + 31))
        if nq * len(lengths) < need:
            width = -(-sum(lengths) // -(-need // nq))
            least = MIN_PIECE_OVERLAPS * overlap + SLAB_COLS
            cuts = [max(1, min(-(-n // width), n // least))
                    for n in lengths]
    out = []
    for g, (n, k) in enumerate(zip(lengths, cuts)):
        if n == 0:
            continue
        bounds = [0] + [i * n // k // SLAB_COLS * SLAB_COLS
                        for i in range(1, k)] + [n]
        for a, b in zip(bounds, bounds[1:]):
            w0 = max(a - overlap, 0) // SLAB_COLS * SLAB_COLS if a else 0
            out.append(Piece(g, (a, b), (w0, w0 + round_up(b - w0,
                                                           SLAB_COLS))))
    return out


def wavefront_resident(qlen_pad: int, device) -> int:
    """The K7 blocks the card holds at once at qlen_pad rows (its SMs
    times the blocks an SM holds)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _sw._kernel("swipe_wavefront_resident")(qlen_pad,
                                                      ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"swipe_wavefront_resident: CUDA error {rc}")
    return out.value


def sw_wavefront_giants(mq: torch.Tensor, qlens, giants: HeldGiants, *,
                        overlap: int | None, gapopenextend: int,
                        gapextend: int) -> torch.Tensor:
    """[NQ, G] int32 scores of NQ queries (mq, build_mq, on the device;
    qlens their residues) against the G held giants, in one K7 launch:
    a chain a (query, piece of plan_pieces) from a fresh state, each
    folding its max into its (query, giant) score.  ``overlap``: the
    span bound V of any positive-score local alignment at these
    queries' length, None where it is unbounded."""
    dev = mq.device
    _sw._check("mq", mq, torch.int8, 3, dev)
    _sw._check("db", giants.db, torch.int8, 1, dev)
    nq, qlen_pad, nsym = mq.shape
    if nsym != 32 or len(qlens) != nq:
        raise ValueError(f"sw_wavefront_giants: mq {tuple(mq.shape)} and "
                         f"{len(qlens)} query lengths")
    if not 0 < qlen_pad <= MAX_QLEN:
        raise ValueError(f"qlen_pad {qlen_pad} not in 1..{MAX_QLEN}")
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend)
    card = dev.type == "cuda"
    pieces = plan_pieces(giants.lengths, nq, qlen_pad, overlap,
                         wavefront_resident(qlen_pad, dev) if card else None)
    trace.count("wavefront.chains", nq * len(pieces))
    trace.count("wavefront.cells_walked", int(np.sum(qlens)) * sum(
        p.walk[1] - p.walk[0] for p in pieces))
    if not card:
        return sw_wavefront_giants_plain(mq, qlens, giants, overlap=overlap,
                                         **kw)
    ng = len(giants.lengths)
    s = torch.zeros((nq, ng), dtype=torch.int32, device=dev)
    if not pieces or not nq:
        return s
    chains = np.array([(giants.starts[p.giant] + p.walk[0], q,
                        q * ng + p.giant, (p.walk[1] - p.walk[0]) // SLAB_COLS)
                       for p in pieces for q in range(nq)], dtype=np.int64)
    _launch(mq, giants.db, chains, None, None, s, carry=False, **kw)
    return s


def sw_wavefront_giants_plain(mq, qlens, giants: HeldGiants, *,
                              overlap: int | None, gapopenextend: int,
                              gapextend: int) -> torch.Tensor:
    """Plain version of sw_wavefront_giants: each giant whole, from a
    fresh state, on sw_wavefront_plain (``qlens`` and ``overlap`` do not
    change the scores)."""
    nq, qlen_pad, _ = mq.shape
    s = torch.zeros((nq, len(giants.lengths)), dtype=torch.int32,
                    device=mq.device)
    for g, (at, n) in enumerate(zip(giants.starts, giants.lengths)):
        state = make_wavefront_state(nq, qlen_pad, mq.device)
        sw_wavefront_plain(mq, giants.db[at:at + n], *state,
                           gapopenextend=gapopenextend, gapextend=gapextend)
        s[:, g] = state[2]
    return s
