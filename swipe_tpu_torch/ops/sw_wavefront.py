"""Wavefront Smith-Waterman: NQ queries x ONE giant db sequence, streamed
through fixed-width segments.

Port of ``swipe_tpu/ops/sw_wavefront.py``.  The stream kernels put one db
sequence in each lane, so a lone chromosome-scale unit would run on one
lane of the card.  The wavefront kernel (K7, ``csrc/wavefront.cu``)
parallelises inside the (query, sequence) pair instead: the segment's
columns are cut into slabs of SLAB_COLS, a warp a slab, thread t owning
32 columns and computing row s - t of them at step s (the band walker of
``csrc/rows.cuh`` with rows and columns swapped).  Every query's slabs
run at once on all the SMs, each a few dozen steps behind the one to its
left, whose right edge it reads row by row through global memory (see
the source's notes).  It serves the few giants whose positive-score span
is too large to cut them into overlapped pieces (the engine's routing,
pipeline.SearchEngine._iter_carry_scores).

The cross-segment state is, per query row, the H and E of the segment's
last column (E as the cell's own value, not pre-advanced) and the
query's running max.  The JAX package keeps the same quantities in its
TPU edge ring (wavefront_state_from_jax converts).

``sw_wavefront`` takes its kernel for CUDA tensors and its plain version
(``sw_wavefront_plain``) for CPU tensors, and counts its launches in
``trace.launched("swipe_wavefront")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..batching import NEG_INF, PAD_SYMBOL
from . import sw_stream as _sw

__all__ = ["SEG_STRIPS", "SLAB_COLS", "STRIP", "build_mq",
           "make_wavefront_state", "sw_wavefront", "sw_wavefront_plain",
           "sw_wavefront_scores", "wavefront_slabs",
           "wavefront_state_from_jax"]

STRIP = 1024        # the JAX kernel's strip width: segments are multiples
# segment width for sw_wavefront_scores: long sequences stream through
# equal segments plus a power-of-two-bucketed tail (the JAX package's
# segmentation, so both packages carry state across the same cuts)
SEG_STRIPS = 256
MAX_QLEN = 1024     # the kernel's row cap (the JAX kernel's)
# K7's slab, the columns of a warp: 32 threads x 32 columns
# (csrc/wavefront.cu COLS)
SLAB_COLS = 1024


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
    _sw._check_gaps(gapopenextend, gapextend)
    if db.data_ptr() % 4 or mq.data_ptr() % 16:
        raise ValueError("sw_wavefront: db must be 4-byte and mq 16-byte "
                         "aligned")
    # the slabs' right edges (a row is {H, 1, E + Q, 1} once written) and
    # the ticket counter, zeroed on this stream before the launch
    edge = torch.zeros((nq, wavefront_slabs(db.shape[0]),
                        -(-qlen_pad // 64) * 64, 4), dtype=torch.int32,
                       device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _sw._launch("swipe_wavefront", dev, _sw._ptr(mq), _sw._ptr(db),
                _sw._ptr(h), _sw._ptr(e), _sw._ptr(s), _sw._ptr(edge),
                _sw._ptr(ticket), nq, qlen_pad, db.shape[0],
                int(gapopenextend), int(gapextend))
    return h, e, s


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
