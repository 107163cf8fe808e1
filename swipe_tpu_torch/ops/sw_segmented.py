"""Segmented Smith-Waterman scoring of segment-packed chunks: the
untiled CUDA kernel (K9) and the plain version shared with the tiled one.

Port of ``swipe_tpu/ops/sw_pallas.py`` (``sw_scores_segmented`` and its
lax twin ``sw_scores_lax``, ``build_qpt``), named for what it does: no
part of the port is Pallas.  A segment-packed chunk
(``batching.pack_database``) holds segments of NSEQS length-sorted
sequences, one per lane, concatenated along the db axis; a block->segment
map names each SEG_BLK-column block's segment.  Every lane's state
resets where a segment starts, and its best score is kept where the
segment ends: ``out[q, segment, lane]``.

``sw_scores_segmented`` runs ``csrc/segment.cu`` (bound with ctypes) for
CUDA tensors and the plain column loop ``sw_scores_segmented_plain`` for
CPU tensors; a failed launch raises.  It takes an int8 profile or, for
matrices outside int8, an int32 one (the route of the JAX package's
lax twin).  Its launches count in ``trace.launched("swipe_segment")``.

On the card both segmented entry points (this one and
``ops.sw_tiled.sw_scores_tiled``) run one kernel on the band walker of
``csrc/rows.cuh``: a warp a (query, lane), 8 lanes of one query a block,
bands sized to QLEN laid from each query's end (``query_lengths``),
planes between bands, the queries split over launches by
``sw_stream.plane_split`` (``segment_plan``).  It needs gapopenextend
>= gapextend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batching import NEG_INF, PAD_SYMBOL, SEG_BLK
from . import sw_stream as _sw

__all__ = ["PAD_SYMBOL", "NEG_INF", "SEG_BLK", "build_qpt", "qpt_pad",
           "query_lengths", "segment_plan",
           "sw_scores_segmented", "sw_scores_segmented_plain"]


def build_qpt(queries: list[np.ndarray], matrix: np.ndarray,
              qlen_pad: int, dtype=np.int8) -> np.ndarray:
    """Transposed query profiles [NQ, qlen_pad, 32].

    QPT[n, q, s] = matrix[query_n[q], s]; rows beyond a query's length and
    the PAD_SYMBOL column are strongly negative (the type's minimum, at
    most -2^20), so padded cells decay instead of scoring.  dtype=int8
    (default) for matrices in int8; np.int32 for matrices outside it."""
    m = np.asarray(matrix, dtype=np.int64)
    info = np.iinfo(dtype)
    if m.min() < info.min or m.max() > info.max:
        raise ValueError(
            f"score matrix must fit {np.dtype(dtype).name} for this kernel")
    pad = qpt_pad(dtype)
    nq = len(queries)
    qpt = np.full((nq, qlen_pad, 32), pad, dtype=dtype)
    for n, q in enumerate(queries):
        L = len(q)
        if L > qlen_pad:
            raise ValueError(f"query {n} longer than qlen_pad ({L} > {qlen_pad})")
        qpt[n, :L, :] = m[np.asarray(q, dtype=np.int64), :].astype(dtype)
        qpt[n, :, PAD_SYMBOL] = pad
    return qpt


def qpt_pad(dtype) -> int:
    """build_qpt's pad for a profile of ``dtype`` (numpy or torch): the
    type's minimum, at most -2^20."""
    info = torch.iinfo(dtype) if isinstance(dtype, torch.dtype) \
        else np.iinfo(dtype)
    return max(int(info.min), -(1 << 20))


def query_lengths(qpt: torch.Tensor) -> torch.Tensor:
    """Each query's rows in a build_qpt profile [NQ, QLEN, 32]: its last
    row with an entry other than the pad, plus one ([NQ] int32, on
    qpt's device; 0 for a query of pad rows only).  Rows past it hold
    the pad alone and so never raise a score."""
    nq, qlen, _ = qpt.shape
    if qlen == 0:
        return torch.zeros(nq, dtype=torch.int32, device=qpt.device)
    real = (qpt != qpt_pad(qpt.dtype)).any(dim=2)          # [NQ, QLEN]
    rows = torch.arange(1, qlen + 1, dtype=torch.int32, device=qpt.device)
    return torch.where(real, rows, 0).amax(dim=1)


def segment_plan(qpt: torch.Tensor, L: int, nseqs: int, gapopenextend: int,
                 gapextend: int):
    """The card kernel's launches for qpt against an [L, nseqs] chunk:
    (query_lengths(qpt), the band height, the queries a launch takes).
    The band is K2's (sw_stream.stream_band: 128, 256 or 512 rows) for
    an int8 profile and 256 rows (8 a thread, the walker's int32 strip)
    for an int32 one.  Raises ValueError on a negative gap open penalty,
    which the walker does not take."""
    _sw._check_gaps(gapopenextend, gapextend)
    nq, qlen_pad, _ = qpt.shape
    band = _sw.ROW_BANDS[True] if qpt.dtype == torch.int32 \
        else _sw.stream_band(qlen_pad)
    return (query_lengths(qpt), band,
            _sw.plane_split(nq, qlen_pad, band, L, nseqs))


def sw_scores_segmented_plain(qpt, db, seg_ids, *, nsegs: int,
                              gapopenextend: int, gapextend: int
                              ) -> torch.Tensor:
    """Plain version of sw_scores_segmented and sw_scores_tiled (the JAX
    package's sw_scores_lax): a column loop with the query rows
    vectorized, F resolved by a weighted prefix max (cummax)."""
    nq, qlen, _ = qpt.shape
    L, nseqs = db.shape
    dev = db.device
    Q, R = gapopenextend, gapextend
    nblocks = L // SEG_BLK
    seg = seg_ids[:nblocks].tolist()
    qp = qpt.to(torch.int32)                              # [NQ, QLEN, 32]
    iota = torch.arange(qlen, dtype=torch.int32, device=dev)[None, :, None]
    out = torch.zeros((nq, nsegs, nseqs), dtype=torch.int32, device=dev)
    h = torch.zeros((nq, qlen, nseqs), dtype=torch.int32, device=dev)
    e = torch.full_like(h, NEG_INF)
    s = torch.zeros((nq, nseqs), dtype=torch.int32, device=dev)
    for b in range(nblocks):
        if b == 0 or seg[b] != seg[b - 1]:
            h.zero_()
            e.fill_(NEG_INF)
            s.zero_()
        for j in range(SEG_BLK):
            p = qp.index_select(2, db[b * SEG_BLK + j].long())
            h, e = _sw._column(h, e, p, Q, R, iota, None)
            s = torch.maximum(s, h.amax(dim=1))
        if b == nblocks - 1 or seg[b + 1] != seg[b]:
            out[:, seg[b]] = s
    return out


def check_segment_args(qpt, db, seg_ids, nsegs: int, dtypes) -> torch.device:
    """Validate the arguments the segmented kernels share; returns the
    device."""
    dev = db.device
    if qpt.dtype not in dtypes:
        raise ValueError(f"qpt: expected one of {dtypes}, got {qpt.dtype}")
    _sw._check("qpt", qpt, qpt.dtype, 3, dev)
    _sw._check("db", db, torch.int8, 2, dev)
    _sw._check("seg_ids", seg_ids, torch.int32, 1, dev)
    L, _ = db.shape
    if L % SEG_BLK:
        raise ValueError(f"db length {L} not a multiple of {SEG_BLK}")
    if qpt.shape[2] != 32 or seg_ids.shape[0] != L // SEG_BLK + 1 \
            or nsegs <= 0:
        raise ValueError("segmented scoring: inconsistent shapes qpt "
                         f"{tuple(qpt.shape)} db {tuple(db.shape)} seg_ids "
                         f"{tuple(seg_ids.shape)} nsegs {nsegs}")
    return dev


def segment_launch(fn: str, qpt, db, seg_ids, nsegs: int, Q: int, R: int,
                   *lead) -> torch.Tensor:
    """Launch a segmented entry point of csrc/segment.cu (segment_plan):
    the zeroed output (segments no block names stay 0) and, when a query
    can take more than one band, the planes between bands."""
    dev = db.device
    nq, qlen_pad, _ = qpt.shape
    L, nseqs = db.shape
    qlens, band, step = segment_plan(qpt, L, nseqs, Q, R)
    out = torch.zeros((nq, nsegs, nseqs), dtype=torch.int32, device=dev)
    bh = None if qlen_pad <= band else torch.empty(
        (2, step, L, nseqs), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, step):
        q1 = min(nq, q0 + step)
        _sw._launch(fn, dev, _sw._ptr(qpt[q0:q1]), _sw._ptr(qlens[q0:q1]),
                    *lead, _sw._ptr(db), _sw._ptr(seg_ids),
                    _sw._ptr(out[q0:q1]),
                    _sw._ptr(None if bh is None else bh[0]),
                    _sw._ptr(None if bh is None else bh[1]), q1 - q0,
                    qlen_pad, L // SEG_BLK, nseqs, nsegs, int(Q), int(R),
                    band // 32)
    return out


def sw_scores_segmented(qpt: torch.Tensor, db: torch.Tensor,
                        seg_ids: torch.Tensor, *, nsegs: int,
                        gapopenextend: int, gapextend: int) -> torch.Tensor:
    """Score queries against a segment-packed chunk.

    qpt:     [NQ, QLEN, 32] int8 transposed query profiles (build_qpt), or
             int32 for matrices outside int8
    db:      [L, NSEQS] int8 packed chunk (batching.pack_database), L a
             multiple of SEG_BLK, PAD_SYMBOL padded
    seg_ids: [L // SEG_BLK + 1] int32 nondecreasing block->segment map
             (the last entry repeats the final segment)
    Returns [NQ, nsegs, NSEQS] int32 exact local alignment scores; the
    segments seg_ids never names are 0 (the JAX package's
    sw_scores_segmented and sw_scores_lax)."""
    dev = check_segment_args(qpt, db, seg_ids, nsegs,
                             (torch.int8, torch.int32))
    kw = dict(nsegs=nsegs, gapopenextend=gapopenextend, gapextend=gapextend)
    if dev.type != "cuda":
        return sw_scores_segmented_plain(qpt, db, seg_ids, **kw)
    return segment_launch("swipe_segment", qpt, db, seg_ids, nsegs,
                          gapopenextend, gapextend,
                          int(qpt.dtype == torch.int32))
