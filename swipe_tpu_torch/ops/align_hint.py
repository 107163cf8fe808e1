"""Alignment-endpoint hint pass (the reference's search16s equivalent).

Port of ``swipe_tpu/ops/align_hint.py``: the NumPy pass is a copy; the
device route runs the port's hint kernel (ops.sw_stream.sw_hint_stream)
when the engine's device is CUDA.

Parity target: search16s.cc:297-548.  For each hit that will
be displayed, the reference runs a CDEPTH=1 16-bit kernel that, whenever the
running maximum S strictly increases after a column, records

* ``bestpos`` — the 0-based db offset of that column (i.e. the FIRST column
  at which the final maximum is attained), and
* ``bestq``  — the SMALLEST query row whose H equals S in that column
  (the i loop scans qlen-1..0 and lets smaller i overwrite).

hits_align then skips the forward region pass and starts the reverse pass
from (bestq, bestpos) — but only when ``bestq > 0`` and ``bestpos != 0``
(hits.cc:587-595), and only when the score is below SCORELIMIT_16.  These
tie-breaking semantics differ from the forward region scan (which picks the
smallest query row overall), so reproducing them is required for alignment
parity when several optimal endpoints exist.

One entry point, hint_endpoints_grid, takes every (query, subjects) bin
of an align phase.  Each bin becomes lanes (_bin_lanes): a subject is
one lane from column 0; a chromosome-scale one (over GIANT_HINT_MIN
columns) is its overlapped pieces, each tracking only the columns it
owns; one that cannot be cut (free gap extension, an all-negative
matrix) takes one lane whole.  When the device is CUDA the lanes run
on the hint kernel at any query length, a matrix outside int8 on its
wide instantiation (build_matrix_wide): a launch costs microseconds
there, a NumPy column pass milliseconds.  One planner (_plan) cuts the
bins into launches under _LAUNCH_BYTES of padded subjects.  The NumPy
pass (_hint_host) runs each bin on a CPU device, and on the card only
what cannot launch: a bin with an empty query, a warp over the cap
alone.  The counters ``hint.lanes_kernel`` and ``hint.lanes_host`` count
the lanes each route takes.  Results are exact on either route.  A
failure of the kernel raises; nothing falls back.
"""

from __future__ import annotations

import numpy as np

from .. import trace

__all__ = ["GIANT_HINT_MIN", "hint_endpoints_grid"]

# int32 is provably sufficient for the batched passes: scores are
# bounded by qlen * max(matrix) << 2^31, and the sentinel leaves E after
# the first column (E >= H - Q >= -Q), whatever the subject's length
NEG32 = -(1 << 28)

# a launch's lanes round up to whole warps and its columns to whole
# blocks, nothing more
WARP = 32
# footprint cap of one launch: bins x columns x lanes int8.  The kernel's
# planes between a long query's bands take 16 bytes a subject byte, so
# at most 1 GiB under it
_LAUNCH_BYTES = 64 << 20

# subjects longer than this segment into overlapped pieces for the hint
# pass (the transpose of the search phase's segmented-giant scoring): a
# lone chromosome otherwise runs one lane through maxlen sequential
# columns
GIANT_HINT_MIN = 1 << 18


def _span_bound(m: int, maxS: int, R: int) -> int | None:
    """Max db-span of a positive-score local alignment: pairs contribute
    at most m * maxS and each unpaired db residue costs at least R.  With
    free gap extension (R == 0) the span is unbounded — no
    segmentation."""
    if maxS <= 0 or R <= 0:
        return None
    return m + -(-m * maxS // R)


def _on_cuda(device) -> bool:
    return device is not None and str(device).startswith("cuda")


def _fits_int8(mat: np.ndarray) -> bool:
    return mat.min() >= -128 and mat.max() <= 127


def _segmentable(n: int, V: int | None) -> bool:
    """Whether a subject of ``n`` columns is hinted in overlapped pieces
    (chromosome-scale, and over four span bounds ``V``)."""
    return n > GIANT_HINT_MIN and V is not None and n > 4 * V


def _cut(d: np.ndarray, V: int):
    """A chromosome-scale subject's overlapped pieces, [(piece, first
    tracked column, offset in the subject)]: each piece owns its columns
    from V on (from 0 in the first), where every colmax is the true
    one."""
    N = len(d)
    stride = max(2 * V, -(-N // 1024), 2048)
    stride = -(-stride // 256) * 256
    return [(d[pos: pos + stride + V], 0 if pos == 0 else V, pos)
            for pos in range(0, max(N - V, 1), stride)]


def _merge(res, owners, offsets, out: list) -> None:
    """Fold lane results [(S, bestq, bestpos)] into their subjects'
    (``out[owner]``), lanes in ascending offset within a subject: the
    larger S, on a tie the smaller global column."""
    best: dict[int, tuple[int, int, int]] = {}
    for (s, bq, bp), i, pos in zip(res, owners, offsets):
        cur = best.get(i)
        if cur is None or s > cur[0] or (s == cur[0] and 0 <= bq
                                         and pos + bp < cur[2]):
            best[i] = (s, bq, pos + bp) if bq >= 0 else (s, bq, bp)
    for i, r in best.items():
        out[i] = r


def _launch_dims(lanes) -> tuple[int, int]:
    """(columns, lanes) of one hint launch over ``lanes``, one subject
    list a bin: the longest subject rounded to whole blocks, the largest
    bin to whole warps."""
    from .sw_stream import KSEG
    cols = max(len(d) for ds in lanes for d in ds)
    n = max(len(ds) for ds in lanes)
    return -(-cols // KSEG) * KSEG, -(-n // WARP) * WARP


def _bin_lanes(q, dseqs, mat, R):
    """A bin's lanes: (subjects and pieces, first tracked columns,
    owners, offsets).  A subject is one lane from column 0; a
    segmentable chromosome-scale one is its overlapped pieces (_cut)."""
    V = _span_bound(len(q), int(mat.max()), R)
    lanes = []
    for i, d in enumerate(dseqs):
        d = np.asarray(d)
        lanes += [(piece, st, i, pos) for piece, st, pos in (
            _cut(d, V) if _segmentable(len(d), V) else [(d, 0, 0)])]
    return tuple(list(x) for x in zip(*lanes))


def hint_endpoints_grid(jobs, matrix, gapopen: int, gapextend: int,
                        device=None):
    """Endpoint hints of MANY (query, subject-list) bins at once.

    ``jobs`` is a list of (qseq, dseqs) — one bin per (query, qstrand,
    qframe) of an align phase; the reference runs its hint kernel on the
    whole displayed-hit bin per thread (align_chunk, swipe.cc:339-414):
    the first column attaining the final max, the smallest row within
    it.  When ``device`` is CUDA the bins' lanes ride the hint kernel's
    query axis (ops.sw_stream.sw_hint_stream) in the launches of _plan;
    otherwise each bin's lanes run in one NumPy pass.

    Chromosome-scale subjects segment into overlapped pieces that run
    as parallel lanes (EXACT: a positive-score alignment spans at most
    _span_bound db columns, so every colmax over a piece's OWNED
    columns — those at least that far from the piece start — is the
    true colmax; ownership partitions the columns, so merging by
    (max S, then smallest global column) reproduces the unsegmented
    first-improving-column/smallest-row tie semantics bit-for-bit).

    Returns a list of per-bin result lists [(S, bestq, bestpos)],
    aligned with ``jobs``.
    """
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q, R = gapopen + gapextend, gapextend
    lanes = {bi: _bin_lanes(q, dseqs, mat, R)
             for bi, (q, dseqs) in enumerate(jobs) if len(dseqs)}
    got = {bi: [None] * len(x[0]) for bi, x in lanes.items()}
    if _on_cuda(device):
        for launch in _plan({bi: x[0] for bi, x in lanes.items()
                             if len(jobs[bi][0])}):
            out = _hint_launch(
                [(jobs[bi][0], [lanes[bi][0][k] for k in ks])
                 for bi, ks in launch], mat, Q, R, device,
                [[lanes[bi][1][k] for k in ks] for bi, ks in launch])
            for (bi, ks), res in zip(launch, out):
                for k, r in zip(ks, res):
                    got[bi][k] = r
    results = [[] for _ in jobs]
    for bi, (subs, starts, owners, offsets) in lanes.items():
        left = [k for k, r in enumerate(got[bi]) if r is None]
        if left:
            res = _hint_host(jobs[bi][0], [subs[k] for k in left], mat, Q,
                             R, np.asarray([starts[k] for k in left]))
            for k, r in zip(left, res):
                got[bi][k] = r
        results[bi] = [None] * len(jobs[bi][1])
        _merge(got[bi], owners, offsets, results[bi])
    return results


def _plan(bins):
    """The hint launches over ``bins`` {bin: lanes}: lists of (bin, lane
    indices), each under _LAUNCH_BYTES of padded subjects.  Bins of like
    lane lengths share a launch, so a short bin is not padded to a long
    one's columns; in their order a bin added to a launch is its widest
    yet.  A bin over the cap alone is cut into whole warps of its
    longest lanes at a time; a lane whose warp alone is over the cap is
    left out, for the NumPy pass.  Lanes are independent, so a cut
    changes no result."""
    launches: list = []
    group: list = []
    width = 0
    for bi in sorted(bins, key=lambda b: max(map(len, bins[b]))):
        ds = bins[bi]
        cols, n = _launch_dims([ds])
        if cols * n > _LAUNCH_BYTES:
            order = sorted(range(len(ds)), key=lambda k: -len(ds[k]))
            while order:
                cols = _launch_dims([[ds[order[0]]]])[0]
                fit = _LAUNCH_BYTES // (max(cols, 1) * WARP) * WARP
                if fit:
                    launches.append([(bi, order[:fit])])
                order = order[max(fit, 1):]
            continue
        if group and (len(group) + 1) * cols * max(width, n) \
                > _LAUNCH_BYTES:
            launches.append(group)
            group, width = [], 0
        group.append((bi, list(range(len(ds)))))
        width = max(width, n)
    if group:
        launches.append(group)
    return launches


def _hint_launch(bins, mat, Q, R, device, starts):
    """One hint-kernel launch over ``bins`` [(qseq, subjects)]: bin b's
    subject i in lane (b, i), PAD-padded to _launch_dims, from its first
    tracked column ``starts[b][i]``.  The subjects are laid lane by lane
    and turned column-major on the device; the three results come back
    in one copy.  Returns each bin's [(S, bestq, bestpos)]."""
    import torch

    from ..batching import PAD_SYMBOL
    from .sw_stream import (build_matrix8, build_matrix_wide, build_qcodes,
                            sw_hint_stream)

    cols, lanes = _launch_dims([ds for _, ds in bins])
    qc, ql = build_qcodes([np.asarray(q) for q, _ in bins],
                          max(len(q) for q, _ in bins))
    dense = np.full((len(bins), lanes, cols), PAD_SYMBOL, dtype=np.int8)
    st = np.zeros((len(bins), lanes), dtype=np.int32)
    for b, (_, ds) in enumerate(bins):
        for i, d in enumerate(ds):
            dense[b, i, : len(d)] = np.asarray(d, dtype=np.int8)
        st[b, :len(ds)] = starts[b]
    trace.count("hint.lanes_kernel", sum(len(ds) for _, ds in bins))
    dev = torch.device("cpu" if device is None else device)
    db = trace.to_device(dense, dev).transpose(1, 2).contiguous()
    out = trace.to_host(torch.stack(sw_hint_stream(
        trace.to_device(qc, dev), trace.to_device(ql, dev),
        trace.to_device((build_matrix8 if _fits_int8(mat)
                         else build_matrix_wide)(mat), dev),
        db, trace.to_device(st, dev),
        gapopenextend=int(Q), gapextend=int(R)))).tolist()
    return [list(zip(*(x[b][:len(ds)] for x in out)))
            for b, (_, ds) in enumerate(bins)]


def _hint_host(q, dseqs, mat, Q, R, starts):
    """The NumPy hint pass over one bin's lanes, each from its first
    tracked column ``starts`` (columns before a lane's start never
    update S/bq/bp — the owned-column mask of a chromosome's pieces)."""
    q = np.asarray(q, dtype=np.int64)
    lens = np.array([len(d) for d in dseqs], dtype=np.int64)
    n = len(dseqs)
    m = len(q)
    maxlen = int(lens.max())
    trace.count("hint.lanes_host", n)
    QP = mat[q, :].T.astype(np.int32)                 # (32, m)
    dense = np.zeros((n, maxlen), dtype=np.int8)
    for i, d in enumerate(dseqs):
        dense[i, : len(d)] = np.asarray(d, dtype=np.int8)

    H = np.zeros((n, m), dtype=np.int32)
    E = np.full((n, m), NEG32, dtype=np.int32)
    idxR = (np.arange(m, dtype=np.int64) * R).astype(np.int32)
    S = np.zeros(n, dtype=np.int32)
    bestpos = np.zeros(n, dtype=np.int64)
    bestq = np.full(n, -1, dtype=np.int64)
    for j in range(maxlen):
        active = j < lens
        if not active.any():
            break
        P = QP[dense[:, j], :]                        # (n, m)
        E = np.maximum(E - R, H - Q)
        diag = np.concatenate(
            [np.zeros((n, 1), dtype=np.int32), H[:, :-1]], axis=1)
        hnof = np.maximum(np.maximum(diag + P, E), 0)
        A = np.maximum.accumulate(hnof + idxR, axis=1)
        F = np.concatenate(
            [np.full((n, 1), NEG32, dtype=np.int32), A[:, :-1]],
            axis=1) - Q - idxR + R
        H = np.maximum(hnof, F)
        colmax = H.max(axis=1)
        improve = active & (colmax > S) & (j >= starts)
        if improve.any():
            rows = np.argmax(H == colmax[:, None], axis=1)
            S = np.where(improve, colmax, S)
            bestpos = np.where(improve, j, bestpos)
            bestq = np.where(improve, rows, bestq)
        H = np.where(active[:, None], H, 0)
        E = np.where(active[:, None], E, NEG32)
    return [(int(S[i]), int(bestq[i]), int(bestpos[i])) for i in range(n)]
