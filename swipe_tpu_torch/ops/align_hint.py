"""Alignment-endpoint hint pass (the reference's search16s equivalent).

Port of ``swipe_tpu/ops/align_hint.py``: the NumPy host passes are
copies; the device routes run the port's hint kernel
(ops.sw_stream.sw_hint_stream) when the engine's device is CUDA.

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

The align phase's grid keeps the JAX package's domain (int8 matrices,
queries up to 1024 rows, bins up to 1024 subjects); other bins go to
hint_endpoints_many.  When the engine's device is CUDA every hint runs
on the hint kernel, whatever its size: a launch costs microseconds
there, a NumPy column pass milliseconds.  A matrix outside int8 runs on
the kernel's wide instantiation (an int32 matrix, build_matrix_wide).
The NumPy host pass is the route on a CPU device, and on the card only
for what is over the byte caps (a bin's padded subjects over
_BIN_LAUNCH_BYTES, or one warp's scratch over _SCRATCH_BYTES).  The
counters ``hint.lanes_kernel`` and ``hint.lanes_host`` count the lanes
each route takes.  Results are exact on either route.  A failure of the
kernel raises; nothing falls back.

Chromosome-scale subjects (over GIANT_HINT_MIN columns) are cut into
overlapped pieces that ride the hint kernel as lanes beside their bin's
other subjects, each piece tracking only the columns it owns; subjects
that cannot be cut (free gap extension, an all-negative matrix) take
one lane whole.
"""

from __future__ import annotations

import numpy as np

from .. import trace

__all__ = ["GIANT_HINT_MIN", "hint_endpoint", "hint_endpoints_many",
           "hint_endpoints_grid"]

# int32 is provably sufficient for the batched passes: scores are
# bounded by qlen * max(matrix) << 2^31, and the sentinel leaves E after
# the first column (E >= H - Q >= -Q), whatever the subject's length
NEG32 = -(1 << 28)

# subjects of one hint-kernel bin at most (the kernel's domain, as in the
# JAX package); a bin's lanes round up to whole warps and its columns to
# whole blocks, nothing more
MAX_BIN_SUBJECTS = 1024
WARP = 32
# footprint cap of one launch: bins x columns x lanes int8
_LAUNCH_BYTES = 64 << 20
# caps of a per-bin batch (_hint_batch): its subjects (bins x columns x
# lanes int8), and the kernel's scratch of one launch (_scratch_bytes;
# a batch over it splits its lanes over several launches)
_BIN_LAUNCH_BYTES = 512 << 20
_SCRATCH_BYTES = 1 << 30

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


def _fits_kernel(mat: np.ndarray, m: int) -> bool:
    """The grid's domain, the JAX package's: int8 scores, at most 1024
    query rows."""
    return _fits_int8(mat) and 0 < m <= 1024


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


def hint_endpoint(qseq: np.ndarray, dseq: np.ndarray, matrix: np.ndarray,
                  gapopen: int, gapextend: int, device=None
                  ) -> tuple[int, int, int]:
    """Return (score, bestq, bestpos) of one subject with search16s tie
    semantics: hint_endpoints_many of that subject alone, so its rules
    pick the hint kernel or the NumPy pass."""
    return hint_endpoints_many(qseq, [np.asarray(dseq)], matrix, gapopen,
                               gapextend, device)[0]


def hint_endpoints_many(qseq: np.ndarray, dseqs: list[np.ndarray],
                        matrix: np.ndarray, gapopen: int, gapextend: int,
                        device=None) -> list[tuple[int, int, int]]:
    """Endpoint hints of MANY db sequences against one query.

    One vectorized pass over [nhits, qlen] state — the reference runs
    its hint kernel on the whole displayed-hit bin per thread
    (align_chunk, swipe.cc:339-414): the first column attaining the
    final max, the smallest row within it.  Each batch runs on the hint
    kernel when ``device`` is CUDA, at any query length (_hint_batch).

    Chromosome-scale subjects segment into overlapped pieces that run
    as parallel lanes (EXACT: a positive-score alignment spans at most
    _span_bound db columns, so every colmax over a piece's OWNED
    columns — those at least that far from the piece start — is the
    true colmax; ownership partitions the columns, so merging by
    (max S, then smallest global column) reproduces the unsegmented
    first-improving-column/smallest-row tie semantics bit-for-bit).
    """
    if not dseqs:
        return []
    q = np.asarray(qseq, dtype=np.int64)
    m = len(q)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q = gapopen + gapextend
    R = gapextend

    V = _span_bound(m, int(mat.max()), R)
    giants, solos = [], []
    for i, d in enumerate(dseqs):
        if _segmentable(len(d), V):
            giants.append(i)
        elif len(d) > GIANT_HINT_MIN and V is None:
            # unsegmentable chromosome-scale subject (free gap extension
            # or an all-negative matrix): batching it would pad every
            # lane of the bin to its length — it runs alone
            solos.append(i)
    if not giants and not solos:
        return _hint_batch(q, [np.asarray(d) for d in dseqs], mat, Q, R,
                           device)

    results: list[tuple[int, int, int] | None] = [None] * len(dseqs)
    skip = set(giants) | set(solos)
    normals = [i for i in range(len(dseqs)) if i not in skip]
    if normals:
        for i, res in zip(normals, _hint_batch(
                q, [np.asarray(dseqs[i]) for i in normals], mat, Q, R,
                device)):
            results[i] = res
    for i in solos:
        results[i] = _hint_batch(q, [np.asarray(dseqs[i])], mat, Q, R,
                                 device)[0]
    if not giants:
        return results

    lanes = [(piece, st, i, pos) for i in giants
             for piece, st, pos in _cut(np.asarray(dseqs[i]), V)]
    pieces, starts, owners, offsets = zip(*lanes)
    res = _hint_batch(q, list(pieces), mat, Q, R, device,
                      np.asarray(starts, dtype=np.int64))
    _merge(res, owners, offsets, results)
    return results


def _launch_dims(bins) -> tuple[int, int]:
    """(columns, lanes) of one hint launch over ``bins`` [(qseq,
    subjects)]: the longest subject rounded to whole blocks, the largest
    bin to whole warps."""
    from .sw_stream import KSEG
    cols = max(len(d) for _, ds in bins for d in ds)
    lanes = max(len(ds) for _, ds in bins)
    return -(-cols // KSEG) * KSEG, -(-lanes // WARP) * WARP


def _launch_bytes(bins) -> int:
    cols, lanes = _launch_dims(bins)
    return len(bins) * cols * lanes


def _scratch_bytes(bins, mat) -> int:
    """The hint kernel's scratch for one launch over ``bins``: the rows
    between a query's bands (H, F, column max and its row: 4 int32 a
    column and lane), when a query has more than one band.  The grid's
    launches (at most two bands, _LAUNCH_BYTES of subjects) stay under
    _SCRATCH_BYTES by their own cap."""
    from .sw_stream import ROW_BANDS
    cols, lanes = _launch_dims(bins)
    m = max(len(q) for q, _ in bins)
    return 16 * len(bins) * cols * lanes \
        if m > ROW_BANDS[not _fits_int8(mat)] else 0


def _lane_groups(q, dseqs, mat):
    """The subjects of one per-bin batch in groups whose launches each
    keep the hint kernel's scratch under _SCRATCH_BYTES: one group when
    the batch does, else whole warps of the longest subjects left at a
    time; None when a warp of one subject alone is over the cap.  Lanes
    are independent, so a split changes no result."""
    if _scratch_bytes([(q, dseqs)], mat) <= _SCRATCH_BYTES:
        return [list(range(len(dseqs)))]
    order = sorted(range(len(dseqs)), key=lambda i: -len(dseqs[i]))
    groups = []
    while order:
        warp = _scratch_bytes([(q, [dseqs[order[0]]])], mat)
        fit = len(order) if warp == 0 else _SCRATCH_BYTES // warp * WARP
        if fit == 0:
            return None
        groups.append(order[:fit])
        order = order[fit:]
    return groups


def _bin_lanes(q, dseqs, mat, R):
    """A grid bin's lanes: (subjects and pieces, first tracked columns,
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
                        device=None, force_device: bool = False):
    """hint_endpoints_many for MANY (query, subject-list) bins at once.

    ``jobs`` is a list of (qseq, dseqs) — one bin per (query, qstrand,
    qframe) of an align phase.  When ``device`` is CUDA, every bin in the
    kernel's domain rides the hint kernel's query axis
    (ops.sw_stream.sw_hint_stream), whatever its size: a chromosome-scale
    subject is cut into its overlapped pieces, lanes beside the bin's
    other subjects, and bins are sorted by their longest lane and cut
    into launches under a footprint cap.  Bins outside the domain
    (non-int8 matrices, queries over 1024 rows, over MAX_BIN_SUBJECTS
    subjects, over the footprint cap alone) take hint_endpoints_many,
    which runs them on the kernel as well.  ``force_device`` takes the
    kernel route whatever the device — on a CPU ``device`` that is the
    kernel's plain version.

    Returns a list of per-bin result lists, aligned with ``jobs``.
    """
    results: list = [None] * len(jobs)
    if not jobs:
        return results
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    on_dev = force_device or _on_cuda(device)
    lanes = {}
    for bi, (q, dseqs) in enumerate(jobs):
        if on_dev and _fits_kernel(mat, len(q)) \
                and 0 < len(dseqs) <= MAX_BIN_SUBJECTS:
            got = _bin_lanes(q, dseqs, mat, gapextend)
            if _launch_bytes([(q, got[0])]) <= _LAUNCH_BYTES:
                lanes[bi] = got
                continue
        results[bi] = hint_endpoints_many(np.asarray(q), dseqs, matrix,
                                          gapopen, gapextend, device)
    if not lanes:
        return results

    # bins of like lane lengths share a launch, so a short bin is not
    # padded to a long one's columns; in this order a bin added to a
    # group is the group's widest yet
    def launch(group):
        out = _hint_launch([(jobs[i][0], lanes[i][0]) for i in group], mat,
                           gapopen + gapextend, gapextend, device,
                           [lanes[i][1] for i in group])
        for i, res in zip(group, out):
            results[i] = [None] * len(jobs[i][1])
            _merge(res, lanes[i][2], lanes[i][3], results[i])

    batch = sorted(lanes, key=lambda bi: max(map(len, lanes[bi][0])))
    group: list[int] = []
    width = 0
    for bi in batch:
        cols, n = _launch_dims([(jobs[bi][0], lanes[bi][0])])
        if group and (len(group) + 1) * cols * max(width, n) \
                > _LAUNCH_BYTES:
            launch(group)
            group, width = [], 0
        group.append(bi)
        width = max(width, n)
    launch(group)
    return results


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

    cols, lanes = _launch_dims(bins)
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


def _hint_batch(q, dseqs, mat, Q, R, device=None, starts=None):
    """Batched hint pass with an optional per-lane first-tracked column
    (``starts``: columns before a lane's start never update S/bq/bp —
    the owned-column mask of the segmented-giant route)."""
    lens = np.array([len(d) for d in dseqs], dtype=np.int64)
    n = len(dseqs)
    m = len(q)
    maxlen = int(lens.max())
    if starts is None:
        starts = np.zeros(n, dtype=np.int64)

    # on the card, the kernel route at any size, query length and matrix
    # (the wide instantiation outside int8): one launch holds the batch,
    # or several its lanes where the scratch between a long query's bands
    # would pass its cap.  A batch over 512 MB of padded lanes, or over
    # the scratch cap in a warp alone, stays on the host instead
    groups = None
    if (_on_cuda(device) and m > 0
            and _launch_bytes([(q, dseqs)]) <= _BIN_LAUNCH_BYTES):
        groups = _lane_groups(q, dseqs, mat)
    if groups is not None:
        out = [None] * n
        for g in groups:
            res = _hint_launch([(q, [dseqs[i] for i in g])], mat, Q, R,
                               device, [starts[g]])[0]
            for i, r in zip(g, res):
                out[i] = r
        return out

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
