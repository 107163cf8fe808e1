"""Gapped local-alignment traceback (host side).

Produces run-length encoded alignment op strings ("M12D3I1...") for reported
hits using the linear-space divide-and-conquer strategy of Myers & Miller
(1988) seeded by the end/start-point search of Huang, Hardison & Miller
(1990).  Semantics (including tie-breaking and sentinel values) match the
reference aligner exactly (parity target: align.cc:38-519):

* ``region``: forward pass finds (score, a_end, b_end) — skipped when a score
  hint is supplied; reverse pass from the end point finds (a_begin, b_begin)
  as the first cell in (descending i, descending j) scan order whose reverse
  score reaches the target score.
* ``diff``: recursive middle-row split; the join maximizes HH[j] + XX[N-j]
  (first max wins) and then EE[j] + YY[N-j] + q (last max >= wins, taking the
  gap-crossing split).

A fast C++ implementation (native/aligner.cc, loaded via ctypes) is used when
available; the NumPy implementation below is the semantic specification and
the fallback.  Gap costs: q = gapopen, r = gapextend; a gap of length L costs
q + L*r.
"""

from __future__ import annotations

import numpy as np

from . import native

__all__ = ["align", "region"]

_SENTINEL = -1  # the reference uses -1, not -inf, in the reverse pass


def _row_forward(prev_H, EE, scores, q, r, floor_zero, h0, f_init):
    """One forward DP row, vectorized along the db axis (length N).

    prev_H/EE are the previous row's H and this row's carried E (both length
    N); ``scores`` holds match scores for this row; h0 is H[i][-1-column]
    boundary (the value `h` enters the row with); f_init the entering f.
    Returns (H_row, EE_row).  The in-row f chain
        f_j = max(f_{j-1}, h_{j-1} - q) - r
    is resolved exactly with a weighted prefix max over the f-free h values;
    opening from a gap-derived cell never beats extending because q >= 0.
    """
    N = len(scores)
    E_new = np.maximum(EE, prev_H - q) - r
    diag = np.concatenate(([h0], prev_H[:-1]))
    hnof = diag + scores
    if floor_zero:
        hnof = np.maximum(hnof, 0)
    hnof = np.maximum(hnof, E_new)
    # f candidates: from hnof within the row, and from the entering f chain
    idx = np.arange(N, dtype=np.int64)
    base = np.maximum(f_init, h0 - q) - r  # f at column 0
    A = np.maximum.accumulate(hnof + idx * r)
    # f_j = max_k<=j-1 (h_k - q - (j-k) r) = A[j-1] - q - j*r
    f = np.concatenate(([base], np.maximum(A[:-1] - q - idx[1:] * r,
                                           base - idx[1:] * r)))
    H = np.maximum(hnof, f)
    return H, E_new


def region(a, b, matrix, q, r):
    """Find score and alignment region endpoints.

    Returns (score, a_begin, b_begin, a_end, b_end) with 0-based inclusive
    coordinates.  (The reference's hint path — skipping the forward pass
    when score/endpoints are known — is served by calling
    ``region_reverse`` directly, as the align phase does.)
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    M, N = len(a), len(b)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    if M == 0 or N == 0:
        # empty query/subject scores 0; score-0 pairs trip the fatal
        # below (the reference segfaults fetching+aligning an empty db
        # sequence under -c 0, so the fatal is the non-UB equivalent)
        raise RuntimeError("Internal error in align function.")

    score = 0
    a_end = b_end = 0
    H = np.zeros(N, dtype=np.int64)
    EE = np.full(N, -q, dtype=np.int64)
    for i in range(M):
        scores = mat[a[i], b]
        H, EE = _row_forward(H, EE, scores, q, r, True, 0, -q)
        row_best = int(H.max())
        if row_best > score:
            score = row_best
            a_end = i
            b_end = int(np.argmax(H))  # first max in ascending j
    a_begin, b_begin = region_reverse(a, b, mat, q, r, score, a_end, b_end)
    return score, a_begin, b_begin, a_end, b_end


def region_reverse(a, b, matrix, q, r, score, a_end, b_end):
    """Reverse pass: find (a_begin, b_begin) for a known end point and score.

    Scans i descending from a_end, j descending from b_end, stopping at the
    first cell whose reverse-path score reaches ``score``.  Uses the
    reference's -1 sentinels (not -inf).
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    n = b_end + 1
    brev = b[b_end::-1]  # reversed db prefix
    HH = np.full(n, _SENTINEL, dtype=np.int64)
    EE = np.full(n, _SENTINEL, dtype=np.int64)
    for i in range(a_end, -1, -1):
        scores = mat[a[i], brev]
        h0 = 0 if i == a_end else _SENTINEL
        HH, EE = _row_reverse(HH, EE, scores, q, r, h0)
        # the reference requires a STRICT improvement over Cost=0 before
        # testing Cost >= score (align.cc:144-151), so a score-0 pair is
        # never "found" and trips the fatal — match that exactly
        hits = np.nonzero(HH >= max(score, 1))[0]
        if len(hits):
            jr = int(hits[0])  # first in reversed order = largest original j
            return i, b_end - jr
    raise RuntimeError("Internal error in align function.")


def _row_reverse(prev_H, EE, scores, q, r, h0):
    """One reverse DP row over the reversed db axis (no zero floor)."""
    N = len(scores)
    E_new = np.maximum(EE, prev_H - q) - r
    diag = np.concatenate(([h0], prev_H[:-1]))
    hnof = np.maximum(diag + scores, E_new)
    idx = np.arange(N, dtype=np.int64)
    # the entering h of the reverse row is always the -1 sentinel (the
    # diagonal h0 differs on the a_end row, but not the f chain)
    base = np.maximum(np.int64(_SENTINEL), _SENTINEL - q) - r
    A = np.maximum.accumulate(hnof + idx * r)
    # f_j = max_k<=j-1 (h_k - q - (j-k) r) = A[j-1] - q - j*r
    f = np.concatenate(([base], np.maximum(A[:-1] - q - idx[1:] * r,
                                           base - idx[1:] * r)))
    H = np.maximum(hnof, f)
    return H, E_new


class _Ops:
    """Run-length op-string accumulator: M=match/mismatch, D=query char vs gap,
    I=gap vs db char."""

    def __init__(self):
        self.parts: list[tuple[str, int]] = []

    def add(self, op: str, count: int):
        if count <= 0:
            return
        if self.parts and self.parts[-1][0] == op:
            self.parts[-1] = (op, self.parts[-1][1] + count)
        else:
            self.parts.append((op, count))

    def __str__(self):
        return "".join(f"{op}{n}" for op, n in self.parts)


def _diff(ops, a, b, mat, q, r, M, N, a_pos, b_pos, tb, te):
    """Myers-Miller divide and conquer on a[a_pos:a_pos+M] vs b[b_pos:b_pos+N].

    tb/te are the gap-open penalties applicable at the extreme left/right
    (0 when a gap is already open across the boundary, q otherwise).
    """
    if N == 0:
        if M > 0:
            ops.add("D", M)
        return
    if M == 0:
        ops.add("I", N)
        return
    if M == 1:
        # single query char vs N db chars
        if tb <= te:
            best = -tb - (1 + N) * r - q
            J = -1
        else:
            best = -q - (1 + N) * r - te
            J = N
        row = mat[a[a_pos], b[b_pos:b_pos + N]] - r * (N - 1)
        for j in range(N):
            sc = int(row[j])
            if j > 0:
                sc -= q
            if j < N - 1:
                sc -= q
            if sc > best:
                best = sc
                J = j
        if J == -1:
            ops.add("D", 1)
            ops.add("I", N)
        elif J == N:
            ops.add("I", N)
            ops.add("D", 1)
        else:
            ops.add("I", J)
            ops.add("M", 1)
            ops.add("I", N - 1 - J)
        return

    I = M // 2

    # forward global pass over rows a_pos..a_pos+I-1 with boundary tb
    HH = np.empty(N + 1, dtype=np.int64)
    EE = np.empty(N + 1, dtype=np.int64)
    HH[0] = 0
    HH[1:] = -q - r * np.arange(1, N + 1, dtype=np.int64)
    EE[1:] = HH[1:] - q
    EE[0] = 0  # unused until set below
    t = -tb
    for i in range(1, I + 1):
        t -= r
        HH, EE = _global_row(HH, EE, mat[a[a_pos + i - 1], b[b_pos:b_pos + N]],
                             q, r, t)
    EE[0] = HH[0]

    # reverse global pass over rows a_pos+M-1..a_pos+I with boundary te
    XX = np.empty(N + 1, dtype=np.int64)
    YY = np.empty(N + 1, dtype=np.int64)
    XX[0] = 0
    XX[1:] = -q - r * np.arange(1, N + 1, dtype=np.int64)
    YY[1:] = XX[1:] - q
    YY[0] = 0
    t = -te
    brev = b[b_pos:b_pos + N][::-1]
    for i in range(1, M - I + 1):
        t -= r
        XX, YY = _global_row(XX, YY, mat[a[a_pos + M - i], brev], q, r, t)
    YY[0] = XX[0]

    # join: first strict max of HH[j] + XX[N-j]; then EE[j] + YY[N-j] + q
    # with >= (the gap-crossing split wins ties)
    sum1 = HH + XX[::-1]
    J = int(np.argmax(sum1))
    best = int(sum1[J])
    P = 0
    sum2 = EE + YY[::-1] + q
    j2 = len(sum2) - 1 - int(np.argmax(sum2[::-1]))  # last max
    if int(sum2[j2]) >= best:
        best = int(sum2[j2])
        P = 1
        J = j2
    if P == 0:
        _diff(ops, a, b, mat, q, r, I, J, a_pos, b_pos, tb, q)
        _diff(ops, a, b, mat, q, r, M - I, N - J, a_pos + I, b_pos + J, q, te)
    else:
        _diff(ops, a, b, mat, q, r, I - 1, J, a_pos, b_pos, tb, 0)
        ops.add("D", 2)
        _diff(ops, a, b, mat, q, r, M - I - 1, N - J,
              a_pos + I + 1, b_pos + J, 0, te)


def _global_row(prev_H, EE, scores, q, r, t):
    """One global (Needleman-Wunsch style, no floor) row of length N+1.

    prev_H/EE have length N+1 (column 0 = boundary); ``t`` is this row's
    column-0 boundary value.  Returns updated (HH, EE).
    """
    N = len(scores)
    E_new = np.empty(N + 1, dtype=np.int64)
    E_new[0] = EE[0]
    E_new[1:] = np.maximum(EE[1:], prev_H[1:] - q) - r
    diag = prev_H[:-1]
    hnof = np.maximum(diag + scores, E_new[1:])
    idx = np.arange(N, dtype=np.int64)
    base = t - q  # f entering column 1: max over boundary chain
    A = np.maximum.accumulate(hnof + idx * r)
    f = np.concatenate(([base - r],
                        np.maximum(A[:-1] - q - idx[1:] * r,
                                   base - r - idx[1:] * r)))
    H = np.empty(N + 1, dtype=np.int64)
    H[0] = t
    H[1:] = np.maximum(hnof, f)
    return H, E_new


def align_py(a, b, matrix, q, r, hint=None):
    """Full gapped alignment of query ``a`` vs db sequence ``b`` (NumPy path).

    Returns (score, a_begin, b_begin, a_end, b_end, opstring).  ``hint`` may
    be (score, a_end, b_end) from the 16-bit hint kernel, skipping the
    forward pass.
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    if hint is not None:
        score, a_end, b_end = hint
        a_begin, b_begin = region_reverse(a, b, mat, q, r, score, a_end, b_end)
    else:
        score, a_begin, b_begin, a_end, b_end = region(a, b, mat, q, r)
    ops = _Ops()
    _diff(ops, a, b, mat, q, r, a_end - a_begin + 1, b_end - b_begin + 1,
          a_begin, b_begin, q, q)
    return score, a_begin, b_begin, a_end, b_end, str(ops)


def _align_impl(a, b, matrix, q, r, hint=None):
    if native.available():
        return native.align(a, b, matrix, q, r, hint)
    return align_py(a, b, matrix, q, r, hint)


def align(a, b, matrix, q, r, hint=None):
    """Gapped alignment; uses the native C++ aligner when available.

    With a hint, the db sequence is first cut to the window that can
    contain the alignment (EXACT: a local alignment of positive score
    spans at most V db columns — ops.align_hint._span_bound, the same
    bound the segmented hint pass and the engine's giant segmentation
    rely on — so b_begin >= b_end+1-V; reverse-DP values inside the
    window do not depend on the cut columns).  This bounds the reverse
    pass and the traceback to O(M*V) regardless of subject length,
    which is what keeps the align phase flat when a hit sits
    mid-chromosome.
    """
    if hint is not None:
        from .ops.align_hint import _span_bound
        score, a_end, b_end = hint
        V = _span_bound(len(a), int(np.asarray(matrix).max()), r)
        if V is not None:
            w0 = b_end + 1 - V
            if w0 > 0:
                sub = np.asarray(b)[w0: b_end + 1]
                s, ab, bb, ae, be, ops = _align_impl(
                    a, sub, matrix, q, r, (score, a_end, b_end - w0))
                return s, ab, bb + w0, ae, be + w0, ops
    return _align_impl(a, b, matrix, q, r, hint)
