"""Host-side Smith-Waterman oracles used for testing and as exact fallbacks.

``sw_scalar`` is a literal textbook implementation of the gapped local
alignment recurrence used by the reference's 63-bit kernel
(search63.cc:28-89).  ``sw_numpy`` is a vectorized
formulation (parallel over query positions, exact lazy-F via a weighted
prefix max) that is fast enough to serve as the oracle on thousands of
sequences; the two are cross-checked in the test suite.

Conventions (shared across the whole framework):
  * gap of length L costs  gapopen + L * gapextend
  * ``Q`` below = gapopen + gapextend (charged at the first gap residue),
    ``R`` = gapextend.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sw_scalar", "sw_numpy", "sw_numpy_many"]

NEG = -(1 << 40)


def sw_scalar(query: np.ndarray, dseq: np.ndarray, matrix: np.ndarray,
              gapopen: int, gapextend: int) -> int:
    """Textbook O(M*N) affine-gap local alignment score."""
    q = np.asarray(query, dtype=np.int64)
    d = np.asarray(dseq, dtype=np.int64)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q = gapopen + gapextend
    R = gapextend
    m = len(q)
    H = np.zeros(m + 1, dtype=np.int64)   # H[i] = cell in previous db column
    E = np.full(m + 1, NEG, dtype=np.int64)  # gap-in-query (along db axis)
    best = 0
    for dj in d:
        diag = 0  # H[i-1] of previous column
        f = NEG
        for i in range(1, m + 1):
            e = max(E[i] - R, H[i] - Q)
            h = max(0, diag + mat[q[i - 1], dj], e, f)
            diag = H[i]
            H[i] = h
            E[i] = e
            f = max(f - R, h - Q)
            if h > best:
                best = h
    return int(best)


def sw_numpy(query: np.ndarray, dseq: np.ndarray, matrix: np.ndarray,
             gapopen: int, gapextend: int) -> int:
    """Vectorized-over-query exact SW score for a single db sequence."""
    return int(
        sw_numpy_many(query, [np.asarray(dseq)], matrix, gapopen, gapextend)[0]
    )


def sw_numpy_many(query: np.ndarray, dseqs: list[np.ndarray] | np.ndarray,
                  matrix: np.ndarray, gapopen: int, gapextend: int,
                  lengths: np.ndarray | None = None) -> np.ndarray:
    """Exact SW scores of one query against many db sequences at once.

    ``dseqs`` may be a list of 1-D code arrays or a dense [nseq, maxlen]
    array with ``lengths`` giving true lengths.  Vectorized over both the
    sequence axis and the query axis; the per-column gap-in-db chain (F in
    the reference's orientation) is resolved exactly with a weighted prefix
    max: F[i] = max_{k<i}(Hnof[k] - Q - (i-1-k)R)
             = max-accum(Hnof[k] + k*R)[i-1] - Q - (i-1)*R,
    which is exact because opening a gap from a gap-derived cell can never
    beat extending (gapopen >= 0).
    """
    qcodes = np.asarray(query, dtype=np.int64)
    m = len(qcodes)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q = gapopen + gapextend
    R = gapextend

    if isinstance(dseqs, np.ndarray) and dseqs.ndim == 2:
        dense = dseqs.astype(np.int64)
        lens = (np.full(len(dense), dense.shape[1], dtype=np.int64)
                if lengths is None else np.asarray(lengths, dtype=np.int64))
    else:
        lens = np.array([len(s) for s in dseqs], dtype=np.int64)
        maxlen = int(lens.max()) if len(lens) else 0
        dense = np.zeros((len(dseqs), maxlen), dtype=np.int64)
        for i, s in enumerate(dseqs):
            dense[i, : len(s)] = np.asarray(s, dtype=np.int64)

    n_seq, maxlen = dense.shape
    # Query profile: QP[sym, i] = matrix[query[i], sym]
    QP = mat[qcodes, :].T  # (32, m)

    H = np.zeros((n_seq, m), dtype=np.int64)
    E = np.full((n_seq, m), NEG, dtype=np.int64)
    best = np.zeros(n_seq, dtype=np.int64)
    idxR = np.arange(m, dtype=np.int64) * R

    for j in range(maxlen):
        active = j < lens
        if not active.any():
            break
        sym = dense[:, j]
        P = QP[sym, :]  # (n_seq, m) substitution scores for this column
        E = np.maximum(E - R, H - Q)
        diag = np.concatenate(
            [np.zeros((n_seq, 1), dtype=np.int64), H[:, :-1]], axis=1
        )
        Hnof = np.maximum(np.maximum(diag + P, E), 0)
        # exact F via weighted prefix max
        A = np.maximum.accumulate(Hnof + idxR, axis=1)
        # F[i] = A[i-1] - Q - (i-1)*R
        F = np.concatenate(
            [np.full((n_seq, 1), NEG, dtype=np.int64), A[:, :-1]], axis=1
        ) - Q - idxR + R
        H = np.maximum(Hnof, F)
        col_best = H.max(axis=1)
        best = np.where(active, np.maximum(best, col_best), best)
        # freeze state on exhausted sequences
        H = np.where(active[:, None], H, 0)
        E = np.where(active[:, None], E, NEG)
    return best
