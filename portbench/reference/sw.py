"""Plain Smith-Waterman scores of queries against many subjects.

The benchmark's reference: PyTorch tensor operations only, on whatever
device it is given, with no kernel, pack or table of the program under
test.  Sequences arrive as letters; a score matrix file maps them to
indices.

The recurrence is Gotoh's affine-gap local alignment with the gap cost
``gapopen + L * gapextend`` for a gap of length L:

    E[i, j] = max(E[i, j-1], H[i, j-1] - gapopen) - gapextend
    F[i, j] = max(F[i-1, j], H[i-1, j] - gapopen) - gapextend
    H[i, j] = max(0, H[i-1, j-1] + s(q_i, d_j), E[i, j], F[i, j])

computed one subject column at a time for a batch of subjects, the query
rows along the first axis.  The column's F chain is resolved exactly with
a running maximum over rows: F[i] = max_{k<i} (H'[k] + k g) - o - i g,
where H' is the column before F is applied (opening a gap from a cell
that itself ends a vertical gap never beats extending, since o >= 0).

Scores are exact.  Tensors are int16 where the bound max(s) * m plus the
row offsets provably fits, else int32; ``saturate`` clamps every H to a
ceiling instead, which is the control's lower precision, not an exact
score.
"""

from __future__ import annotations

import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_matrix(name: str) -> tuple[str, np.ndarray]:
    """(letters, [n, n] int64 scores) of the matrix file ``<name>.txt``
    beside this module (NCBI's text layout: a header row of letters,
    then one row per letter)."""
    letters, rows = None, []
    with open(os.path.join(HERE, name + ".txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if letters is None:
                letters = "".join(line.split())
                continue
            rows.append([int(x) for x in line.split()[1:]])
    return letters, np.array(rows, dtype=np.int64)


def nucleotide_matrix(match: int, mismatch: int) -> tuple[str, np.ndarray]:
    """(letters, scores) of a match/mismatch scheme over ACGT."""
    m = np.full((4, 4), mismatch, dtype=np.int64)
    np.fill_diagonal(m, match)
    return "ACGT", m


def encode(letters: str, seq: bytes | np.ndarray) -> np.ndarray:
    """Matrix indices (uint8) of ASCII residues; raises on a letter the
    matrix does not have."""
    lut = np.full(256, 255, dtype=np.uint8)
    for i, c in enumerate(letters):
        lut[ord(c)] = i
    out = lut[np.frombuffer(bytes(seq), dtype=np.uint8)
              if not isinstance(seq, np.ndarray) else seq]
    if (out == 255).any():
        raise ValueError("a residue outside the matrix's letters")
    return out


def span_bound(m: int, max_score: int, gapextend: int) -> int:
    """Longest subject span of a positive-score local alignment of a query
    of m residues: its pairs score at most m * max_score, and every
    subject residue beyond the m paired ones costs at least gapextend."""
    return m + -(-m * max_score // gapextend)


class Subjects:
    """Many subjects as one flat index array on a device, with their
    starts and lengths; subjects longer than ``piece`` are cut into
    overlapped pieces, each piece's score counting for its subject (the
    overlap holds every positive alignment whole, so the maximum over
    pieces is the subject's score)."""

    def __init__(self, flat: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray, device):
        self.device = torch.device(device)
        self.flat = torch.from_numpy(np.ascontiguousarray(flat)).to(
            self.device)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lens = np.asarray(lens, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.lens)

    def pieces(self, overlap: int, piece: int):
        """(owner, start, length) arrays of the pieces."""
        owner, st, ln = [], [], []
        stride = max(piece - overlap, 1)
        for i, (s, n) in enumerate(zip(self.starts, self.lens)):
            if n <= piece:
                owner.append(i), st.append(s), ln.append(n)
                continue
            for p in range(0, n - overlap, stride):
                owner.append(i)
                st.append(s + p)
                ln.append(min(piece, n - p))
        return (np.array(owner, np.int64), np.array(st, np.int64),
                np.array(ln, np.int64))


def _batches(lens: np.ndarray, m: int, elems: int, cells: int):
    """Consecutive runs of ``lens`` (sorted ascending): at most elems / m
    subjects, at most ``cells`` subject residues padded, and a longest
    subject at most 1.25 times the first plus 16."""
    n = len(lens)
    k = 0
    width = max(elems // max(m, 1), 1)
    while k < n:
        end = min(k + width, n)
        cap = int(lens[k] * 1.25) + 16
        end = min(end, int(np.searchsorted(lens, cap, side="right")))
        while end - k > 1 and (end - k) * int(lens[end - 1]) > cells:
            end = k + max(cells // int(lens[end - 1]), 1)
        end = max(end, k + 1)
        yield k, end
        k = end


def sw_scan(queries: list[np.ndarray], subjects: Subjects,
            matrix: np.ndarray, gapopen: int, gapextend: int, *,
            saturate: int | None = None, elems: int = 1 << 25,
            cells: int = 1 << 25, piece: int | None = None) -> np.ndarray:
    """Best local score of each query (matrix indices) against every
    subject: int64 [query, subject].  All queries run in one pass, each
    padded at its end to the longest with rows that score below any cell
    (a padded row's H stays under a real cell's, so it never sets a
    maximum).  ``saturate`` caps every cell's H at that value (the
    control)."""
    dev = subjects.device
    Q = len(queries)
    m = max((len(q) for q in queries), default=0)
    mat = np.asarray(matrix, dtype=np.int64)
    max_s = int(mat.max())
    best = np.zeros((Q, len(subjects)), dtype=np.int64)
    if m == 0 or max_s <= 0:
        return best
    overlap = span_bound(m, max_s, gapextend) if gapextend > 0 else None
    if piece is None or overlap is None:
        owner = np.arange(len(subjects), dtype=np.int64)
        st, ln = subjects.starts, subjects.lens
    else:
        owner, st, ln = subjects.pieces(overlap, max(piece, 2 * overlap))
    go, ge = int(gapopen), int(gapextend)
    # int16 holds every value when the largest, a row offset plus the
    # best score, stays under 2**15; the pad score sits below any H
    bound = (max_s + ge) * m + go + ge + 1
    dtype = torch.int16 if bound < (1 << 15) - 1 and saturate is None \
        else torch.int32
    neg = -(max_s * m + 1)
    prof = np.full((Q, m, mat.shape[1] + 1), neg, dtype=np.int64)
    for k, q in enumerate(queries):
        prof[k, :len(q), :-1] = mat[np.asarray(q, np.int64)]
    pad = prof.shape[2] - 1
    P = torch.from_numpy(prof).to(dev, dtype)
    rows = torch.arange(m, device=dev, dtype=dtype)[:, None]
    rowg = rows * ge
    # F[r] = C[r-1] - go - r*ge for rows r >= 1
    offs = (go + rows[1:] * ge).to(dtype)
    order = np.argsort(ln, kind="stable")
    lens_sorted = ln[order]
    for k, end in _batches(lens_sorted, Q * m, elems, cells):
        sel = order[k:end]
        B = len(sel)
        L = int(lens_sorted[end - 1])
        st_t = torch.from_numpy(st[sel]).to(dev)
        ln_t = torch.from_numpy(ln[sel]).to(dev)
        j = torch.arange(L, device=dev)[:, None]
        pos = torch.clamp(st_t[None, :] + j, max=subjects.flat.numel() - 1)
        subj = subjects.flat[pos].to(torch.int32)
        subj[j >= ln_t[None, :]] = pad
        Ha = torch.zeros((Q, m + 1, B), dtype=dtype, device=dev)
        Hb = torch.zeros_like(Ha)
        E = torch.full((Q, m, B), -(go + ge), dtype=dtype, device=dev)
        T = torch.empty_like(E)
        A = torch.empty_like(E)
        Cv = torch.empty_like(E)
        Ci = torch.empty((Q, m, B), dtype=torch.int64, device=dev)
        F = torch.empty((Q, m - 1, B), dtype=dtype, device=dev)
        S = torch.zeros((Q, B), dtype=dtype, device=dev)
        for c in range(L):
            Hn = Hb[:, 1:]
            s = P.index_select(2, subj[c])
            torch.add(Ha[:, :-1], s, out=Hn)
            torch.sub(Ha[:, 1:], go + ge, out=T)
            E.sub_(ge)
            torch.maximum(E, T, out=E)
            torch.maximum(Hn, E, out=Hn)
            Hn.clamp_(min=0)
            if m > 1:
                torch.add(Hn, rowg, out=A)
                torch.cummax(A, dim=1, out=(Cv, Ci))
                torch.sub(Cv[:, :-1], offs, out=F)
                torch.maximum(Hn[:, 1:], F, out=Hn[:, 1:])
            if saturate is not None:
                Hn.clamp_(max=saturate)
            torch.maximum(S, Hn.amax(dim=1), out=S)
            Ha, Hb = Hb, Ha
        got = S.cpu().numpy().astype(np.int64)
        for q in range(Q):
            np.maximum.at(best[q], owner[sel], got[q])
    return best
