"""What a SWIPE search must return, worked out from the inputs alone.

Plain NumPy and the scores of ``sw.sw_scan``: the hit list (every
(sequence, key) whose best local score reaches the E-value cutoff,
ordered by score descending, then sequence number descending, then
key, cut at max(-v, -b) entries; the key stands for a hit's strands
and reading frames), the E-value of each hit under the
Karlin-Altschul statistics that the configuration states, and a judge
of reported alignments that re-walks them over the inputs.

Nothing here reads the program under test; its outputs are passed in
only to be judged.
"""

from __future__ import annotations

import math
import re

import numpy as np

_OPS = re.compile(r"([MDI])(\d+)")


def length_adjustment(K: float, alpha_d_lambda: float, beta: float,
                      m: int, n: int, N: int) -> int:
    """BLAST's edge-effect correction: the largest integer ell with
    ell <= beta + (alpha/lambda)(ln K + ln((m - ell)(n - N ell))), found by
    the bisection of NCBI's BLAST_ComputeLengthAdjustment (20 steps)."""
    logK = math.log(K)
    m, n, N = float(m), float(n), float(N)
    mb = m * N + n
    c = n * m - max(m, n) / K
    if c < 0:
        return 0
    ell_max = 2 * c / (mb + math.sqrt(mb * mb - 4 * N * c))
    ell_min, ell_next, converged = 0.0, 0.0, False
    for i in range(1, 21):
        ell = ell_next
        ell_bar = alpha_d_lambda * (
            logK + math.log((m - ell) * (n - N * ell))) + beta
        if ell_bar >= ell:
            ell_min = ell
            if ell_bar - ell_min <= 1.0:
                converged = True
                break
            if ell_min >= ell_max:
                break
        else:
            ell_max = ell
        if ell_min <= ell_bar <= ell_max:
            ell_next = ell_bar
        else:
            ell_next = ell_max if i == 1 else (ell_min + ell_max) / 2
    adj = int(ell_min)
    if converged:
        ell = math.ceil(ell_min)
        if ell <= ell_max and alpha_d_lambda * (
                logK + math.log((m - ell) * (n - N * ell))) + beta >= ell:
            adj = int(ell)
    return adj


class Statistics:
    """E-values of one query against one database: K m' n' e^(-lambda S)
    with the lengths corrected by ``length_adjustment``."""

    def __init__(self, stats: dict, qlen: int, db_residues: int,
                 db_seqs: int):
        self.lam = float(stats["lambda"])
        K = float(stats["K"])
        adj = length_adjustment(K, float(stats["alpha"]) / self.lam,
                                float(stats["beta"]), qlen, db_residues,
                                db_seqs)
        self.kmn = K * float(qlen - adj) * float(db_residues - db_seqs * adj)

    def evalue(self, score: int) -> float:
        return self.kmn * math.exp(-self.lam * score)

    def min_score(self, expect: float) -> int:
        """Smallest score whose E-value is at most ``expect``."""
        return int(math.ceil(-math.log(expect / self.kmn) / self.lam))


def hit_list(scores: np.ndarray, key: np.ndarray, seqno: np.ndarray,
             threshold: int, keep: int) -> list[tuple[int, int, int]]:
    """[(seqno, key, score)] of the units scoring at least
    ``threshold``: score descending, seqno descending, key ascending,
    the first ``keep``."""
    sel = np.flatnonzero(scores >= threshold)
    order = np.lexsort((key[sel], -seqno[sel], -scores[sel]))[:keep]
    sel = sel[order]
    return [(int(seqno[i]), int(key[i]), int(scores[i])) for i in sel]


def walk(ops: str, q: np.ndarray, d: np.ndarray, q0: int, d0: int,
         matrix: np.ndarray, gapopen: int, gapextend: int):
    """Score and last (query, subject) positions of a run-length op string
    ("M" pairs a query and a subject residue, "D" skips query residues,
    "I" subject residues) laid from (q0, d0); None when it leaves either
    sequence or is empty."""
    i, j, score, n = q0, d0, 0, 0
    for op, num in _OPS.findall(ops):
        k = int(num)
        n += k
        if op == "M":
            if i + k > len(q) or j + k > len(d) or i < 0 or j < 0:
                return None
            score += int(matrix[q[i:i + k], d[j:j + k]].sum())
            i += k
            j += k
        else:
            score -= gapopen + gapextend * k
            if op == "D":
                i += k
            else:
                j += k
    if n == 0 or "".join(f"{a}{b}" for a, b in _OPS.findall(ops)) != ops:
        return None
    return score, i - 1, j - 1
