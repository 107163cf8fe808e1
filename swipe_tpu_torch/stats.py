"""Karlin-Altschul statistics: parameter tables, length adjustment, E-values.

The parameter tables are the public-domain NCBI BLAST constants
(per-matrix/per-gap-cost rows; protein rows are 8-wide
{gapopen, gapextend, decline_to_align, lambda, K, H, alpha, beta} —
get_params reads columns 3..7 — and blastn rows are 7-wide without the
decline field) stored in ``swipe_tpu_torch/data/ka_params.json``.  Lookup
semantics match the reference (parity targets: stats.cc:44-325 and
blastkar_partial.c:656-748):

* protein params: exact (gapopen, gapextend) row for the matrix; row
  (32767, 32767) holds the ungapped values (used by tblastx).
* nucleotide params: per (match, mismatch) table; gap costs at or above the
  table's (gomax, gemax) threshold are treated as infinite, i.e. row (0, 0).
* length adjustment: iterative fixed point of
  ell = beta + (alpha/lambda) (ln K + ln((m - ell)(n - N ell))).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

__all__ = [
    "KAParams",
    "get_params",
    "get_params_nt",
    "get_prefs",
    "length_adjustment",
    "EvalueModel",
]

_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        path = os.path.join(os.path.dirname(__file__), "data",
                            "ka_params.json")
        with open(path) as f:
            _TABLES = json.load(f)
    return _TABLES


@dataclass(frozen=True)
class KAParams:
    lambda_: float
    K: float
    H: float
    alpha: float
    beta: float


def get_params(matrixname: str, gapopen: int, gapextend: int) -> KAParams | None:
    """Gapped Karlin-Altschul parameters for a protein matrix, or None."""
    table = _tables()["protein"].get(matrixname.upper())
    if table is None:
        return None
    for row in table:
        if abs(row[0] - gapopen) < 0.1 and abs(row[1] - gapextend) < 0.1:
            return KAParams(row[3], row[4], row[5], row[6], row[7])
    return None


def get_params_nt(matchscore: int, mismatchscore: int,
                  gapopen: int, gapextend: int) -> KAParams | None:
    """Karlin-Altschul parameters for blastn match/mismatch scoring."""
    t = _tables()
    key = f"{matchscore},{mismatchscore}"
    table = t["nucleotide"].get(key)
    if table is None:
        return None
    gomax, gemax = t["nt_gmax"][key]
    if gapopen >= gomax and gapextend >= gemax:
        gapopen = 0
        gapextend = 0
    for row in table:
        if abs(row[0] - gapopen) < 0.1 and abs(row[1] - gapextend) < 0.1:
            return KAParams(row[2], row[3], row[4], row[5], row[6])
    return None


def get_prefs(matrixname: str) -> tuple[int, int] | None:
    """Default (gapopen, gapextend) for a matrix: its first BEST-flagged row."""
    t = _tables()
    key = matrixname.upper()
    table = t["protein"].get(key)
    prefs = t["prefs"].get(key)
    if table is None or prefs is None:
        return None
    for row, p in zip(table, prefs):
        if p:
            return int(row[0]), int(row[1])
    return None


def length_adjustment(K: float, logK: float, alpha_d_lambda: float,
                      beta: float, query_length: int, db_length: int,
                      db_num_seqs: int) -> tuple[int, bool]:
    """BLAST edge-effect length adjustment.

    Returns (adjustment, converged).  Integer approximation (from below) of
    the fixed point of f(ell) = beta + (alpha/lambda)(lnK + ln((m-ell)(n-N
    ell))), constrained so K (m-A)(n-NA) > max(m,n).
    """
    maxits = 20
    m = float(query_length)
    n = float(db_length)
    N = float(db_num_seqs)

    a = N
    mb = m * N + n
    c = n * m - max(m, n) / K
    if c < 0:
        return 0, False
    ell_max = 2 * c / (mb + math.sqrt(mb * mb - 4 * a * c))

    ell_min = 0.0
    ell_next = 0.0
    converged = False
    for i in range(1, maxits + 1):
        ell = ell_next
        ss = (m - ell) * (n - N * ell)
        ell_bar = alpha_d_lambda * (logK + math.log(ss)) + beta
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
    if converged:
        adj = int(ell_min)
        ell = math.ceil(ell_min)
        if ell <= ell_max:
            ss = (m - ell) * (n - N * ell)
            if alpha_d_lambda * (logK + math.log(ss)) + beta >= ell:
                adj = int(ell)
    else:
        adj = int(ell_min)
    return adj, converged


class EvalueModel:
    """Per-(query, database, scoring) E-value/bit-score engine.

    Mirrors the statistics block of the reference's hits_init
    (hits.cc:283-511): looks up lambda/K/H/alpha/beta,
    computes the length adjustment and the effective search space Kmn, and
    converts E-value cutoffs into raw score thresholds.
    """

    def __init__(self, symtype: int, query_length_primary: int,
                 db_seqcount: int, db_symcount: int, *,
                 matrixname: str | None = None,
                 matchscore: int = 0, mismatchscore: int = 0,
                 gapopen: int = 0, gapextend: int = 0,
                 effdbsize: int = 0):
        self.available = False
        self.Kmn = 0.0
        self.m = 0
        self.n = 0
        self.length_adjust = 0

        if symtype == 0:
            p = get_params_nt(matchscore, mismatchscore, gapopen, gapextend)
        elif symtype < 5:
            if symtype == 4:
                p = get_params(matrixname or "", 32767, 32767)
            else:
                p = get_params(matrixname or "", gapopen, gapextend)
        else:
            p = None
        if p is None:
            return

        self.available = True
        self.params = p
        self.lambda_ = p.lambda_
        self.K = p.K
        self.H = p.H
        self.alpha = p.alpha
        self.beta = p.beta
        self.logK = math.log(p.K)
        self.lambda_d_log2 = p.lambda_ / math.log(2.0)
        self.logK_d_log2 = self.logK / math.log(2.0)

        # qlen/dlen in the units the statistics expect (aa for translated)
        qlen = query_length_primary
        if symtype in (2, 4):
            qlen = query_length_primary // 3
        if effdbsize > 0:
            dlen = effdbsize
        else:
            dlen = db_symcount // 3 if symtype in (3, 4) else db_symcount

        lenadj, _ = length_adjustment(
            p.K, self.logK, p.alpha / p.lambda_, p.beta,
            qlen, dlen, db_seqcount)
        self.length_adjust = lenadj
        self.m = qlen - lenadj
        self.n = effdbsize if effdbsize > 0 else dlen - db_seqcount * lenadj
        self.Kmn = p.K * float(self.m) * float(self.n)

    # ---- conversions -------------------------------------------------------

    def evalue(self, score: int) -> float:
        return self.Kmn * math.exp(-self.lambda_ * score)

    def bits(self, score: int) -> float:
        return self.lambda_d_log2 * score - self.logK_d_log2

    def bits_rounded(self, score: int) -> int:
        return int(math.floor(self.bits(score) + 0.5))

    # (long)(ceil/floor of -inf) on x86-64: cvttsd2si yields LONG_MIN for
    # inf/nan/out-of-range.  Kmn == 0 (an empty query record: a bare
    # '>header' line is valid FASTA) reaches exactly that in the
    # reference (hits.cc:491,497 with expect/0 = inf); Python would
    # instead raise ZeroDivisionError, killing the whole run
    _LONG_MIN = -(1 << 63)

    def min_score_for_expect(self, expect: float) -> int:
        """Smallest score with E-value <= expect (reference's ceil rule,
        incl. the Kmn=0 -> LONG_MIN cast quirk)."""
        if self.Kmn <= 0:
            return self._LONG_MIN
        return int(math.ceil(-math.log(expect / self.Kmn) / self.lambda_))

    def max_score_for_expect(self, minexpect: float) -> int:
        """Largest score with E-value >= minexpect (reference's floor
        rule, incl. the Kmn=0 -> LONG_MIN cast quirk)."""
        if self.Kmn <= 0:
            return self._LONG_MIN
        return int(math.floor(-math.log(minexpect / self.Kmn) / self.lambda_))
