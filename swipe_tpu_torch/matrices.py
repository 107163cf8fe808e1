"""Score matrices: built-ins, file/string parser, bias and tier score limits.

Parity target: matrices.cc (score_matrix_read, :317-614).

The canonical matrix is a 32x32 int64 array indexed by [query_code, db_code]
with unset entries equal to -1 (the reference memsets the table to 0xff bytes).
From it we derive:

* ``bias``            = -min(matrix)                       (BIAS)
* ``scorelimit_7``    = 128 - max(matrix)                  (SCORELIMIT_7)
* ``scorelimit_16``   = 65536 - max(matrix)                (SCORELIMIT_16)
* device-side int8/int16/int32 copies used by the Pallas kernels.

Built-in matrix *data* (BLOSUM45/50/62/80/90, PAM30/70/250, IDENTITY_5_1) are
the standard public NCBI tables, stored as plain text files in
``swipe_tpu_torch/data/``; the parser below reads the same whitespace format as
NCBI's matrix files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .alphabet import MAP_NCBI_AA, MAP_SOUND

__all__ = ["ScoreMatrix", "BUILTIN_MATRICES"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

BUILTIN_MATRICES = (
    "BLOSUM45",
    "BLOSUM50",
    "BLOSUM62",
    "BLOSUM80",
    "BLOSUM90",
    "PAM30",
    "PAM70",
    "PAM250",
    "IDENTITY_5_1",
)


def _parse_matrix_text(text: str, charmap: np.ndarray) -> np.ndarray:
    """Parse an NCBI-format score-matrix text into the 32x32 canonical array.

    Lines starting with '#' or empty are comments; a line starting with
    whitespace gives the column symbol order; any other line is a row whose
    first character is the row symbol.  Entries whose row or column symbol is
    outside the 32-code alphabet are dropped.

    The canonical array is indexed [query_code, db_code] throughout this
    package, while the reference scores matrix[db<<5 | query]
    (align.cc:86, search63.cc:52) against its file-row-major parse
    (matrices.cc:408-417) — i.e. score(q, d) = file[row d][col q].  The
    parsed array is therefore TRANSPOSED before returning so asymmetric
    matrix files behave identically.  (All builtin matrices are
    symmetric, so this only matters for user files.)
    """
    m = np.full((32, 32), -1, dtype=np.int64)
    order: list[int] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if line[0] in (" ", "\t"):
            order = [int(charmap[ord(c)]) for c in line.split()]
            continue
        a = int(charmap[ord(line[0])])
        scores = [int(tok) for tok in line[1:].split()]
        for b, sc in zip(order, scores):
            if 0 <= a < 32 and 0 <= b < 32:
                m[a, b] = sc
    return m.T.copy()


@dataclass
class ScoreMatrix:
    """A 32x32 substitution matrix plus the derived kernel parameters."""

    name: str
    matrix: np.ndarray  # (32, 32) int64, [query_code, db_code]
    gapopen: int = 0
    gapextend: int = 0

    lo: int = field(init=False)
    hi: int = field(init=False)
    bias: int = field(init=False)
    scorelimit_7: int = field(init=False)
    scorelimit_8: int = field(init=False)
    scorelimit_16: int = field(init=False)
    scorelimit_32: int = field(init=False)

    def __post_init__(self) -> None:
        self.matrix = np.asarray(self.matrix, dtype=np.int64).reshape(32, 32)
        self.lo = int(self.matrix.min())
        self.hi = int(self.matrix.max())
        self.bias = -self.lo
        self.scorelimit_7 = 128 - self.hi
        self.scorelimit_8 = 256 - self.hi
        self.scorelimit_16 = 65536 - self.hi
        self.scorelimit_32 = 4294967296 - self.hi

    @property
    def gapopenextend(self) -> int:
        return self.gapopen + self.gapextend

    @property
    def fits_int8(self) -> bool:
        """True when the int8 TPU kernels can take this matrix directly."""
        return self.lo >= -128 and self.hi <= 127

    def with_gaps(self, gapopen: int, gapextend: int) -> "ScoreMatrix":
        return ScoreMatrix(self.name, self.matrix, gapopen, gapextend)

    # ---- constructors -----------------------------------------------------

    @classmethod
    def builtin(cls, name: str, gapopen: int = 0, gapextend: int = 0,
                symtype: int = 1) -> "ScoreMatrix":
        path = os.path.join(_DATA_DIR, name.lower() + ".mat")
        if not os.path.exists(path):
            raise FileNotFoundError(f"No built-in matrix named {name!r}")
        charmap = MAP_SOUND if symtype == 5 else MAP_NCBI_AA
        with open(path) as f:
            m = _parse_matrix_text(f.read(), charmap)
        return cls(name.upper(), m, gapopen, gapextend)

    @classmethod
    def from_file(cls, path: str, gapopen: int = 0, gapextend: int = 0,
                  symtype: int = 1) -> "ScoreMatrix":
        charmap = MAP_SOUND if symtype == 5 else MAP_NCBI_AA
        with open(path) as f:
            m = _parse_matrix_text(f.read(), charmap)
        return cls(os.path.basename(path), m, gapopen, gapextend)

    @classmethod
    def from_name_or_file(cls, name: str, gapopen: int = 0, gapextend: int = 0,
                          symtype: int = 1) -> "ScoreMatrix":
        if name.upper() in BUILTIN_MATRICES:
            return cls.builtin(name, gapopen, gapextend, symtype)
        return cls.from_file(name, gapopen, gapextend, symtype)

    @classmethod
    def nucleotide(cls, matchscore: int, mismatchscore: int,
                   gapopen: int = 0, gapextend: int = 0) -> "ScoreMatrix":
        """Synthesize the nt16 matrix: match on the diagonal of codes 1..15.

        Parity target: matrices.cc:533-537 — ambiguity codes
        score as a match only against themselves.
        """
        m = np.full((32, 32), -1, dtype=np.int64)
        for a in range(1, 16):
            for b in range(1, 16):
                m[a, b] = matchscore if a == b else mismatchscore
        return cls(f"nt(+{matchscore}/{mismatchscore})", m, gapopen, gapextend)

    # ---- device-friendly views -------------------------------------------

    def as_int8(self) -> np.ndarray:
        """int8 view with the same wrap-around the reference's casts produce."""
        return self.matrix.astype(np.int8)

    def as_int16(self) -> np.ndarray:
        return self.matrix.astype(np.int16)

    def as_int32(self) -> np.ndarray:
        return self.matrix.astype(np.int32)
