"""Reading frames of nucleotide letters, for the translated search modes
(blastx, tblastn, tblastx), worked out from the inputs alone.

Frame f of the plus strand starts at base f; frame f of the minus strand
starts at base f of the reverse complement; a frame holds every whole
codon from there (SWIPE's ``translate``, query.cc:459-506).  Codons are
read under NCBI genetic code 1.  A codon with an ambiguous IUPAC base
stands for every concrete codon it covers: it translates to their amino
acid where all agree, to B where they only span D and N, to Z where they
only span Q and E, and to X otherwise (SWIPE's ``translate_createtable``,
query.cc:377-451).

A hit of a translated search is one (query frame, record frame) pair of
a record.  Its key, ``key(qstrand, qframe, dstrand, dframe)``, is one
number that sorts as the program breaks ties between equal scores of a
record: qstrand, qframe, dstrand, dframe ascending.  A query row's key
plus a record frame's key is the key of their pair.
"""

from __future__ import annotations

import numpy as np

# NCBI genetic code 1 (the standard code), codons in TCAG order: the
# codon b1 b2 b3 is entry 16 b1 + 4 b2 + b3 with T=0, C=1, A=2, G=3
CODE1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"

# IUPAC letters as sets of bases, a bit each: A=1, C=2, G=4, T=8
_IUPAC = {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "M": 3, "R": 5, "W": 9,
          "S": 6, "Y": 10, "K": 12, "V": 7, "H": 11, "D": 13, "B": 14,
          "N": 15}
_TCAG = {1: 2, 2: 1, 4: 3, 8: 0}        # a base's bit -> its place in TCAG

MASK = np.full(256, 255, dtype=np.uint8)
for _c, _m in _IUPAC.items():
    MASK[ord(_c)] = MASK[ord(_c.lower())] = _m
# the complement swaps the A and T bits and the C and G bits
COMPLEMENT = np.array([((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1)
                       | ((m & 8) >> 3) for m in range(16)], dtype=np.uint8)


def _codon_table(code: str) -> np.ndarray:
    """[16 * 16 * 16] amino-acid letters (ASCII) by the three bases'
    masks."""
    table = np.zeros(16 ** 3, dtype=np.uint8)
    bases = {m: [t for bit, t in _TCAG.items() if m & bit]
             for m in range(1, 16)}
    for a in range(1, 16):
        for b in range(1, 16):
            for c in range(1, 16):
                aas = {code[16 * x + 4 * y + z] for x in bases[a]
                       for y in bases[b] for z in bases[c]}
                if len(aas) == 1:
                    aa = aas.pop()
                elif aas <= {"D", "N"}:
                    aa = "B"
                elif aas <= {"Q", "E"}:
                    aa = "Z"
                else:
                    aa = "X"
                table[256 * a + 16 * b + c] = ord(aa)
    return table


TABLE = _codon_table(CODE1)


def translate(seq: np.ndarray, strand: int, frame: int) -> np.ndarray:
    """ASCII amino acids of one reading frame of ASCII nucleotides:
    ``strand`` 0 the letters as given, 1 their reverse complement;
    ``frame`` 0-2 the first base read.  Raises on a letter that is no
    IUPAC nucleotide."""
    m = MASK[np.asarray(seq, dtype=np.uint8)]
    if (m == 255).any():
        raise ValueError("a letter outside the IUPAC nucleotides")
    if strand:
        m = COMPLEMENT[m[::-1]]
    n = max((len(m) - frame) // 3, 0)
    c = m[frame:frame + 3 * n].reshape(n, 3).astype(np.int64)
    return TABLE[256 * c[:, 0] + 16 * c[:, 1] + c[:, 2]]


def key(qstrand: int, qframe: int, dstrand: int, dframe: int) -> int:
    """One number for a hit's frames, ascending as the program's ties."""
    return ((3 * qstrand + qframe) * 2 + dstrand) * 3 + dframe


def unkey(k: int) -> tuple[int, int, int, int]:
    """(qstrand, qframe, dstrand, dframe) of a key."""
    return k // 18, k // 6 % 3, k // 3 % 2, k % 3


def strands(config: dict) -> list[int]:
    """The query strands that the configuration's ``strands`` names (1
    plus, 2 minus, 3 both)."""
    return [s for s in (0, 1) if (s + 1) & int(config["strands"])]


def query_frames(query: np.ndarray, config: dict):
    """[(row key, letters)] of a nucleotide query's frames on its
    strands."""
    return [(key(s, f, 0, 0), translate(query, s, f))
            for s in strands(config) for f in range(3)]


def record_frames(corpus):
    """Every record's six frames as subjects: (letters, starts, lengths,
    record number, key) of each, record by record, plus strand then
    minus, frame 0-2."""
    parts, seqno, keys = [], [], []
    for i in range(len(corpus.lens)):
        rec = corpus.record(i)
        for s in (0, 1):
            for f in range(3):
                parts.append(translate(rec, s, f))
                seqno.append(i)
                keys.append(key(0, 0, s, f))
    lens = np.array([len(p) for p in parts], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return (flat, starts, lens, np.array(seqno, dtype=np.int64),
            np.array(keys, dtype=np.int64))
