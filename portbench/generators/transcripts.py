"""Full-length transcripts for blastx against a protein database with
UniProtKB/Swiss-Prot's statistics: each query is the coding sequence of
a mutated database record between a 5' and a 3' UTR, read in either
orientation.

The database and the proteins are ``protein_corpus``'s: ``build`` is its
``build``, and a transcript's protein is one of its queries (a record of
the target length with a share of its residues redrawn, further mutated
copies planted in other records).  A transcript of L bases holds a
protein of P = (L - utr5 - utr3 - 3) / 3 residues: the 5' UTR, P sense
codons, a stop codon and the 3' UTR.  Each residue's codon is drawn
uniformly from its synonymous codons under genetic code 1, the stop
uniformly from the three stops, the UTR bases uniformly from ACGT (50%
GC).  Half the transcripts, at even odds from the seed, are reverse
complemented, as an unstranded assembly gives them, so each query has
one true reading frame: frame utr5 % 3 of the strand it was written on.
"""

from __future__ import annotations

import numpy as np

from portbench.generators import protein_corpus
from portbench.generators.genome import revcomp
from portbench.reference.translate import CODE1
from portbench.workload import Corpus, draw, letters_lut

build = protein_corpus.build

_BASES = "TCAG"
# codons of genetic code 1, in TCAG order, as ASCII bytes
_CODONS = np.frombuffer("".join(
    a + b + c for a in _BASES for b in _BASES for c in _BASES).encode(),
    np.uint8).reshape(64, 3)


def _synonyms() -> tuple[np.ndarray, np.ndarray]:
    """([256, 6] codon numbers of each amino-acid letter, [256] how many
    it has); a letter with none has 0."""
    table = np.zeros((256, 6), dtype=np.int64)
    count = np.zeros(256, dtype=np.int64)
    for i, aa in enumerate(CODE1):
        a = ord(aa)
        table[a, count[a]] = i
        count[a] += 1
    return table, count


_SYNONYMS, _NSYN = _synonyms()
_STOPS = _SYNONYMS[ord("*"), :_NSYN[ord("*")]]
_UTR = letters_lut(dict.fromkeys("ACGT", 1))


def _flank(config: dict) -> int:
    """Bases of a transcript outside its sense codons: both UTRs and the
    stop codon."""
    q = config["queries"]
    return int(q["utr5"]) + int(q["utr3"]) + 3


def back_translate(protein: np.ndarray, rng: np.random.Generator
                   ) -> np.ndarray:
    """ASCII bases of ``protein`` (ASCII amino acids), a codon drawn
    uniformly from each residue's synonyms, then a stop codon."""
    n = _NSYN[protein]
    if (n == 0).any() or (protein == ord("*")).any():
        raise ValueError("a residue with no sense codon")
    pick = (rng.random(len(protein)) * n).astype(np.int64)
    codons = np.append(_SYNONYMS[protein, pick],
                       _STOPS[rng.integers(0, len(_STOPS))])
    return _CODONS[codons].ravel()


def query_lengths(config: dict, lo: int, hi: int, pool: int) -> np.ndarray:
    """``pool`` transcript lengths within [lo, hi]: the protein lengths
    that ``protein_corpus`` takes between the coding lengths that fit,
    wrapped in the UTRs and the stop codon."""
    f = _flank(config)
    plo, phi = max(-(-(lo - f) // 3), 1), (hi - f) // 3
    if plo > phi:
        raise ValueError(f"no transcript of {config['name']} in "
                         f"[{lo}, {hi}] bases holds a protein")
    return 3 * protein_corpus.query_lengths(config, plo, phi, pool) + f


def transcripts(corpus: Corpus, config: dict, rounds: list[np.ndarray],
                rng: np.random.Generator):
    """[(transcript letters, its protein's letters, reverse
    complemented)] of every query, in stream order."""
    q = config["queries"]
    f = _flank(config)
    proteins = protein_corpus.queries(corpus, config,
                                      [(r - f) // 3 for r in rounds], rng)
    out = []
    for p in proteins:
        cds = back_translate(np.frombuffer(p, np.uint8), rng)
        t = np.concatenate([draw(_UTR, int(q["utr5"]), rng), cds,
                            draw(_UTR, int(q["utr3"]), rng)])
        minus = bool(rng.integers(0, 2))
        out.append(((revcomp(t) if minus else t).tobytes(), p, minus))
    return out


def queries(corpus: Corpus, config: dict, rounds: list[np.ndarray],
            rng: np.random.Generator) -> list[bytes]:
    return [t for t, _, _ in transcripts(corpus, config, rounds, rng)]
