"""One bacterial chromosome that encodes proteins: open reading frames
(ORFs) placed end to end with intergenic gaps, on either strand; queries
are windows of the ORFs' proteins with a share of their residues
redrawn, so each query has one true reading frame on the chromosome.

The chromosome has the configured length and GC share (E. coli K-12
MG1655, NCBI NC_000913.3: 4,641,652 bp, 50.8% GC) and ``orfs`` ORFs
(Blattner et al. 1997: 4,288 protein-coding genes).  An ORF of n codons
is ATG, n - 1 sense codons and a stop.  A sense codon is drawn again
while it is a stop, so no stop lies in frame inside an ORF; since the
stops are AT-rich, the sense codons' bases are drawn at the GC share
that leaves the kept codons at the configured share (``coding_gc``).  ORF lengths, in codons before the stop, are the quantiles at
(i + 1/2) / n of a log-normal whose mean is ``orf_length.mean_aa`` and
whose log-spread is ``orf_length.sigma``, in an order from the seed, so
every seed has the same lengths; they must cover ``coding_share`` of the
chromosome (87.8%, Blattner et al.) within a percent.  The bases left
over are intergenic gaps, split among the ORFs' n + 1 gaps uniformly at
random, their bases drawn by the GC share.  Each ORF lies on either
strand at even odds.  The strand, the order, the gaps and every base
come from the seed.

``revcomp`` and the GC table are ``genome.py``'s (the blastn
configuration's chromosome model).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import ndtr, ndtri

from portbench.generators.genome import _gc_lut, revcomp
from portbench.reference.translate import translate
from portbench.workload import Corpus, draw, letters_lut

STOPS = (b"TAA", b"TAG", b"TGA")


@dataclass
class CodingCorpus(Corpus):
    """The chromosome as one record, and where its ORFs lie: [n, 3]
    int64 rows of (first base on the chromosome, codons before the
    stop, strand)."""

    orfs: np.ndarray = None


def _model(db: dict) -> tuple[float, float]:
    """(mu, sigma) of the ORF length log-normal, in codons."""
    m = db["orf_length"]
    sigma = float(m["sigma"])
    return float(np.log(m["mean_aa"])) - sigma * sigma / 2, sigma


def orf_lengths(db: dict) -> np.ndarray:
    """Codons before the stop of each ORF, ascending: the model's
    quantiles at (i + 1/2) / n, at least 2 (ATG and one sense codon)."""
    n = int(db["orfs"])
    mu, sigma = _model(db)
    q = np.exp(mu + sigma * ndtri((np.arange(n) + 0.5) / n))
    return np.maximum(q.astype(np.int64), 2)


def _is_stop(codons: np.ndarray) -> np.ndarray:
    """[n] bool of [n, 3] uint8 codons."""
    out = np.zeros(len(codons), dtype=bool)
    for s in STOPS:
        out |= (codons == np.frombuffer(s, np.uint8)).all(axis=1)
    return out


def _sense_codons(n: int, lut: np.ndarray, rng) -> np.ndarray:
    """[n, 3] codons, each base drawn from ``lut``, a stop drawn again."""
    codons = draw(lut, 3 * n, rng).reshape(n, 3)
    bad = np.flatnonzero(_is_stop(codons))
    while len(bad):
        codons[bad] = draw(lut, 3 * len(bad), rng).reshape(len(bad), 3)
        bad = bad[_is_stop(codons[bad])]
    return codons


def coding_gc(gc: float) -> float:
    """The GC share to draw codon bases at so that the codons that are no
    stop hold ``gc`` of G and C (bisection; a codon's G + C count and the
    stops' odds are polynomials in the share)."""
    def kept(p):
        a, g = (1 - p) / 2, p / 2
        stop = a ** 3 + 2 * a * a * g          # TAA, TAG, TGA
        return (3 * p - 2 * a * a * g) / (3 * (1 - stop))

    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if kept(mid) < gc else (lo, mid)
    return (lo + hi) / 2


def _stop_codons(n: int, gc: float, rng) -> np.ndarray:
    """[n, 3] stops, each as likely as its bases are under the GC
    share."""
    p = {ord("A"): (1 - gc) / 2, ord("T"): (1 - gc) / 2, ord("G"): gc / 2}
    w = np.array([np.prod([p[b] for b in s]) for s in STOPS])
    pick = rng.choice(len(STOPS), size=n, p=w / w.sum())
    table = np.frombuffer(b"".join(STOPS), np.uint8).reshape(3, 3)
    return table[pick]


def build(db: dict, rng: np.random.Generator) -> CodingCorpus:
    nbp = int(db["chromosome_bp"])
    gc = float(db["gc"])
    lut = _gc_lut(gc)
    codon_lut = _gc_lut(coding_gc(gc))
    lens = orf_lengths(db)[rng.permutation(int(db["orfs"]))]
    n = len(lens)
    coding = int((3 * lens + 3).sum())
    share = coding / nbp
    if coding > nbp or abs(share - float(db["coding_share"])) > 0.01:
        raise ValueError(f"ORFs of {coding} bp cover {share:.4f} of "
                         f"{nbp} bp, not {db['coding_share']}")
    strand = rng.integers(0, 2, size=n)
    # the intergenic bases split uniformly among the n + 1 gaps
    cuts = np.sort(rng.integers(0, nbp - coding + 1, size=n))
    gaps = np.diff(np.concatenate([[0], cuts, [nbp - coding]]))
    sense = _sense_codons(int((lens - 1).sum()), codon_lut, rng)
    stops = _stop_codons(n, gc, rng)
    atg = np.frombuffer(b"ATG", np.uint8)
    intergenic = draw(lut, nbp - coding, rng)
    parts, orfs = [], np.zeros((n, 3), dtype=np.int64)
    pos = gpos = spos = 0
    for i, (L, st) in enumerate(zip(lens.tolist(), strand.tolist())):
        g = int(gaps[i])
        parts.append(intergenic[gpos:gpos + g])
        gpos += g
        pos += g
        orf = np.concatenate([atg, sense[spos:spos + L - 1].ravel(),
                              stops[i]])
        spos += L - 1
        parts.append(revcomp(orf) if st else orf)
        orfs[i] = (pos, L, st)
        pos += len(orf)
    parts.append(intergenic[gpos:])
    chrom = np.concatenate(parts)
    assert len(chrom) == nbp
    header = b"chr synthetic chromosome of %d bp, %d ORFs" % (nbp, n)
    return CodingCorpus(chrom, np.zeros(1, np.int64),
                        np.array([nbp], np.int64), [header], "nt", orfs)


def query_lengths(config: dict, lo: int, hi: int, pool: int) -> np.ndarray:
    """``pool`` lengths at evenly spaced quantiles of the ORF length model
    between lo and hi."""
    mu, sigma = _model(config["database"])
    a, b = ndtr((np.log([max(lo, 1), hi + 1]) - mu) / sigma)
    p = a + (b - a) * (np.arange(pool) + 0.5) / pool
    return np.clip(np.exp(mu + sigma * ndtri(p)).astype(np.int64), lo, hi)


def orf_protein(corpus: CodingCorpus, i: int) -> np.ndarray:
    """ASCII amino acids of ORF ``i``, its stop left out."""
    start, L, st = corpus.orfs[i].tolist()
    nt = corpus.record(0)[start:start + 3 * L + 3]
    return translate(nt, st, 0)[:L]


def queries(corpus: CodingCorpus, config: dict, rounds: list[np.ndarray],
            rng: np.random.Generator) -> list[bytes]:
    """For each target length L, a window of L codons of an ORF of at
    least L codons, both drawn from the seed, translated, with the
    configured share of its residues redrawn by the configured amino-acid
    composition."""
    qc = config["queries"]
    lut = letters_lut(qc["composition"])
    sub = float(qc["substitution"])
    codons = corpus.orfs[:, 1]
    out = []
    for targets in rounds:
        for L in targets.tolist():
            fits = np.flatnonzero(codons >= L)
            if not len(fits):
                raise ValueError(f"no ORF of {L} codons or more")
            i = int(fits[rng.integers(0, len(fits))])
            s = int(rng.integers(0, int(codons[i]) - L + 1))
            q = orf_protein(corpus, i)[s:s + L].copy()
            pos = np.flatnonzero(rng.random(L) < sub)
            q[pos] = draw(lut, len(pos), rng)
            out.append(q.tobytes())
    return out
