"""One bacterial chromosome and gene records cut from it; queries are
windows of the chromosome, of the configured lengths, with a share of
their bases redrawn.

The chromosome has the configured length and GC share (E. coli K-12
MG1655, NCBI NC_000913.3: 4,641,652 bp, 50.8% GC), its bases drawn from
the seed.  Gene records are windows of it on either strand, their
lengths evenly spaced over the configured range in an order from the
seed (so every seed has the same residues in all).  chip_smoke.py's
``genome`` builds the same database.
"""

from __future__ import annotations

import numpy as np

from portbench.workload import Corpus, draw, letters_lut

_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMPLEMENT[_a] = _b


def revcomp(s: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[s[::-1]]


def _gc_lut(gc: float) -> np.ndarray:
    return letters_lut({"A": 1 - gc, "C": gc, "G": gc, "T": 1 - gc})


def build(db: dict, rng: np.random.Generator) -> Corpus:
    nbp = int(db["chromosome_bp"])
    chrom = draw(_gc_lut(float(db["gc"])), nbp, rng)
    n = int(db["genes"])
    glo, ghi = db["gene_length"]
    glen = (glo + (np.arange(n) + 0.5) / n * (ghi - glo + 1)).astype(
        np.int64)[rng.permutation(n)]
    gstart = (rng.random(n) * (nbp - glen)).astype(np.int64)
    strand = rng.integers(0, 2, size=n)
    parts = [chrom]
    headers = [b"chr synthetic chromosome of %d bp" % nbp]
    for i, (s, L, st) in enumerate(zip(gstart.tolist(), glen.tolist(),
                                       strand.tolist())):
        g = chrom[s:s + L]
        parts.append(revcomp(g) if st else g)
        headers.append(b"g%d gene at %d strand %d" % (i, s, st))
    lens = np.array([len(p) for p in parts], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return Corpus(np.concatenate(parts), starts, lens, headers, "nt")


def query_lengths(config: dict, lo: int, hi: int, pool: int) -> np.ndarray:
    """``pool`` lengths: the configured query lengths within [lo, hi],
    ascending, taken in turn."""
    got = sorted(L for L in config["queries"]["lengths"] if lo <= L <= hi)
    if not got:
        raise ValueError(f"no query length of {config['name']} in "
                         f"[{lo}, {hi}]")
    return np.resize(np.array(got, dtype=np.int64), pool)


def queries(corpus: Corpus, config: dict, rounds: list[np.ndarray],
            rng: np.random.Generator) -> list[bytes]:
    sub = float(config["queries"]["substitution"])
    chrom = corpus.record(0)
    out = []
    for targets in rounds:
        for L in targets.tolist():
            s = int(rng.integers(0, len(chrom) - L + 1))
            q = chrom[s:s + L].copy()
            if rng.integers(0, 2):
                q = revcomp(q)
            pos = np.flatnonzero(rng.random(L) < sub)
            q[pos] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, size=len(pos))]
            out.append(q.tobytes())
    return out
