"""A protein database with UniProtKB/Swiss-Prot's statistics, and queries
that are mutated copies of its records.

Copied from the repository's ``bench_corpus.py`` (its constants; the
configuration file states them): residues drawn from the release
statistics' amino-acid composition, lengths from a log-normal fitted to
the published median (292) and mean (361), mu = ln 292, sigma =
sqrt(2 ln(361/292)), cut to [min, max].  Lengths are the model's
quantiles at (i + 1/2) / n in an order drawn from the seed, so every
seed gets the same lengths; the residues are drawn from the seed.  The
quantiles stop near 6,600 aa; the release's longest record (titin,
35,213 aa) takes the place of the last.

A query is a record whose length is nearest its target, with a share of
its residues redrawn; further mutated copies of it overwrite the start of
as many other records at least as long ("plants"), so each query has
true homologs.  chip_smoke.py's ``swissprot_fasta`` plants the same way.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri

from portbench.workload import Corpus, draw, letters_lut


def lengths(db: dict, n: int) -> np.ndarray:
    """The length model's quantiles at (i + 1/2) / n, ascending; where the
    configuration names the release's ``longest`` record, the last is
    that long."""
    m = db["length_model"]
    q = np.exp(m["mu"] + m["sigma"] * ndtri((np.arange(n) + 0.5) / n))
    q = np.clip(q.astype(np.int64), m["min"], m["max"])
    if "longest" in db:
        q[-1] = int(db["longest"])
    return q


def build(db: dict, rng: np.random.Generator) -> Corpus:
    n = int(db["sequences"])
    lens = lengths(db, n)[rng.permutation(n)]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = draw(letters_lut(db["composition"]), int(lens.sum()), rng)
    headers = [b"s%d seq %d" % (i, i) for i in range(n)]
    return Corpus(flat, starts, lens, headers, "aa")


def query_lengths(config: dict, lo: int, hi: int, pool: int) -> np.ndarray:
    """``pool`` lengths at evenly spaced quantiles of the database's length
    model between lo and hi."""
    m = config["database"]["length_model"]
    from scipy.special import ndtr
    a, b = (ndtr((np.log([max(lo, 1), hi + 1]) - m["mu"]) / m["sigma"]))
    p = a + (b - a) * (np.arange(pool) + 0.5) / pool
    return np.clip(np.exp(m["mu"] + m["sigma"] * ndtri(p)).astype(np.int64),
                   lo, hi)


def queries(corpus: Corpus, config: dict, rounds: list[np.ndarray],
            rng: np.random.Generator) -> list[bytes]:
    qc = config["queries"]
    lut = letters_lut(config["database"]["composition"])
    sub = float(qc["substitution"])
    lens = corpus.lens
    # records by length, each length's records in an order from the seed
    order = np.lexsort((rng.random(len(lens)), lens))
    by_len = {}
    for rec in order.tolist():
        by_len.setdefault(int(lens[rec]), []).append(rec)
    uniq = np.array(sorted(by_len), dtype=np.int64)
    used = np.zeros(len(lens), dtype=bool)

    def mutate(seq):
        seq = seq.copy()
        pos = np.flatnonzero(rng.random(len(seq)) < sub)
        seq[pos] = draw(lut, len(pos), rng)
        return seq

    def nearest(target):
        i = int(np.searchsorted(uniq, target))
        lo, hi = i - 1, i
        while lo >= 0 or hi < len(uniq):
            dlo = target - uniq[lo] if lo >= 0 else None
            dhi = uniq[hi] - target if hi < len(uniq) else None
            side = hi if dlo is None or (dhi is not None and dhi < dlo) \
                else lo
            recs = by_len[int(uniq[side])]
            while recs and used[recs[-1]]:
                recs.pop()
            if recs:
                return recs.pop()
            if side == hi:
                hi += 1
            else:
                lo -= 1
        raise ValueError("no record left for a query")

    tall = np.argsort(lens, kind="stable")
    out = []
    for targets in rounds:
        # records are taken in length order, so the lengths a round gets
        # do not depend on the order it is sent in
        got = {}
        for k in np.argsort(targets, kind="stable").tolist():
            rec = nearest(int(targets[k]))
            used[rec] = True
            got[k] = rec
        for k in range(len(targets)):
            src = got[k]
            q = mutate(corpus.record(src))
            L = len(q)
            hosts = tall[np.searchsorted(lens[tall], L):]
            hosts = hosts[~used[hosts]]
            for h in rng.choice(hosts, size=min(int(qc["plants"]),
                                                len(hosts)), replace=False):
                s = corpus.starts[h]
                corpus.flat[s:s + L] = mutate(q)
                used[h] = True
            out.append(q.tobytes())
    return out
