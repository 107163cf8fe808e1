"""The comparison that decides ``correct``: what the timed path returned for
a sample of the window's queries, judged against the plain reference.

Numbers compared, each with the limit its configuration file states:

* ``lists_wrong``: sampled queries whose hit list (sequence number,
  key, raw score, in order) differs from the reference's; the key tells
  a record's hits apart by their strands and reading frames (the mode
  module's ``hit_key``);
* ``alignments_wrong``: shown alignments that do not re-walk, over the
  inputs (the frames that the key names, in a translated mode), from
  their reported start to their reported end with the reference's best
  score of that sequence and key (or whose reported score is not it);
* ``evalue_gap``: the largest relative gap between a hit's E-value as the
  program gives it and the reference's E-value at that list position;
* ``requests_failed``: requests of the window that raised.
"""

from __future__ import annotations

import numpy as np

from portbench import workload
from portbench.reference import search, sw

# subjects longer than this are scored as overlapped pieces
PIECE = 4096
# queries share a pass of the scan while the longest is at most this
# many times the shortest (a shorter one is padded to the longest)
SPREAD = 1.5


def _groups(lengths: list[int], spread: float) -> list[list[int]]:
    """Indices grouped by length: runs of the sorted lengths whose longest
    is at most ``spread`` times their shortest."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    groups: list[list[int]] = []
    for i in order:
        if groups and lengths[i] <= spread * lengths[groups[-1][0]]:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


class Reference:
    """The reference's view of one configuration's database, through the
    mode module of its ``symtype`` (``modes/``)."""

    def __init__(self, config: dict, corpus, device):
        self.config = config
        self.corpus = corpus
        self.mode = workload.load_mode(config)
        self.letters, self.matrix = self.mode.scoring(config)
        flat, starts, lens, self.unit_seqno, self.unit_key = \
            self.mode.units(corpus, config)
        self.subjects = sw.Subjects(sw.encode(self.letters, flat), starts,
                                    lens, device)

    def encode(self, seq) -> np.ndarray:
        return sw.encode(self.letters, np.asarray(seq, dtype=np.uint8))

    def rows(self, query: bytes):
        """[(row key, letters)] of the query's rows."""
        return self.mode.query_rows(np.frombuffer(query, dtype=np.uint8),
                                    self.config)

    def scores(self, queries: list[bytes], saturate: int | None = None
               ) -> list[np.ndarray]:
        """Per query, [row, subject] best local scores (rows as
        ``rows`` gives them).  Rows whose lengths lie within SPREAD of
        each other share one pass of the scan."""
        c = self.config
        rows, owner = [], []
        for k, query in enumerate(queries):
            for _, r in self.rows(query):
                rows.append(self.encode(r))
                owner.append(k)
        best = [None] * len(rows)
        for group in _groups([len(r) for r in rows], SPREAD):
            got = sw.sw_scan([rows[i] for i in group], self.subjects,
                             self.matrix, c["gapopen"], c["gapextend"],
                             saturate=saturate, piece=PIECE)
            for i, g in zip(group, got):
                best[i] = g
        return [np.stack([b for b, o in zip(best, owner) if o == k])
                for k in range(len(queries))]

    def statistics(self, query: bytes) -> search.Statistics:
        return search.Statistics(self.config["statistics"],
                                 *self.mode.stat_lengths(query,
                                                         self.corpus))

    def keys(self, query: bytes, units=slice(None)) -> np.ndarray:
        """[row, subject] key of each pair's hit."""
        rs = np.array([k for k, _ in self.rows(query)], dtype=np.int64)
        return self.mode.hit_strand(rs[:, None],
                                    self.unit_key[units][None, :])

    def hits(self, query: bytes, scores: np.ndarray):
        """(reference hit list, its statistics) from [row, subject]
        scores."""
        c = self.config
        stats = self.statistics(query)
        thr = max(int(c["minscore"]), stats.min_score(float(c["expect"])))
        keep = min(max(c["descriptions"], c["alignments"]), scores.size)
        key = np.broadcast_to(self.keys(query), scores.shape)
        seqno = np.broadcast_to(self.unit_seqno, scores.shape)
        return search.hit_list(scores.ravel(), key.ravel(),
                               seqno.ravel(), thr, keep), stats

    def best(self, query: bytes, scores: np.ndarray, seqno: int,
             key: int) -> int:
        """The reference's best score of one record's hit with ``key``."""
        u = np.flatnonzero(self.unit_seqno == seqno)
        sel = scores[:, u][self.keys(query, u) == key]
        return int(sel.max()) if sel.size else 0


def judge(ref: Reference, sample, aligned: bool = True) -> dict:
    """Numbers of the comparison over ``sample``: [(query letters, hit
    list)], each hit list with ``hits`` (seqno, strands and frames, score
    and, for the first -b, alignment and coordinates; or ``Keyed``) and
    ``evalue(score)``."""
    c = ref.config
    lists_wrong = alignments_wrong = 0
    gap = 0.0
    every = ref.scores([q for q, _ in sample])
    for (query, got), scores in zip(sample, every):
        want, stats = ref.hits(query, scores)
        have = [(h.seqno, h.key if isinstance(h, Keyed) else
                 ref.mode.hit_key(h), h.score) for h in got.hits]
        lists_wrong += have != want
        for (_, _, sp), (_, _, sr) in zip(have, want):
            ep, er = got.evalue(sp), stats.evalue(sr)
            if ep != er:
                # E-values of strong hits underflow to 0 on both sides;
                # the cap keeps the number finite in JSON
                gap = max(gap, min(abs(ep - er) / max(er, 1e-300), 1e300))
        if not aligned:
            continue
        q0 = np.frombuffer(query, np.uint8)
        for h in got.hits[:c["alignments"]]:
            key = ref.mode.hit_key(h)
            best = ref.best(query, scores, h.seqno, key)
            q, d = ref.mode.walk_pair(q0, ref.corpus.record(h.seqno), key)
            q, d = ref.encode(q), ref.encode(d)
            walked = search.walk(h.alignment, q, d, h.align_q_start,
                                 h.align_d_start, ref.matrix, c["gapopen"],
                                 c["gapextend"])
            alignments_wrong += walked is None or h.score_align != best \
                or walked != (best, h.align_q_end, h.align_d_end)
    return {"lists_wrong": lists_wrong, "alignments_wrong": alignments_wrong,
            "evalue_gap": gap}


class Keyed:
    """A hit of the reference's own list, by its key."""

    def __init__(self, seqno: int, key: int, score: int):
        self.seqno, self.key, self.score = seqno, key, score


class ControlList:
    """A hit list made by the reference at a lower precision, from scores
    whose every cell saturated at CEILING (``Reference.scores(queries,
    CEILING)``), as in SWIPE's first 8-bit pass before it rescores the
    saturated sequences."""

    CEILING = 127

    def __init__(self, ref: Reference, query: bytes, scores: np.ndarray):
        want, self._stats = ref.hits(query, scores)
        self.hits = [Keyed(*h) for h in want]

    def evalue(self, score: int) -> float:
        return self._stats.evalue(score)


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
