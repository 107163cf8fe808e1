"""Hit management: top-K selection, thresholds, counters, align phase.

Functional re-design of the reference's mutex-guarded sorted-insertion list
(parity target: hits.cc:28-618).  Scores stream in as NumPy
batches from the TPU kernel; candidates at or above the initial threshold
are accumulated and the final top-K is selected with exactly the ordering
the reference's insertion loop produces:

* list order: score descending, then seqno descending (hits.cc:188-191 —
  an equal-score new entry moves above entries with a *smaller* seqno),
  then insertion order (qstrand, qframe, dstrand, dframe ascending) for
  exact (score, seqno) ties;
* ``totalhits`` counts entries at/above the initial threshold, ``obvious``
  counts entries above the upper threshold, and entries above the upper
  threshold are *excluded* from the list (hits.cc:168-180);
* keephits = max(descriptions, alignments), clamped to the theoretical
  maximum number of distinct hits for the mode (hits.cc:283-313).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .align import align as align_fn
from .stats import EvalueModel

__all__ = ["Hit", "HitList"]


def mode_multiplier(symtype: int, querystrands: int) -> int:
    """Max distinct hits per db sequence for the mode (hits.cc:287-311)."""
    if symtype == 0:
        return 2 if querystrands == 3 else 1
    if symtype == 2:
        return 6 if querystrands == 3 else 3
    if symtype == 3:
        return 6
    if symtype == 4:
        return 36 if querystrands == 3 else 18
    return 1


@dataclass
class Hit:
    seqno: int
    score: int
    qstrand: int
    qframe: int
    dstrand: int
    dframe: int
    header: str = ""
    deflines: list = None
    defline_objs: list = None
    dseq: np.ndarray | None = None
    dlen: int = 0
    dlennt: int = 0
    alignment: str = ""
    score_align: int = 0
    align_q_start: int = 0
    align_q_end: int = 0
    align_d_start: int = 0
    align_d_end: int = 0


class HitList:
    def __init__(self, descriptions: int, alignments: int, minscore: int,
                 maxscore: int, minexpect: float, expect: float,
                 evmodel: EvalueModel, db, symtype: int, querystrands: int,
                 engine=None):
        self.opt_descriptions = descriptions
        self.opt_alignments = alignments
        self.evmodel = evmodel
        self.db = db
        # the search's engine answers a hit's subject from the units it
        # holds (SearchEngine.subject); without one, the database does
        self.engine = engine
        self.symtype = symtype
        self.querystrands = querystrands

        keephits = max(descriptions, alignments)
        maxhits = db.seqcount_masked() * mode_multiplier(symtype, querystrands)
        self.keephits = min(keephits, maxhits)

        self.scorethreshold = minscore
        self.upperscorethreshold = maxscore
        if evmodel.available:
            mse = evmodel.min_score_for_expect(expect)
            if mse > self.scorethreshold:
                self.scorethreshold = mse
            if minexpect > 0.0:
                xse = evmodel.max_score_for_expect(minexpect)
                if xse < self.upperscorethreshold:
                    self.upperscorethreshold = xse
        self.init_threshold = self.scorethreshold

        self.totalhits = 0
        self.obvious = 0
        # candidate buffer: [n, 6] int64 blocks of (score, seqno, qstrand,
        # qframe, dstrand, dframe), compacted by _compact() — no
        # per-candidate Python objects on the hot path
        self._parts: list[np.ndarray] = []
        self._ncand = 0
        self.hits: list[Hit] = []

    # ---- search phase -------------------------------------------------------

    def enter_batch(self, seqnos: np.ndarray, scores: np.ndarray,
                    qstrand: int, qframe: int,
                    dstrands: np.ndarray, dframes: np.ndarray,
                    counts: tuple[int, int] | None = None) -> None:
        """Enter a batch of (seqno, score) results for one query frame.

        blastn minus-strand results are recorded as plus-query/minus-db,
        like the reference (swipe.cc:1468-1471).  ``counts`` supplies
        precomputed (totalhits, obvious) increments when ``scores`` is
        already a device-side top-K selection rather than the full batch.
        """
        seqnos = np.asarray(seqnos)
        scores = np.asarray(scores)
        if counts is None:
            self.obvious += int((scores > self.upperscorethreshold).sum())
            self.totalhits += int((scores >= self.init_threshold).sum())
        else:
            self.totalhits += int(counts[0])
            self.obvious += int(counts[1])
        if self.keephits == 0:
            # -v 0 -b 0 (accepted by the reference): counters only, no list
            return
        keep = (scores >= self.scorethreshold) & \
               (scores <= self.upperscorethreshold)
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return
        part = np.empty((len(idx), 6), dtype=np.int64)
        part[:, 0] = scores[idx]
        part[:, 1] = seqnos[idx]
        # exact (score, seqno) ties keep the reference's single-threaded
        # insertion order: qstrand, qframe, dstrand, dframe ascending
        # (the search loops of swipe.cc:1403-1596)
        if self.symtype == 0 and qstrand:
            part[:, 2] = 0
            part[:, 3] = 0
            part[:, 4] = 1
            part[:, 5] = 0
        else:
            part[:, 2] = qstrand
            part[:, 3] = qframe
            part[:, 4] = np.asarray(dstrands)[idx]
            part[:, 5] = np.asarray(dframes)[idx]
        self._parts.append(part)
        self._ncand += len(part)
        # bounded memory like the reference's rising dynamic threshold
        # (hits.cc:218-219): once the buffer is well past keephits, keep
        # only the winners and admit nothing below the kth score.  The
        # comparator is a total order, so truncation keeps exactly the
        # entries the final sort would.
        if self._ncand > max(4 * self.keephits, 4096):
            self._compact()
            if self.keephits and self._ncand == self.keephits:
                self.scorethreshold = max(self.scorethreshold,
                                          int(self._parts[0][-1, 0]))

    def _compact(self) -> None:
        """Sort the buffer by (score desc, seqno desc, qstrand, qframe,
        dstrand, dframe asc) and truncate to keephits."""
        if not self._parts:
            return
        cand = np.concatenate(self._parts, axis=0)
        order = np.lexsort((cand[:, 5], cand[:, 4], cand[:, 3], cand[:, 2],
                            -cand[:, 1], -cand[:, 0]))[: self.keephits]
        cand = cand[order]
        self._parts = [cand]
        self._ncand = len(cand)

    def finalize(self) -> None:
        """Select and order the kept hits (the reference's final list)."""
        self._compact()
        cand = self._parts[0] if self._parts else np.empty((0, 6), np.int64)
        self.hits = [
            Hit(seqno=int(c[1]), score=int(c[0]), qstrand=int(c[2]),
                qframe=int(c[3]), dstrand=int(c[4]), dframe=int(c[5]))
            for c in cand
        ]
        self._parts = []
        self._ncand = 0

    @property
    def count(self) -> int:
        return len(self.hits)

    @property
    def showhits(self) -> int:
        return min(self.count, self.opt_descriptions)

    @property
    def showalignments(self) -> int:
        return min(self.count, self.opt_alignments)

    # ---- align phase --------------------------------------------------------

    def _qseq(self, query, qstrand: int, qframe: int) -> np.ndarray:
        if self.symtype == 0:
            return query.nt[0]
        return query.aa[3 * qstrand + qframe]

    def _fetch_hit(self, i: int, h: Hit) -> None:
        """Headers/deflines for every kept hit; the sequence for shown
        ones (hits_align's fetch half, hits.cc:553-570)."""
        h.deflines = self.db.get_deflines(h.seqno)
        h.defline_objs = self.db.get_defline_objects(h.seqno)
        h.header = h.deflines[0] if h.deflines else ""
        if i >= self.opt_alignments:
            # not aligned, but displays may still need the sequence
            # length (-m 7 <len>); the reference prints stale memory
            # here — we report the true length (see report.show_xml)
            if self.engine is not None:
                h.dlen, h.dlennt = self.engine.subject_length(
                    h.seqno, h.dstrand, h.dframe)
            else:
                h.dlen, h.dlennt = self.db.get_length(
                    h.seqno, self.symtype, h.dstrand, h.dframe)
            return
        if self.engine is not None:
            dseq, ntlen = self.engine.subject(h.seqno, h.dstrand, h.dframe)
        else:
            dseq, ntlen = self.db.get_sequence(
                h.seqno, self.symtype, h.dstrand, h.dframe)
        h.dseq = dseq
        h.dlen = len(dseq)
        h.dlennt = ntlen

    @property
    def _hintable(self) -> bool:
        # blastn minus-strand-only quirk: the reference's align-phase
        # strand bins cover only qstrand=1 when -S 2
        # (swipe.cc:279 qstrand1 = querystrands==2 ? 1 : 0), but blastn
        # hits are recorded as plus-query/minus-db (swipe.cc:1468-1471),
        # so they never receive a hint and region()'s row-major tie
        # rule picks the alignment endpoint instead
        return not (self.symtype == 0 and self.querystrands == 2)

    def _align_hit(self, h: Hit, query, matrix, gapopen: int,
                   gapextend: int, hint) -> None:
        (h.score_align, h.align_q_start, h.align_d_start,
         h.align_q_end, h.align_d_end, h.alignment) = align_fn(
            self._qseq(query, h.qstrand, h.qframe), h.dseq, matrix,
            gapopen, gapextend, hint=hint)

    def align_prepare(self, query, scorelimit_16: int = 1 << 62,
                      seqnos: tuple[int, int] | None = None):
        """Phase 1 of the align phase: fetch headers/sequences for every
        kept hit and bin the shown hits needing an endpoint hint by
        (qstrand, qframe) — the reference's align_threads_init binning
        (swipe.cc:527-577).  Returns (shown, bins) where bins is a list
        of (qseq, [(i, hit)]); a multi-query batch concatenates all
        lists' bins into ONE device hint dispatch
        (ops.align_hint.hint_endpoints_grid).  ``seqnos`` = (lo, hi)
        takes only the hits of sequences in [lo, hi): a multi-host
        run's owned shard (parallel.multihost)."""
        shown = []
        for i, h in enumerate(self.hits):
            if seqnos is not None and not seqnos[0] <= h.seqno < seqnos[1]:
                continue
            self._fetch_hit(i, h)
            if i < self.opt_alignments:
                shown.append((i, h))
        bins = []
        if self._hintable:
            groups: dict[tuple[int, int], list] = {}
            for i, h in shown:
                if h.score < scorelimit_16:
                    groups.setdefault((h.qstrand, h.qframe),
                                      []).append((i, h))
            for (qs, qf), items in groups.items():
                bins.append((self._qseq(query, qs, qf), items))
        return shown, bins

    def align_finish(self, query, matrix: np.ndarray, gapopen: int,
                     gapextend: int, shown, hints,
                     threads: int = 1) -> None:
        """Phase 2: run the gapped tracebacks over ``threads`` workers
        (the -a flag; the native aligner releases the GIL during the C
        call), applying the precomputed endpoint hints."""
        def work(item):
            i, h = item
            self._align_hit(h, query, matrix, gapopen, gapextend,
                            hints.get(i))

        if threads > 1 and len(shown) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=threads) as ex:
                list(ex.map(work, shown))
        else:
            for item in shown:
                work(item)
