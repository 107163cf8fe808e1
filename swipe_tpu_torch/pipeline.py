"""Search pipeline: pack -> score on the card -> top-K -> hits -> align.

Port of ``swipe_tpu/pipeline.py`` for the stream backend.  The host
decisions are the JAX engine's, so the same packs and the same hits come
out: the lane counts of STREAM_CONFIGS, qlen_bucket, SLOT_BATCH with
power-of-two slot padding, the 8192-column chunks and the 65,536-column
giant threshold, the flow heuristic, the giant routing, the device cache
budget, the reversed tie order of the top-K, the init/upper thresholds
and kbase, and the cascade counters.

Database units up to the giant threshold take one of three routes, per
slot group one walk over chunks cached on the device and one
device-to-host copy feeding hit entry:

* the plain lane pack (pack_stream): each chunk's scores (K2, which
  looks scores up in the matrix), then each sequence's score gathered
  and reduced to the top K with torch ops;
* the flow series (pack_stream_flow), for heavy length tails over small
  databases: each chunk's scores on the carry kernel's flow form (K3,
  which looks scores up in the matrix), each lane's DP state gathered
  across lanes between chunks;
* queries over 1024 rows (the "long" groups: qlen_pad rounded to 512,
  1024 lanes, SLOT_BATCH_LONG slots) take the plain pack at
  LONG_MAX_COLS columns, whatever the flow heuristic says, scored in
  512-row tile passes (K5) that look scores up in the matrix (no K1).

Chromosome-scale units follow, per slot group, on one of three giant
routes: overlapped pieces on K2 (segmented), the anti-diagonal
wavefront kernel (K7) for a few giants whose pieces would be too long,
or the carry series (pack_stream_carry) on K3.  Long groups always take
the carry series, in tile passes (K6).  The align phase's endpoint
hints run the hint kernel (K4) through
ops.align_hint.hint_endpoints_grid.

The segment-packed route (the JAX engine's _search_segments) serves
``backend="pallas"`` (the query-tiled kernel K8), ``"pallas_v1"`` (the
untiled K9) and every score matrix outside int8 whatever the backend
(K9 on an int32 profile, as the JAX engine's lax twin): the units up to
the giant threshold are packed by pack_database at 512 lanes, all slots
score at once, one kernel call a chunk, and the giants follow on the
carry series (K3, int32 matrix when wide) at any query length.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import trace
from .alphabet import revcompl
from .batching import (PAD_SYMBOL, StreamChunk, pack_database, pack_stream,
                       pack_stream_carry, pack_stream_flow, round_up)
from .hits import HitList
from .io.db import Database
from .io.fasta import Query
from .matrices import ScoreMatrix
from .stats import EvalueModel

__all__ = ["SearchEngine", "SearchParams", "SearchTimings", "chunk_reduce",
           "resolve_device", "reverse_tie_order"]


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU.  With
    no card and no explicit "cpu" this raises; the port never drops to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("swipe_tpu_torch runs on a CUDA device; none is "
                           "available (pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def reverse_tie_order(meta: np.ndarray) -> np.ndarray:
    """Column order for the device-side top-K: units must ascend in the
    REVERSE of the hit list's tie preference (score desc, seqno desc,
    dstrand asc, dframe asc — hits.finalize), because the top-K prefers
    the highest column on ties.  ``meta`` is [n, 3] rows of (seqno,
    dstrand, dframe)."""
    return np.lexsort((-meta[:, 2], -meta[:, 1], meta[:, 0]))


def chunk_reduce(sc: torch.Tensor, init_thr: torch.Tensor,
                 upper: torch.Tensor, k: int, sl7: int, sl16: int):
    """Per-chunk hit reduction on the device: top-K candidates and the
    counters of one [NQ, n] score block.

    Scores above the per-slot upper cutoff (-u / -k) count in ``obvious``
    and are masked to -1 (callers drop them), so the top-K stays exact.
    Candidates are ordered by (score desc, column desc) — the JAX
    engine's reversed lax.top_k.  torch.topk promises no order among
    ties, so the order is made explicit: each entry's key is
    (score << 32) | column, unique per row.  With k >= n every column is
    kept in its own order.  Returns (vals, idx, totalh, obvious, n16,
    n63); idx holds columns of ``sc``."""
    totalh = (sc >= init_thr[:, None]).sum(dim=1, dtype=torch.int32)
    obvious = (sc > upper[:, None]).sum(dim=1, dtype=torch.int32)
    n16 = (sc >= sl7).sum(dtype=torch.int32)
    n63 = (sc >= sl16).sum(dtype=torch.int32)
    sc = torch.where(sc > upper[:, None], -1, sc)
    n = sc.shape[1]
    col = torch.arange(n, dtype=torch.int64, device=sc.device)
    if k < n:
        key = torch.topk((sc.to(torch.int64) << 32) | col, k, dim=1).values
        vals = (key >> 32).to(torch.int32)
        idx = key & 0xFFFFFFFF
    else:
        vals = sc
        idx = col.expand(sc.shape[0], n)
    return vals, idx, totalh, obvious, n16, n63


@dataclass
class SearchParams:
    symtype: int = 1
    querystrands: int = 3
    matrixname: str = "BLOSUM62"
    matchscore: int = 1
    mismatchscore: int = -3
    gapopen: int = 11
    gapextend: int = 1
    descriptions: int = 250   # -v
    alignments: int = 100     # -b
    minscore: int = 1         # -c
    maxscore: int = 2**63 - 1  # -u
    expect: float = 10.0      # -e
    minexpect: float = 0.0    # -k
    effdbsize: int = 0        # -z
    query_gencode: int = 1
    db_gencode: int = 1
    threads: int = 1          # -a: align-phase worker pool width

    @property
    def gapopenextend(self) -> int:
        return self.gapopen + self.gapextend


@dataclass
class SearchTimings:
    """GCUPS meter (parity: clock_start/clock_stop swipe.cc:1716-1790)."""

    start: float = 0.0
    elapsed: float = 0.0
    speed: float = 0.0
    starttime: str = ""
    endtime: str = ""
    # precision-cascade counters (compute*/rounds*, swipe.cc:111-119)
    compute: dict = field(default_factory=lambda: {7: 0, 16: 0, 32: 0, 63: 0})
    rounds: dict = field(default_factory=lambda: {7: 0, 16: 0, 32: 0, 63: 0})

    def begin(self):
        self.start = time.time()
        self.starttime = time.strftime(
            "%a, %e %b %Y %H:%M:%S UTC", time.gmtime(self.start))

    @staticmethod
    def _work_multiplier(query, symtype: int, querystrands: int) -> float:
        """Per-query cell multiplier of the GCUPS formula
        (clock_stop, swipe.cc:1744-1775)."""
        if symtype == 0:
            w = len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        if symtype in (1, 5):
            return len(query.aa[0])
        if symtype == 2:
            w = len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        if symtype == 3:
            return 2 * len(query.aa[0])
        if symtype == 4:
            w = 2 * len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        return 0

    def end_batch(self, db_symcount: int, queries, symtype: int,
                  querystrands: int):
        now = time.time()
        self.endtime = time.strftime(
            "%a, %e %b %Y %H:%M:%S UTC", time.gmtime(now))
        self.elapsed = now - self.start
        speed = float(db_symcount) * sum(
            self._work_multiplier(q, symtype, querystrands)
            for q in queries)
        self.speed = speed / self.elapsed if self.elapsed > 0 else 0.0


class SearchEngine:
    """Holds the lane-packed database on the device and runs queries
    against it."""

    # (lanes, query-row cap): the JAX engine's configurations, kept so
    # both packages pack and group identically
    STREAM_CONFIGS = ((2048, 512), (1024, 1024))
    # queries over the last config's row cap are "long"
    ROW_CAP = STREAM_CONFIGS[-1][1]
    # packed chunks stay on the device up to this budget; larger
    # databases upload per search
    DEVICE_CACHE_BYTES = 8 << 30
    # slots scored per kernel pass: bounds the [nslots, nblocks, nseqs]
    # per-block dump and the row-state scratch
    SLOT_BATCH = 16
    # long groups (queries over ROW_CAP rows): slots per
    # pass, tile rows, lanes, and the plain pack's chunk height (their
    # boundary planes cost 8 bytes per chunk cell and slot)
    SLOT_BATCH_LONG = 4
    LONG_TILE_ROWS = 512
    LONG_NSEQS = 1024
    LONG_MAX_COLS = 16384
    # flow-route heuristic (JAX engine _flow_cols): heavy length tails
    # over small databases take the flow series instead of the plain pack
    FLOW_TAIL_RATIO = 1.25
    FLOW_MIN_AVG_LANE = 512
    # giant routing: overlapped segmentation when the positive-score span
    # allows it, else the wavefront kernel for at most this many giants,
    # else the carry series (tests pin routes with these two)
    WAVEFRONT_MAX_GIANTS = 64
    SEGMENT_GIANTS = True
    # scoring backends: the stream route, or the segment-packed route on
    # the query-tiled (pallas) or untiled (pallas_v1) kernel
    BACKENDS = ("stream", "pallas", "pallas_v1")

    def __init__(self, db: Database, params: SearchParams, *, device=None,
                 nseqs: int | None = None, max_cols: int | None = None,
                 backend: str = "stream"):
        self.db = db
        self.params = params
        self.device = resolve_device(device)
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of "
                             f"{self.BACKENDS}")
        self.backend = backend
        self.matrix = self._build_matrix()
        stream = backend == "stream"
        # only the segment route scores matrices outside int8
        self._segment_route = not stream or not self.matrix.fits_int8
        self._forced_nseqs = None
        if stream:
            valid = tuple(n for n, _ in self.STREAM_CONFIGS)
            if nseqs is None:
                nseqs = valid[0]
            elif nseqs not in valid:
                raise ValueError(
                    f"stream lane counts are {valid}, got {nseqs}")
            else:
                self._forced_nseqs = nseqs
        elif nseqs is None:
            nseqs = 512
        # the segment pack's (lanes, chunk height): the engine's for the
        # segment backends, 512 x 16,384 for a wide matrix on the stream
        # backend (the JAX engine's _segment_chunks)
        self._seg_shape = (512, 16384) if stream else \
            (nseqs, max_cols or 16384)
        if max_cols is None:
            # stream: 2048 lanes x 8192 columns = 16 MB per chunk (the JAX
            # engine's); units up to 65536 columns stay in the plain pack
            # as oversized chunks.  The segment backends' giants are units
            # over a chunk's height
            max_cols = 8192 if stream else 16384
            self._giant_cols = 65536 if stream else max_cols
        else:
            self._giant_cols = max_cols
        self._max_cols = max_cols
        self._pack(nseqs)

    def _build_matrix(self) -> ScoreMatrix:
        p = self.params
        if p.symtype == 0:
            return ScoreMatrix.nucleotide(p.matchscore, p.mismatchscore,
                                          p.gapopen, p.gapextend)
        return ScoreMatrix.from_name_or_file(
            p.matrixname, p.gapopen, p.gapextend, symtype=p.symtype)

    def _pack(self, nseqs: int) -> None:
        with trace.span("setup.units"):
            units = list(self.db.search_units(self.params.symtype))
        self._unit_seqs = [u.codes for u in units]
        self.unit_meta = np.array(
            [(u.seqno, u.dstrand, u.dframe) for u in units], dtype=np.int64
        ).reshape(len(units), 3)
        # units longer than the giant threshold would stretch a whole
        # pack to nseqs x their length; they take the giant routes
        lens = np.array([len(s) for s in self._unit_seqs], dtype=np.int64)
        self._giant_ids = np.nonzero(lens > self._giant_cols)[0].astype(
            np.int64)
        self._normal_ids = np.nonzero(lens <= self._giant_cols)[0].astype(
            np.int64)
        self._giant_seqs = [self._unit_seqs[i] for i in self._giant_ids]
        self._norm_lens = lens[self._normal_ids]
        # a giant's minus strand, made for the align phase at its first hit
        self._derived: dict[int, np.ndarray] = {}
        # plain packs and their device copies by (lanes, chunk height)
        self._stream_packs: dict[tuple, list] = {}
        self._dev_stream: dict[tuple, list] = {}
        self._flow_packs: dict[int, list] = {}
        self._dev_flow: dict[int, list] = {}
        self._carry_packs: dict[int, list] = {}
        self._seg_packs: dict[tuple, tuple] = {}
        self._dev_seg: dict[tuple, list] = {}
        self._seg_chunks = None
        self._dev_segpack: dict[int, list] = {}
        # the giants' one device copy for the wavefront route
        self._dev_giants = None
        if self._segment_route:
            # the segment route reads only its own pack
            self.chunks = self._segment_chunks()
        else:
            # flow-routed databases never touch the plain lane pack
            self.chunks = None if self._flow_cols(nseqs) is not None \
                else self._stream_chunks(nseqs)

    @property
    def unit_count(self) -> int:
        """Number of (seqno, strand, frame) scoring units in the database."""
        return len(self.unit_meta)

    def _flow_cols(self, nseqs: int) -> int | None:
        """Full-chunk height for the flow route, or None to keep the
        plain lane pack (the JAX engine's heuristic, over the units up to
        the giant threshold)."""
        if self._norm_lens.size == 0:
            return None
        total = int(self._norm_lens.sum())
        longest = int(self._norm_lens.max())
        avg_lane = total / nseqs
        if avg_lane < self.FLOW_MIN_AVG_LANE \
                or longest <= self.FLOW_TAIL_RATIO * avg_lane:
            return None
        mc = (int(avg_lane) // 2 + 64) // 128 * 128
        return min(max(mc, 256), self._max_cols)

    def _stream_chunks(self, nseqs: int, max_cols: int | None = None):
        """Lane-packed chunks at a lane count and chunk height (built
        once; giants excluded)."""
        key = (nseqs, max_cols or self._max_cols)
        if key not in self._stream_packs:
            seqs = [self._unit_seqs[i] for i in self._normal_ids]
            with trace.span("setup.pack", route="stream", lanes=key[0],
                            cols=key[1]):
                self._stream_packs[key] = pack_stream(
                    seqs, nseqs=key[0], max_cols=key[1],
                    seqnos=self._normal_ids)
        return self._stream_packs[key]

    def _flow_chunks(self, nseqs: int):
        """Flow-series chunks at a lane count (built once)."""
        if nseqs not in self._flow_packs:
            seqs = [self._unit_seqs[i] for i in self._normal_ids]
            cols = self._flow_cols(nseqs)
            with trace.span("setup.pack", route="flow", lanes=nseqs,
                            cols=cols):
                self._flow_packs[nseqs] = pack_stream_flow(
                    seqs, nseqs=nseqs, max_cols=cols, drain_cols=128,
                    seqnos=self._normal_ids)
        return self._flow_packs[nseqs]

    def _segment_chunks(self):
        """Segment-packed chunks of the units up to the giant threshold
        (built once)."""
        if self._seg_chunks is None:
            nseqs, max_cols = self._seg_shape
            seqs = [self._unit_seqs[i] for i in self._normal_ids]
            with trace.span("setup.pack", route="segment", lanes=nseqs,
                            cols=max_cols):
                self._seg_chunks = pack_database(
                    seqs, nseqs=nseqs, max_cols=max_cols,
                    seqnos=self._normal_ids)
        return self._seg_chunks

    def _carry_chunks(self, nseqs: int):
        """Carry-series chunks of the giant units (built once): each lane
        streams whole giants through chunks of at most max_cols columns,
        with H/E/S carried between them."""
        if nseqs not in self._carry_packs:
            with trace.span("setup.pack", route="carry", lanes=nseqs,
                            cols=self._max_cols):
                self._carry_packs[nseqs] = pack_stream_carry(
                    self._giant_seqs, nseqs=nseqs, max_cols=self._max_cols,
                    seqnos=self._giant_ids)
        return self._carry_packs[nseqs]

    def query_frames(self, query: Query) -> list[tuple[int, int, np.ndarray]]:
        return query.frames()

    def search(self, query: Query, timings: SearchTimings | None = None
               ) -> HitList:
        """Run the full search+align pipeline for one query."""
        return self.search_batch([query], timings)[0]

    def search_batch(self, queries: list[Query],
                     timings: SearchTimings | None = None) -> list[HitList]:
        """Search a batch of queries, one kernel pass per db chunk and
        slot group; returns one finalized and aligned HitList per query,
        in order."""
        with trace.request(queries=len(queries)):
            hitlists = self._hitlists(queries)
            # flat (hitlist, qstrand, qframe, codes) slots across the batch
            slots = []
            for query, hits in zip(queries, hitlists):
                for qstrand, qframe, codes in self.query_frames(query):
                    slots.append((hits, qstrand, qframe, codes))
            if slots:
                with trace.span("scoring", slots=len(slots)):
                    self._scoring_phase(queries, slots, timings)
            with trace.span("finalize"):
                for hits in hitlists:
                    hits.finalize()
            self._align_phase(queries, hitlists)
        return hitlists

    def _scoring_phase(self, queries, slots, timings) -> None:
        """Score every slot and enter the hits, between the GCUPS meter's
        begin and end_batch."""
        p = self.params
        if timings is not None:
            timings.begin()
        if self._segment_route:
            self._search_segments(slots, timings)
        else:
            for (qlen_pad, nseqs, long), group in self._slot_groups(slots):
                # a tail group pads to its own power of two
                step = self.SLOT_BATCH_LONG if long else self.SLOT_BATCH
                for i in range(0, len(group), step):
                    self._search_stream_group(group[i:i + step], qlen_pad,
                                              nseqs, timings, long)
        if timings is not None:
            timings.end_batch(self.db.symcount_masked(), queries,
                              p.symtype, p.querystrands)

    def _hitlists(self, queries: list[Query]) -> list[HitList]:
        """One empty HitList per query, with its E-value model."""
        p = self.params
        hitlists = []
        for query in queries:
            evmodel = EvalueModel(
                p.symtype, query.length, self.db.seqcount_masked(),
                self.db.symcount_masked(),
                matrixname=p.matrixname if p.symtype != 0 else None,
                matchscore=p.matchscore, mismatchscore=p.mismatchscore,
                gapopen=p.gapopen, gapextend=p.gapextend,
                effdbsize=p.effdbsize)
            hitlists.append(
                HitList(p.descriptions, p.alignments, p.minscore,
                        p.maxscore, p.minexpect, p.expect, evmodel, self.db,
                        p.symtype, p.querystrands, engine=self))
        return hitlists

    def _held_unit(self, u: int) -> np.ndarray | None:
        """The codes of unit ``u`` as the engine holds them."""
        return self._unit_seqs[u]

    def _held(self, seqno: int, dstrand: int, dframe: int):
        """(unit, its held codes) that a hit on (seqno, dstrand, dframe)
        of a nucleotide database reads, or None where the engine holds
        no such unit (a record check_inclusion dropped).  A blastn hit's
        minus strand reads its plus strand's unit.  unit_meta is sorted
        by (seqno, dstrand, dframe), as search_units yields the units."""
        translated = self.params.symtype in (3, 4)
        um = self.unit_meta
        u = int(np.searchsorted(um[:, 0], seqno))
        if translated:
            u += 3 * dstrand + dframe
        if u >= len(um) or um[u, 0] != seqno or (
                translated and (um[u, 1], um[u, 2]) != (dstrand, dframe)):
            return None
        held = self._held_unit(u)
        return None if held is None else (u, held)

    def subject(self, seqno: int, dstrand: int, dframe: int
                ) -> tuple[np.ndarray, int]:
        """A hit's subject codes in its orientation and the record's
        nucleotide length, as ``db.get_sequence`` gives them, read-only.

        A nucleotide database's held unit answers as it is (every frame
        of tblastn and tblastx, every blastn plus strand); a giant's
        minus strand is made from its plus strand's unit at its first hit
        and kept for the engine's life; anything else, and every protein
        database, reads the database."""
        p = self.params
        if p.symtype not in (0, 3, 4):
            return self.db.get_sequence(seqno, p.symtype, dstrand, dframe)
        got = self._held(seqno, dstrand, dframe)
        minus = p.symtype == 0 and dstrand
        if got is None or (minus and got[0] not in self._giant_ids):
            trace.count("align.subject.db")
            return self.db.get_sequence(seqno, p.symtype, dstrand, dframe)
        u, codes = got
        if minus:
            if u not in self._derived:
                self._derived[u] = revcompl(codes)
                trace.count("align.subject.derived")
            codes = self._derived[u]
        trace.count("align.subject.held")
        view = codes.view()
        view.flags.writeable = False
        return view, self._ntlen(seqno, codes)

    def subject_length(self, seqno: int, dstrand: int, dframe: int
                       ) -> tuple[int, int]:
        """(subject length, nucleotide length) of a hit, as
        ``db.get_length`` gives them, from a held unit where there is
        one."""
        p = self.params
        got = self._held(seqno, dstrand, dframe) \
            if p.symtype in (0, 3, 4) else None
        if got is None:
            return self.db.get_length(seqno, p.symtype, dstrand, dframe)
        return len(got[1]), self._ntlen(seqno, got[1])

    def _ntlen(self, seqno: int, codes: np.ndarray) -> int:
        """A record's nucleotide length: its blastn unit's, or for a
        frame, what symtype 0 reads without translating."""
        if self.params.symtype == 0:
            return len(codes)
        return self.db.get_length(seqno, 0)[1]

    def _align_phase(self, queries, hitlists, seqnos=None):
        """Fetch and align the finalized hit lists' hits (all, or with
        ``seqnos`` = (lo, hi) those of sequences in [lo, hi)): the hint
        pass runs across the whole batch, all (query, qstrand, qframe)
        bins in one set of kernel launches, then the tracebacks."""
        from .ops.align_hint import hint_endpoints_grid
        with trace.span("align", queries=len(queries)):
            p = self.params
            prepared = []
            jobs = []
            with trace.span("align.fetch"):
                for query, hits in zip(queries, hitlists):
                    shown, bins = hits.align_prepare(
                        query, self.matrix.scorelimit_16, seqnos)
                    prepared.append((query, hits, shown, bins))
                    for qseq, items in bins:
                        jobs.append((qseq, [h.dseq for _, h in items]))
            with trace.span("align.hint", bins=len(jobs)):
                res = hint_endpoints_grid(jobs, self.matrix.matrix, p.gapopen,
                                          p.gapextend, device=self.device)
            with trace.span("align.traceback",
                            shown=sum(len(x[2]) for x in prepared)):
                k = 0
                for query, hits, shown, bins in prepared:
                    hints: dict[int, tuple[int, int, int]] = {}
                    for qseq, items in bins:
                        for (i, h), (score, bestq, bestpos) in zip(items,
                                                                   res[k]):
                            if bestq > 0 and bestpos:
                                hints[i] = (score, bestq, bestpos)
                        k += 1
                    hits.align_finish(query, self.matrix.matrix, p.gapopen,
                                      p.gapextend, shown, hints,
                                      threads=p.threads)

    def _slot_groups(self, slots):
        """Slots sorted by length and grouped by (qlen bucket, lanes,
        long), so one long query does not push the batch onto a slower
        configuration.  Long queries (over ROW_CAP) round qlen_pad up to
        whole tiles, on LONG_NSEQS lanes."""
        groups: list[tuple] = []
        caps = dict(self.STREAM_CONFIGS)
        for s in sorted(slots, key=lambda s: len(s[3])):
            qlen_pad = self.qlen_bucket(len(s[3]))
            if self._forced_nseqs is not None \
                    and qlen_pad <= caps[self._forced_nseqs]:
                nseqs = self._forced_nseqs
            else:
                nseqs = next((n for n, cap in self.STREAM_CONFIGS
                              if qlen_pad <= cap), None)
            if nseqs is None:
                cfg = (round_up(len(s[3]), self.LONG_TILE_ROWS),
                       self.LONG_NSEQS, True)
            else:
                cfg = (qlen_pad, nseqs, False)
            if groups and groups[-1][0] == cfg:
                groups[-1][1].append(s)
            else:
                groups.append((cfg, [s]))
        return groups

    @staticmethod
    def qlen_bucket(L: int) -> int:
        """Query-row bucket for a query of length L: short queries bucket
        to 32 rows, longer ones to 128."""
        if L <= 128:
            return max(32, -(-L // 32) * 32)
        return -(-L // 128) * 128

    def _dev_chunks(self, packs, cache: dict, key, prep):
        """Device tensors of ``packs`` (prep per chunk), cached in
        ``cache[key]`` while their total is within DEVICE_CACHE_BYTES,
        else prepared lazily per chunk."""
        size = sum(c.data_t.size if isinstance(c, StreamChunk)
                   else c.data.size for c in packs)
        if size <= self.DEVICE_CACHE_BYTES:
            if key not in cache:
                with trace.span("setup.upload", chunks=len(packs),
                                bytes=size):
                    cache[key] = [prep(c) for c in packs]
            yield from cache[key]
        else:
            for c in packs:
                yield prep(c)

    def _prep_chunk(self, c):
        """(data, start, end_block, lane, unit ids) of one chunk on the
        device, the score-gather coordinates in reverse tie order (the
        order the top-K relies on)."""
        from .ops.sw_stream import chunk_tensors
        order = reverse_tie_order(self.unit_meta[c.seqnos])
        data, start, eb, ln = chunk_tensors(
            c.data_t, c.start, c.end_block[order], c.lane[order],
            self.device)
        ud = c.seqnos[order].astype(np.int32)
        return data, start, eb, ln, trace.to_device(ud, self.device)

    def _dev_stream_chunks(self, nseqs: int, max_cols: int | None = None):
        """Device tensors per plain-pack chunk (_prep_chunk)."""
        return self._dev_chunks(self._stream_chunks(nseqs, max_cols),
                                self._dev_stream,
                                (nseqs, max_cols or self._max_cols),
                                self._prep_chunk)

    def _dev_flow_chunks(self, nseqs: int):
        """Device tensors per flow chunk: _prep_chunk's and the chunk's
        carry_src."""
        def prep(c):
            data, start, eb, ln, ud = self._prep_chunk(c)
            src = trace.to_device(c.carry_src.astype(np.int64),
                                  self.device)
            return data, start, src, eb, ln, ud

        return self._dev_chunks(self._flow_chunks(nseqs), self._dev_flow,
                                nseqs, prep)

    def _search_segments(self, slots, timings):
        """The segment-packed route (the JAX engine's _search_segments):
        every slot at once at qlen_pad = max(64, the longest slot rounded
        to 64), one kernel call per chunk (K8 for backend "pallas", else
        K9; an int32 profile for matrices outside int8), the scores mapped
        back to units through the chunk's seqnos and entered with the
        tier counters from the host scores; then the giants on the carry
        series."""
        from .ops.sw_segmented import build_qpt, sw_scores_segmented
        from .ops.sw_tiled import sw_scores_tiled
        p = self.params
        wide = not self.matrix.fits_int8
        score = sw_scores_tiled if self.backend == "pallas" and not wide \
            else sw_scores_segmented
        qlen_pad = max(64, round_up(max(len(s[3]) for s in slots), 64))
        dev = self.device

        def prep(c):
            return (trace.to_device(c.data, dev),
                    trace.to_device(c.seg_ids, dev), c)

        with trace.span("scoring.group", qlen_pad=qlen_pad,
                        nseqs=self._seg_shape[0],
                        long=qlen_pad > self.ROW_CAP,
                        slots=len(slots), route="segment"):
            qpt = trace.to_device(build_qpt(
                [s[3] for s in slots], self.matrix.matrix, qlen_pad,
                dtype=np.int32 if wide else np.int8), dev)
            for data, seg_ids, chunk in self._dev_chunks(
                    self._segment_chunks(), self._dev_segpack, 0, prep):
                out = trace.to_host(score(
                    qpt, data, seg_ids, nsegs=chunk.nsegs,
                    gapopenextend=p.gapopenextend,
                    gapextend=p.gapextend)).numpy()
                unit_idx = chunk.seqnos.ravel()
                valid = unit_idx >= 0
                meta = self.unit_meta[unit_idx[valid]]
                with trace.span("scoring.enter"):
                    flats = []
                    for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                        flat = out[fi].reshape(-1)[valid]
                        flats.append(flat)
                        hits.enter_batch(meta[:, 0], flat, qstrand, qframe,
                                         meta[:, 1], meta[:, 2])
                    self._count_tiers(timings, np.stack(flats), len(slots))
        self._score_carry_series(slots, qlen_pad, timings, lax=True)

    def _search_stream_group(self, slots, qlen_pad, nseqs, timings,
                             long=False):
        """Score one slot group on its plain pack, flow series or (long)
        tile passes and enter its hits; then the giants."""
        route = "long" if long else "flow" \
            if self._flow_cols(nseqs) is not None else "stream"
        with trace.span("scoring.group", qlen_pad=qlen_pad, nseqs=nseqs,
                        long=long, slots=len(slots), route=route):
            self._score_stream_group(slots, qlen_pad, nseqs, timings, route)
        # chromosome-scale units follow on the giant routes
        self._score_carry_series(slots, qlen_pad, timings)

    def _score_stream_group(self, slots, qlen_pad, nseqs, timings, route):
        from .ops.sw_stream import build_matrix8, build_qcodes
        # one walk of the route's pack, and the live slots it carries
        trace.count(f"scoring.passes.{route}")
        trace.count(f"scoring.slots.{route}", len(slots))
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        # pad the slot count to a power of two, as the JAX engine does;
        # a dead slot has length 0 and scores 0
        nslots = len(slots)
        nslots_pad = 1 << (nslots - 1).bit_length()
        if nslots_pad != nslots:
            qc = np.concatenate(
                [qc, np.full((nslots_pad - nslots, qlen_pad), PAD_SYMBOL,
                             qc.dtype)], axis=0)
            ql = np.concatenate(
                [ql, np.zeros(nslots_pad - nslots, ql.dtype)], axis=0)
        dev = self.device
        qc = trace.to_device(qc, dev)
        ql = trace.to_device(ql, dev)
        m8 = trace.to_device(build_matrix8(self.matrix.matrix), dev)
        # dead padding slots get INT32_MAX thresholds: they count no
        # hits and mask nothing
        pad_hi = [2**31 - 1] * (nslots_pad - nslots)

        def thresholds(attr):
            return trace.to_device(torch.tensor(
                [max(min(getattr(s[0], attr), 2**31 - 1), -2**31)
                 for s in slots] + pad_hi, dtype=torch.int32), dev)

        init_thr = thresholds("init_threshold")
        # upper cutoff (-u/-k): chunk_reduce masks scores above it
        upper_thr = thresholds("upperscorethreshold")
        kbase = max(s[0].keephits for s in slots) + 64
        # long groups take the plain pack in tile passes; otherwise heavy
        # length tails over small databases take the flow series
        if route == "long":
            scored = self._stream_scores(
                self._dev_stream_chunks(nseqs, self.LONG_MAX_COLS), qc, ql,
                m8, long=True)
        elif route == "flow":
            scored = self._flow_scores(nseqs, qc, ql, m8, qlen_pad)
        else:
            scored = self._stream_scores(self._dev_stream_chunks(nseqs), qc,
                                         ql, m8)
        packed, n_units = self._walk(scored, init_thr, upper_thr, kbase)
        if n_units:
            self._enter_packed(slots, packed, n_units, timings)

    def _stream_scores(self, chunks, qc, ql, m8, long=False):
        """Score plain-pack chunks (K2; a long group: K5's tile passes),
        both looking scores up in the matrix: yields (dump, end_block,
        lane, unit ids) per chunk."""
        from .ops.sw_stream import sw_scores_stream, sw_scores_stream_long
        p = self.params
        kw = dict(gapopenextend=p.gapopenextend, gapextend=p.gapextend)
        for data, start, eb, ln, ud in chunks:
            if long:
                out = sw_scores_stream_long(qc, ql, m8, data, start,
                                            tile_rows=self.LONG_TILE_ROWS,
                                            **kw)
            else:
                out = sw_scores_stream(qc, ql, m8, data, start, **kw)
            yield out, eb, ln, ud

    def _flow_scores(self, nseqs, qc, ql, m8, qlen_pad):
        """Score a flow series in order (K3, which looks scores up in the
        matrix: no block profiles), the carried state permuted between
        chunks: yields (dump, end_block, lane, unit ids) for the chunks
        where units end.  The series' head starts fresh and its tail
        hands no state on."""
        from .ops.sw_stream import (make_stream_state, permute_stream_state,
                                    sw_scores_stream_carry)
        p = self.params
        nchunks = len(self._flow_chunks(nseqs))
        state = None
        for i, (data, start, src, eb, ln, ud) in enumerate(
                self._dev_flow_chunks(nseqs)):
            if i == 0:
                state = make_stream_state(qc.shape[0], qlen_pad,
                                          data.shape[1], self.device)
            else:
                state = permute_stream_state(*state, src)
            out, *state = sw_scores_stream_carry(
                qc, ql, m8, data, start, *state,
                gapopenextend=p.gapopenextend, gapextend=p.gapextend,
                carry_in=i > 0, carry_out=i < nchunks - 1)
            if ud.shape[0]:
                yield out, eb, ln, ud

    def _walk(self, scored, init_thr, upper, kbase):
        """Gather and reduce every scored chunk on the device; returns the
        packed host array [nq, 2K + 4] = [scores | unit ids | totalh |
        obvious | n16 | n63] (one device-to-host copy) and the unit
        count, or (None, 0) when no chunk was scored."""
        from .ops.sw_stream import gather_scores
        nq = init_thr.shape[0]
        dev = self.device
        sl7 = self.matrix.scorelimit_7
        sl16 = self.matrix.scorelimit_16
        vals_parts, unit_parts = [], []
        totalh = torch.zeros(nq, dtype=torch.int32, device=dev)
        obvious = torch.zeros_like(totalh)
        n16 = torch.zeros((), dtype=torch.int32, device=dev)
        n63 = torch.zeros_like(n16)
        n_units = 0
        for out, eb, ln, ud in scored:
            sc = gather_scores(out, eb, ln)
            del out
            v, idx, th, ob, a, b = chunk_reduce(sc, init_thr, upper, kbase,
                                                sl7, sl16)
            totalh += th
            obvious += ob
            n16 += a
            n63 += b
            vals_parts.append(v)
            unit_parts.append(ud[idx])
            n_units += ud.shape[0]
        if not vals_parts:
            return None, 0
        V = torch.cat(vals_parts, dim=1)
        U = torch.cat(unit_parts, dim=1)
        packed = torch.cat(
            [V, U, totalh[:, None], obvious[:, None],
             n16.expand(nq, 1), n63.expand(nq, 1)], dim=1)
        return trace.to_host(packed).numpy(), n_units

    def _enter_packed(self, slots, packed, n_units, timings):
        """Unpack one [nq, 2K+4] walk result and enter all hits."""
        with trace.span("scoring.enter"):
            K = (packed.shape[1] - 4) // 2
            V, U = packed[:, :K], packed[:, K:2 * K]
            totalh = packed[:, 2 * K]
            obvious = packed[:, 2 * K + 1]
            n16, n63 = int(packed[0, 2 * K + 2]), int(packed[0, 2 * K + 3])
            for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                sel = V[fi] >= 0
                meta = self.unit_meta[U[fi][sel]]
                hits.enter_batch(meta[:, 0], V[fi][sel], qstrand, qframe,
                                 meta[:, 1], meta[:, 2],
                                 counts=(int(totalh[fi]), int(obvious[fi])))
            if timings is not None:
                timings.compute[7] += n_units * len(slots)
                timings.compute[16] += n16
                timings.compute[63] += n63
                timings.rounds[7] += len(slots)
                if n16:
                    timings.rounds[16] += len(slots)
                if n63:
                    timings.rounds[63] += len(slots)

    # ---- giant units --------------------------------------------------------

    def _score_carry_series(self, slots, qlen_pad, timings, lax=False):
        """Score the giant units against the slots, SLOT_BATCH (long:
        SLOT_BATCH_LONG) at a time, and enter their hits.  ``lax``: the
        segment route's giants, always on the untiled carry series (the
        JAX engine's lax mode)."""
        if self._giant_ids.size == 0:
            return
        step = self.SLOT_BATCH if qlen_pad <= self.ROW_CAP \
            else self.SLOT_BATCH_LONG
        for i in range(0, len(slots), step):
            group = slots[i:i + step]
            scored = self._iter_carry_series(group, qlen_pad, lax=True) \
                if lax else self._iter_carry_scores(group, qlen_pad)
            with trace.span("scoring.group", qlen_pad=qlen_pad,
                            nseqs=len(self._giant_ids),
                            long=qlen_pad > self.ROW_CAP,
                            slots=len(group), route="giants"):
                for units, sc in scored:
                    self._enter_chunk(group, units, sc, timings)

    def _iter_carry_scores(self, slots, qlen_pad):
        """Route the giants (the JAX engine's rules) and yield (unit ids,
        host scores [nslots, n]).  A positive-score local alignment spans
        at most _overlap_bound columns, so overlapped pieces score giants
        exactly on the stream kernel; where that bound is too large, a
        few giants take the wavefront kernel and many the carry
        series.  Long groups always take the carry series."""
        if qlen_pad <= self.ROW_CAP:
            V = self._overlap_bound(qlen_pad)
            if self.SEGMENT_GIANTS and V <= self._max_cols // 2:
                yield from self._iter_segmented_giants(slots, qlen_pad, V)
                return
            if len(self._giant_ids) <= self.WAVEFRONT_MAX_GIANTS:
                yield from self._iter_wavefront_scores(slots, qlen_pad, V)
                return
        yield from self._iter_carry_series(slots, qlen_pad)

    def _slot_tensors(self, slots, qlen_pad):
        """(qcodes, qlens, matrix) of unpadded slots on the device; the
        matrix is int8 (build_matrix8), or int32 (build_matrix_wide) for
        scores outside int8."""
        from .ops.sw_stream import (build_matrix8, build_matrix_wide,
                                    build_qcodes)
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        dev = self.device
        mat = (build_matrix8 if self.matrix.fits_int8
               else build_matrix_wide)(self.matrix.matrix)
        return (trace.to_device(qc, dev), trace.to_device(ql, dev),
                trace.to_device(mat, dev))

    def _iter_carry_series(self, slots, qlen_pad, lax=False):
        """The carry series on K3 (long groups: K6's tile passes; with
        ``lax``, K3 at any query length): each giant streams through
        chunks of max_cols columns on one lane, its state carried chunk
        to chunk.  The JAX engine pads the pack's compact lanes to 1024
        (its lax mode keeps them compact); here the state is the compact
        width rounded to a warp (the scores of real lanes are the
        same)."""
        from .ops.sw_stream import (chunk_tensors, gather_scores,
                                    make_stream_state,
                                    make_stream_state_long,
                                    sw_scores_stream_carry,
                                    sw_scores_stream_carry_long)
        p = self.params
        chunks = self._carry_chunks(1024)
        done = []
        with trace.span("giant.carry", slots=len(slots), qlen_pad=qlen_pad):
            qc, ql, m8 = self._slot_tensors(slots, qlen_pad)
            width = round_up(chunks[0].nseqs, 32)
            kw = dict(gapopenextend=p.gapopenextend, gapextend=p.gapextend)
            if qlen_pad > self.ROW_CAP and not lax:
                score = sw_scores_stream_carry_long
                kw["tile_rows"] = self.LONG_TILE_ROWS
                state = make_stream_state_long(len(slots), qlen_pad, width,
                                               self.LONG_TILE_ROWS,
                                               self.device)
            else:
                score = sw_scores_stream_carry
                state = make_stream_state(len(slots), qlen_pad, width,
                                          self.device)
            for i, ch in enumerate(chunks):
                data, start, eb, ln = chunk_tensors(ch.data_t, ch.start,
                                                    ch.end_block, ch.lane,
                                                    self.device)
                out, *state = score(qc, ql, m8, data, start, *state,
                                    carry_in=i > 0,
                                    carry_out=i < len(chunks) - 1, **kw)
                if len(ch.seqnos):
                    done.append((ch.seqnos, trace.to_host(
                        gather_scores(out, eb, ln)).numpy()))
            self._count_giant_cells("carry", slots)
        yield from done

    def _overlap_bound(self, qlen_pad: int) -> int:
        """Upper bound on the db-span of any positive-score local
        alignment (ops.align_hint._span_bound, shared with the segmented
        hint pass).  Pieces of a giant cut with this much overlap contain
        every scoring alignment whole, so max-over-pieces is EXACT.
        All-negative matrices admit no positive alignment (any overlap
        is exact); free gap extension makes the span unbounded — the
        bound then fails the segmentation gate."""
        from .ops.align_hint import _span_bound
        maxS = int(self.matrix.matrix.max())
        if maxS <= 0:
            return qlen_pad
        V = _span_bound(qlen_pad, maxS, self.params.gapextend)
        return (1 << 62) if V is None else V

    def _iter_segmented_giants(self, slots, qlen_pad, V):
        """Score the giants as overlapped pieces of stride S and length
        S + V lane-packed at full occupancy (K2); a giant's score is the
        max over its pieces."""
        from .ops.sw_stream import gather_scores, sw_scores_stream
        p = self.params
        nseqs = 2048 if qlen_pad <= dict(self.STREAM_CONFIGS)[2048] \
            else 1024
        owner, dev_chunks = self._seg_giant_chunks(nseqs, V)
        best = np.zeros((len(slots), len(self._giant_ids)), dtype=np.int64)
        with trace.span("giant.pieces", slots=len(slots), qlen_pad=qlen_pad,
                        overlap=V):
            qc, ql, m8 = self._slot_tensors(slots, qlen_pad)
            for data, start, eb, ln, snos in dev_chunks:
                out = sw_scores_stream(qc, ql, m8, data, start,
                                       gapopenextend=p.gapopenextend,
                                       gapextend=p.gapextend)
                sc = trace.to_host(gather_scores(out, eb, ln)).numpy()
                np.maximum.at(best, (slice(None), owner[snos]), sc)
            self._count_giant_cells("pieces", slots)
        yield self._giant_ids, best

    def _seg_giant_chunks(self, nseqs: int, V: int):
        """Owner map and device tensors of the giant-piece pack, built
        once per (nseqs, V) and cached on the device within the budget it
        shares with the plain pack."""
        from .ops.sw_stream import chunk_tensors
        key = (nseqs, V)
        if key not in self._seg_packs:
            # the stride adapts to the giant payload so mid-size genomes
            # still fill the lanes; a piece of S + V always fits a chunk
            total = sum(len(s) for s in self._giant_seqs)
            S = max(total // (4 * nseqs), V, 1024)
            S = min(S, self._max_cols - V)
            pieces, owner = [], []
            for gi, seq in enumerate(self._giant_seqs):
                for pos in range(0, max(len(seq) - V, 1), S):
                    pieces.append(seq[pos: pos + S + V])
                    owner.append(gi)
            with trace.span("setup.pack", route="pieces", lanes=nseqs,
                            cols=self._max_cols):
                self._seg_packs[key] = (
                    np.asarray(owner, dtype=np.int64),
                    pack_stream(pieces, nseqs=nseqs, max_cols=self._max_cols,
                                seqnos=np.arange(len(pieces),
                                                 dtype=np.int64)))
        owner, chunks = self._seg_packs[key]

        def prep(ch):
            return (*chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                   ch.lane, self.device), ch.seqnos)

        total = sum(c.data_t.size for c in chunks)
        if key in self._dev_seg or \
                self._cached_bytes() + total <= self.DEVICE_CACHE_BYTES:
            if key not in self._dev_seg:
                with trace.span("setup.upload", chunks=len(chunks),
                                bytes=total):
                    self._dev_seg[key] = [prep(c) for c in chunks]
            return owner, self._dev_seg[key]
        return owner, (prep(c) for c in chunks)

    def _cached_bytes(self) -> int:
        """The device copies the giant routes' budget counts: the plain
        and piece packs' and the held giants'."""
        cached = sum(sum(c.data_t.size for c in self._stream_packs[k])
                     for k in self._dev_stream if k in self._stream_packs)
        cached += sum(sum(c.data_t.size for c in self._seg_packs[k][1])
                      for k in self._dev_seg if k in self._seg_packs)
        if self._dev_giants is not None:
            cached += self._dev_giants.db.numel()
        return cached

    def _held_giants(self):
        """The giants' one device copy (ops.sw_wavefront.hold_giants),
        made once and kept within the budget the piece packs share; over
        it, made for each call."""
        from .ops.sw_wavefront import SLAB_COLS, hold_giants
        if self._dev_giants is not None:
            return self._dev_giants
        size = sum(round_up(len(g), SLAB_COLS) for g in self._giant_seqs)
        if self._cached_bytes() + size > self.DEVICE_CACHE_BYTES:
            return hold_giants(self._giant_seqs, self.device)
        with trace.span("setup.upload", giants=len(self._giant_seqs),
                        bytes=size):
            self._dev_giants = hold_giants(self._giant_seqs, self.device)
        return self._dev_giants

    def _iter_wavefront_scores(self, slots, qlen_pad, V):
        """Score every giant with the anti-diagonal wavefront kernel (K7)
        in one call: the giants held on the device, cut into pieces
        overlapped by V where the slots alone would leave the card idle
        (ops.sw_wavefront.plan_pieces)."""
        from .ops.sw_stream import build_matrix8, build_qcodes
        from .ops.sw_wavefront import build_mq, sw_wavefront_giants
        p = self.params
        giants = self._held_giants()
        with trace.span("giant.wavefront", slots=len(slots),
                        qlen_pad=qlen_pad, giants=len(self._giant_ids)):
            qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
            mq = trace.to_device(build_mq(
                qc, build_matrix8(self.matrix.matrix)), self.device)
            done = trace.to_host(sw_wavefront_giants(
                mq, ql, giants, overlap=V, gapopenextend=p.gapopenextend,
                gapextend=p.gapextend)).numpy()
            self._count_giant_cells("wavefront", slots)
        # a giant a yield, as the cascade counters count them
        for i, gid in enumerate(self._giant_ids):
            yield np.array([gid], dtype=np.int64), done[:, i:i + 1]

    def _count_giant_cells(self, route: str, slots) -> None:
        """Add the cells a giant route walked, ``giant.cells.<route>``:
        the slots' query residues times the giants' residues, with no
        padding and no piece overlap."""
        trace.count(f"giant.cells.{route}",
                    sum(len(s[3]) for s in slots)
                    * sum(len(g) for g in self._giant_seqs))

    def _enter_chunk(self, slots, units, sc, timings):
        """Enter the giants' host scores [nslots, n] of ``units``."""
        meta = self.unit_meta[units]
        with trace.span("scoring.enter"):
            for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                hits.enter_batch(meta[:, 0], sc[fi], qstrand, qframe,
                                 meta[:, 1], meta[:, 2])
            self._count_tiers(timings, sc, len(slots))

    def _count_tiers(self, timings, scores, nq: int) -> None:
        """Cascade-compatibility counters (compute*/rounds*,
        swipe.cc:111-119) from exact scores: the tier a sequence would
        end at in the reference's 7 -> 16 -> 63-bit escalation follows
        from its score against SCORELIMIT_7/_16."""
        if timings is None:
            return
        n16 = int((scores >= self.matrix.scorelimit_7).sum())
        n63 = int((scores >= self.matrix.scorelimit_16).sum())
        timings.compute[7] += int(scores.size)
        timings.compute[16] += n16
        timings.compute[63] += n63
        timings.rounds[7] += nq
        if n16:
            timings.rounds[16] += nq
        if n63:
            timings.rounds[63] += nq
