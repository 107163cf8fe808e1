"""Multi-host execution: the mpiswipe replacement, as running code.

Port of ``swipe_tpu/parallel/multihost.py`` on ``torch.distributed``.
The reference's ``mpiswipe`` is a master/slave MPI program
(swipe.cc:1793-2434): phase 1 hands out seqno chunks, slaves search
locally and bulk-report their top-K as 8-long tuples plus counters
(:2273-2334, merged :1951-1993); phase 2 routes each displayed hit to a
slave that recomputes the alignment and streams dseq / coords /
op-string / header back (:2336-2411).  Every rank opens the database
itself over a shared filesystem.

Here:

* every process calls :func:`init_multihost` (a gloo process group:
  only host bytes cross hosts) and opens the database itself;
* the database is split into per-host contiguous seqno shards balanced
  by residue mass, snapped to volume boundaries when the BLAST db has
  several volumes and the snap keeps the balance (:func:`split_seqnos`)
  — unit numbering stays GLOBAL (``Database.unit_metas``), so merged
  results are host-independent;
* each host lane-packs and scores its shard on its OWN devices (every
  visible CUDA device; one process owns them all, so a host-side
  gather merges them): each device scores its lane slice, gathers its
  sequences' scores and reduces them to a top-K (score desc, unit desc
  — the hit list's tie order) plus totalhits / obvious / tier counters;
* hosts run at their own pace; the reduced per-chunk payloads are
  exchanged ONCE per search with a byte all-gather and entered by every
  host in (rank, chunk) order — replacing tag_search_report + tag_stats;
* host-speed skew is absorbed by DYNAMIC work assignment
  (:func:`assign_ranges`): each host scores a first wave (a quarter of
  its static shard) while timing itself, the measured residues/second
  ride one tiny all-gather, and every host deterministically recomputes
  the remaining assignment proportional to measured speed (the
  reference master's on-demand chunk handout, swipe.cc:1335-1362,
  1883-1994);
* the align phase aligns on each host the kept hits of the sequences it
  owns (one batched hint pass, then the tracebacks), and the filled hits
  are exchanged with one byte all-gather — replacing the per-hit
  tag_align message quartet.

Every host ends with identical, fully aligned HitLists; rank 0 renders
the report (the CLI wires this through ``--mh-procs/--mh-rank/
--mh-coord``).  Output bytes are independent of the wave assignment:
the scored union is always the whole database and the merge is exact,
so the measured speeds only move WHERE work runs, never what is
reported.

Units longer than ``max_cols`` stay with their static owner: it scores
them through the single-host giant routes (overlapped pieces on the
stream kernel, the wavefront kernel or the carry series), and their
(unit, scores) rows ride one byte all-gather so every host enters the
same union.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch

from ..batching import pack_stream, round_up
from ..pipeline import SearchEngine, chunk_reduce, reverse_tie_order
from .distributed import local_devices

__all__ = ["init_multihost", "split_seqnos", "assign_ranges",
           "stabilize_speeds", "MultiHostEngine"]

# a collective waits this long for the slowest rank, then fails the run:
# a rank that died must not hang the others
COLLECTIVE_TIMEOUT_S = 1800


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the multi-host job: a gloo process group whose store rank 0
    serves at ``coordinator`` (host:port).  The group is destroyed when
    the process exits."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    atexit.register(_leave)


def _leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_bytes(data: bytes) -> list[bytes]:
    """Exchange one byte blob per process (the sizes, then the blobs
    padded to the largest); ``[data]`` without a process group."""
    import torch.distributed as dist
    _, n = _rank_world()
    if n == 1:
        return [data]
    size = torch.tensor([len(data)], dtype=torch.int64)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [b[:s].numpy().tobytes() for b, s in zip(bufs, sizes)]


def _db_cumlens(db) -> np.ndarray:
    """[seqcount + 1] cumulative residue counts, from the offset tables
    when the backing store answers cheaply (BlastDatabase.get_length
    never decodes)."""
    n = db.seqcount()
    lens = np.empty(n, dtype=np.int64)
    for s in range(n):
        lens[s] = db.get_length(s, 0 if getattr(db, "dbtype", "aa") == "nt"
                                else 1)[1]
    return np.concatenate([[0], np.cumsum(lens)])


def split_seqnos(db, n_hosts: int, *,
                 balance_tol: float = 0.20) -> list[tuple[int, int]]:
    """Contiguous per-host seqno ranges balanced by RESIDUE mass.

    The reference's master hands chunks out dynamically so a skewed
    database never idles a rank (search_getwork swipe.cc:1335-1362,
    master loop :1883-1994).  The static equivalent is a
    size-proportional split: host cuts are placed on the cumulative
    residue curve (lengths read from the volume offset tables — no
    sequence decode), not on the sequence count, so one giant volume
    among tiny ones still yields near-equal per-host work.  Cuts are
    then snapped to volume starts (mmap locality; the reference's
    calc_chunks never crosses volumes either, database.cc:1102-1103) but
    ONLY when the snap keeps every host's residue load within
    ``balance_tol`` of the even share — load balance outranks volume
    alignment.  Residual imbalance is bounded by the longest single
    sequence (chromosome-scale units additionally stream through the
    owning host's giant routes, see MultiHostEngine).
    """
    total = db.seqcount()
    cum = _db_cumlens(db)
    even = cum[-1] / n_hosts if n_hosts else 0
    # residue-proportional cut points
    cuts = [0]
    for h in range(1, n_hosts):
        cuts.append(int(np.searchsorted(cum, h * even, side="left")))
    cuts.append(total)
    vol_start = getattr(db, "_vol_start", None)
    if vol_start is not None and len(vol_start) > 2 and even > 0:
        vs = np.asarray(vol_start, dtype=np.int64)
        for h in range(1, n_hosts):
            snapped = int(vs[np.argmin(np.abs(cum[vs] - cum[cuts[h]]))])
            trial = list(cuts)
            trial[h] = snapped
            trial = np.maximum.accumulate(trial)
            loads = cum[trial[1:]] - cum[trial[:-1]]
            if loads.max() <= (1 + balance_tol) * even:
                cuts[h] = snapped
    cuts = list(np.maximum.accumulate(cuts))
    cuts[n_hosts] = total
    return list(zip(cuts[:-1], cuts[1:]))


def assign_ranges(segments: list[tuple[int, int]], weights: np.ndarray,
                  cum: np.ndarray) -> list[list[tuple[int, int]]]:
    """Cut a list of seqno segments into per-host pieces by weight.

    ``segments`` are disjoint ascending [lo, hi) seqno ranges (the
    hosts' unscored remainders), ``cum`` a cumulative residue curve
    (the engine passes its giant-excluded WORK curve: units the waves
    never lane-pack contribute zero mass), ``weights`` one positive
    speed per host
    (residues/second measured on the first wave).  Returns, per host, a
    list of [lo, hi) pieces whose residue mass is proportional to its
    weight — every host derives the identical assignment from the same
    all-gathered weights, so no further coordination is needed (the
    static form of the reference master's dynamic chunk handout,
    swipe.cc:1335-1362).
    """
    n = len(weights)
    w = np.asarray(weights, dtype=np.float64)
    w = np.where(w > 0, w, w[w > 0].mean() if (w > 0).any() else 1.0)
    seg_res = np.array([cum[hi] - cum[lo] for lo, hi in segments],
                       dtype=np.float64)
    total = seg_res.sum()
    if total <= 0:
        return [[] for _ in range(n)]
    targets = np.cumsum(w / w.sum()) * total     # host h ends at targets[h]
    out: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    h = 0
    done = 0.0
    for (lo, hi) in segments:
        while lo < hi:
            # advance past hosts whose quota is already filled
            while h < n - 1 and done >= targets[h] - 0.5:
                h += 1
            if h == n - 1:
                out[h].append((lo, hi))
                done += cum[hi] - cum[lo]
                break
            # largest prefix of [lo, hi) fitting host h's quota
            room = targets[h] - done
            cut = int(np.searchsorted(cum, cum[lo] + room,
                                      side="right")) - 1
            cut = max(lo + 1, min(cut, hi))
            out[h].append((lo, cut))
            done += cum[cut] - cum[lo]
            lo = cut
    return out


def stabilize_speeds(prev: np.ndarray | None, speeds: np.ndarray,
                     drift: float) -> np.ndarray:
    """Hysteresis over all-gathered per-host speeds.

    A rank whose shard had zero wave-1 work (all-giant or empty)
    measures speed 0 every batch; substitute the mean of the positive
    speeds (the normalization ``assign_ranges`` itself applies) so one
    workless rank cannot disable the hysteresis — and the wave-2 pack
    cache — fleet-wide.  Then, when the fresh speeds keep the same
    relative shape as the ones that produced the cached assignment
    (every ratio within ``drift`` of the mean drift), return ``prev``
    unchanged so the assignment — and therefore the wave-2 pack cache —
    is stable under measurement noise.  All inputs are derived from
    all-gathered arrays, so every host computes the identical result.
    """
    if (speeds <= 0).any() and (speeds > 0).any():
        speeds = speeds.copy()
        speeds[speeds <= 0] = speeds[speeds > 0].mean()
    if prev is not None and (prev > 0).all() and (speeds > 0).all():
        r = speeds / prev
        if r.max() <= drift * r.min():
            return prev
    return speeds


def _pick_stream_mode(use_kernel: bool, lpd: int, qlen_pad: int
                      ) -> tuple[str, int]:
    """Kernel route for the multi-host search step: the JAX engine's row
    caps (512 at 2048 lanes a device, 1024 at 1024), past which queries
    take the query-tiled passes at whole 512-row tiles.  "lax" is the
    route of matrices outside int8 and of the CPU backends."""
    if not use_kernel:
        return "lax", qlen_pad
    cap = 512 if lpd == 2048 else 1024
    if qlen_pad <= cap:
        return "stream", qlen_pad
    return "stream_long", -(-qlen_pad // 512) * 512


def _scores_lax(qcodes, qlens, matrix, db, start, **kw) -> torch.Tensor:
    """A lane pack's per-block dump under the "lax" route: the stream
    kernel (K2) for an int8 matrix; for an int32 one the row form of the
    carry kernel (K3r) from a fresh state, which computes K2's function
    when nothing is carried in (K2 takes int8 only)."""
    from ..ops import sw_stream
    if matrix.dtype == torch.int8:
        return sw_stream.sw_scores_stream(qcodes, qlens, matrix, db, start,
                                          **kw)
    h, e, s = sw_stream.make_stream_state(qcodes.shape[0], qcodes.shape[1],
                                          db.shape[1], db.device)
    return sw_stream.sw_scores_stream_carry_rows(
        qcodes, qlens, matrix, db, start, h, e, s, carry_in=False,
        carry_out=False, **kw)[0]


class MultiHostEngine(SearchEngine):
    """SearchEngine over every process of a multi-host job and every
    local device of this one.

    Construct after :func:`init_multihost` (or without a process group:
    a world of one); every process builds one and runs the same queries.
    All processes end with identical HitLists (scores, counters,
    headers, alignments); rank 0 typically renders.
    """

    # first-wave share of each host's static shard: measured while timed,
    # the remainder is reassigned by measured speed (assign_ranges)
    WAVE1_FRAC = 0.25
    # speed skew below this keeps the static residue-proportional split
    # (avoids repacking noise when hosts are in fact symmetric)
    REBALANCE_TOL = 1.15
    # fresh speeds whose relative shape stays within this factor of the
    # speeds that produced the cached assignment reuse that assignment
    # (keeps the wave-2 pack cache hot under measurement noise)
    SPEED_DRIFT = 1.10

    def __init__(self, db, params, *, devices=None, nseqs: int | None = None,
                 max_cols: int | None = None, backend: str = "stream"):
        self._pid, self._nproc = _rank_world()
        self.backend = "stream" if backend == "auto" else backend
        self._devices = local_devices(devices)
        self._n_local = len(self._devices)
        # the giant routes and the align phase run on the first device
        self.device = self._devices[0]
        self.db = db
        self.params = params
        self.matrix = self._build_matrix()
        stream = self.backend == "stream"
        if nseqs is None:
            # the stream kernel takes 1024 lanes a device; "lax" anything
            nseqs = (1024 * self._n_local
                     if stream and self.matrix.fits_int8 else 512)
        if max_cols is None:
            max_cols = 65536 if stream else 16384
        self._pack(nseqs, max_cols)

    # ---- packing ------------------------------------------------------------

    def _pack(self, nseqs: int, max_cols: int) -> None:
        symtype = self.params.symtype
        # lanes per host must split evenly over the host's devices
        if nseqs % self._n_local:
            nseqs += self._n_local - nseqs % self._n_local
        self._nseqs_local = nseqs
        self._max_cols = max_cols
        self.unit_meta = self.db.unit_metas(symtype)      # GLOBAL numbering
        self._cum = _db_cumlens(self.db)
        # WORK curve: giant units (len > max_cols) never enter the lane
        # packs the waves score — they take the static owner's giant
        # routes outside the timed waves — so speed measurement and
        # proportional reassignment must not count their residue mass
        lens = np.diff(self._cum)
        self._cum_work = np.concatenate(
            [[0], np.cumsum(np.where(lens > max_cols, 0, lens))])
        self._ranges = split_seqnos(self.db, self._nproc)
        lo, hi = self._ranges[self._pid]
        # GIANT units stay with the STATIC owner; every host excludes
        # them from lane packs by the same length test, so dynamic
        # reassignment can never double-score one.  The decode also
        # yields the shard's NORMAL units, kept as this host's
        # range-addressable cache (_units_for_range) so wave packs never
        # re-decode the shard
        self._own_range = (lo, hi)
        self._own_ids, self._own_seqs = self._load_units(
            lo, hi, keep_giants=True)
        self._own_seqnos = self.unit_meta[self._own_ids, 0] \
            if len(self._own_ids) else np.zeros(0, dtype=np.int64)
        # wave split: deterministic from the work curve, so every host
        # knows every other host's unscored remainder without
        # communication
        self._wave_splits = []
        for (rlo, rhi) in self._ranges:
            target = self._cum_work[rlo] + self.WAVE1_FRAC * (
                self._cum_work[rhi] - self._cum_work[rlo])
            w = int(np.searchsorted(self._cum_work, target, side="left"))
            self._wave_splits.append(min(max(w, rlo), rhi))
        # caches the giant routes reach through the base class
        # (_iter_carry_scores -> _iter_segmented_giants/_seg_giant_chunks,
        # _iter_wavefront_scores -> _held_giants, _iter_carry_series ->
        # _carry_chunks)
        self._carry_packs = {}
        self._stream_packs = {}
        self._dev_stream = {}
        self._seg_packs = {}
        self._dev_seg = {}
        self._dev_giants = None
        self._wave1_chunks = None
        # wave-2 pack cache: two entries, keyed by the assigned ranges —
        # steady-state query streams (speeds within SPEED_DRIFT of the
        # ones that produced the cached assignment) reuse the packed
        # chunks instead of re-decoding + re-packing ~3/4 of the shard
        self._wave2_cache: dict[tuple, list] = {}
        self._assign_speeds: np.ndarray | None = None
        self._derived = {}

    def _load_units(self, lo: int, hi: int, *, keep_giants: bool):
        """Decode [lo, hi)'s units; NORMAL units go to (ids, seqs);
        giants are kept as this host's giant-route work only when it is
        the static owner."""
        symtype = self.params.symtype
        um = self.unit_meta
        ids = np.nonzero(
            (um[:, 0] >= lo) & (um[:, 0] < hi))[0].astype(np.int64)
        seqs = [u.codes for u in self.db.search_units(symtype, (lo, hi))]
        if len(seqs) != len(ids):
            raise RuntimeError("the database's units changed under the "
                               "engine")
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        giant = np.nonzero(lens > self._max_cols)[0]
        normal = np.nonzero(lens <= self._max_cols)[0]
        if keep_giants:
            self._giant_ids = ids[giant]
            self._giant_seqs = [seqs[i] for i in giant]
        return ids[normal], [seqs[i] for i in normal]

    def _held_unit(self, u: int):
        """Unit ``u``'s codes where this host decoded them at init (its
        shard's normal units and its giants), else None."""
        for ids, seqs in ((self._own_ids, self._own_seqs),
                          (self._giant_ids, self._giant_seqs)):
            i = int(np.searchsorted(ids, u))
            if i < len(ids) and ids[i] == u:
                return seqs[i]
        return None

    def _units_for_range(self, lo: int, hi: int):
        """NORMAL units of [lo, hi): served from the shard decode done at
        init when the range lies inside this host's static shard (the
        common case — wave 1 and the static wave 2), decoded on demand
        only for ranges taken from OTHER hosts' shards."""
        olo, ohi = self._own_range
        if lo >= olo and hi <= ohi:
            i0 = int(np.searchsorted(self._own_seqnos, lo, side="left"))
            i1 = int(np.searchsorted(self._own_seqnos, hi, side="left"))
            return self._own_ids[i0:i1], self._own_seqs[i0:i1]
        return self._load_units(lo, hi, keep_giants=False)

    def _pack_ranges(self, pieces: list[tuple[int, int]]):
        """Lane-pack the NORMAL units of a list of seqno ranges."""
        all_ids, all_seqs = [], []
        for (lo, hi) in pieces:
            ids, seqs = self._units_for_range(lo, hi)
            all_ids.append(ids)
            all_seqs.extend(seqs)
        ids = np.concatenate(all_ids) if all_ids else \
            np.zeros(0, dtype=np.int64)
        return pack_stream(all_seqs, nseqs=self._nseqs_local,
                           max_cols=self._max_cols, seqnos=ids)

    def _local_wave1(self):
        if self._wave1_chunks is None:
            lo, _ = self._ranges[self._pid]
            self._wave1_chunks = self._pack_ranges(
                [(lo, self._wave_splits[self._pid])])
        return self._wave1_chunks

    def _wave2_for(self, mine):
        """Packed chunks for this host's wave-2 ranges, LRU-cached.

        Holds TWO entries so skew oscillating around REBALANCE_TOL
        (static assignment <-> one dynamic assignment) stays cached
        instead of re-packing ~3/4 of the shard per flip; a cache hit
        refreshes LRU position so the alternation partner survives."""
        key = tuple(mine)
        wave2 = self._wave2_cache.get(key)
        if wave2 is None:
            wave2 = self._pack_ranges(mine)
            self._wave2_cache[key] = wave2
            while len(self._wave2_cache) > 2:
                self._wave2_cache.pop(next(iter(self._wave2_cache)))
        else:
            self._wave2_cache[key] = self._wave2_cache.pop(key)
        return wave2

    # ---- search -------------------------------------------------------------

    def search_batch(self, queries, timings=None):
        hitlists = self._hitlists(queries)
        slots = []
        for query, hits in zip(queries, hitlists):
            for qstrand, qframe, codes in self.query_frames(query):
                slots.append((hits, qstrand, qframe, codes))
        if slots:
            if timings is not None:
                timings.begin()
            self._mh_search(slots, timings)
            if timings is not None:
                timings.end_batch(self.db.symcount_masked(), queries,
                                  self.params.symtype,
                                  self.params.querystrands)
        for hits in hitlists:
            hits.finalize()
        self._mh_align(queries, hitlists)
        return hitlists

    def _slowdown(self) -> float:
        """Seconds to sleep before each local chunk: the JAX package's
        test hooks for the dynamic-balance tests (subprocess CLI runs
        cannot monkeypatch).  SWIPE_TPU_TEST_SLOW_RANK takes a comma list
        of ranks, SWIPE_TPU_TEST_CHUNK_SLEEP one sleep per listed rank
        (the last entry repeats when shorter)."""
        slow_ids = [s for s in os.environ.get(
            "SWIPE_TPU_TEST_SLOW_RANK", "").split(",") if s != ""]
        if str(self._pid) not in slow_ids:
            return 0.0
        sleeps = os.environ.get("SWIPE_TPU_TEST_CHUNK_SLEEP", "0").split(",")
        return float(sleeps[min(slow_ids.index(str(self._pid)),
                                len(sleeps) - 1)])

    def _mh_search(self, slots, timings):
        from ..ops.sw_stream import (build_matrix8, build_matrix_wide,
                                     build_qcodes)
        lpd = self._nseqs_local // self._n_local   # lanes per device
        use_kernel = (self.backend == "stream" and self.matrix.fits_int8
                      and lpd % 1024 == 0)
        qlen_pad = max(128, round_up(max(len(s[3]) for s in slots), 128))
        mode, qlen_pad = _pick_stream_mode(use_kernel, lpd, qlen_pad)
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        mat = (build_matrix8 if self.matrix.fits_int8
               else build_matrix_wide)(self.matrix.matrix)

        def clip(attr):
            return np.asarray([max(min(getattr(s[0], attr), 2**31 - 1),
                                   -2**31) for s in slots], np.int32)

        host = (qc, ql, mat, clip("init_threshold"),
                clip("upperscorethreshold"))
        # each device's copy of the search's inputs, one per device
        # object (a device listed twice shares them)
        args = {}
        for dev in self._devices:
            if dev not in args:
                args[dev] = tuple(torch.from_numpy(x).to(dev) for x in host)
        kbase = max(s[0].keephits for s in slots) + 64
        sleep = self._slowdown()

        def score_chunk(ch):
            if sleep:
                time.sleep(sleep)
            return self._score_chunk(ch, args, mode, lpd, kbase)

        # ---- wave 1: static quarter-shard, timed ----------------------------
        t0 = time.time()
        payloads = [score_chunk(ch) for ch in self._local_wave1()]
        t1 = max(time.time() - t0, 1e-6)
        lo, hi = self._ranges[self._pid]
        w = self._wave_splits[self._pid]
        res1 = float(self._cum_work[w] - self._cum_work[lo])
        # the first batch's wave-1 wall includes building the kernels
        # (once a process); speeds are measured again every batch, so a
        # skewed first assignment corrects itself on the next
        speed = res1 / t1 if res1 > 0 else 0.0

        # ---- rebalance: measured speeds -> deterministic reassignment -------
        speeds = np.array([np.frombuffer(b, np.float64)[0] for b in
                           _allgather_bytes(np.float64(speed).tobytes())])
        speeds = stabilize_speeds(self._assign_speeds, speeds,
                                  self.SPEED_DRIFT)
        self._assign_speeds = speeds
        segments = [(int(self._wave_splits[h]), int(self._ranges[h][1]))
                    for h in range(self._nproc)]
        segments = [(a, b) for a, b in segments if b > a]
        pos = speeds[speeds > 0]
        skewed = pos.size > 1 and pos.max() > self.REBALANCE_TOL * pos.min()
        if skewed:
            mine = assign_ranges(segments, speeds, self._cum_work)[self._pid]
        else:
            mine = [(w, hi)] if hi > w else []
        got = sum(self._cum_work[b] - self._cum_work[a] for a, b in mine)
        print(f"swipe_tpu_torch multihost: rank {self._pid} wave2 residues "
              f"{int(got)} (speed {speed:.0f}/s, "
              f"{'dynamic' if skewed else 'static'})", file=sys.stderr)

        # ---- wave 2: reassigned remainder -----------------------------------
        payloads += [score_chunk(ch) for ch in self._wave2_for(mine)]

        # ---- one exchange of the reduced payloads ---------------------------
        for blob in _allgather_bytes(pickle.dumps(payloads)):
            for payload in pickle.loads(blob):
                self._mh_enter(slots, *payload, timings)
        self._mh_score_giants(slots, qlen_pad, timings,
                              lax=mode == "lax")

    def _score_chunk(self, ch, args, mode, lpd, kbase):
        """One local chunk over the local devices: each scores its lane
        slice, gathers its sequences' scores (columns in reverse tie
        order, padded with unit -1 to a power of two of at least 64),
        counts totalhits / obvious / tiers / cells and keeps its top-k
        in the hit list's tie order (pipeline.chunk_reduce).  Returns
        the host payload (top [NQ, n_local * k], units, totalh [NQ],
        obvious [NQ], n16, n63, cells): the lists concatenated in
        device order, the counters summed."""
        from ..ops.sw_stream import (chunk_tensors, gather_scores,
                                     sw_scores_stream, sw_scores_stream_long)
        p = self.params
        kw = dict(gapopenextend=p.gapopenextend, gapextend=p.gapextend)
        sl7, sl16 = self.matrix.scorelimit_7, self.matrix.scorelimit_16
        dev_of = ch.lane // lpd
        # the unit columns a device gathers, bucketed as the JAX engine
        # buckets its step's signature
        M = max(int(np.bincount(dev_of, minlength=self._n_local).max())
                if len(ch.lane) else 0, 1)
        M = max(64, 1 << (M - 1).bit_length())
        parts = []
        for d, dev in enumerate(self._devices):
            qc, ql, mat, thr, upper = args[dev]
            g = np.nonzero(dev_of == d)[0]
            # reverse tie preference per device: the top-k keeps the
            # highest column among equal scores
            g = g[reverse_tie_order(self.unit_meta[ch.seqnos[g]])]
            eb = np.zeros(M, np.int64)
            ln = np.zeros(M, np.int64)
            un = np.full(M, -1, np.int64)
            eb[: len(g)] = ch.end_block[g]
            ln[: len(g)] = ch.lane[g] - d * lpd
            un[: len(g)] = ch.seqnos[g]
            lanes = slice(d * lpd, (d + 1) * lpd)
            data, start, ebt, lnt = chunk_tensors(
                ch.data_t[lanes], ch.start[:, lanes], eb, ln, dev)
            if mode == "stream":
                out = sw_scores_stream(qc, ql, mat, data, start, **kw)
            elif mode == "stream_long":
                out = sw_scores_stream_long(qc, ql, mat, data, start,
                                            tile_rows=self.LONG_TILE_ROWS,
                                            **kw)
            else:
                out = _scores_lax(qc, ql, mat, data, start, **kw)
            unt = torch.from_numpy(un).to(dev)
            sc = torch.where(unt[None, :] >= 0, gather_scores(out, ebt, lnt),
                             -1)
            vals, idx, totalh, obvious, n16, n63 = chunk_reduce(
                sc, thr, upper, kbase, sl7, sl16)
            parts.append((vals, unt[idx], totalh, obvious, n16, n63))
        host = [[t.cpu().numpy() for t in part] for part in parts]
        cells = len(ch.seqnos) * int(qc.shape[0])
        return (np.concatenate([h[0] for h in host], axis=1),
                np.concatenate([h[1] for h in host], axis=1),
                sum(h[2] for h in host), sum(h[3] for h in host),
                int(sum(h[4] for h in host)), int(sum(h[5] for h in host)),
                cells)

    def _mh_score_giants(self, slots, qlen_pad, timings, *, lax):
        """Chromosome-scale units: the static owner scores its giants on
        the single-host giant routes (``lax``: the carry series at any
        query length, the JAX engine's lax mode), then the per-unit
        score rows — a handful of (units, nslots scores) pairs — ride one
        byte all-gather so every host enters the identical union in rank
        order.  Counters come from the union, so totalhits / obvious /
        tier counts are global.  Collective: every process calls this
        every batch (with an empty payload when it owns no giants)."""
        local = []
        if self._giant_ids.size:
            scored = self._iter_carry_series(slots, qlen_pad, lax=True) \
                if lax else self._iter_carry_scores(slots, qlen_pad)
            local = [(units, np.asarray(sc)) for units, sc in scored]
        for blob in _allgather_bytes(pickle.dumps(local)):
            for units, sc in pickle.loads(blob):
                self._enter_chunk(slots, units, sc, timings)

    def _mh_enter(self, slots, top, units, totalh, obvious, n16, n63,
                  cells, timings):
        for fi, (hits, qstrand, qframe, _) in enumerate(slots):
            u = units[fi]
            # drop padding sentinels AND upper-cutoff-masked entries
            # (both carry score -1, below any real SW score)
            keep = (u >= 0) & (top[fi] >= 0)
            meta = self.unit_meta[u[keep]]
            hits.enter_batch(meta[:, 0], top[fi][keep], qstrand, qframe,
                             meta[:, 1], meta[:, 2],
                             counts=(int(totalh[fi]), int(obvious[fi])))
        if timings is not None:
            # cells = scored units x nslots of this chunk on every device;
            # tier counts are exact globals
            timings.compute[7] += cells
            timings.compute[16] += n16
            timings.compute[63] += n63
            timings.rounds[7] += len(slots)
            if n16:
                timings.rounds[16] += len(slots)
            if n63:
                timings.rounds[63] += len(slots)

    # ---- align --------------------------------------------------------------

    def _mh_align(self, queries, hitlists):
        """Each host fetches the kept hits of the sequences it owns and
        aligns the shown ones (the single-host align phase restricted to
        its shard: one batched hint pass, then the tracebacks); the
        filled hits ride one byte all-gather."""
        lo, hi = self._ranges[self._pid]
        self._align_phase(queries, hitlists, seqnos=(lo, hi))
        payload = [(qi, i, h) for qi, hits in enumerate(hitlists)
                   for i, h in enumerate(hits.hits) if lo <= h.seqno < hi]
        for pid, blob in enumerate(_allgather_bytes(pickle.dumps(payload))):
            if pid == self._pid:
                continue
            for qi, i, h in pickle.loads(blob):
                hitlists[qi].hits[i] = h
