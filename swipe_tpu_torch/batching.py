"""Host-side database batching: LPT lane packing for the stream kernel.

Port of ``swipe_tpu/batching.py`` (``pack_stream``, ``StreamChunk``,
``round_up``).  Packs are byte-identical to the JAX package's, so one pack
can feed both implementations.  The flow and carry packers come with the
flow route and the giant-sequence route.

Sequences are sorted longest-first and each is appended to the currently
shortest lane (longest-processing-time scheduling) in blocks of KSEG
columns; a per-(block, lane) start mask marks where a lane begins a new
sequence — the static-shape equivalent of SWIPE's lane refill machine.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

__all__ = ["StreamChunk", "pack_stream", "round_up", "PAD_SYMBOL",
           "NEG_INF"]

PAD_SYMBOL = 31       # db/query padding symbol; profile row/col forced -128
NEG_INF = -(1 << 30)  # -inf stand-in that survives adds without overflow


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pack_stream_native(seqs, lens, order, seqnos, nseqs: int,
                        max_cols: int, block: int) -> list["StreamChunk"]:
    """pack_stream through the native planner/filler (the port's native.py):
    same LPT plan, chunk splits, member order, and byte layout as the
    Python loop — the fuzz test asserts full equality."""
    from . import native
    max_blocks = max(max_cols // block, 1)
    nchunks, chunk_id, lane, startblk, chunk_nblocks = native.pack_plan(
        lens, order, nseqs, max_blocks, block)
    blob = np.concatenate([np.asarray(s, dtype=np.int8).ravel()
                           for s in seqs]) if len(seqs) else \
        np.zeros(0, dtype=np.int8)
    offs = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    nb_arr = np.maximum(-(-lens // block), 1)
    # flush order within a chunk: lane-major, then placement order
    ord2 = np.lexsort((startblk, lane, chunk_id))
    bounds = np.searchsorted(chunk_id[ord2], np.arange(nchunks + 1))
    chunks: list[StreamChunk] = []
    for c in range(nchunks):
        sel = np.ascontiguousarray(ord2[bounds[c]: bounds[c + 1]])
        ncols = int(chunk_nblocks[c]) * block
        data_t = np.empty((nseqs, ncols), dtype=np.int8)
        start = np.zeros((int(chunk_nblocks[c]), nseqs), dtype=np.int8)
        lane_c = np.ascontiguousarray(lane[sel])
        blk_c = np.ascontiguousarray(startblk[sel])
        native.pack_fill(sel, blob, offs, lane_c, blk_c, block,
                         PAD_SYMBOL, data_t, start)
        chunks.append(StreamChunk(
            data_t, start, np.ascontiguousarray(seqnos[sel]),
            lane_c, (blk_c + nb_arr[sel] - 1).astype(np.int32),
            int(lens[sel].sum())))
    return chunks


@dataclass
class StreamChunk:
    """One lane-packed batch for the stream kernel (ops.sw_stream).

    Packing model = SWIPE's channel machine at block granularity
    (search7.cc:830-957): each of ``nseqs`` lanes holds a
    concatenation of sequences, each padded up to KSEG-column blocks; the
    ``start`` mask marks blocks where a lane begins a new sequence (the
    kernel resets that lane's state there).  Sequence k's score is the
    kernel's per-block dump at (end_block[k], lane[k]).

    data_t:    [nseqs, L] int8, PAD_SYMBOL padded, L multiple of KSEG —
               lane-major so each sequence is one contiguous memcpy at
               pack time; consumers needing the kernel's [L, nseqs] view
               transpose on device (cheap) or use ``.data`` (host copy)
    start:     [L // KSEG, nseqs] int8
    seqnos:    [n] int64 original sequence ids
    lane:      [n] int32
    end_block: [n] int32
    residues:  true residue count (for occupancy accounting)
    """

    data_t: np.ndarray
    start: np.ndarray
    seqnos: np.ndarray
    lane: np.ndarray
    end_block: np.ndarray
    residues: int

    @property
    def data(self) -> np.ndarray:
        """[L, nseqs] host copy (tests / lax paths)."""
        return np.ascontiguousarray(self.data_t.T)

    @property
    def nseqs(self) -> int:
        return self.data_t.shape[0]

    @property
    def n_cols(self) -> int:
        return self.data_t.shape[1]

    @property
    def occupancy(self) -> float:
        return self.residues / (self.data_t.size or 1)


def pack_stream(seqs: list[np.ndarray], nseqs: int = 2048,
                max_cols: int = 65536, block: int = 16,
                seqnos: np.ndarray | None = None) -> list[StreamChunk]:
    """LPT-pack sequences onto ``nseqs`` lanes with block-granular refill.

    Sequences are sorted longest-first and each is appended to the
    currently shortest lane (longest-processing-time scheduling), rounded
    up to ``block`` columns — the static-shape equivalent of SWIPE's
    dynamic lane refill.  Occupancy on real length distributions is
    ~0.95+.  ``max_cols`` caps a chunk's column count; a single sequence
    longer than that still becomes its own (oversized) chunk.
    """
    if seqnos is None:
        seqnos = np.arange(len(seqs), dtype=np.int64)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")

    from . import native
    if native.pack_available() and len(seqs) >= 4096:
        # the C plan+fill (native/packer.cc): byte-identical output
        return _pack_stream_native(seqs, lens, order, seqnos, nseqs,
                                   max_cols, block)

    chunks: list[StreamChunk] = []
    # per-chunk state
    heap = [(0, ln) for ln in range(nseqs)]  # (blocks used, lane)
    members: list[list[int]] = [[] for _ in range(nseqs)]

    def flush():
        nonlocal heap, members
        if not any(members):
            heap = [(0, ln) for ln in range(nseqs)]
            return
        loads = np.zeros(nseqs, dtype=np.int64)
        for used, ln in heap:
            loads[ln] = used
        # bucket the block count (bounded compile-cache shapes), capped
        # at max_blocks so the bucket cannot push a full chunk past the
        # documented max_cols when max_blocks % 8 != 0; oversized-member
        # chunks (loads.max() > max_blocks, see docstring) keep their
        # true height
        nblocks = round_up(int(loads.max()), 8)
        if int(loads.max()) <= max_blocks:
            nblocks = min(nblocks, max_blocks)
        # lane-major build: each sequence lands with ONE contiguous copy
        # ([L, nseqs] column writes are 2KB-strided and ~10x slower)
        data_t = np.full((nseqs, nblocks * block), PAD_SYMBOL,
                         dtype=np.int8)
        start = np.zeros((nblocks, nseqs), dtype=np.int8)
        snos, lanev, endv = [], [], []
        residues = 0
        for ln in range(nseqs):
            row = data_t[ln]
            b = 0
            for si in members[ln]:
                s = seqs[si]
                nb = max(-(-len(s) // block), 1)
                row[b * block: b * block + len(s)] = s
                start[b, ln] = 1
                snos.append(seqnos[si])
                lanev.append(ln)
                endv.append(b + nb - 1)
                residues += len(s)
                b += nb
        chunks.append(StreamChunk(
            data_t, start,
            np.array(snos, dtype=np.int64),
            np.array(lanev, dtype=np.int32),
            np.array(endv, dtype=np.int32),
            residues))
        heap = [(0, ln) for ln in range(nseqs)]
        members = [[] for _ in range(nseqs)]

    max_blocks = max(max_cols // block, 1)
    # a sequence longer than max_cols stretches the whole chunk: raise the
    # cap so OTHER lanes keep filling to the same height (otherwise every
    # other lane would be padding).  The chunk's footprint is still
    # nseqs x longest-member — chromosome-scale sequences belong in
    # pack_stream_carry, which bounds every chunk at nseqs x max_cols.
    chunk_cap = max_blocks
    for si in order:
        nb = max(-(-int(lens[si]) // block), 1)
        used, ln = heap[0]
        if used and used + nb > chunk_cap:
            flush()
            chunk_cap = max_blocks
            used, ln = heap[0]
        chunk_cap = max(chunk_cap, nb)
        heapq.heappushpop(heap, (used + nb, ln))
        members[ln].append(int(si))
    flush()
    return chunks
