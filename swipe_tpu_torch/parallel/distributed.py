"""Multi-device scoring in one process: the MPI master/slave replacement.

Port of ``swipe_tpu/parallel/distributed.py``.  The reference distributes
dynamically over MPI point-to-point messages (master/slave,
swipe.cc:1793-2434): slaves score db chunks, keep a local top-K, and the
master merges the per-slave top-Ks exactly (slaves keep at least K
entries, swipe.cc:2182).  Here a packed chunk is split over a device
mesh's "db" axis (each device scores a disjoint lane range) and, in a
second axis "q", over the queries; every device reduces its scores to a
fixed-size top-k, the per-device lists are gathered to the host in mesh
order and ``merge_topk`` merges them — exact for the same reason the MPI
merge is exact.  The cell counter sums over both axes, the tag_stats
merge (swipe.cc:1978-1992).

One process owns all its local devices, so the JAX module's collectives
(all_gather, psum) become a gather to the host.  Each device's inputs
and scratch are allocated on that device, and its launches run on that
device's current stream, so the devices score concurrently until the
gather.  The scoring is the segment kernel (K9, ops.sw_segmented) or the
stream kernel (K2, ops.sw_stream) on a CUDA device, their plain versions
on the CPU.

Multi-host execution lives in :mod:`.multihost` (``MultiHostEngine``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..pipeline import resolve_device

__all__ = ["Mesh", "local_devices", "make_mesh", "sharded_topk_scores",
           "sharded_stream_topk", "shard_stream_chunk", "merge_topk"]


def local_devices(devices=None) -> list[torch.device]:
    """The devices of a multi-device run: ``devices`` as given (the CPU
    only when asked for), else every visible CUDA device; raises when a
    CUDA device is wanted and there is none (pipeline.resolve_device)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices given")
    return devs


@dataclass(frozen=True)
class Mesh:
    """A [n_db, n_q] grid of devices: ``devices[i][j]`` scores lane shard
    i against query shard j."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = ("db", "q")

    @property
    def shape(self) -> dict[str, int]:
        return {"db": len(self.devices), "q": len(self.devices[0])}


def make_mesh(n_db: int | None = None, n_q: int = 1, devices=None) -> Mesh:
    """A (db, q) mesh over ``devices`` (local_devices: by default every
    visible CUDA device), filled row by row as the JAX module reshapes
    its device list.  One device may stand in several cells: the tests
    build an 8-cell mesh of CPU devices, the card's smoke run two cells
    of one card."""
    devs = local_devices(devices)
    if n_db is None:
        n_db = len(devs) // n_q
    if n_db < 1 or n_q < 1 or n_db * n_q > len(devs):
        raise ValueError(f"a {n_db} x {n_q} mesh needs {n_db * n_q} "
                         f"devices, {len(devs)} given")
    return Mesh(tuple(tuple(devs[i * n_q + j] for j in range(n_q))
                      for i in range(n_db)))


def _shards(n: int, parts: int, what: str) -> list[slice]:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by {parts}")
    m = n // parts
    return [slice(i * m, (i + 1) * m) for i in range(parts)]


def _topk_records(scores: torch.Tensor, units: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One device's top-k of [NQ, n] scores whose columns hold ``units``
    [n] (-1 for empty lanes, whose scores are forced to -1), in
    lax.top_k's order: score desc, then the lowest column.  torch.topk
    promises no order among ties, so each entry's key is (score << 32) |
    (n - 1 - column), unique in its row.  Returns (scores [NQ, k'], units
    [NQ, k']) with k' = min(k, n)."""
    flat = torch.where(units[None, :] >= 0, scores, -1)
    n = flat.shape[1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=flat.device)
    key = torch.topk((flat.to(torch.int64) << 32) | rev, min(k, n),
                     dim=1).values
    return (key >> 32).to(torch.int32), units[n - 1 - (key & 0xFFFFFFFF)]


def _gather(mesh: Mesh, parts) -> tuple[np.ndarray, np.ndarray, int]:
    """The per-device (top, units, cells) of every mesh cell, gathered
    to the host: rows by query shard, columns by lane shard in mesh
    order (the JAX module's tiled all_gather over "db"), cells summed
    over both axes."""
    n_db, n_q = mesh.shape["db"], mesh.shape["q"]
    host = {ij: (t.cpu().numpy(), u.cpu().numpy().astype(np.int32), int(c))
            for ij, (t, u, c) in parts.items()}
    scores = np.concatenate([np.concatenate(
        [host[i, j][0] for i in range(n_db)], axis=1) for j in range(n_q)])
    units = np.concatenate([np.concatenate(
        [host[i, j][1] for i in range(n_db)], axis=1) for j in range(n_q)])
    return scores, units, sum(c for _, _, c in host.values())


def sharded_topk_scores(mesh: Mesh, qpt, db, seg_ids, unit_ids, *,
                        nsegs: int, gapopenextend: int, gapextend: int,
                        k: int):
    """Score a segment-packed chunk over the mesh and gather every
    device's top-k.

    qpt:      [NQ, QLEN, 32] int8 (or int32) profiles — split over "q"
    db:       [L, NSEQS] int8 (batching.pack_database) — lanes over "db"
    seg_ids:  [nblocks + 1] int32 — every device's
    unit_ids: [nsegs, NSEQS] global unit numbers (-1 empty) — like db
    Returns (scores [NQ, n_db * k], units [NQ, n_db * k], cells) on the
    host: ``merge_topk`` merges them; cells counts the valid units times
    the queries over every device."""
    from ..ops import sw_segmented
    qpt, db, seg_ids, unit_ids = (torch.as_tensor(x) for x in
                                  (qpt, db, seg_ids, unit_ids))
    lanes = _shards(db.shape[1], mesh.shape["db"], "lanes")
    rows = _shards(qpt.shape[0], mesh.shape["q"], "queries")
    parts = {}
    for i, row in enumerate(mesh.devices):
        for j, dev in enumerate(row):
            out = sw_segmented.sw_scores_segmented(
                qpt[rows[j]].to(dev), db[:, lanes[i]].contiguous().to(dev),
                seg_ids.to(dev), nsegs=nsegs, gapopenextend=gapopenextend,
                gapextend=gapextend)
            units = unit_ids[:, lanes[i]].reshape(-1).to(dev)
            top, un = _topk_records(out.reshape(out.shape[0], -1), units, k)
            parts[i, j] = (top, un, (units >= 0).sum() * out.shape[0])
    return _gather(mesh, parts)


def merge_topk(scores: np.ndarray, units: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side final merge of gathered per-device top-k lists.

    Sentinel padding entries (unit -1, masked to score -1 on device —
    below any legal SW score) sort last.  Returns
    ``(scores [NQ, kk], units [NQ, kk], counts [NQ])`` where ``counts[i]``
    is the number of REAL entries in row i: row i's results are exactly
    ``scores[i, :counts[i]]`` / ``units[i, :counts[i]]`` and the explicit
    count replaces the old "skip trailing unit<0 entries" convention.
    Entries at or beyond ``counts[i]`` are pinned to score -1 / unit -1.
    """
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(scores, order, axis=1)
    u = np.take_along_axis(units, order, axis=1)
    real = u >= 0
    counts = real.sum(axis=1).astype(np.int64)
    kk = min(k, int(counts.max())) if u.size else 0
    s, u, real = s[:, :kk], u[:, :kk], real[:, :kk]
    # uniform sentinels past each row's count (device masking already
    # guarantees score -1 there, but pin it so the contract is typed,
    # not conventional)
    s = np.where(real, s, -1)
    u = np.where(real, u, -1)
    return s, u, np.minimum(counts, kk)


def shard_stream_chunk(chunk, n_db: int):
    """Split a StreamChunk's per-sequence coordinates per device.

    Lanes are assigned contiguously: device d owns lanes
    [d*nl, (d+1)*nl).  Returns (end_block, lane_local, unit) arrays of
    shape [n_db, M] (padded with unit -1), ready to shard over "db".
    """
    nseqs = chunk.nseqs
    if nseqs % n_db:
        raise ValueError(f"nseqs {nseqs} not divisible by n_db {n_db}")
    nl = nseqs // n_db
    dev = chunk.lane // nl
    groups = [np.nonzero(dev == d)[0] for d in range(n_db)]
    # width >= 1 so an empty chunk still yields well-formed [n_db, 1]
    # sentinel arrays (unit -1) instead of zero-width top_k inputs
    m = max(max(len(g) for g in groups), 1)
    eb = np.zeros((n_db, m), dtype=np.int32)
    ln = np.zeros((n_db, m), dtype=np.int32)
    un = np.full((n_db, m), -1, dtype=np.int32)
    for d, g in enumerate(groups):
        eb[d, : len(g)] = chunk.end_block[g]
        ln[d, : len(g)] = chunk.lane[g] - d * nl
        un[d, : len(g)] = chunk.seqnos[g]
    return eb, ln, un


def sharded_stream_topk(mesh: Mesh, qcodes, qlens, matrix8, db, start,
                        eb, ln, units, *, gapopenextend: int,
                        gapextend: int, k: int):
    """The stream kernel's multi-device step: lanes over "db", queries
    over "q"; each device scores, gathers its sequences' scores and takes
    its top-k, then every list is gathered to the host.

    qcodes/qlens: build_qcodes; matrix8: build_matrix8;
    db/start: a lane-packed chunk (batching.pack_stream: ``.data`` and
    ``.start``), lanes split over "db";
    eb/ln/units: [n_db, M] per-device coordinates (shard_stream_chunk).
    Returns (scores [NQ, n_db * k], units [NQ, n_db * k], cells) on the
    host, as sharded_topk_scores."""
    from ..ops import sw_stream
    qcodes, qlens, matrix8, db, start, eb, ln, units = (
        torch.as_tensor(x) for x in
        (qcodes, qlens, matrix8, db, start, eb, ln, units))
    lanes = _shards(db.shape[1], mesh.shape["db"], "lanes")
    rows = _shards(qcodes.shape[0], mesh.shape["q"], "queries")
    parts = {}
    for i, row in enumerate(mesh.devices):
        for j, dev in enumerate(row):
            out = sw_stream.sw_scores_stream(
                qcodes[rows[j]].to(dev), qlens[rows[j]].to(dev),
                matrix8.to(dev), db[:, lanes[i]].contiguous().to(dev),
                start[:, lanes[i]].contiguous().to(dev),
                gapopenextend=gapopenextend, gapextend=gapextend)
            un = units[i].to(dev)
            sc = sw_stream.gather_scores(out, eb[i].long().to(dev),
                                         ln[i].long().to(dev))
            top, top_un = _topk_records(sc, un, k)
            parts[i, j] = (top, top_un, (un >= 0).sum() * out.shape[0])
    return _gather(mesh, parts)
