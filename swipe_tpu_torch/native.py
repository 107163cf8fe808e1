"""ctypes bindings to the native C++ host library.

Port of ``swipe_tpu/native.py``.  The library holds the gapped aligner
(region reverse pass + Myers-Miller traceback) and the LPT lane packer,
built from ``native/aligner.cc`` and ``native/packer.cc`` by ``g++`` at
first use (``_build.native_library``; no ``-march=native``, so it runs on
any x86-64 host).  The committed ``native/libswipetpu.so`` is not loaded.
When no library can be built, the NumPy implementations in :mod:`.align`
and :mod:`.batching` are used instead.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_TRIED = False
_MALLOC_TUNED = False


def tune_malloc() -> bool:
    """Keep large allocations on the reusable brk heap (glibc mallopt).

    glibc serves big numpy buffers via mmap and unmaps them on free, so
    every multi-MB temporary pays kernel page faults again on the next
    allocation; on virtualized hosts those faults can dominate the
    host-side phases.  Raising M_MMAP_THRESHOLD keeps those buffers in
    the heap, where freed chunks are reused without refaulting.  Best-effort and idempotent;
    returns True when the knob was applied.  The reference never needs
    this because it mmaps its database once and reuses fixed per-thread
    buffers (database.cc:1342-1349).
    """
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6")
        M_MMAP_THRESHOLD = -3
        _MALLOC_TUNED = bool(libc.mallopt(M_MMAP_THRESHOLD, 1 << 30))
    except (OSError, AttributeError):
        _MALLOC_TUNED = False
    return _MALLOC_TUNED


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from ._build import native_library
    path = native_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.swtpu_align.restype = ctypes.c_long
    lib.swtpu_align.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,   # a, M
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,   # b, N
        ctypes.POINTER(ctypes.c_long),                  # matrix 32x32
        ctypes.c_long, ctypes.c_long,                   # q, r
        ctypes.c_long,                                  # hint flag
        ctypes.POINTER(ctypes.c_long),                  # inout coords[5]
        ctypes.c_char_p, ctypes.c_long,                 # ops buf, cap
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.swtpu_pack_plan.restype = ctypes.c_int64
    lib.swtpu_pack_plan.argtypes = [
        ctypes.c_int64, i64p, i64p,                 # nseq lens order
        ctypes.c_int64, ctypes.c_int64,             # nlanes maxblk
        ctypes.c_int64,                             # block
        i32p, i32p, i64p, i64p,                     # chunk lane blk nb
    ]
    lib.swtpu_pack_fill.restype = None
    lib.swtpu_pack_fill.argtypes = [
        ctypes.c_int64, i64p,                       # nmember seqidx
        i8p, i64p,                                  # blob offs
        i32p, i64p,                                 # lane startblk
        ctypes.c_int64, ctypes.c_int64,             # block ncols
        ctypes.c_int8,                              # pad
        i8p, i8p,                                   # data_t start
        ctypes.c_int64, ctypes.c_int64,             # nlanes nblocks
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def pack_available() -> bool:
    return _load() is not None


def pack_plan(lens: np.ndarray, order: np.ndarray, nlanes: int,
              max_blocks: int, block: int):
    """LPT chunk plan (native/packer.cc swtpu_pack_plan): returns
    (nchunks, chunk_id[nseq], lane[nseq], start_block[nseq],
    chunk_nblocks[nchunks]) — bit-identical to pack_stream's Python
    assignment loop."""
    import ctypes as ct
    lib = _load()
    n = len(lens)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    order64 = np.ascontiguousarray(order, dtype=np.int64)
    chunk_id = np.empty(n, dtype=np.int32)
    lane = np.empty(n, dtype=np.int32)
    startblk = np.empty(n, dtype=np.int64)
    chunk_nblocks = np.empty(max(n, 1), dtype=np.int64)
    p = lambda a, t: a.ctypes.data_as(ct.POINTER(t))
    nchunks = lib.swtpu_pack_plan(
        n, p(lens64, ct.c_int64), p(order64, ct.c_int64),
        nlanes, max_blocks, block,
        p(chunk_id, ct.c_int32), p(lane, ct.c_int32),
        p(startblk, ct.c_int64), p(chunk_nblocks, ct.c_int64))
    return int(nchunks), chunk_id, lane, startblk, chunk_nblocks[:nchunks]


def pack_fill(seqidx: np.ndarray, blob: np.ndarray, offs: np.ndarray,
              lane: np.ndarray, startblk: np.ndarray, block: int,
              pad: int, data_t: np.ndarray, start: np.ndarray) -> None:
    """Fill one chunk's lane-major plane + start mask (swtpu_pack_fill).
    ``seqidx``/``lane``/``startblk`` are the chunk's members in flush
    order; data_t may be uninitialized (every byte is written)."""
    import ctypes as ct
    lib = _load()
    nblocks, nlanes = start.shape
    p = lambda a, t: a.ctypes.data_as(ct.POINTER(t))
    lib.swtpu_pack_fill(
        len(seqidx), p(seqidx, ct.c_int64),
        p(blob, ct.c_int8), p(offs, ct.c_int64),
        p(lane, ct.c_int32), p(startblk, ct.c_int64),
        block, data_t.shape[1], pad,
        p(data_t, ct.c_int8), p(start, ct.c_int8), nlanes, nblocks)


def align(a, b, matrix, q, r, hint=None):
    """Native gapped alignment; same contract as align.align_py."""
    lib = _load()
    a8 = np.ascontiguousarray(np.asarray(a), dtype=np.int8)
    b8 = np.ascontiguousarray(np.asarray(b), dtype=np.int8)
    m64 = np.ascontiguousarray(np.asarray(matrix), dtype=np.int64).reshape(-1)
    coords = np.zeros(5, dtype=np.int64)  # score, ab, bb, ae, be
    if hint is not None:
        coords[0], coords[3], coords[4] = hint
    # op string is <= 2*(M+N): runs of "X<len>" with sum(len) <= M+N and
    # digits(len) <= len.  (The old 16x cap zeroed multi-GB buffers for
    # chromosome-scale subjects on the hint-less blastn -S 2 path.)
    cap = 2 * (len(a8) + len(b8)) + 64
    buf = ctypes.create_string_buffer(cap)
    rc = lib.swtpu_align(
        a8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(a8),
        b8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(b8),
        m64.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        q, r, 1 if hint is not None else 0,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        buf, cap,
    )
    if rc < 0:
        raise RuntimeError("Internal error in align function.")
    return (int(coords[0]), int(coords[1]), int(coords[2]),
            int(coords[3]), int(coords[4]), buf.value.decode())
