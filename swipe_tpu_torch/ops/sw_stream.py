"""Stream Smith-Waterman on lane-packed chunks: the CUDA kernels and their
plain PyTorch versions.

Port of ``swipe_tpu/ops/sw_stream.py``.  Seven kernels, hand-written CUDA
C++ for sm_90a under ``csrc/`` and bound through a plain C interface with
ctypes:

* ``build_dprofile_series`` (``csrc/dprofile.cu``) — the block score
  profiles of a chunk (held by the check phase; no search builds them);
* ``sw_scores_stream`` (``csrc/carry_rows.cu``, a warp a (query, lane),
  bands sized to the query) — exact affine-gap scores of NQ queries
  against every lane of a chunk, dumped per block;
* ``sw_scores_stream_carry`` — the same over one chunk of a flow or
  carry series, with each lane's DP state carried in and out, in one of
  two forms (``carry_form``: by the launch's lanes and matrix), both in
  ``csrc/carry_rows.cu`` with a warp a (query, lane): the flow form
  ``sw_scores_stream_carry_flow`` (K2's blocks and bands sized to the
  query; the flow series) and the row form
  ``sw_scores_stream_carry_rows`` (one-warp blocks; the giant carry
  series and every int32-matrix launch);
* ``sw_hint_stream`` (``csrc/hint.cu``, a warp a (bin, lane)) —
  alignment-endpoint hints with search16s tie rules;
* ``stream_tile_pass`` (``csrc/carry_rows.cu``, a warp a (query, lane)) —
  one query-tile pass of ``sw_scores_stream_long``, the scores of queries
  over one tile;
* ``stream_tile_carry_pass`` (``csrc/carry_rows.cu``, a warp a (query,
  lane)) — the same over one chunk of a carry series
  (``sw_scores_stream_carry_long``).

The carry and hint kernels also take an int32 matrix
(``build_matrix_wide``, scores outside int8) in wide instantiations.

Each wrapper takes its kernel for CUDA tensors and its plain version
(``*_plain``, same module) for CPU tensors, and nothing else: a failed
launch raises.  Each launch counts in ``trace``'s counter
``launch.<C entry>`` (``trace.launched``).

The recurrence, shared by all of them (Q = gapopen + gapextend,
R = gapextend):

    E = max(E_left - R, H_left - Q)    (db-gap chain, along columns)
    F = max(F_up - R, H_up - Q)        (query-gap chain, along rows)
    H = max(diag + profile, E, F, 0)
    S = max(S, H)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, trace
from ..batching import NEG_INF, PAD_SYMBOL

__all__ = ["KSEG", "build_matrix8", "build_matrix_wide", "build_qcodes",
           "chunk_tensors",
           "build_dprofile_series", "build_dprofile_series_plain",
           "sw_scores_stream", "sw_scores_stream_plain", "gather_scores",
           "make_stream_state", "permute_stream_state",
           "stream_state_from_jax", "carry_form", "stream_plan",
           "sw_scores_stream_carry", "sw_scores_stream_carry_flow",
           "sw_scores_stream_carry_rows",
           "sw_scores_stream_carry_plain", "sw_hint_stream",
           "sw_hint_stream_plain", "tile_planes_from_jax",
           "make_stream_state_long", "stream_state_long_from_jax",
           "stream_tile_pass", "stream_tile_pass_plain",
           "sw_scores_stream_long", "stream_tile_carry_pass",
           "stream_tile_carry_pass_plain", "sw_scores_stream_carry_long"]

KSEG = 16   # db columns per block = lane-refill granularity of the packs


def build_matrix8(matrix: np.ndarray) -> np.ndarray:
    """[32, 32] int8 score matrix with the PAD row/column forced to -128."""
    m = np.asarray(matrix, dtype=np.int64)
    if m.min() < -128 or m.max() > 127:
        raise ValueError("score matrix must fit int8 for the stream kernels")
    m8 = m.astype(np.int8).copy()
    m8[PAD_SYMBOL, :] = -128
    m8[:, PAD_SYMBOL] = -128
    return m8


def build_matrix_wide(matrix: np.ndarray) -> np.ndarray:
    """[32, 32] int32 matrix for scores outside int8 (the carry and hint
    kernels' wide instantiations): the PAD row and column only need to be
    strictly negative, so padding never raises a running max."""
    m = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    m32 = m.astype(np.int32).copy()
    pad = int(min(m.min(), -1))
    m32[PAD_SYMBOL, :] = pad
    m32[:, PAD_SYMBOL] = pad
    return m32


def _pad_score(matrix: torch.Tensor) -> int:
    """The score of a PAD row or column: -128 in build_matrix8, the
    matrix minimum (strictly negative) in build_matrix_wide."""
    return min(int(matrix.min()), -1)


def _check_matrix(matrix: torch.Tensor, device) -> bool:
    """Validate an int8 (build_matrix8) or int32 (build_matrix_wide)
    [32, 32] matrix; returns whether it is the wide one."""
    wide = matrix.dtype == torch.int32
    _check("matrix", matrix, torch.int32 if wide else torch.int8, 2, device)
    if tuple(matrix.shape) != (32, 32):
        raise ValueError(f"matrix shape {tuple(matrix.shape)} != (32, 32)")
    return wide


def build_qcodes(queries: list[np.ndarray], qlen_pad: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """([NQ, qlen_pad] int32 codes, [NQ] int32 lengths) for the kernels."""
    nq = len(queries)
    qc = np.full((nq, qlen_pad), PAD_SYMBOL, dtype=np.int32)
    ql = np.zeros((nq,), dtype=np.int32)
    for n, q in enumerate(queries):
        L = len(q)
        if L > qlen_pad:
            raise ValueError(f"query {n} longer than qlen_pad ({L})")
        qc[n, :L] = np.asarray(q, dtype=np.int32)
        ql[n] = L
    return qc, ql


def chunk_tensors(data_t: np.ndarray, start: np.ndarray,
                  end_block: np.ndarray, lane: np.ndarray, device):
    """Device tensors of one stream chunk (either package's packer).

    ``data_t`` is the lane-major [NSEQS, L] plane; it is uploaded as is
    and transposed once on the device, so the kernels read [L, NSEQS]
    with neighbouring lanes at neighbouring addresses.  Returns
    (data [L, NSEQS] int8, start [L // KSEG, NSEQS] int8,
    end_block [n] int64, lane [n] int64)."""
    data = trace.to_device(np.ascontiguousarray(data_t, dtype=np.int8),
                           device).t().contiguous()
    return (data,
            trace.to_device(np.ascontiguousarray(start, dtype=np.int8),
                            device),
            trace.to_device(np.asarray(end_block, dtype=np.int64), device),
            trace.to_device(np.asarray(lane, dtype=np.int64), device))


# ---- binding ---------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "swipe_dprofile": ("dprofile", [_P, _P, _P, ctypes.c_longlong, _I, _P]),
    "swipe_stream_rows": ("carry_rows", [_P] * 8 + [_I] * 9 + [_P]),
    "swipe_hint": ("hint", [_P] * 3 + [_I] + [_P] * 6 + [_I] * 6 + [_P]),
    "swipe_stream_tile": ("carry_rows", [_P] * 8 + [_I] * 10 + [_P]),
    "swipe_stream_tile_carry": ("carry_rows", [_P] * 12 + [_I] * 10 + [_P]),
    "swipe_carry_rows": ("carry_rows", [_P] * 11 + [_I] * 10 + [_P]),
    "swipe_carry_flow": ("carry_rows", [_P] * 11 + [_I] * 10 + [_P]),
    "swipe_wavefront": ("wavefront", [_P] * 4 + [_I] * 2 + [_P] * 5
                        + [_I] * 5 + [_P]),
    "swipe_wavefront_resident": ("wavefront", [_I, _P]),
    "swipe_segment": ("segment", [_P] * 2 + [_I] + [_P] * 5 + [_I] * 8
                      + [_P]),
    "swipe_segment_tiled": ("segment", [_P] * 7 + [_I] * 8 + [_P]),
    "swipe_peak": ("peak", [_P] * 2 + [_I] * 6 + [_P]),
}
_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def _kernel(fn: str):
    """The C entry point ``fn``, building the kernels at first use."""
    if fn not in _FUNCS:
        source, argtypes = _SIGNATURES[fn]
        lib = ctypes.CDLL(_build.kernel_library(source))
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FUNCS[fn] = f
    return _FUNCS[fn]


def _launch(fn: str, device: torch.device, *args) -> None:
    trace.count("launch." + fn)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_dprof(dprof, nblocks: int, nseqs: int, device) -> None:
    if dprof is not None:
        _check("dprof", dprof, torch.int32, 4, device)
        if tuple(dprof.shape) != (nblocks, 32, KSEG, nseqs):
            raise ValueError(f"dprof shape {tuple(dprof.shape)} != "
                             f"{(nblocks, 32, KSEG, nseqs)}")


# ---- K1: block score profiles ---------------------------------------------

def build_dprofile_series_plain(matrix8: torch.Tensor, db: torch.Tensor
                                ) -> torch.Tensor:
    """Plain version of build_dprofile_series."""
    L, nseqs = db.shape
    prof = matrix8.to(torch.int32)[:, db.long()]          # [32, L, NSEQS]
    return prof.view(32, L // KSEG, KSEG, nseqs).permute(1, 0, 2, 3) \
        .contiguous()


def build_dprofile_series(matrix8: torch.Tensor, db: torch.Tensor
                          ) -> torch.Tensor:
    """Block score profiles of a chunk:
    ``out[b, sym, j, lane] = matrix8[sym, db[b * KSEG + j, lane]]``.

    matrix8: [32, 32] int8 (build_matrix8); db: [L, NSEQS] int8 chunk,
    L a multiple of KSEG, NSEQS a multiple of 4, symbols 0..31.  Returns
    [L // KSEG, 32, KSEG, NSEQS] int32 — the memory order of the JAX
    package's [nblocks, 32, KSEG * 8, NSEQS / 8] array, so a ``view``
    turns one into the other: 128 bytes per db byte.  The card's stream
    and carry kernels read no profiles (they stage the query's scores
    from the matrix), so no search builds them; the plain versions still
    take them on the CPU."""
    dev = db.device
    _check("matrix8", matrix8, torch.int8, 2, dev)
    _check("db", db, torch.int8, 2, dev)
    L, nseqs = db.shape
    if tuple(matrix8.shape) != (32, 32):
        raise ValueError(f"matrix8 shape {tuple(matrix8.shape)} != (32, 32)")
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    if dev.type != "cuda":
        return build_dprofile_series_plain(matrix8, db)
    if nseqs % 4:
        raise ValueError(f"NSEQS {nseqs} not a multiple of 4")
    out = torch.empty((L // KSEG, 32, KSEG, nseqs), dtype=torch.int32,
                      device=dev)
    _launch("swipe_dprofile", dev, _ptr(matrix8), _ptr(db), _ptr(out), L,
            nseqs)
    return out



# ---- K2: grouped stream scoring -------------------------------------------

# K2's band heights on the card (32 threads x 4, 8 or 16 rows a thread,
# csrc/carry_rows.cu stream_rows_kernel): a launch takes the lowest that
# holds qlen_pad, or the highest in several bands
STREAM_BANDS = (128, 256, 512)
# the planes between K2's bands, at most this many bytes a launch
_STREAM_PLANE_BYTES = 1 << 30


def stream_band(qlen_pad: int) -> int:
    """K2's band height for a launch of qlen_pad rows."""
    return next((b for b in STREAM_BANDS if qlen_pad <= b), STREAM_BANDS[-1])


def plane_split(nq: int, qlen_pad: int, band: int, L: int, nseqs: int
                ) -> int:
    """The queries a launch of a band walker (K2, K3's flow form, K8,
    K9) takes: all of them when qlen_pad fits one band, else as many as
    keep the planes between bands, [2, step, L, nseqs] int32, within
    _STREAM_PLANE_BYTES (at least one)."""
    if qlen_pad <= band:
        return nq
    return max(1, min(nq, _STREAM_PLANE_BYTES // (8 * L * nseqs)))


def stream_plan(nq: int, qlen_pad: int, L: int, nseqs: int
                ) -> tuple[int, int]:
    """The launches of K2 and K3's flow form for nq queries at qlen_pad
    against an [L, nseqs] chunk: (the band height, stream_band(qlen_pad);
    the queries a launch takes, plane_split).  The kernels' rows a thread
    are the band over 32."""
    band = stream_band(qlen_pad)
    return band, plane_split(nq, qlen_pad, band, L, nseqs)


def _row_shift(h: torch.Tensor, fill: int) -> torch.Tensor:
    """h moved down one query row (dim 1), ``fill`` entering at row 0."""
    top = torch.full_like(h[:, :1], fill)
    return torch.cat([top, h[:, :-1]], dim=1)


def _rows(h, e, p, Q: int, R: int, iota, clamp, top=None):
    """H of one db column over all query rows at once ([NQ, QLEN, lanes]
    tensors), from the previous column's H, this column's E and the
    scores p: F resolves with a weighted prefix max (cummax) instead of
    the kernels' row walk.  Row -1 holds H = 0 and F = -inf, or, with
    ``top`` = (diag, ftop) ([NQ, lanes] each, a query tile's boundary),
    H = diag at the previous column and F = ftop entering row 0.
    Returns (H, the F entering each row)."""
    hd = _row_shift(h, 0) if top is None else \
        torch.cat([top[0][:, None], h[:, :-1]], dim=1)
    hnof = torch.clamp_min(torch.maximum(hd + p, e), 0)
    if clamp is not None:
        hnof = torch.clamp_max(hnof, clamp)
    t = torch.cummax(hnof + iota * R, dim=1).values
    f = _row_shift(t, NEG_INF) - (Q + torch.clamp_min(iota - 1, 0) * R)
    if top is not None:
        f = torch.maximum(f, top[1][:, None] - iota * R)
    h = torch.maximum(hnof, f)
    if clamp is not None:
        h = torch.clamp_max(h, clamp)
    return h, f


def _column(h, e, p, Q: int, R: int, iota, clamp):
    """One db column of the recurrence (after the JAX package's
    _stream_lax_core): (H, E) of the previous column to (H, E) of this
    one."""
    e = torch.maximum(e - R, h - Q)
    return _rows(h, e, p, Q, R, iota, clamp)[0], e


def _stream_plain(qcodes, qlens, matrix8, db, start, state, *, Q: int,
                  R: int, clamp, dprof, carry_in: bool = False):
    """The column loop of both stream kernels' plain versions (after the
    JAX package's _stream_lax_core).  ``state`` is None or the (h, e, s)
    of a series in the kernels' convention: per query row, H at the last
    column and E pre-advanced into the next one (E' = max(E - R, H - Q)).
    It is read when ``carry_in``, else every lane starts fresh at block
    0.  Rows at and past a query's length are no part of the state: they
    start fresh and come back as they went in.  Returns (dump, h, e,
    s)."""
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    dev = db.device
    nblocks = L // KSEG
    iota = torch.arange(qlen_pad, dtype=torch.int32, device=dev)[None, :,
                                                                  None]
    qmask = iota < qlens[:, None, None]                   # [NQ, QLEN, 1]
    qflat = qcodes.long().flatten()
    qprof = matrix8.to(torch.int32)[qcodes.long()]        # [NQ, QLEN, 32]
    pad_pen = _pad_score(matrix8)          # the PAD row of the matrix
    if carry_in:
        h = torch.where(qmask, state[0], 0)
        e = torch.where(qmask, state[1], NEG_INF)
        s = state[2].clone()
    else:
        h = torch.zeros((nq, qlen_pad, nseqs), dtype=torch.int32, device=dev)
        e = torch.full_like(h, NEG_INF)
        s = torch.zeros((nq, nseqs), dtype=torch.int32, device=dev)
    out = torch.empty((nq, nblocks, nseqs), dtype=torch.int32, device=dev)
    for b in range(nblocks):
        reset = start[b] != 0
        h = torch.where(reset, 0, h)
        e = torch.where(reset, NEG_INF, e)
        s = torch.where(reset, 0, s)
        for j in range(KSEG):
            if dprof is None:
                p = qprof.index_select(2, db[b * KSEG + j].long())
            else:                                         # [NQ, QLEN, NSEQS]
                p = dprof[b, :, j].index_select(0, qflat).view(
                    nq, qlen_pad, nseqs)
            p = torch.where(qmask, p, pad_pen)
            h = _rows(h, e, p, Q, R, iota, clamp)[0]
            e = torch.maximum(e - R, h - Q)
            s = torch.maximum(s, h.amax(dim=1))
        out[:, b] = s
    if state is not None:
        h = torch.where(qmask, h, state[0])
        e = torch.where(qmask, e, state[1])
    return out, h, e, s


def sw_scores_stream_plain(qcodes, qlens, matrix8, db, start, *,
                           gapopenextend: int, gapextend: int,
                           clamp: int | None = None, dprof=None
                           ) -> torch.Tensor:
    """Plain version of sw_scores_stream: a column loop with the query
    rows vectorized (after the JAX package's _stream_lax_core)."""
    return _stream_plain(qcodes, qlens, matrix8, db, start, None,
                         Q=gapopenextend, R=gapextend, clamp=clamp,
                         dprof=dprof)[0]


def sw_scores_stream(qcodes: torch.Tensor, qlens: torch.Tensor,
                     matrix8: torch.Tensor, db: torch.Tensor,
                     start: torch.Tensor, *, gapopenextend: int,
                     gapextend: int, clamp: int | None = None,
                     dprof: torch.Tensor | None = None) -> torch.Tensor:
    """Score queries against a lane-packed chunk.

    qcodes:  [NQ, QLEN] int32 query codes, PAD_SYMBOL padded (build_qcodes)
    qlens:   [NQ] int32 true query lengths (<= QLEN)
    matrix8: [32, 32] int8 score matrix (build_matrix8)
    db:      [L, NSEQS] int8 lane-packed chunk (batching.pack_stream,
             chunk_tensors), L a multiple of KSEG
    start:   [L // KSEG, NSEQS] int8 — 1 where a lane begins a new
             sequence at that block
    clamp:   saturate H at this value (the reference's narrow tiers)
    dprof:   the chunk's block profiles (build_dprofile_series), read by
             the plain version only: the card's kernel takes none
    Returns [NQ, L // KSEG, NSEQS] int32: each lane's running max after
    every block; a sequence's score is the value at its end block
    (gather_scores).

    On the card (csrc/carry_rows.cu stream_rows_kernel) a warp takes a
    (query, lane), its threads pipelining the query's rows in bands of
    stream_band(QLEN) rows laid from each query's end, 8 lanes of one
    query a block sharing the band's profile; needs gapopenextend >=
    gapextend.  Timed against the lane form it replaced (a thread a
    (query, lane), with block profiles) at four shapes, it was 2.4 to 15
    times faster (PERF.md)."""
    dev = db.device
    _check("qcodes", qcodes, torch.int32, 2, dev)
    _check("qlens", qlens, torch.int32, 1, dev)
    _check("matrix8", matrix8, torch.int8, 2, dev)
    _check("db", db, torch.int8, 2, dev)
    _check("start", start, torch.int8, 2, dev)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    nblocks = L // KSEG
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    if tuple(start.shape) != (nblocks, nseqs) or qlens.shape[0] != nq \
            or tuple(matrix8.shape) != (32, 32):
        raise ValueError("sw_scores_stream: inconsistent shapes "
                         f"qcodes {tuple(qcodes.shape)} qlens "
                         f"{tuple(qlens.shape)} db {tuple(db.shape)} start "
                         f"{tuple(start.shape)}")
    _check_dprof(dprof, nblocks, nseqs, dev)
    if dev.type != "cuda":
        return sw_scores_stream_plain(
            qcodes, qlens, matrix8, db, start, gapopenextend=gapopenextend,
            gapextend=gapextend, clamp=clamp, dprof=dprof)
    if dprof is not None:
        raise ValueError("the card's K2 takes no block profiles")
    _check_gaps(gapopenextend, gapextend)
    out = torch.zeros((nq, nblocks, nseqs), dtype=torch.int32, device=dev)
    band, step = stream_plan(nq, qlen_pad, L, nseqs)
    # the planes between a query's bands, when it has more than one
    bh = None if qlen_pad <= band else torch.empty(
        (2, step, L, nseqs), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, step):
        q1 = min(nq, q0 + step)
        _launch("swipe_stream_rows", dev, _ptr(qcodes[q0:q1]),
                _ptr(qlens[q0:q1]), _ptr(matrix8), _ptr(db), _ptr(start),
                _ptr(out[q0:q1]), _ptr(None if bh is None else bh[0]),
                _ptr(None if bh is None else bh[1]), q1 - q0, qlen_pad,
                nblocks, nseqs, int(gapopenextend), int(gapextend),
                band // 32, *_clampv(clamp))
    return out


# ---- K3: one chunk of a flow or carry series ------------------------------

def make_stream_state(nq: int, qlen_pad: int, nseqs: int, device=None):
    """Fresh (h, e, s) carry state of a flow or carry series: h/e
    [NQ, QLEN, NSEQS] int32 (the JAX lax twin's lane-flat layout), s
    [NQ, NSEQS] int32."""
    h = torch.zeros((nq, qlen_pad, nseqs), dtype=torch.int32, device=device)
    return (h, torch.full_like(h, NEG_INF),
            torch.zeros((nq, nseqs), dtype=torch.int32, device=device))


def stream_state_from_jax(h, e, s):
    """The JAX carry kernel's state (h/e [NQ, QLEN, SUB, NL], s [NQ, SUB,
    NL]; lane i at (i // NL, i % NL)) in this module's lane-flat layout,
    as CPU tensors.  Takes anything numpy can read."""
    h, e, s = (np.asarray(x, dtype=np.int32) for x in (h, e, s))
    nq, qlen_pad = h.shape[:2]
    return (torch.from_numpy(h.reshape(nq, qlen_pad, -1).copy()),
            torch.from_numpy(e.reshape(nq, qlen_pad, -1).copy()),
            torch.from_numpy(s.reshape(nq, -1).copy()))


def permute_stream_state(h: torch.Tensor, e: torch.Tensor, s: torch.Tensor,
                         carry_src: torch.Tensor):
    """Gather a carry state across lanes by FlowChunk.carry_src: lane i of
    the result holds lane carry_src[i] of the input; lanes with
    carry_src < 0 start fresh in the next chunk (its start mask resets
    them) and read lane 0.  The result has len(carry_src) lanes, so a
    shorter carry_src narrows the state (the flow series' drains)."""
    src = torch.clamp_min(carry_src.long(), 0)
    return h.index_select(2, src), e.index_select(2, src), \
        s.index_select(1, src)


def _pad_to_state_width(db, start, nseqs_state: int):
    """PAD-fill a compact chunk (pack_stream_carry) up to the carry
    state's lane count; the new lanes never start a sequence."""
    L, nseqs = db.shape
    if nseqs < nseqs_state:
        db = torch.cat([db, torch.full((L, nseqs_state - nseqs), PAD_SYMBOL,
                                       dtype=db.dtype, device=db.device)],
                       dim=1)
        start = torch.cat([start, torch.zeros(
            (start.shape[0], nseqs_state - nseqs), dtype=start.dtype,
            device=start.device)], dim=1)
    return db, start


def sw_scores_stream_carry_plain(qcodes, qlens, matrix8, db, start, h, e, s,
                                 *, gapopenextend: int, gapextend: int,
                                 clamp: int | None = None, dprof=None,
                                 carry_in: bool = True,
                                 carry_out: bool = True):
    """Plain version of sw_scores_stream_carry (same contract)."""
    db, start = _pad_to_state_width(db, start, h.shape[2])
    out, h2, e2, s2 = _stream_plain(
        qcodes, qlens, matrix8, db, start, (h, e, s), Q=gapopenextend,
        R=gapextend, clamp=clamp, dprof=dprof, carry_in=carry_in)
    if carry_out:
        h.copy_(h2)
        e.copy_(e2)
        s.copy_(s2)
    return out, h, e, s


# the carry and hint kernels' band height (32 threads x rows a thread),
# by whether the matrix is int32; csrc/rows.cuh Rows<M>::RS (K2's are
# STREAM_BANDS, chosen by the launch's qlen_pad)
ROW_BANDS = {False: 32 * 16, True: 32 * 8}


# the lanes of a carry launch from which K3's flow form scores it: the
# smallest lane count of scripts/row_kernels.py's forms grid (16 queries
# of 200 and of 500 rows, 32 to 2,048 lanes) from which the flow form was
# as fast as the row form at both lengths (PERF.md)
FLOW_LANES = 128


def carry_form(nseqs: int, wide: bool) -> str:
    """Which kernel scores a carry launch of nseqs lanes on the card, both
    in csrc/carry_rows.cu with a warp a (query, lane): "flow" (K2's
    blocks of 8 lanes of one query sharing the band's profile, bands of
    128, 256 or 512 rows by qlen_pad) from FLOW_LANES lanes on (the flow
    series' chunks and drains), else "rows" (one-warp blocks, which
    spread a launch of few pairs over every SM; the giant carry series),
    and "rows" for the int32 matrix, which the flow form does not take.
    Both compute the same function."""
    return "rows" if wide or nseqs < FLOW_LANES else "flow"


def _check_carry(qcodes, qlens, matrix8, db, start, h, e, s, clamp, dprof):
    """Validate a carry call; returns (wide, db, start) with db/start
    PAD-filled to the state's width."""
    dev = db.device
    for name, t, dtype, ndim in (("qcodes", qcodes, torch.int32, 2),
                                 ("qlens", qlens, torch.int32, 1),
                                 ("db", db, torch.int8, 2),
                                 ("start", start, torch.int8, 2),
                                 ("h", h, torch.int32, 3),
                                 ("e", e, torch.int32, 3),
                                 ("s", s, torch.int32, 2)):
        _check(name, t, dtype, ndim, dev)
    wide = _check_matrix(matrix8, dev)
    if wide and (dprof is not None or clamp is not None):
        raise ValueError("block profiles and the clamp are int8-matrix only")
    nq, qlen_pad = qcodes.shape
    nseqs = h.shape[2]
    db, start = _pad_to_state_width(db, start, nseqs)
    L = db.shape[0]
    nblocks = L // KSEG
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    if db.shape[1] != nseqs or tuple(start.shape) != (nblocks, nseqs) \
            or tuple(h.shape) != (nq, qlen_pad, nseqs) \
            or e.shape != h.shape or tuple(s.shape) != (nq, nseqs) \
            or qlens.shape[0] != nq:
        raise ValueError("sw_scores_stream_carry: inconsistent shapes "
                         f"qcodes {tuple(qcodes.shape)} db "
                         f"{tuple(db.shape)} start {tuple(start.shape)} "
                         f"h {tuple(h.shape)} s {tuple(s.shape)}")
    _check_dprof(dprof, nblocks, nseqs, dev)
    return wide, db, start


def _carry_state(h, e, s, carry_in: bool, carry_out: bool):
    """The state a carry kernel updates in place: the state itself, or
    for a series' last chunk a copy (without carry-in, a scratch)."""
    if carry_out:
        return h, e, s
    if carry_in:
        return h.clone(), e.clone(), s.clone()
    return tuple(torch.empty_like(x) for x in (h, e, s))


def _clampv(clamp):
    return int(clamp is not None), int(clamp) if clamp is not None else 0


def sw_scores_stream_carry(qcodes: torch.Tensor, qlens: torch.Tensor,
                           matrix8: torch.Tensor, db: torch.Tensor,
                           start: torch.Tensor, h: torch.Tensor,
                           e: torch.Tensor, s: torch.Tensor, *,
                           gapopenextend: int, gapextend: int,
                           clamp: int | None = None,
                           dprof: torch.Tensor | None = None,
                           carry_in: bool = True, carry_out: bool = True):
    """sw_scores_stream over ONE chunk of a flow or carry series
    (batching.pack_stream_flow / pack_stream_carry), with each lane's DP
    state carried in and out, so a chunk boundary is invisible to the DP.

    matrix8 is int8 (build_matrix8) or, for scores outside int8, int32
    (build_matrix_wide: the kernels' wide instantiations, no profiles).

    h/e: [NQ, QLEN, NSEQS] int32 and s: [NQ, NSEQS] int32 — per query
    row, H at the last column and E pre-advanced into the next one, and
    the running max (make_stream_state for a fresh series;
    permute_stream_state between the chunks of a flow series).  A lane
    whose start bit is set at block 0 ignores the carried state.  Rows
    at and past qlens[q] are no part of the state.
    db/start may be narrower than the state (compact carry chunks): the
    missing lanes are PAD-filled on the device.  ``dprof`` holds the
    profiles at the state's width; the plain version reads them on the
    CPU, and the card's kernels take none.

    With ``carry_out`` the state tensors are updated IN PLACE and
    returned.  Without it they are returned unchanged and must not be
    threaded on (a series' last chunk).  With ``carry_in=False`` every
    lane starts fresh at block 0 and h/e/s are not read (a series' first
    chunk).  Returns (dump [NQ, L // KSEG, NSEQS], h, e, s).

    The call takes one of two forms (carry_form, by the state's lanes and
    the matrix): sw_scores_stream_carry_flow or
    sw_scores_stream_carry_rows, which validate it and, on the CPU, both
    run the plain version.  Scores and state are the JAX package's
    sw_scores_stream_carry (``minter`` and ``ru`` are TPU-only and change
    no result)."""
    fn = sw_scores_stream_carry_flow if carry_form(
        h.shape[2], matrix8.dtype == torch.int32) == "flow" \
        else sw_scores_stream_carry_rows
    return fn(qcodes, qlens, matrix8, db, start, h, e, s,
              gapopenextend=gapopenextend, gapextend=gapextend, clamp=clamp,
              dprof=dprof, carry_in=carry_in, carry_out=carry_out)


def _check_gaps(gapopenextend: int, gapextend: int) -> None:
    """The row-form kernels take F from the cell before the max with F,
    exact when the gap open penalty is at least 0."""
    if gapopenextend < gapextend:
        raise ValueError(f"gapopenextend {gapopenextend} < gapextend "
                         f"{gapextend}: a negative gap open penalty")


def sw_scores_stream_carry_rows(qcodes, qlens, matrix8, db, start, h, e, s,
                                *, gapopenextend: int, gapextend: int,
                                clamp: int | None = None, dprof=None,
                                carry_in: bool = True,
                                carry_out: bool = True):
    """sw_scores_stream_carry on the row form (csrc/carry_rows.cu): one
    warp a (query, lane), the query's rows spread over its threads in
    bands walked in turn.  Same contract; takes no block profiles and
    needs gapopenextend >= gapextend."""
    wide, db, start = _check_carry(qcodes, qlens, matrix8, db, start, h, e,
                                   s, clamp, dprof)
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend, clamp=clamp,
              dprof=dprof, carry_in=carry_in, carry_out=carry_out)
    dev = db.device
    if dev.type != "cuda":
        return sw_scores_stream_carry_plain(qcodes, qlens, matrix8, db,
                                            start, h, e, s, **kw)
    if dprof is not None:
        raise ValueError("the row form takes no block profiles")
    _check_gaps(gapopenextend, gapextend)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    out = torch.zeros((nq, L // KSEG, nseqs), dtype=torch.int32, device=dev)
    hst, est, sio = _carry_state(h, e, s, carry_in, carry_out)
    # the planes between a query's bands, when it has more than one
    bh = bf = None
    if qlen_pad > ROW_BANDS[wide]:
        bh = torch.empty((nq, L, nseqs), dtype=torch.int32, device=dev)
        bf = torch.empty_like(bh)
    _launch("swipe_carry_rows", dev, _ptr(qcodes), _ptr(qlens),
            _ptr(matrix8), _ptr(db), _ptr(start), _ptr(out), _ptr(hst),
            _ptr(est), _ptr(sio), _ptr(bh), _ptr(bf), int(carry_in),
            int(wide), nq, qlen_pad, L // KSEG, nseqs, int(gapopenextend),
            int(gapextend), *_clampv(clamp))
    return out, h, e, s


def sw_scores_stream_carry_flow(qcodes, qlens, matrix8, db, start, h, e, s,
                                *, gapopenextend: int, gapextend: int,
                                clamp: int | None = None, dprof=None,
                                carry_in: bool = True,
                                carry_out: bool = True):
    """sw_scores_stream_carry on the flow form (csrc/carry_rows.cu
    flow_rows_kernel): K2's kernel with the state carried, a warp a
    (query, lane), 8 lanes of one query a block sharing the band's
    profile, bands of stream_band(QLEN) rows laid from each query's end
    (stream_plan).  Same contract; on the card the int8 matrix only, no
    block profiles, and gapopenextend >= gapextend."""
    wide, db, start = _check_carry(qcodes, qlens, matrix8, db, start, h, e,
                                   s, clamp, dprof)
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend, clamp=clamp,
              dprof=dprof, carry_in=carry_in, carry_out=carry_out)
    dev = db.device
    if dev.type != "cuda":
        return sw_scores_stream_carry_plain(qcodes, qlens, matrix8, db,
                                            start, h, e, s, **kw)
    if wide:
        raise ValueError("the flow form takes the int8 matrix only")
    if dprof is not None:
        raise ValueError("the card's K3 takes no block profiles")
    _check_gaps(gapopenextend, gapextend)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    out = torch.zeros((nq, L // KSEG, nseqs), dtype=torch.int32, device=dev)
    hst, est, sio = _carry_state(h, e, s, carry_in, carry_out)
    band, step = stream_plan(nq, qlen_pad, L, nseqs)
    # the planes between a query's bands, when it has more than one
    bh = None if qlen_pad <= band else torch.empty(
        (2, step, L, nseqs), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, step):
        q1 = min(nq, q0 + step)
        _launch("swipe_carry_flow", dev, _ptr(qcodes[q0:q1]),
                _ptr(qlens[q0:q1]), _ptr(matrix8), _ptr(db), _ptr(start),
                _ptr(out[q0:q1]), _ptr(hst[q0:q1]), _ptr(est[q0:q1]),
                _ptr(sio[q0:q1]), _ptr(None if bh is None else bh[0]),
                _ptr(None if bh is None else bh[1]), int(carry_in), q1 - q0,
                qlen_pad, L // KSEG, nseqs, int(gapopenextend),
                int(gapextend), band // 32, *_clampv(clamp))
    return out, h, e, s


# ---- K5, K6: query-tile passes (queries over one tile) -------------------

def _lane_flat(x) -> torch.Tensor:
    """A JAX array [..., SUB, NL] (lane i at (i // NL, i % NL)) as a CPU
    tensor [d0, -1, NSEQS] in this module's lane-flat layout."""
    x = np.asarray(x, dtype=np.int32)
    return torch.from_numpy(
        x.reshape(x.shape[0], -1, x.shape[-2] * x.shape[-1]).copy())


def tile_planes_from_jax(*arrays):
    """The JAX tile kernels' boundary planes [NQ, nblocks, KSEG, SUB, NL]
    and per-block dumps [NQ, nblocks, SUB, NL] in this module's layout
    ([NQ, L, NSEQS] and [NQ, nblocks, NSEQS]), as CPU tensors."""
    return tuple(_lane_flat(a) for a in arrays)


def make_stream_state_long(nq: int, qlen_pad: int, nseqs: int,
                           tile_rows: int = 512, device=None):
    """Fresh (h, e, s, bh0c) carry state of a carry series for queries
    over one tile: h/e [NQ, QLEN, NSEQS] (K3's layout: tile t owns rows
    [t * tile_rows, (t + 1) * tile_rows)), s [NQ, NSEQS] and bh0c
    [NQ, ntiles + 1, NSEQS] (slot t: tile t - 1's bottom-row H at the
    previous chunk's last column; slot 0 stays 0, the row above the
    query)."""
    h, e, s = make_stream_state(nq, qlen_pad, nseqs, device)
    bh0c = torch.zeros((nq, qlen_pad // tile_rows + 1, nseqs),
                       dtype=torch.int32, device=device)
    return h, e, s, bh0c


def stream_state_long_from_jax(h, e, s, bh0c):
    """The JAX tiled-carry state (h/e [NQ, ntiles, T, SUB, NL], s [NQ, SUB,
    NL], bh0c [NQ, ntiles + 1, SUB, NL]) in this module's layout, as CPU
    tensors."""
    return _lane_flat(h), _lane_flat(e), _lane_flat(s)[:, 0], \
        _lane_flat(bh0c)


def _tile_plain(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev,
                carry, *, Q: int, R: int, tile_rows: int, clamp):
    """The column loop of both tile kernels' plain versions (_stream_plain
    over the rows of one query tile, row -1 from the planes).  ``carry``
    is None (K5: the tile's rows start fresh at block 0) or the (h, e, s,
    bh0c) of a carry series (K6).  Updates bh, bf, sprev and the carried
    rows in place, as the kernels do."""
    nq = qcodes.shape[0]
    L, nseqs = db.shape
    dev = db.device
    r0 = tile * tile_rows
    rows = torch.clamp(qlens.long() - r0, 0, tile_rows)          # [NQ]
    # only the rows some query has (past them all is PAD); with none,
    # the planes and the dump stay as they are, except that a carry
    # series' tile 0 still folds the carried S into the dump
    T = int(rows.max()) if nq else 0
    if T == 0 and (carry is None or tile > 0):
        return
    T = max(T, 1)
    iota = torch.arange(T, dtype=torch.int32, device=dev)[None, :, None]
    qmask = iota < rows[:, None, None]                           # [NQ, T, 1]
    has = (rows > 0)[:, None]
    last = torch.clamp_min(rows - 1, 0)[:, None, None].expand(nq, 1, nseqs)
    qt = qcodes[:, r0:r0 + T].long()
    qprof = matrix8.to(torch.int32)[qt]                          # [NQ, T, 32]
    if carry is None:
        h = torch.zeros((nq, T, nseqs), dtype=torch.int32, device=dev)
        e = torch.full_like(h, NEG_INF)
        s = torch.zeros((nq, nseqs), dtype=torch.int32, device=dev)
        bhl = torch.zeros_like(s)
    else:
        hs, es, ss, bh0c = carry
        h = torch.where(qmask, hs[:, r0:r0 + T], 0)
        e = torch.where(qmask, es[:, r0:r0 + T], NEG_INF)
        s = ss.clone() if tile == 0 else torch.zeros_like(ss)
        bhl = bh0c[:, tile].clone()
    for b in range(L // KSEG):
        reset = start[b] != 0
        h = torch.where(reset, 0, h)
        e = torch.where(reset, NEG_INF, e)
        s = torch.where(reset, 0, s)
        # H of row -1 before the block's first column: the previous
        # block's plane, the previous sequence's on a reset lane.  The
        # block's own planes already belong to the new sequence
        diag = torch.where(reset, 0, bhl)
        bhl = bh[:, (b + 1) * KSEG - 1].clone()
        for j in range(KSEG):
            c = b * KSEG + j
            p = torch.where(qmask, qprof.index_select(2, db[c].long()), -128)
            htop = bh[:, c].clone()
            h, f = _rows(h, e, p, Q, R, iota, clamp, top=(diag, bf[:, c]))
            e = torch.maximum(e - R, h - Q)
            s = torch.maximum(s, torch.where(qmask, h, 0).amax(dim=1))
            # the bottom row's H and its F advanced into the next tile;
            # a tile without rows passes the planes through
            hb = torch.gather(h, 1, last)[:, 0]
            fb = torch.maximum(torch.gather(f, 1, last)[:, 0] - R, hb - Q)
            bh[:, c] = torch.where(has, hb, htop)
            bf[:, c] = torch.where(has, fb, bf[:, c])
            diag = htop
        # the merge is per block, with no reset: the earlier passes' dump
        # of a refill block already belongs to the new sequence
        sprev[:, b] = torch.maximum(sprev[:, b], s)
    if carry is not None:
        hs[:, r0:r0 + T] = torch.where(qmask, h, hs[:, r0:r0 + T])
        es[:, r0:r0 + T] = torch.where(qmask, e, es[:, r0:r0 + T])


def _check_tile(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev,
                tile_rows):
    """Validate the arguments the two tile passes share; returns the
    device."""
    dev = db.device
    for name, t, dtype, ndim in (("qcodes", qcodes, torch.int32, 2),
                                 ("qlens", qlens, torch.int32, 1),
                                 ("matrix8", matrix8, torch.int8, 2),
                                 ("db", db, torch.int8, 2),
                                 ("start", start, torch.int8, 2),
                                 ("bh", bh, torch.int32, 3),
                                 ("bf", bf, torch.int32, 3),
                                 ("sprev", sprev, torch.int32, 3)):
        _check(name, t, dtype, ndim, dev)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    nblocks = L // KSEG
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    if tile_rows <= 0 or qlen_pad % tile_rows \
            or not 0 <= tile < qlen_pad // tile_rows:
        raise ValueError(f"tile {tile} of {tile_rows} rows does not divide "
                         f"qlen_pad {qlen_pad}")
    if tuple(start.shape) != (nblocks, nseqs) or qlens.shape[0] != nq \
            or tuple(bh.shape) != (nq, L, nseqs) or bf.shape != bh.shape \
            or tuple(sprev.shape) != (nq, nblocks, nseqs) \
            or tuple(matrix8.shape) != (32, 32):
        raise ValueError("tile pass: inconsistent shapes qcodes "
                         f"{tuple(qcodes.shape)} db {tuple(db.shape)} start "
                         f"{tuple(start.shape)} bh {tuple(bh.shape)} sprev "
                         f"{tuple(sprev.shape)}")
    return dev


def stream_tile_pass_plain(qcodes, qlens, tile, matrix8, db, start, bh, bf,
                           sprev, *, gapopenextend: int, gapextend: int,
                           tile_rows: int, clamp: int | None = None):
    """Plain version of stream_tile_pass (same contract)."""
    _tile_plain(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev, None,
                Q=gapopenextend, R=gapextend, tile_rows=tile_rows,
                clamp=clamp)
    return sprev, bh, bf


def stream_tile_pass(qcodes: torch.Tensor, qlens: torch.Tensor, tile: int,
                     matrix8: torch.Tensor, db: torch.Tensor,
                     start: torch.Tensor, bh: torch.Tensor, bf: torch.Tensor,
                     sprev: torch.Tensor, *, gapopenextend: int,
                     gapextend: int, tile_rows: int,
                     clamp: int | None = None):
    """One query-tile pass of sw_scores_stream_long: query rows
    [tile * tile_rows, (tile + 1) * tile_rows) against a lane-packed
    chunk.

    qcodes/qlens/matrix8/db/start/clamp: as sw_scores_stream, with
    qlen_pad a multiple of tile_rows.  Scores come from the matrix: the
    tile kernel takes no block profiles (they were slower on the card at
    every long shape measured).
    bh/bf:  [NQ, L, NSEQS] int32 — the previous tile's bottom row per
            column: its H, and its F advanced into this tile's top row
            (zeros and NEG_INF for tile 0);
    sprev:  [NQ, L // KSEG, NSEQS] int32 — the previous passes' per-block
            dump (zeros for tile 0).
    All three are updated IN PLACE (this tile's bottom row; the dump
    max-merged with this tile's running max) and returned as (out, bho,
    bfo).  A query that ended in an earlier tile passes the planes
    through and leaves the dump as it was.  Results are the JAX package's
    _stream_tile_pass (the TPU walks PAD rows up to a multiple of 4, so
    the planes of a query's last, partial tile may differ; nothing reads
    them but passes without rows).  On the card (csrc/carry_rows.cu: a
    warp a (query, lane)) it needs gapopenextend >= gapextend."""
    dev = _check_tile(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev,
                      tile_rows)
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend,
              tile_rows=tile_rows, clamp=clamp)
    if dev.type != "cuda":
        return stream_tile_pass_plain(qcodes, qlens, tile, matrix8, db, start,
                                      bh, bf, sprev, **kw)
    _check_gaps(gapopenextend, gapextend)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    _launch("swipe_stream_tile", dev, _ptr(qcodes), _ptr(qlens),
            _ptr(matrix8), _ptr(db), _ptr(start), _ptr(sprev),
            _ptr(bh), _ptr(bf), int(tile), tile_rows,
            nq, qlen_pad, L // KSEG, nseqs, int(gapopenextend),
            int(gapextend), int(clamp is not None),
            int(clamp) if clamp is not None else 0)
    return sprev, bh, bf


def _tile_planes(nq: int, L: int, nseqs: int, device):
    """(bh, bf, out) entering a chunk's tile-0 pass: the zero row above
    the query and an empty dump."""
    bh = torch.zeros((nq, L, nseqs), dtype=torch.int32, device=device)
    return (bh, torch.full_like(bh, NEG_INF),
            torch.zeros((nq, L // KSEG, nseqs), dtype=torch.int32,
                        device=device))


def sw_scores_stream_long(qcodes: torch.Tensor, qlens: torch.Tensor,
                          matrix8: torch.Tensor, db: torch.Tensor,
                          start: torch.Tensor, *, gapopenextend: int,
                          gapextend: int, tile_rows: int = 512,
                          clamp: int | None = None) -> torch.Tensor:
    """sw_scores_stream for queries over one tile: qlen_pad // tile_rows
    passes of stream_tile_pass over the chunk, each carrying its bottom
    row's H and F per column to the next (the JAX package's
    sw_scores_stream_long).  Same contract and result as
    sw_scores_stream."""
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    bh, bf, out = _tile_planes(nq, L, nseqs, db.device)
    for t in range(qlen_pad // tile_rows):
        stream_tile_pass(qcodes, qlens, t, matrix8, db, start, bh, bf, out,
                         gapopenextend=gapopenextend, gapextend=gapextend,
                         tile_rows=tile_rows, clamp=clamp)
    return out


def stream_tile_carry_pass_plain(qcodes, qlens, tile, matrix8, db, start, bh,
                                 bf, sprev, h, e, s, bh0c, *,
                                 gapopenextend: int, gapextend: int,
                                 tile_rows: int, clamp: int | None = None):
    """Plain version of stream_tile_carry_pass (same contract)."""
    _tile_plain(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev,
                (h, e, s, bh0c), Q=gapopenextend, R=gapextend,
                tile_rows=tile_rows, clamp=clamp)
    return sprev, bh, bf, h, e


def stream_tile_carry_pass(qcodes: torch.Tensor, qlens: torch.Tensor,
                           tile: int, matrix8: torch.Tensor,
                           db: torch.Tensor, start: torch.Tensor,
                           bh: torch.Tensor, bf: torch.Tensor,
                           sprev: torch.Tensor, h: torch.Tensor,
                           e: torch.Tensor, s: torch.Tensor,
                           bh0c: torch.Tensor, *, gapopenextend: int,
                           gapextend: int, tile_rows: int,
                           clamp: int | None = None):
    """One query-tile pass over one chunk of a carry series
    (sw_scores_stream_carry_long): stream_tile_pass whose tile rows
    continue a carried state instead of starting fresh.

    h/e:  [NQ, QLEN, NSEQS] int32 — the series' per-row H/E
          (make_stream_state_long); the tile's rows are read at block 0
          and updated IN PLACE;
    s:    [NQ, NSEQS] int32 — the carried running max, read by tile 0
          only (the other tiles fold into the dump);
    bh0c: [NQ, ntiles + 1, NSEQS] int32 — slot ``tile`` is the diagonal
          into this tile's top row at the chunk's first column.
    A lane whose start bit is set at block 0 ignores the carried state.
    db/start have the state's width.  Returns (out, bho, bfo, h, e), all
    updated in place; the tile's bottom-row H at the chunk's last column
    is bho[:, -1].  On the card (csrc/carry_rows.cu: a warp a (query,
    lane)) it needs gapopenextend >= gapextend."""
    dev = _check_tile(qcodes, qlens, tile, matrix8, db, start, bh, bf, sprev,
                      tile_rows)
    for name, t, ndim in (("h", h, 3), ("e", e, 3), ("s", s, 2),
                          ("bh0c", bh0c, 3)):
        _check(name, t, torch.int32, ndim, dev)
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    ntiles = qlen_pad // tile_rows
    if tuple(h.shape) != (nq, qlen_pad, nseqs) or e.shape != h.shape \
            or tuple(s.shape) != (nq, nseqs) \
            or tuple(bh0c.shape) != (nq, ntiles + 1, nseqs):
        raise ValueError("tile carry pass: inconsistent state shapes h "
                         f"{tuple(h.shape)} s {tuple(s.shape)} bh0c "
                         f"{tuple(bh0c.shape)} for qcodes "
                         f"{tuple(qcodes.shape)} db {tuple(db.shape)}")
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend,
              tile_rows=tile_rows, clamp=clamp)
    if dev.type != "cuda":
        return stream_tile_carry_pass_plain(qcodes, qlens, tile, matrix8, db,
                                            start, bh, bf, sprev, h, e, s,
                                            bh0c, **kw)
    _check_gaps(gapopenextend, gapextend)
    _launch("swipe_stream_tile_carry", dev, _ptr(qcodes), _ptr(qlens),
            _ptr(matrix8), _ptr(db), _ptr(start), _ptr(sprev),
            _ptr(bh), _ptr(bf), _ptr(h), _ptr(e), _ptr(s), _ptr(bh0c),
            int(tile), tile_rows, nq, qlen_pad, L // KSEG, nseqs,
            int(gapopenextend), int(gapextend), int(clamp is not None),
            int(clamp) if clamp is not None else 0)
    return sprev, bh, bf, h, e


def sw_scores_stream_carry_long(qcodes: torch.Tensor, qlens: torch.Tensor,
                                matrix8: torch.Tensor, db: torch.Tensor,
                                start: torch.Tensor, h: torch.Tensor,
                                e: torch.Tensor, s: torch.Tensor,
                                bh0c: torch.Tensor, *, gapopenextend: int,
                                gapextend: int, tile_rows: int = 512,
                                clamp: int | None = None,
                                carry_in: bool = True,
                                carry_out: bool = True):
    """sw_scores_stream_carry for queries over one tile: one chunk of a
    carry series in qlen_pad // tile_rows passes of
    stream_tile_carry_pass, the boundary planes carried tile to tile
    within the chunk and the state (h, e, s, bh0c of
    make_stream_state_long) chunk to chunk (the JAX package's
    sw_scores_stream_carry_long).

    db/start may be narrower than the state (compact carry chunks): the
    missing lanes are PAD-filled on the device.  carry_in/carry_out as in
    sw_scores_stream_carry: without carry-out the state comes back
    unchanged (a series' last chunk works on a copy), without carry-in it
    is not read.  Returns (dump [NQ, L // KSEG, NSEQS], h, e, s, bh0c)."""
    nq, qlen_pad = qcodes.shape
    db, start = _pad_to_state_width(db, start, h.shape[2])
    L, nseqs = db.shape
    state = (h, e, s, bh0c)
    if not carry_in:
        fresh = make_stream_state_long(nq, qlen_pad, nseqs, tile_rows,
                                       db.device)
        if carry_out:
            for x, y in zip(state, fresh):
                x.copy_(y)
        else:
            state = fresh
    elif not carry_out:
        state = (h.clone(), e.clone(), s, bh0c)   # s and bh0c are read only
    bh, bf, out = _tile_planes(nq, L, nseqs, db.device)
    bottom = []
    for t in range(qlen_pad // tile_rows):
        stream_tile_carry_pass(qcodes, qlens, t, matrix8, db, start, bh, bf,
                               out, *state, gapopenextend=gapopenextend,
                               gapextend=gapextend, tile_rows=tile_rows,
                               clamp=clamp)
        bottom.append(bh[:, -1].clone())
    if carry_out:
        # after the last pass: tile t + 1 read slot t + 1 at its start
        s.copy_(out[:, -1])
        bh0c[:, 1:] = torch.stack(bottom, dim=1)
    return out, h, e, s, bh0c


def gather_scores(out: torch.Tensor, end_block: torch.Tensor,
                  lane: torch.Tensor) -> torch.Tensor:
    """[NQ, nseq] scores from the per-block dump: out[:, end_block, lane]
    with the per-sequence coordinates of batching.pack_stream."""
    return out[:, end_block, lane]


# ---- K4: endpoint hints ---------------------------------------------------

def sw_hint_stream_plain(qcodes, qlens, matrix8, db, starts, *,
                         gapopenextend: int, gapextend: int):
    """Plain version of sw_hint_stream: a column loop over [NQ, QLEN,
    NSEQS] state (after the JAX package's _hint_lax_impl); the smallest
    row attaining a column's max is taken by an explicit minimum."""
    nq, qlen_pad = qcodes.shape
    _, L, nseqs = db.shape
    dev = db.device
    Q, R = gapopenextend, gapextend
    iota = torch.arange(qlen_pad, dtype=torch.int32, device=dev)[None, :,
                                                                  None]
    rowvalid = iota < qlens[:, None, None]
    qprof = matrix8.to(torch.int32)[qcodes.long()]        # [NQ, QLEN, 32]
    pad_pen = _pad_score(matrix8)
    h = torch.zeros((nq, qlen_pad, nseqs), dtype=torch.int32, device=dev)
    e = torch.full_like(h, NEG_INF)
    S = torch.zeros((nq, nseqs), dtype=torch.int32, device=dev)
    bq = torch.full_like(S, -1)
    bp = torch.zeros_like(S)
    for j in range(L):
        sym = db[:, j].long()[:, None, :].expand(nq, qlen_pad, nseqs)
        p = torch.where(rowvalid, torch.gather(qprof, 2, sym), pad_pen)
        h, e = _column(h, e, p, Q, R, iota, None)
        hv = torch.where(rowvalid, h, 0)
        colmax = hv.amax(dim=1)                           # [NQ, NSEQS]
        rows = torch.where(hv == colmax[:, None], iota, qlen_pad).amin(dim=1)
        improve = (colmax > S) & (j >= starts)
        S = torch.where(improve, colmax, S)
        bp = torch.where(improve, j, bp)
        bq = torch.where(improve, rows, bq)
    return S, bq, bp


def sw_hint_stream(qcodes: torch.Tensor, qlens: torch.Tensor,
                   matrix8: torch.Tensor, db: torch.Tensor,
                   starts: torch.Tensor, *, gapopenextend: int,
                   gapextend: int):
    """Endpoint hints for a batch of query bins, each against its own
    subjects, one subject per lane.

    qcodes: [NQ, QLEN] int32 (build_qcodes), qlens: [NQ] int32,
    matrix8: [32, 32] int8 (build_matrix8) or int32 (build_matrix_wide,
    for scores outside int8: the kernel's wide instantiation),
    db: [NQ, L, NSEQS] int8 — bin q's subject i in
    lane (q, i), PAD_SYMBOL padded; starts: [NQ, NSEQS] int32 per-lane
    first-tracked column (zeros for whole subjects).  Returns
    (S, bestq, bestpos), each [NQ, NSEQS] int32, with search16s tie
    rules: bestpos is the first column attaining the final maximum,
    bestq the smallest query row attaining it there, -1 when the lane
    never scores above 0.  On the card (csrc/hint.cu: a warp a (bin,
    lane)) it needs gapopenextend >= gapextend."""
    dev = db.device
    _check("qcodes", qcodes, torch.int32, 2, dev)
    _check("qlens", qlens, torch.int32, 1, dev)
    wide = _check_matrix(matrix8, dev)
    _check("db", db, torch.int8, 3, dev)
    _check("starts", starts, torch.int32, 2, dev)
    nq, qlen_pad = qcodes.shape
    nqd, L, nseqs = db.shape
    if nqd != nq or qlens.shape[0] != nq \
            or tuple(starts.shape) != (nq, nseqs):
        raise ValueError("sw_hint_stream: inconsistent shapes "
                         f"qcodes {tuple(qcodes.shape)} db "
                         f"{tuple(db.shape)} starts {tuple(starts.shape)}")
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    if dev.type != "cuda":
        return sw_hint_stream_plain(qcodes, qlens, matrix8, db, starts,
                                    gapopenextend=gapopenextend,
                                    gapextend=gapextend)
    _check_gaps(gapopenextend, gapextend)
    outs = [torch.empty((nq, nseqs), dtype=torch.int32, device=dev)
            for _ in range(3)]
    # the rows between a query's bands (H, F, column max, its row), when
    # it has more than one
    planes = torch.empty((nq, L, nseqs, 4), dtype=torch.int32, device=dev) \
        if qlen_pad > ROW_BANDS[wide] else None
    _launch("swipe_hint", dev, _ptr(qcodes), _ptr(qlens), _ptr(matrix8),
            int(wide), _ptr(db), _ptr(starts), *map(_ptr, outs),
            _ptr(planes), nq, qlen_pad, L // KSEG, nseqs,
            int(gapopenextend), int(gapextend))
    return tuple(outs)
