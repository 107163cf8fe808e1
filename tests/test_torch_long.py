"""The port's query-tile passes (plain versions, on the CPU) against the
JAX package: the tile kernels in interpret mode pass by pass and chunk by
chunk, the whole tiled scoring against the NumPy oracle, and the hint
pass over 1024 query rows on the hint kernel's route.  Integer DP: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_row_cases as rc
from swipe_tpu.batching import pack_stream, pack_stream_carry
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import align_hint as jah
from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch import trace
from swipe_tpu_torch.ops import align_hint as tah
from swipe_tpu_torch.ops import sw_stream as tsw

KSEG = tsw.KSEG


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread is
    several times faster than a pool contended by other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _rand_seqs(rng, n, lo, hi):
    return [rng.integers(1, 26, size=int(rng.integers(lo, hi)),
                         dtype=np.int8) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def tiled(m62):
    """The shapes of the JAX package's tiled-scoring test: queries of 250,
    40 and 130 rows at qlen_pad 256 in 64-row tiles (tail tiles without
    rows), one 1024-lane chunk."""
    rng = np.random.default_rng(9)
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in (250, 40, 130)]
    seqs = _rand_seqs(rng, 1100, 1, 200)
    chunks = pack_stream(seqs, nseqs=1024)
    qc, ql = jsw.build_qcodes(queries, 256)
    return queries, seqs, chunks, qc, ql, jsw.build_matrix8(m62.matrix)


@pytest.mark.parametrize("clamp", [None, 60])
def test_tile_pass_matches_jax_pass_by_pass(tiled, clamp):
    # each pass from the same planes: the dump everywhere, the planes
    # where the query fills the tile (the TPU walks PAD rows up to a
    # multiple of 4 in a query's last tile)
    _, _, chunks, qc, ql, m8 = tiled
    ch = chunks[0]
    L, nseqs = ch.data.shape
    nb, T = L // KSEG, 64
    db8 = jnp.asarray(ch.data).reshape(L * 8, nseqs // 8)
    start32 = jnp.asarray(ch.start, jnp.int32).reshape(nb, 8, nseqs // 8)
    bh = jnp.zeros((3, nb, KSEG, 8, nseqs // 8), jnp.int32)
    bf = jnp.full_like(bh, tsw.NEG_INF)
    out = jnp.zeros((3, nb, 8, nseqs // 8), jnp.int32)
    args = [_t(a) for a in (qc, ql)]
    for t in range(4):
        tb, tf, to = tsw.tile_planes_from_jax(bh, bf, out)
        got = tsw.stream_tile_pass(
            *args, t, _t(m8), _t(ch.data), _t(ch.start), tb, tf, to,
            gapopenextend=12, gapextend=1, tile_rows=T, clamp=clamp)
        assert got[0] is to and got[1] is tb and got[2] is tf   # in place
        out, bh, bf = jsw._stream_tile_pass(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray([t], jnp.int32),
            jnp.asarray(m8), db8, start32, bh, bf, out, gapopenextend=12,
            gapextend=1, tile_rows=T, clamp=clamp, interpret=True)
        want = tsw.tile_planes_from_jax(out, bh, bf)
        assert torch.equal(got[0], want[0])
        full = torch.from_numpy(ql >= (t + 1) * T)
        assert full.any() or t == 3
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g[full], w[full])
    assert trace.launched("swipe_stream_tile") == 0   # CPU: plain version


def test_tile_pass_matches_jax_at_strip_and_tile_edges(tiled):
    # queries one row into the fourth tile, one strip into the third and
    # inside its second strip (torch_row_cases.tile_lengths at the
    # fixture's 64-row tiles and shapes), lanes holding mutated copies of
    # query windows across those edges: every pass's dump, and the
    # planes where the query fills the tile
    _, _, chunks, _, _, m8 = tiled
    rng = np.random.default_rng(41)
    queries = [rng.integers(1, 26, size=n, dtype=np.int8)
               for n in rc.tile_lengths(64)[:3]]
    qc, ql = jsw.build_qcodes(queries, 256)
    ch = chunks[0]
    data = ch.data.copy()
    assert len(rc.plant_windows(rng, data, ch.start, queries,
                                (16, 64, 128, 144, 151, 192))) >= 40
    L, nseqs = data.shape
    nb, T = L // KSEG, 64
    db8 = jnp.asarray(data).reshape(L * 8, nseqs // 8)
    start32 = jnp.asarray(ch.start, jnp.int32).reshape(nb, 8, nseqs // 8)
    bh = jnp.zeros((3, nb, KSEG, 8, nseqs // 8), jnp.int32)
    bf = jnp.full_like(bh, tsw.NEG_INF)
    out = jnp.zeros((3, nb, 8, nseqs // 8), jnp.int32)
    for t in range(4):
        tb, tf, to = tsw.tile_planes_from_jax(bh, bf, out)
        got = tsw.stream_tile_pass(
            _t(qc), _t(ql), t, _t(m8), _t(data), _t(ch.start), tb, tf, to,
            gapopenextend=12, gapextend=1, tile_rows=T)
        out, bh, bf = jsw._stream_tile_pass(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray([t], jnp.int32),
            jnp.asarray(m8), db8, start32, bh, bf, out, gapopenextend=12,
            gapextend=1, tile_rows=T, clamp=None, interpret=True)
        want = tsw.tile_planes_from_jax(out, bh, bf)
        assert torch.equal(got[0], want[0])
        full = torch.from_numpy(ql >= (t + 1) * T)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g[full], w[full])
    assert int(got[0].max()) > 150       # the planted windows score


def test_stream_long_matches_jax_and_oracle(tiled, m62):
    queries, seqs, chunks, qc, ql, m8 = tiled
    got = np.zeros((3, len(seqs)), dtype=np.int64)
    for ch in chunks:
        out = tsw.sw_scores_stream_long(
            _t(qc), _t(ql), _t(m8), _t(ch.data), _t(ch.start),
            gapopenextend=12, gapextend=1, tile_rows=64)
        want = jsw.sw_scores_stream_long(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(m8),
            jnp.asarray(ch.data), jnp.asarray(ch.start), gapopenextend=12,
            gapextend=1, tile_rows=64, interpret=True)
        assert np.array_equal(out.numpy(), np.asarray(want))
        got[:, ch.seqnos] = tsw.gather_scores(
            out, torch.from_numpy(ch.end_block.astype(np.int64)),
            torch.from_numpy(ch.lane.astype(np.int64))).numpy()
        # the same dump as one pass over all rows (K2's plain version)
        assert torch.equal(out, tsw.sw_scores_stream(
            _t(qc), _t(ql), _t(m8), _t(ch.data), _t(ch.start),
            gapopenextend=12, gapextend=1))
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_carry_long_matches_jax_chunk_by_chunk(m62):
    # the JAX package's tiled-carry shapes: queries of 150 and 40 rows in
    # 64-row tiles, two sequences cut across many 256-column chunks.  The
    # port runs chunk k + 1 from JAX's state after chunk k; the state's
    # rows below qlen must agree
    rng = np.random.default_rng(29)
    queries = [rng.integers(1, 26, size=150, dtype=np.int8),
               rng.integers(1, 26, size=40, dtype=np.int8)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in [1400, 620] + list(rng.integers(1, 120, size=500))]
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=256)
    assert len(chunks) >= 4
    qc, ql = jsw.build_qcodes(queries, 192)
    m8 = jsw.build_matrix8(m62.matrix)
    rowmask = torch.from_numpy(np.arange(192)[None, :, None]
                               < ql[:, None, None]).expand(2, 192, 1024)
    slotmask = torch.from_numpy(np.arange(4)[None, :, None] * 64
                                < np.maximum(ql, 1)[:, None, None]
                                ).expand(2, 4, 1024)
    jstate = jsw.make_stream_state_long(2, 192, 1024, tile_rows=64)
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    for i, ch in enumerate(chunks):
        state = tsw.stream_state_long_from_jax(*jstate)
        last = i == len(chunks) - 1
        kept = tuple(x.clone() for x in state)
        out, *state = tsw.sw_scores_stream_carry_long(
            _t(qc), _t(ql), _t(m8), _t(ch.data), _t(ch.start), *state,
            gapopenextend=12, gapextend=1, tile_rows=64, carry_out=not last)
        wout, *jstate = jsw.sw_scores_stream_carry_long(
            qc, ql, m8, ch.data, ch.start, *jstate, gapopenextend=12,
            gapextend=1, tile_rows=64, interpret=True)
        assert np.array_equal(out.numpy(), np.asarray(wout))
        want = tsw.stream_state_long_from_jax(*jstate)
        if last:        # no carry-out: the state comes back unchanged
            want = kept
        for g, w in zip(state[:2], want[:2]):
            assert torch.equal(g[rowmask], w[rowmask])
        assert torch.equal(state[2], want[2])
        # bh0c's slots that a tile with rows reads (a partial tile's
        # bottom row is the TPU's PAD row)
        assert torch.equal(state[3][slotmask], want[3][slotmask])
        if len(ch.seqnos):
            got[:, ch.seqnos] = np.asarray(jsw.gather_scores(
                out.numpy(), ch.end_block, ch.lane))
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_carry_long_fresh_head_and_compact_width(m62):
    # a series' head without carry-in and compact chunks at a warp's
    # width: the same scores as the oracle over the whole series
    rng = np.random.default_rng(30)
    queries = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (70, 0)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in (900, 500, 33)]
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=128)
    assert chunks[0].nseqs == 3 and len(chunks) > 3
    qc, ql = (_t(a) for a in jsw.build_qcodes(queries, 96))
    m8 = _t(jsw.build_matrix8(m62.matrix))
    state = tsw.make_stream_state_long(2, 96, 32, tile_rows=32)
    for x in state:
        x.fill_(7)                  # garbage: carry_in=False never reads it
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    for i, ch in enumerate(chunks):
        out, *state = tsw.sw_scores_stream_carry_long(
            qc, ql, m8, _t(ch.data), _t(ch.start), *state,
            gapopenextend=12, gapextend=1, tile_rows=32, carry_in=i > 0)
        assert out.shape == (2, ch.data.shape[0] // KSEG, 32)
        if len(ch.seqnos):
            got[:, ch.seqnos] = out.numpy()[:, ch.end_block, ch.lane]
    # the empty slot (as an engine pads a slot group) scores 0
    want = np.stack([sw_numpy_many(queries[0], seqs, m62.matrix, 11, 1),
                     np.zeros(len(seqs), np.int64)])
    assert np.array_equal(got, want)
    assert trace.launched("swipe_stream_tile_carry") == 0


def _nt_hint_jobs(rng, giant):
    """A 1,100-row blastn query and subjects holding mutated copies of
    it; with ``giant`` one subject of 10,000 columns, a segmented giant
    once GIANT_HINT_MIN is cut down."""
    q = rng.integers(1, 5, size=1100, dtype=np.int8)       # nt16 codes

    def copy(n):
        s = q[:n].copy()
        flip = rng.random(n) < 0.1
        s[flip] = rng.integers(1, 5, size=int(flip.sum()), dtype=np.int8)
        return s

    subs = [np.concatenate([rng.integers(1, 5, size=int(rng.integers(
        0, 200)), dtype=np.int8), copy(int(rng.integers(300, 1100)))])
        for _ in range(6)]
    subs.append(rng.integers(1, 5, size=700, dtype=np.int8))
    if giant:
        g = rng.integers(1, 5, size=10000, dtype=np.int8)
        g[6000:6900] = copy(900)
        subs.insert(2, g)
    return q, subs


@pytest.mark.parametrize("giant", [False, True])
def test_hint_over_1024_rows_on_kernel_route(monkeypatch, giant):
    # a bin over 1024 rows reaches the hint kernel (its plain version
    # here, _on_cuda patched) in one launch, a giant's owned-column pieces
    # beside the other subjects; equal to the JAX package's host pass
    m = ScoreMatrix.nucleotide(1, -3, 5, 2)
    rng = np.random.default_rng(40 + giant)
    q, subs = _nt_hint_jobs(rng, giant)
    monkeypatch.setattr(jah, "GIANT_HINT_MIN", 6000)
    monkeypatch.setattr(tah, "GIANT_HINT_MIN", 6000)
    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    launches = []
    kernel = tsw.sw_hint_stream

    def counted(*a, **k):
        launches.append(tuple(a[0].shape))
        return kernel(*a, **k)

    monkeypatch.setattr(tsw, "sw_hint_stream", counted)
    want = jah.hint_endpoints_many(q, subs, m.matrix, 5, 2)
    got = tah.hint_endpoints_grid([(q, subs)], m.matrix, 5, 2,
                                  device="cpu")[0]
    assert got == want
    # one launch of 1,100 rows, the giant's pieces in it
    assert launches == [(1, 1100)]
    if giant:
        assert got[2][0] > 100 and got[2][2] >= 6000
    # with the cap below a warp of either subject alone, the bin stays on
    # the host pass
    cols = tah._launch_dims([[min(subs[:2], key=len)]])[0]
    assert cols == -(-min(map(len, subs[:2])) // KSEG) * KSEG
    monkeypatch.setattr(tah, "_LAUNCH_BYTES", cols * tah.WARP - 1)
    host = trace.counter("hint.lanes_host")
    assert tah.hint_endpoints_grid([(q, subs[:2])], m.matrix, 5, 2,
                                   device="cpu") == [want[:2]]
    assert len(launches) == 1
    assert trace.counter("hint.lanes_host") - host == 2


@pytest.mark.parametrize("warps", [1, 2])
def test_hint_bin_over_scratch_cap_splits_its_lanes(monkeypatch, warps):
    # a bin of 70 subjects over the launch cap (set to ``warps`` warps of
    # its longest subject) runs on several launches of whole warps under
    # the cap, not on the host pass; equal to the JAX package's host pass
    m = ScoreMatrix.nucleotide(1, -3, 5, 2)
    rng = np.random.default_rng(44)
    q, base = _nt_hint_jobs(rng, False)
    subs = [s[:int(rng.integers(1, len(s) + 1))] for s in base * 10]
    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    cap = warps * tah.WARP * tah._launch_dims([[max(subs, key=len)]])[0]
    monkeypatch.setattr(tah, "_LAUNCH_BYTES", cap)
    assert np.prod(tah._launch_dims([subs])) > cap
    launches = []
    kernel = tsw.sw_hint_stream

    def counted(*a, **k):
        launches.append(tuple(a[3].shape))
        return kernel(*a, **k)

    monkeypatch.setattr(tsw, "sw_hint_stream", counted)
    host = trace.counter("hint.lanes_host")
    got = tah.hint_endpoints_grid([(q, subs)], m.matrix, 5, 2,
                                  device="cpu")[0]
    assert got == jah.hint_endpoints_many(q, subs, m.matrix, 5, 2)
    assert len(launches) > 1 and trace.counter("hint.lanes_host") == host
    assert sum(lanes for _, _, lanes in launches) >= len(subs)
    assert all(cols * lanes <= cap for _, cols, lanes in launches)
