"""The port's stream kernels (plain versions, on the CPU) against the JAX
package: the interpret-mode Pallas kernels, the lax twin and the NumPy
oracle, on the same packs.  Integer DP: every comparison is exact."""

import numpy as np
import pytest
import torch
import torch_row_cases as rc

from swipe_tpu.batching import pack_stream as jax_pack_stream
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.pipeline import _chunk_reduce_impl
from swipe_tpu_torch import trace
from swipe_tpu_torch.ops import sw_stream as tsw
from swipe_tpu_torch.pipeline import chunk_reduce

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


def test_dprofile_plain_matches_jax(m62):
    rng = np.random.default_rng(0)
    db = rng.integers(0, 32, size=(4 * KSEG, 1024)).astype(np.int8)
    m8 = jsw.build_matrix8(m62.matrix)
    want = np.asarray(jsw.build_dprofile_series(m8, db, interpret=True))
    got = tsw.build_dprofile_series(_t(m8), _t(db))
    assert got.shape == (4, 32, KSEG, 1024) and got.dtype == torch.int32
    # the port's [nb, 32, KSEG, NSEQS] is the JAX array's memory order
    assert np.array_equal(got.numpy(), want.reshape(got.shape))
    assert trace.launched("swipe_dprofile") == 0   # CPU: plain version


def test_matrix_and_qcodes_match_jax(m62):
    assert np.array_equal(tsw.build_matrix8(m62.matrix),
                          jsw.build_matrix8(m62.matrix))
    rng = np.random.default_rng(1)
    qs = _rand_seqs(rng, 3, 5, 40)
    for a, b in zip(tsw.build_qcodes(qs, 64), jsw.build_qcodes(qs, 64)):
        assert np.array_equal(a, b)


# (seed, nqueries, query lengths, nseqs, seq lengths, qlen_pad,
#  max_cols, clamp)
CASES = {
    "short_queries": (2, 2, (8, 20), 1100, (1, 90), 32, 65536, None),
    "nq4_mixed": (3, 4, (8, 96), 1100, (1, 60), 96, 65536, None),
    "clamp": (4, 2, (30, 60), 1100, (10, 80), 64, 65536, 40),
    "multi_chunk": (5, 1, (30, 40), 2500, (5, 3 * KSEG), 64, KSEG * 3,
                    None),
    "oversized": (6, 2, (20, 40), 1100, (1, 30), 64, KSEG * 4, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_plain_matches_jax(m62, case):
    seed, nq, qr, n, sr, qlen_pad, max_cols, clamp = CASES[case]
    rng = np.random.default_rng(seed)
    queries = _rand_seqs(rng, nq, *qr)
    seqs = _rand_seqs(rng, n, *sr)
    if case == "oversized":
        seqs[7] = rng.integers(1, 26, size=KSEG * 9 + 3, dtype=np.int8)
    if case == "clamp":
        seqs[0] = queries[0].copy()       # scores far above the clamp
    chunks = jax_pack_stream(seqs, nseqs=1024, max_cols=max_cols)
    if case == "multi_chunk":
        assert len(chunks) > 1
    if case == "oversized":
        assert any(c.n_cols > max_cols for c in chunks)
    qc, ql = jsw.build_qcodes(queries, qlen_pad)
    m8 = jsw.build_matrix8(m62.matrix)
    kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
    got = np.zeros((nq, n), dtype=np.int64)
    for ch in chunks:
        want = np.asarray(jsw.sw_scores_stream(
            qc, ql, m8, ch.data, ch.start, interpret=True, **kw))
        lax = np.asarray(jsw.sw_scores_stream_lax(
            qc, ql, m8, ch.data, ch.start, **kw))
        assert np.array_equal(want, lax)
        data, start, eb, ln = tsw.chunk_tensors(
            ch.data_t, ch.start, ch.end_block, ch.lane, "cpu")
        t8 = _t(m8)
        for dprof in (None, tsw.build_dprofile_series(t8, data)):
            out = tsw.sw_scores_stream(_t(qc), _t(ql), t8, data, start,
                                       dprof=dprof, **kw)
            assert np.array_equal(out.numpy(), want)
        got[:, ch.seqnos] = tsw.gather_scores(out, eb, ln).numpy()
    oracle = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                       for q in queries])
    if clamp is not None:
        oracle = np.minimum(oracle, clamp)
        assert (got == clamp).any()
    assert np.array_equal(got, oracle)
    assert trace.launched("swipe_stream_rows") == 0


@pytest.mark.parametrize("clamp", [None, 60])
@pytest.mark.parametrize("lengths", rc.STREAM_LENGTHS,
                         ids=lambda t: "-".join(map(str, t)))
def test_stream_plain_at_band_edges(m62, lengths, clamp):
    # K2's launches at the card kernel's band edges (bands of 128, 256
    # and 512 rows laid from each query's end, two over 512 rows): query
    # windows planted across strip and band edges, lanes refilled inside
    # the first 32 columns; the plain version against the lax twin
    rng = np.random.default_rng(sum(lengths))
    seqs = _rand_seqs(rng, 80, 50, 120)
    ch = jax_pack_stream(seqs, nseqs=64, max_cols=8 * KSEG)[0]
    start = ch.start.copy()
    start[1, ::5] = 1                   # refills at column 16
    queries = [rng.integers(1, 26, size=n, dtype=np.int8) for n in lengths]
    data_t = ch.data_t.copy()
    assert rc.plant_windows(rng, data_t.T, start, queries, rc.STREAM_EDGES)
    qlen_pad = -(-max(lengths) // 32) * 32
    qc, ql = jsw.build_qcodes(queries, qlen_pad)
    m8 = jsw.build_matrix8(m62.matrix)
    kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
    want = np.asarray(jsw.sw_scores_stream_lax(
        qc, ql, m8, np.ascontiguousarray(data_t.T), start, **kw))
    data, start, _, _ = tsw.chunk_tensors(data_t, start, ch.end_block,
                                          ch.lane, "cpu")
    got = tsw.sw_scores_stream(_t(qc), _t(ql), _t(m8), data, start, **kw)
    assert np.array_equal(got.numpy(), want)
    if clamp is not None:
        assert (want == clamp).any()


def test_stream_band_choice():
    # the card kernel's band: the lowest of STREAM_BANDS that holds
    # qlen_pad (a 200-aa query's 256 rows in a 256-row band), else several
    # of the highest
    for qlen_pad in range(32, 2049, 32):
        band = tsw.stream_band(qlen_pad)
        assert band in tsw.STREAM_BANDS
        fits = [b for b in tsw.STREAM_BANDS if b >= qlen_pad]
        assert band == (min(fits) if fits else max(tsw.STREAM_BANDS))
    assert tsw.stream_band(256) == 256 and tsw.stream_band(257) == 512


def test_gather_scores_matches_jax():
    rng = np.random.default_rng(7)
    out = rng.integers(0, 500, size=(3, 9, 1024)).astype(np.int32)
    eb = rng.integers(0, 9, size=300).astype(np.int32)
    ln = rng.integers(0, 1024, size=300).astype(np.int32)
    want = np.asarray(jsw.gather_scores(out, eb, ln))
    got = tsw.gather_scores(_t(out), _t(eb.astype(np.int64)),
                            _t(ln.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [5, 64, 200])
def test_topk_tie_order_matches_chunk_reduce(k):
    # scores drawn from a handful of values force ties everywhere; the
    # upper cutoff (-u) masks some slots' top scores to -1
    rng = np.random.default_rng(8 + k)
    nq, n = 4, 160
    sc = rng.integers(0, 6, size=(nq, n)).astype(np.int32)
    init_thr = np.array([1, 2, 0, 3], np.int32)
    upper = np.array([2**31 - 1, 4, 3, 2**31 - 1], np.int32)
    got = chunk_reduce(_t(sc), _t(init_thr), _t(upper), k, 2, 4)
    if k < n:
        want = [np.asarray(x) for x in _chunk_reduce_impl(
            sc, init_thr, upper, k, 2, 4)]
    else:
        # the walk keeps every column when k >= n (SearchEngine._walk)
        want = list(map(np.asarray, _chunk_reduce_impl(
            sc, init_thr, upper, n, 2, 4)))
        want[0] = np.where(sc > upper[:, None], -1, sc)
        want[1] = np.broadcast_to(np.arange(n), (nq, n))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert (got[0][:, :-1] == got[0][:, 1:]).any()       # ties happened
