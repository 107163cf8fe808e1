"""The port's endpoint-hint kernel (plain version, on the CPU) against the
JAX package's interpret-mode hint kernel and its NumPy hint pass, with
forced ties, first-tracked-column masks and gapopenextend > 128.  Exact."""

import numpy as np
import pytest
import torch

import torch_row_cases as rc
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import align_hint as jah
from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu_torch import trace
from swipe_tpu_torch.ops import align_hint as tah
from swipe_tpu_torch.ops import sw_stream as tsw

PAD = 31


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread is
    several times faster than a pool contended by other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bins(rng, nbins, nsub, qlo, qhi, slo, shi, alphabet=(1, 26)):
    """Bins of (query, subjects); repeated and low-complexity subjects
    give equal scores at several endpoints (ties)."""
    jobs = []
    for _ in range(nbins):
        q = rng.integers(*alphabet, size=int(rng.integers(qlo, qhi)),
                         dtype=np.int8)
        subs = []
        for k in range(nsub):
            kind = k % 4
            if kind == 0:      # the query's core repeated: equal maxima
                core = q[: max(3, len(q) // 3)]
                s = np.concatenate([core, rng.integers(
                    *alphabet, size=5, dtype=np.int8), core])
            elif kind == 1:    # low complexity
                s = np.full(int(rng.integers(slo, shi)), q[0], np.int8)
            else:
                s = rng.integers(*alphabet, size=int(rng.integers(slo, shi)),
                                 dtype=np.int8)
            subs.append(s)
        jobs.append((q, subs))
    return jobs


def _dense(jobs, L, lanes=1024):
    db = np.full((len(jobs), L, lanes), PAD, np.int8)
    for b, (_, subs) in enumerate(jobs):
        for j, s in enumerate(subs):
            db[b, :len(s), j] = s
    return db


def _hint_inputs(m, gapopen, gapextend, seed):
    rng = np.random.default_rng(seed)
    jobs = _bins(rng, 2, 40, 8, 40, 1, 45)
    qc, ql = jsw.build_qcodes([q for q, _ in jobs], 48)
    return jobs, qc, ql, _dense(jobs, 48), jsw.build_matrix8(m.matrix), rng


def test_hint_plain_matches_jax_kernel():
    # gapopenextend > 128 and first-tracked-column masks against the
    # JAX package's hint kernel in interpret mode
    gapopen, gapextend = 150, 2
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=gapopen, gapextend=gapextend)
    jobs, qc, ql, db, m8, rng = _hint_inputs(m, gapopen, gapextend, 4)
    starts = np.zeros((2, 1024), np.int32)
    starts[0, 1:40:3] = rng.integers(1, 30, size=len(range(1, 40, 3)))
    Q, R = gapopen + gapextend, gapextend
    want = [np.asarray(x) for x in jsw.sw_hint_stream(
        qc, ql, m8, db, starts, gapopenextend=Q, gapextend=R,
        interpret=True)]
    got = tsw.sw_hint_stream(_t(qc), _t(ql), _t(m8), _t(db), _t(starts),
                             gapopenextend=Q, gapextend=R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert (starts[0] > 0).any() and (got[1].numpy() == -1).any()
    assert trace.launched("swipe_hint") == 0


@pytest.mark.parametrize("lengths", [(15, 40), (16, 17)])
def test_hint_plain_matches_jax_kernel_at_strip_edges(lengths):
    # the hard bins of torch_row_cases at the shapes of the test above:
    # queries one row either side of a strip edge and inside a strip,
    # motif subjects tying at several rows, the query's tail before a
    # first tracked column, empty subjects and lanes
    gapopen, gapextend = 150, 2
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=gapopen, gapextend=gapextend)
    rng = np.random.default_rng(sum(lengths))
    bins, tails = rc.hint_bins(rng, lengths, nsub=1000, maxlen=48)
    starts = rc.hint_starts(rng, bins, tails, 1024)
    qc, ql = jsw.build_qcodes([q for q, _ in bins], 48)
    db = rc.hint_dense(bins, 48, 1024)
    m8 = jsw.build_matrix8(m.matrix)
    Q, R = gapopen + gapextend, gapextend
    want = [np.asarray(x) for x in jsw.sw_hint_stream(
        qc, ql, m8, db, starts, gapopenextend=Q, gapextend=R,
        interpret=True)]
    got = tsw.sw_hint_stream(_t(qc), _t(ql), _t(m8), _t(db), _t(starts),
                             gapopenextend=Q, gapextend=R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert (got[1].numpy() == -1).any() and (got[1].numpy() > 0).any()


@pytest.mark.parametrize("gapopen,gapextend", [(11, 1), (150, 2)])
def test_hint_plain_matches_host_pass(gapopen, gapextend):
    # whole subjects against the JAX package's NumPy pass, ties included
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=gapopen, gapextend=gapextend)
    jobs, qc, ql, db, m8, _ = _hint_inputs(m, gapopen, gapextend, gapopen)
    got = tsw.sw_hint_stream(_t(qc), _t(ql), _t(m8), _t(db),
                             torch.zeros((2, 1024), dtype=torch.int32),
                             gapopenextend=gapopen + gapextend,
                             gapextend=gapextend)
    for b, (q, subs) in enumerate(jobs):
        host = jah.hint_endpoints_many(q, subs, m.matrix, gapopen,
                                       gapextend)
        port = [(int(got[0][b, j]), int(got[1][b, j]), int(got[2][b, j]))
                for j in range(len(subs))]
        assert port == host


def test_hint_grid_route_matches_host_pass(monkeypatch):
    # the kernel route, taken on the CPU with _on_cuda patched, runs the
    # kernel's plain version: bins grouped, padded and unpacked as on the
    # card
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    rng = np.random.default_rng(5)
    jobs = _bins(rng, 3, 12, 10, 50, 1, 90)
    want = [jah.hint_endpoints_many(q, subs, m.matrix, 11, 1)
            for q, subs in jobs]
    # the default route on a CPU device is the NumPy pass
    host = trace.counter("hint.lanes_host")
    assert tah.hint_endpoints_grid(jobs, m.matrix, 11, 1,
                                   device="cpu") == want
    assert trace.counter("hint.lanes_host") - host == 36
    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    lanes = trace.counter("hint.lanes_kernel")
    assert tah.hint_endpoints_grid(jobs, m.matrix, 11, 1,
                                   device="cpu") == want
    assert trace.counter("hint.lanes_kernel") - lanes == 36


def test_hint_host_passes_match_jax():
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    rng = np.random.default_rng(6)
    q, subs = _bins(rng, 1, 16, 10, 40, 1, 60)[0]
    # the entry point on the CPU: one NumPy pass over the bin, and an
    # empty bin without one
    assert tah.hint_endpoints_grid([(q, subs), (q, [])], m.matrix, 11, 1) \
        == [jah.hint_endpoints_many(q, subs, m.matrix, 11, 1), []]


def test_hint_kernel_routes_split_launches_and_single_bin(monkeypatch):
    # on the kernel's plain version: bins cut into several launches under
    # the footprint cap, and a bin over the cap alone in whole warps
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    rng = np.random.default_rng(7)
    jobs = _bins(rng, 4, 10, 10, 40, 1, 70)
    want = [jah.hint_endpoints_many(q, subs, m.matrix, 11, 1)
            for q, subs in jobs]
    calls, kernel = [], tsw.sw_hint_stream

    def counted(*a, **k):
        calls.append(tuple(a[3].shape))
        return kernel(*a, **k)

    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    monkeypatch.setattr(tah, "_LAUNCH_BYTES", 2 * 80 * 32)
    monkeypatch.setattr(tsw, "sw_hint_stream", counted)
    got = tah.hint_endpoints_grid(jobs, m.matrix, 11, 1, device="cpu")
    assert got == want
    # columns round to whole blocks, lanes to a warp: 2 bins a launch
    assert len(calls) == 2 and all(c[1] % 16 == 0 and c[2] == 32
                                   for c in calls)
    # the 40 subjects in one bin of two warps, over a cap of one warp at
    # 80 columns: a warp a launch, the longest lanes first
    cap = 80 * 32
    monkeypatch.setattr(tah, "_LAUNCH_BYTES", cap)
    q = jobs[0][0]
    subs = [s for _, ss in jobs for s in ss]
    cols, lanes = tah._launch_dims([subs])
    assert lanes == 64 and cols * lanes > cap >= cols * 32
    assert tah.hint_endpoints_grid([(q, subs)], m.matrix, 11, 1,
                                   device="cpu") == \
        [jah.hint_endpoints_many(q, subs, m.matrix, 11, 1)]
    assert len(calls) == 4 and calls[2] == (1, cols, 32)
    assert calls[3][2] == 32 and calls[3][1] * 32 <= cap


@pytest.mark.parametrize("gapextend,kernel", [(1, False), (1, True),
                                              (0, False), (0, True)])
def test_giant_hint_pass_matches_jax(monkeypatch, gapextend, kernel):
    # chromosome-scale subjects beside ordinary ones, with GIANT_HINT_MIN
    # cut down: overlapped owned-column pieces (segmentable scoring) or
    # one lane whole (free gap extension: no span bound), on the NumPy
    # pass or on the hint kernel's plain version (``kernel``: _on_cuda
    # patched); two equal copies of the query's core make the endpoint a
    # tie across pieces
    monkeypatch.setattr(jah, "GIANT_HINT_MIN", 600)
    monkeypatch.setattr(tah, "GIANT_HINT_MIN", 600)
    if kernel:
        monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    gapopen = 11 + (gapextend == 0)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=gapopen, gapextend=gapextend)
    rng = np.random.default_rng(8 + gapextend)
    q = rng.integers(1, 26, size=30, dtype=np.int8)
    giants = []
    for n in (6000, 9000):
        s = rng.integers(1, 26, size=n, dtype=np.int8)
        s[2048 - 10: 2048 + 20] = q
        s[5000: 5030] = q
        giants.append(s)
    subs = [giants[0], rng.integers(1, 26, size=70, dtype=np.int8),
            giants[1], np.concatenate([q, q])]
    got = tah.hint_endpoints_grid([(q, subs)], m.matrix, gapopen,
                                  gapextend, device="cpu")[0]
    assert got == jah.hint_endpoints_many(q, subs, m.matrix, gapopen,
                                          gapextend)
    assert got[0][2] == 2048 - 10 + 29          # the first of the tie
    # beside another bin, the same hints
    grid = tah.hint_endpoints_grid([(q, subs), (q, subs[1:2])], m.matrix,
                                   gapopen, gapextend, device="cpu")
    assert grid == [got, got[1:2]]


def test_grid_pieces_ride_one_launch_with_their_bins(monkeypatch):
    # two bins that each mix a chromosome-scale subject with ordinary
    # ones, on the grid's kernel route (the plain version here): the
    # giants' overlapped pieces ride beside the bins' other subjects in
    # one launch, equal to the JAX package's NumPy pass; a piece never takes a column
    # before its first tracked one, though a copy of the query sits
    # there; the lanes count on the kernel route alone
    monkeypatch.setattr(jah, "GIANT_HINT_MIN", 600)
    monkeypatch.setattr(tah, "GIANT_HINT_MIN", 600)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    rng = np.random.default_rng(21)
    jobs = []
    for n, plants in ((6000, (2048 + 5, 4096 + 100)), (7000, (2048 + 40,))):
        q = rng.integers(1, 26, size=30, dtype=np.int8)
        giant = rng.integers(1, 26, size=n, dtype=np.int8)
        for pos in plants:      # the head of a piece another piece owns
            giant[pos:pos + 30] = q
        subs = [rng.integers(1, 26, size=int(k), dtype=np.int8)
                for k in rng.integers(80, 300, size=5)]
        subs[1][40:70] = q
        subs.insert(2, giant)
        jobs.append((q, subs))
    seen = []
    kernel = tsw.sw_hint_stream

    def spy(qc, ql, mat, db, starts, **kw):
        out = kernel(qc, ql, mat, db, starts, **kw)
        free = kernel(qc, ql, mat, db, torch.zeros_like(starts), **kw)
        seen.append((starts, out, free))
        return out

    monkeypatch.setattr(tsw, "sw_hint_stream", spy)
    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    lanes, host = (trace.counter("hint.lanes_kernel"),
                   trace.counter("hint.lanes_host"))
    got = tah.hint_endpoints_grid(jobs, m.matrix, 11, 1, device="cpu")
    # 6 subjects a bin, the giants in 3 and 4 pieces: 17 lanes, all on the
    # kernel route
    assert trace.counter("hint.lanes_kernel") - lanes == 17
    assert trace.counter("hint.lanes_host") == host
    assert got == [jah.hint_endpoints_many(q, subs, m.matrix, 11, 1)
                   for q, subs in jobs]
    assert [r[2][2] for r in got] == [2048 + 5 + 29, 2048 + 40 + 29]
    assert len(seen) == 1                   # both bins, one launch
    starts, (S, bq, bp), (_, fbq, fbp) = seen[0]
    late = starts > 0
    assert int(late.sum()) == 2 + 3
    assert bool(((bq < 0) | (bp >= starts))[late].all())
    # unmasked, a late piece's best lies in the head it does not own
    assert bool(((fbq >= 0) & (fbp < starts))[late].any())
