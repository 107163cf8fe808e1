"""The port's wavefront kernel (plain version, on the CPU) against the JAX
package's wavefront kernel in interpret mode, segment by segment: each
segment runs in the port from the JAX state left by the one before, and
the H/E of the last column, the running max and the scores must be
equal.  The cases are those of tests/test_sw_wavefront.py: cuts of the
TPU kernel's strips and blocks, a segment cut, a gap across a cut, zero
and one-residue queries; and alignments with a long horizontal gap across
the card kernel's slab edges and a segment cut.  Exact.  Then the card
kernel's slab count for every segment width."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_row_cases as rc

import swipe_tpu.ops.sw_wavefront as JW
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.ops.sw_stream import build_matrix8, build_qcodes
from swipe_tpu_torch import trace
from swipe_tpu_torch.ops import sw_wavefront as TW

KW = dict(gapopenextend=12, gapextend=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _check(queries, seq, m, qlen_pad):
    """Run the JAX kernel segment by segment and the port's wrapper from
    each JAX state; return the port's threaded scores."""
    qc, _ = build_qcodes(queries, qlen_pad)
    mq = TW.build_mq(qc, build_matrix8(m.matrix))
    assert np.array_equal(mq, JW.build_mq(qc, build_matrix8(m.matrix)))
    tmq = torch.from_numpy(mq)
    segs = TW._segments(len(seq))
    padded = np.full(segs[-1][0] + segs[-1][1], 31, np.int8)
    padded[:len(seq)] = seq
    jstate = JW.make_wavefront_state(len(queries), qlen_pad)
    port_in = TW.make_wavefront_state(len(queries), qlen_pad)
    assert all(torch.equal(a, b) for a, b in
               zip(port_in, TW.wavefront_state_from_jax(*jstate)))
    for pos, width in segs:
        db = padded[pos:pos + width]
        jstate = JW.sw_wavefront(mq, jnp.asarray(db), *jstate,
                                 interpret=True, **KW)
        want = TW.wavefront_state_from_jax(*jstate)
        got = TW.sw_wavefront(tmq, torch.from_numpy(db), *port_in, **KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        port_in = tuple(w.clone() for w in want)
    scores = TW.sw_wavefront_scores(tmq, seq, **KW)
    assert np.array_equal(scores.numpy(),
                          np.asarray(jstate[2]).max(axis=(1, 2)))
    assert trace.launched("swipe_wavefront") == 0
    return scores.numpy()


def _oracle(queries, seq, m):
    return np.array([sw_numpy_many(q, [seq], m.matrix, 11, 1)[0]
                     for q in queries])


def test_wavefront_strip_and_block_cuts(m62):
    # hits across the TPU strip cut (1024 columns) and a block cut (128)
    rng = np.random.default_rng(5)
    queries = [rng.integers(1, 26, size=n, dtype=np.int8)
               for n in (50, 23, 64)]
    seq = rng.integers(1, 26, size=2500, dtype=np.int8)
    seq[1000:1050] = queries[0][:50]
    seq[120:143] = queries[1]
    assert np.array_equal(_check(queries, seq, m62, 64),
                          _oracle(queries, seq, m62))


def test_wavefront_segment_cuts(m62, monkeypatch):
    # 2-strip segments: a hit and a gap across segment cuts, and the
    # power-of-two tail segment
    monkeypatch.setattr(TW, "SEG_STRIPS", 2)
    rng = np.random.default_rng(6)
    q = np.concatenate([np.arange(1, 21, dtype=np.int8)] * 2)
    queries = [rng.integers(1, 26, size=50, dtype=np.int8), q]
    seq = rng.integers(1, 26, size=7000, dtype=np.int8)
    seq[2020:2070] = queries[0]               # crosses the cut at 2048
    seq[4076:4096] = q[:20]                   # ends at the cut at 4096
    seq[4106:4126] = q[20:]                   # resumes after a 10-gap
    assert len(TW._segments(len(seq))) == 4
    assert np.array_equal(_check(queries, seq, m62, 64),
                          _oracle(queries, seq, m62))


def test_wavefront_gap_across_slab_edges(m62, monkeypatch):
    # 2-strip segments (the shapes of test_wavefront_segment_cuts): two
    # 64-row queries of the two best-scoring residues whose halves sit
    # either side of a horizontal gap of 270 columns, over [1780, 2050)
    # (the 256-column slab edge at 1792, the segment cut at 2048) and
    # [3830, 4100) (3840, the cut at 4096): E carries the alignment across
    # them
    monkeypatch.setattr(TW, "SEG_STRIPS", 2)
    rng = np.random.default_rng(9)
    best = 1 + np.argsort(-np.diag(m62.matrix)[1:26], kind="stable")[:2]
    queries = [rc.rich_query(rng, 64, best) for _ in range(2)]
    seq = rng.integers(1, 26, size=7000, dtype=np.int8)
    rc.plant_gapped(seq, queries[0], 32, 1780, 270)
    rc.plant_gapped(seq, queries[1], 32, 3830, 270)
    got = _check(queries, seq, m62, 64)
    assert np.array_equal(got, _oracle(queries, seq, m62))
    # the gapped alignment beats either half alone
    for k, cut in enumerate((1900, 3950)):
        halves = _oracle([queries[k]], seq[:cut], m62)[0], \
            _oracle([queries[k]], seq[cut:], m62)[0]
        assert got[k] > max(halves)


def test_wavefront_zero_and_short(m62):
    # a score of 0 and one-residue queries
    q0 = np.array([4], dtype=np.int8)         # C (rare)
    seq = np.full(1024, 10, dtype=np.int8)
    got = _check([q0, np.array([10], np.int8)], seq, m62, 8)
    assert np.array_equal(got, _oracle([q0, np.array([10], np.int8)], seq,
                                       m62))
    assert got[0] == 0


def test_wavefront_shapes():
    mq = torch.zeros((2, 40, 32), dtype=torch.int8)
    with pytest.raises(ValueError):
        TW.sw_wavefront(mq, torch.zeros(16, dtype=torch.int8),
                        *TW.make_wavefront_state(2, 32), **KW)
    with pytest.raises(ValueError):
        TW.sw_wavefront(torch.zeros((1, 1032, 32), dtype=torch.int8),
                        torch.zeros(16, dtype=torch.int8),
                        *TW.make_wavefront_state(1, 1032), **KW)
    assert TW._segments(0) == []
    assert TW._segments(TW.STRIP * TW.SEG_STRIPS + 1) == \
        [(0, TW.STRIP * TW.SEG_STRIPS), (TW.STRIP * TW.SEG_STRIPS, TW.STRIP)]


def test_wavefront_slab_counts():
    # every segment width _segments yields, 1,024 to 262,144 columns,
    # splits into whole slabs of the card kernel; a query's full segment
    # runs on hundreds of blocks
    widths = {width for n in [1] + [1024 << k for k in range(9)] + [300_000]
              for _, width in TW._segments(n)}
    assert widths == {1024 << k for k in range(9)}
    for L in sorted(widths):
        assert TW.wavefront_slabs(L) * TW.SLAB_COLS == L
    assert TW.wavefront_slabs(TW.STRIP * TW.SEG_STRIPS) == 256
    with pytest.raises(ValueError):
        TW.wavefront_slabs(1000)


# ---- the giants' pieces (plan_pieces) ---------------------------------------

def _check_plan(lengths, nq, qlen_pad, V, resident):
    pieces = TW.plan_pieces(lengths, nq, qlen_pad, V, resident)
    for g, n in enumerate(lengths):
        mine = [p for p in pieces if p.giant == g]
        # the owned ranges tile [0, n) in order: every column owned once
        assert [p.own[0] for p in mine] == [0] + [p.own[1]
                                                  for p in mine[:-1]]
        assert mine[-1].own[1] == n
        for i, p in enumerate(mine):
            assert p.own[0] < p.own[1]
            width = p.walk[1] - p.walk[0]
            assert width > 0 and width % TW.SLAB_COLS == 0
            assert p.walk[0] % TW.SLAB_COLS == 0
            assert p.walk[1] >= p.own[1]
            assert p.walk[1] <= -(-n // TW.SLAB_COLS) * TW.SLAB_COLS
            if i == 0:
                assert p.walk[0] == 0
            else:
                # starts at least V before the columns it owns
                assert p.walk[0] <= p.own[0] - V
            if len(mine) > 1:
                assert p.own[1] - p.own[0] >= TW.MIN_PIECE_OVERLAPS * V
    return pieces


@pytest.mark.parametrize("seed", range(6))
def test_plan_pieces_cover_and_overlap(seed):
    rng = np.random.default_rng(seed)
    lengths = [int(n) for n in rng.integers(65_537, 2_000_000,
                                            size=rng.integers(1, 7))]
    qlen_pad = int(rng.choice([64, 256, 384, 512, 1024]))
    nq = int(rng.integers(1, 4))
    resident = int(rng.choice([264, 660, 792]))
    V = 12 * qlen_pad
    pieces = _check_plan(lengths, nq, qlen_pad, V, resident)
    # the fewest pieces whose chains fill the resident blocks, unless
    # the 8-overlap floor holds a giant back
    need = -(-resident * TW.SLAB_LAG // (qlen_pad + 31))
    floor = all(sum(p.giant == g for p in pieces)
                < n // (TW.MIN_PIECE_OVERLAPS * V + TW.SLAB_COLS)
                for g, n in enumerate(lengths))
    if floor:
        assert nq * len(pieces) >= need
        fewer = -(-need // nq) - 1
        assert len(pieces) - len(lengths) < fewer + len(lengths)


def test_plan_pieces_one_a_giant():
    lengths = [1_547_217] * 6
    one = [(g, (0, n), (0, -(-n // 1024) * 1024))
           for g, n in enumerate(lengths)]
    # free gap extension, no card, the chains already fill the card
    assert TW.plan_pieces(lengths, 1, 384, None, 792) == one
    assert TW.plan_pieces(lengths, 1, 384, 4608, None) == one
    assert TW.plan_pieces(lengths, 16, 384, 4608, 792) == one
    assert TW.plan_pieces(lengths, 1, 384, 1 << 62, 792) == one
    # one tblastn query: 78 pieces of 384 rows, 12 of 1,024, overlap
    # under 5% of the frames
    for rows, resident, n in ((384, 792, 78), (1024, 264, 12)):
        pieces = _check_plan(lengths, 1, rows, 12 * rows, resident)
        assert len(pieces) == n
        walked = sum(p.walk[1] - p.walk[0] for p in pieces)
        assert walked / sum(lengths) < 1.05


def test_plan_pieces_exact(m62):
    # max over the planned pieces, each from a fresh state, equals the
    # whole giant's score: a query planted across every cut, a gapped
    # alignment with its gap inside each overlap; walked from the owned
    # columns alone, a straddling alignment is lost
    rng = np.random.default_rng(11)
    best = 1 + np.argsort(-np.diag(m62.matrix)[1:26], kind="stable")[:2]
    queries = [rc.rich_query(rng, 32, best), rc.rich_query(rng, 30, best),
               rng.integers(1, 26, size=17, dtype=np.int8)]
    qlen_pad = 32
    V = 12 * qlen_pad
    lengths = [20_000, 13_000, 9_000]
    pieces = _check_plan(lengths, len(queries), qlen_pad, V, 264)
    assert [sum(p.giant == g for p in pieces) for g in range(3)] == [4, 3, 2]
    giants = [rng.integers(1, 26, size=n, dtype=np.int8) for n in lengths]
    for p in pieces:
        if p.own[0]:
            b, seq = p.own[0], giants[p.giant]
            seq[b - 16:b + 16] = queries[0]
            rc.plant_gapped(seq, queries[1], 15, b - 50, 40)
    qc, _ = build_qcodes(queries, qlen_pad)
    mq = torch.from_numpy(TW.build_mq(qc, build_matrix8(m62.matrix)))
    held = TW.hold_giants(giants, "cpu")
    whole = TW.sw_wavefront_giants_plain(mq, [len(q) for q in queries], held,
                                         overlap=V, **KW)
    for g, seq in enumerate(giants):
        assert np.array_equal(whole[:, g].numpy(),
                              _oracle(queries, seq, m62))

    def walk(lo, hi, g):
        st = TW.make_wavefront_state(len(queries), qlen_pad)
        at = held.starts[g]
        TW.sw_wavefront_plain(mq, held.db[at + lo:at + hi], *st, **KW)
        return st[2]

    pieces_max = torch.zeros_like(whole)
    owned_max = torch.zeros_like(whole)
    for p in pieces:
        pieces_max[:, p.giant] = torch.maximum(pieces_max[:, p.giant],
                                               walk(*p.walk, p.giant))
        owned_max[:, p.giant] = torch.maximum(owned_max[:, p.giant],
                                              walk(*p.own, p.giant))
    assert torch.equal(pieces_max, whole)
    assert (owned_max[:2] < whole[:2]).all()


def test_wavefront_giants_on_the_cpu(m62):
    # the engine's call on the CPU: one piece a giant, the counters
    rng = np.random.default_rng(12)
    queries = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (20, 9)]
    giants = [rng.integers(1, 26, size=n, dtype=np.int8)
              for n in (3000, 1024)]
    giants[0][2000:2020] = queries[0]
    qc, ql = build_qcodes(queries, 32)
    mq = torch.from_numpy(TW.build_mq(qc, build_matrix8(m62.matrix)))
    held = TW.hold_giants(giants, "cpu")
    assert held.starts == (0, 3072) and held.lengths == (3000, 1024)
    assert held.db.shape == (4096,) and (held.db[3000:3072] == 31).all()
    before = trace.counters()
    got = TW.sw_wavefront_giants(mq, ql, held, overlap=384, **KW)
    after = trace.counters()
    assert after.get("wavefront.chains", 0) - \
        before.get("wavefront.chains", 0) == 4
    assert after.get("wavefront.cells_walked", 0) - \
        before.get("wavefront.cells_walked", 0) == 29 * (3072 + 1024)
    for g, seq in enumerate(giants):
        assert np.array_equal(got[:, g].numpy(),
                              _oracle(queries, seq, m62))
    assert trace.launched("swipe_wavefront") == 0
