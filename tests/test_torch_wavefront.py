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
