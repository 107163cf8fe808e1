"""The port's wavefront kernel (plain version, on the CPU) against the JAX
package's wavefront kernel in interpret mode, segment by segment: each
segment runs in the port from the JAX state left by the one before, and
the H/E of the last column, the running max and the scores must be
equal.  The cases are those of tests/test_sw_wavefront.py: cuts of the
TPU kernel's strips and blocks, a segment cut, a gap across a cut, zero
and one-residue queries.  Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swipe_tpu.ops.sw_wavefront as JW
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.ops.sw_stream import build_matrix8, build_qcodes
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
    assert TW.sw_wavefront.launches == 0
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
