"""The port's flow and carry series on the CPU against the JAX package: the
flow and carry packers, and the carry kernel's plain version against the
JAX carry kernel in interpret mode (chunk by chunk, dumps and carried
state) and against its lax twin on larger cases.  Integer DP: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swipe_tpu.batching import pack_stream_carry as jax_pack_stream_carry
from swipe_tpu.batching import pack_stream_flow as jax_pack_stream_flow
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch import trace
from swipe_tpu_torch.batching import PAD_SYMBOL, pack_stream_carry, \
    pack_stream_flow
from swipe_tpu_torch.ops import sw_stream as tsw

KW = dict(gapopenextend=12, gapextend=1)


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seqs(rng, lens):
    return [rng.integers(1, 26, size=int(L), dtype=np.int8) for L in lens]


def _assert_chunks_equal(got, want, fields):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in fields:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert g.residues == w.residues


STREAM_FIELDS = ("data_t", "start", "seqnos", "lane", "end_block")


# (seed, lengths, nseqs, max_cols, drain_cols, oneshot_drain)
FLOW_PACKS = {
    "heavy_tail": (1, (600, 5, 200, [900, 1400, 2000, 2600]), 1024, 256,
                   128, True),
    "progressive_drain": (2, (300, 5, 80, [9000, 4000]), 64, 128, 32,
                          True),
    "no_oneshot": (3, (200, 1, 60, [700, 300]), 16, 64, 16, False),
    "wide_drain": (4, (3000, 5, 40, [500] * 40), 2048, 64, 32, True),
}


@pytest.mark.parametrize("case", sorted(FLOW_PACKS))
def test_pack_stream_flow_identical(case):
    seed, (n, lo, hi, tail), nseqs, max_cols, drain, oneshot = \
        FLOW_PACKS[case]
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(lo, hi, n), tail])
    rng.shuffle(lens)
    seqs = _seqs(rng, lens)
    seqnos = rng.permutation(len(seqs)).astype(np.int64) + 7
    kw = dict(nseqs=nseqs, max_cols=max_cols, drain_cols=drain,
              seqnos=seqnos, oneshot_drain=oneshot)
    got = pack_stream_flow(seqs, **kw)
    want = jax_pack_stream_flow(seqs, **kw)
    _assert_chunks_equal(got, want, STREAM_FIELDS + ("carry_src",))
    widths = {g.nseqs for g in got}
    if case == "wide_drain":
        assert 1024 in widths and 2048 in widths     # a narrowing drain
    assert len(got) > 2


@pytest.mark.parametrize("nseqs,max_cols", [(64, 1024), (1024, 256),
                                            (8, 96)])
def test_pack_stream_carry_identical(nseqs, max_cols):
    rng = np.random.default_rng(nseqs + max_cols)
    seqs = _seqs(rng, [40000, 9000] + list(rng.integers(1, 300, 300)))
    got = pack_stream_carry(seqs, nseqs=nseqs, max_cols=max_cols,
                            seqnos=np.arange(len(seqs)) * 3)
    want = jax_pack_stream_carry(seqs, nseqs=nseqs, max_cols=max_cols,
                                 seqnos=np.arange(len(seqs)) * 3)
    _assert_chunks_equal(got, want, STREAM_FIELDS)
    assert len(got) > 3


def _masked_state(state, ql):
    """(h, e) rows below each query's length, and s: the part of the
    carried state both packages define (the JAX kernel also walks the
    PAD rows up to the next multiple of 4)."""
    h, e, s = state
    rows = torch.arange(h.shape[1])[None, :, None] < _t(ql)[:, None, None]
    return (torch.where(rows, h, 0), torch.where(rows, e, 0), s)


def _assert_state_equal(got, want, ql):
    for g, w in zip(_masked_state(got, ql), _masked_state(want, ql)):
        assert torch.equal(g, w)


def _jax_series(chunks, qc, ql, m8, flow):
    """The JAX carry kernel over a series in interpret mode: per chunk
    the state going in (lane-flat), the dump and the state coming out."""
    out = []
    h = e = s = None
    for i, ch in enumerate(chunks):
        if i == 0:
            h, e, s = jsw.make_stream_state(qc.shape[0], qc.shape[1],
                                            1024 if not flow else ch.nseqs)
        elif flow:
            h, e, s = jsw.permute_stream_state(h, e, s,
                                               jnp.asarray(ch.carry_src))
        state_in = tsw.stream_state_from_jax(h, e, s)
        dump, h, e, s = jsw.sw_scores_stream_carry(
            qc, ql, m8, ch.data, ch.start, h, e, s, interpret=True, **KW)
        out.append((state_in, np.asarray(dump),
                    tsw.stream_state_from_jax(h, e, s)))
    return out


def _port_series(chunks, qc, ql, m8, flow, state_w, dprof=False,
                 jax_states=None):
    """The port's carry wrapper (plain version on the CPU) over the same
    series, threading its own state (and, given the JAX states, checking
    each chunk's state in against them and also running each chunk from
    the JAX state)."""
    t8 = _t(m8)
    scores = {}
    state = None
    for i, ch in enumerate(chunks):
        if i == 0:
            state = tsw.make_stream_state(qc.shape[0], qc.shape[1], state_w)
        elif flow:
            state = tsw.permute_stream_state(*state, _t(ch.carry_src))
        data, start, eb, ln = tsw.chunk_tensors(
            ch.data_t, ch.start, ch.end_block, ch.lane, "cpu")
        dp = None
        if dprof:
            wide, _ = tsw._pad_to_state_width(data, start, state[0].shape[2])
            dp = tsw.build_dprofile_series(t8, wide)
        last = i == len(chunks) - 1
        kw = dict(KW, dprof=dp)
        if jax_states is not None:
            j_in, j_dump, j_out = jax_states[i]
            _assert_state_equal(state, j_in, ql)
            # the port's chunk from the JAX package's state
            copy = tuple(x.clone() for x in j_in)
            d2, *st2 = tsw.sw_scores_stream_carry(
                _t(qc), _t(ql), t8, data, start, *copy, **kw)
            assert np.array_equal(d2.numpy(), j_dump)
            _assert_state_equal(st2, j_out, ql)
        dump, *state = tsw.sw_scores_stream_carry(
            _t(qc), _t(ql), t8, data, start, *state, carry_in=i > 0,
            carry_out=not last, **kw)
        if jax_states is not None:
            assert np.array_equal(dump.numpy(), jax_states[i][1])
        if len(ch.seqnos):
            sc = tsw.gather_scores(dump, eb, ln).numpy()
            for k, sno in enumerate(ch.seqnos):
                scores[int(sno)] = sc[:, k]
    return scores


def _oracle_check(scores, seqs, queries, m62):
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    got = np.stack([scores[i] for i in range(len(seqs))], axis=1)
    assert np.array_equal(got, want)


def test_carry_series_matches_jax_kernel(m62):
    # a compact carry series: giants cut across chunks on the same lane,
    # small sequences refilling lanes behind them
    rng = np.random.default_rng(22)
    queries = _seqs(rng, [21, 40])
    seqs = _seqs(rng, [700, 420] + list(rng.integers(1, 90, 40)))
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=128)
    assert len(chunks) >= 5 and chunks[0].nseqs < 1024
    qc, ql = jsw.build_qcodes(queries, 40)
    m8 = jsw.build_matrix8(m62.matrix)
    jstates = _jax_series(chunks, qc, ql, m8, flow=False)
    scores = _port_series(chunks, qc, ql, m8, flow=False, state_w=1024,
                          jax_states=jstates)
    _oracle_check(scores, seqs, queries, m62)
    # the port may run the series at the compact width rounded to a warp
    assert chunks[0].nseqs <= 64
    assert _port_series(chunks, qc, ql, m8, flow=False, state_w=64).keys() \
        == scores.keys()
    narrow = _port_series(chunks, qc, ql, m8, flow=False, state_w=64)
    assert all(np.array_equal(narrow[k], scores[k]) for k in scores)


def test_flow_series_matches_jax_kernel(m62):
    # cut chains continued on permuted lanes, narrowing drains, the
    # series head without carry-in and its tail without carry-out; the
    # port's profile path against the same JAX states
    rng = np.random.default_rng(42)
    lens = np.concatenate([rng.integers(5, 120, 90), [500, 800, 300]])
    rng.shuffle(lens)
    seqs = _seqs(rng, lens)
    queries = _seqs(rng, [37, 14])
    # full and drain chunks of one height: two compiled JAX shapes
    chunks = pack_stream_flow(seqs, nseqs=1024, max_cols=64, drain_cols=64)
    assert len(chunks) > 3
    assert any((c.carry_src >= 0).any() for c in chunks[1:])
    qc, ql = jsw.build_qcodes(queries, 40)
    m8 = jsw.build_matrix8(m62.matrix)
    jstates = _jax_series(chunks, qc, ql, m8, flow=True)
    for dprof in (False, True):
        scores = _port_series(chunks, qc, ql, m8, flow=True,
                              state_w=chunks[0].nseqs, dprof=dprof,
                              jax_states=jstates)
        _oracle_check(scores, seqs, queries, m62)


def _lax_state_pre(state, R=1, Q=12):
    """The lax twin keeps E of the last column; the kernels keep it
    pre-advanced into the next one."""
    h, e, s = (torch.from_numpy(np.asarray(x).copy()) for x in state)
    return h, torch.maximum(e - R, h - Q), s


def test_flow_series_larger_matches_lax_twin(m62):
    # a larger flow series against the JAX lax twin: dumps and carried
    # state after every chunk, with a clamp
    rng = np.random.default_rng(43)
    lens = np.concatenate([rng.integers(5, 200, 1500), [1400, 1000]])
    rng.shuffle(lens)
    seqs = _seqs(rng, lens)
    queries = _seqs(rng, [90, 128])
    seqs[0] = queries[0].copy()           # scores far above the clamp
    chunks = pack_stream_flow(seqs, nseqs=1024, max_cols=256,
                              drain_cols=256)
    assert len(chunks) >= 3 and (chunks[-1].carry_src >= 0).any()
    qc, ql = jsw.build_qcodes(queries, 128)
    m8 = jsw.build_matrix8(m62.matrix)
    jh = je = js = None
    state = None
    top = 0
    for i, ch in enumerate(chunks):
        if i == 0:
            jh, je, js = jsw.make_stream_state_lax(2, 128, ch.nseqs)
            state = tsw.make_stream_state(2, 128, ch.nseqs)
        else:
            jh, je, js = jsw.permute_stream_state(jh, je, js,
                                                  jnp.asarray(ch.carry_src))
            state = tsw.permute_stream_state(*state, _t(ch.carry_src))
        dump, jh, je, js = jsw.sw_scores_stream_lax_carry(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(m8),
            jnp.asarray(ch.data), jnp.asarray(ch.start), jh, je, js,
            clamp=100, **KW)
        data, start, _, _ = tsw.chunk_tensors(
            ch.data_t, ch.start, ch.end_block, ch.lane, "cpu")
        got, *state = tsw.sw_scores_stream_carry(
            _t(qc), _t(ql), _t(m8), data, start, *state, clamp=100, **KW)
        assert np.array_equal(got.numpy(), np.asarray(dump))
        _assert_state_equal(state, _lax_state_pre((jh, je, js)), ql)
        top = max(top, int(got.max()))
    assert top == 100


def test_carry_flags_and_shapes(m62):
    # carry_out=False leaves the state as it was; carry_in=False ignores
    # it; rows past qlen come back as they went in; bad shapes raise
    rng = np.random.default_rng(5)
    qc, ql = tsw.build_qcodes(_seqs(rng, [20, 9]), 32)
    qc, ql = _t(qc), _t(ql)
    seqs = _seqs(rng, rng.integers(1, 60, 50))
    ch = pack_stream_carry(seqs, nseqs=32, max_cols=64)[0]
    data, start, _, _ = tsw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                          ch.lane, "cpu")
    t8 = _t(tsw.build_matrix8(m62.matrix))
    junk = [torch.from_numpy(rng.integers(-50, 50, size=s).astype(np.int32))
            for s in ((2, 32, 32), (2, 32, 32), (2, 32))]
    fresh = tsw.make_stream_state(2, 32, 32)
    want, *wstate = tsw.sw_scores_stream_carry(qc, ql, t8, data, start,
                                               *fresh, **KW)
    keep = [x.clone() for x in junk]
    got, *gstate = tsw.sw_scores_stream_carry(qc, ql, t8, data, start, *keep,
                                              carry_in=False, **KW)
    assert torch.equal(got, want)
    _assert_state_equal(gstate, wstate, ql.numpy())
    assert torch.equal(gstate[0][1, 9:], junk[0][1, 9:])     # past qlen
    keep = [x.clone() for x in junk]
    got, *gstate = tsw.sw_scores_stream_carry(qc, ql, t8, data, start, *keep,
                                              carry_out=False, **KW)
    assert all(torch.equal(a, b) for a, b in zip(gstate, junk))
    assert trace.launched("swipe_carry_flow") == 0
    assert trace.launched("swipe_carry_rows") == 0
    with pytest.raises(ValueError):
        tsw.sw_scores_stream_carry(qc, ql, t8, data, start,
                                   *tsw.make_stream_state(2, 32, 16), **KW)
    # permute: lane i takes carry_src[i]; -1 reads lane 0; narrowing
    src = torch.tensor([3, -1, 0, 7], dtype=torch.int32)
    h, e, s = tsw.permute_stream_state(*junk, src)
    assert h.shape == (2, 32, 4) and s.shape == (2, 4)
    assert torch.equal(h[:, :, 0], junk[0][:, :, 3])
    assert torch.equal(s[:, 1], junk[2][:, 0])
