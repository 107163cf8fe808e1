"""The logic the row-form carry kernels (csrc/carry_rows.cu) rely on, on
the CPU: a query's rows cut into bands and walked band after band (row
-1 of a band from the band above's bottom row, the diagonal into its top
row at a chunk's first column from the carried H of the row above)
scores a carry series exactly as the whole query does; the rule that
picks K3's form from a launch's lanes and matrix; and the flow form's
host plan.  Integer DP: every comparison is
exact."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu_torch import trace
from swipe_tpu_torch.batching import pack_stream_carry
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import sw_stream as tsw

# queries that are empty, end inside a band, one row short of a band
# edge, at a band edge, and take three bands of 512 rows (five of 256)
QUERY_LENS = (0, 300, 511, 512, 1100)
QLEN_PAD = 1536


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread is
    several times faster than a pool contended by other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def series():
    """A compact carry series: two giants cut across chunks and short
    records refilling eight lanes mid-chunk; the queries; BLOSUM62 as
    int8."""
    rng = np.random.default_rng(61)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in [700, 450] + list(rng.integers(1, 90, 14))]
    chunks = pack_stream_carry(seqs, nseqs=8, max_cols=160)
    queries = [rng.integers(1, 26, size=n, dtype=np.int8)
               for n in QUERY_LENS]
    qc, ql = (torch.from_numpy(a) for a in tsw.build_qcodes(queries,
                                                             QLEN_PAD))
    m8 = torch.from_numpy(tsw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix))
    return chunks, qc, ql, m8


def test_series_cuts_lanes_and_refills(series):
    chunks = series[0]
    assert len(chunks) >= 3
    # a giant runs on through a chunk boundary, and a lane refills after
    # block 0 of some chunk
    assert any(not ch.start[0].all() for ch in chunks[1:])
    assert any(ch.start[1:].any() for ch in chunks)


@pytest.mark.parametrize("band", [256, 512])
def test_bands_compose_to_the_whole_query(series, band):
    chunks, qc, ql, m8 = series
    kw = dict(gapopenextend=12, gapextend=1)
    width = -(-chunks[0].nseqs // 32) * 32
    nq = qc.shape[0]
    whole = tsw.make_stream_state(nq, QLEN_PAD, width)
    bands = tsw.make_stream_state(nq, QLEN_PAD, width)
    jstate = jsw.make_stream_state_lax(1, QLEN_PAD, chunks[0].nseqs)
    k = QUERY_LENS.index(1100)
    for i, ch in enumerate(chunks):
        data, start, _, _ = tsw.chunk_tensors(ch.data_t, ch.start,
                                              ch.end_block, ch.lane, "cpu")
        flags = dict(carry_in=i > 0, carry_out=i < len(chunks) - 1)
        d1, *whole = tsw.sw_scores_stream_carry_plain(
            qc, ql, m8, data, start, *whole, **kw, **flags)
        # the band composition: bh0c slot t is the carried H of row
        # t * band - 1, the diagonal into band t's top row at column 0
        h, e, s = bands
        bh0c = torch.zeros((nq, QLEN_PAD // band + 1, width),
                           dtype=torch.int32)
        bh0c[:, 1:] = h[:, band - 1::band][:, :QLEN_PAD // band]
        d2, h, e, s, _ = tsw.sw_scores_stream_carry_long(
            qc, ql, m8, data, start, h, e, s, bh0c, tile_rows=band, **kw,
            **flags)
        bands = (h, e, s)
        assert torch.equal(d1, d2), f"chunk {i}: dumps differ"
        for name, a, b in zip("hes", whole, bands):
            assert torch.equal(a, b), f"chunk {i}: {name} differs"
        # the JAX lax twin, for the query of three bands
        jd, *jstate = jsw.sw_scores_stream_lax_carry(
            *(jnp.asarray(x) for x in (qc[k:k + 1].numpy(),
                                       ql[k:k + 1].numpy(), m8.numpy(),
                                       ch.data_t.T.copy(), ch.start)),
            *jstate, **kw)
        assert np.array_equal(np.asarray(jd),
                              d1[k:k + 1, :, :ch.nseqs].numpy())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (query index, row x) planted across a cut: x is the first row of a
# band's second strip, bands laid from the query's end (512 rows of 16 a
# strip, 256 of 8)
CUT_PLANTS = {512: [(4, 604), (3, 16)], 256: [(4, 340), (3, 264)]}


@pytest.mark.parametrize("band", [256, 512])
def test_planted_cut_needs_the_carried_diagonal(series, band):
    # chip_smoke.plant_cuts copies lane symbols around chunk cuts into the
    # queries, so that a planted chunk's dump depends on the carried H of
    # row x - 1 (the diagonal into row x at the chunk's first column, which
    # a row-form kernel hands from one thread to the next before its first
    # shuffle); the whole query and the band composition still agree
    chunks, _, _, m8 = series
    cs = _chip_smoke()
    rng = np.random.default_rng(62)
    qs, where = cs.plant_cuts(chunks, [
        rng.integers(1, 26, size=n, dtype=np.int8) for n in QUERY_LENS],
        CUT_PLANTS[band])
    assert len(where) == 2 and all(c > 0 for c, _, _ in where)
    for k, x in CUT_PLANTS[band]:
        assert (QUERY_LENS[k] - x) % band == band - band // 32
    qc, ql = (torch.from_numpy(a) for a in tsw.build_qcodes(qs, QLEN_PAD))
    width = -(-chunks[0].nseqs // 32) * 32
    state = tsw.make_stream_state(len(qs), QLEN_PAD, width)
    bands = tsw.make_stream_state_long(len(qs), QLEN_PAD, width, band)
    matters = set()
    for i, ch in enumerate(chunks):
        data, start, _, _ = tsw.chunk_tensors(ch.data_t, ch.start,
                                              ch.end_block, ch.lane, "cpu")
        kw = dict(gapopenextend=12, gapextend=1, carry_in=i > 0,
                  carry_out=i < len(chunks) - 1)
        args = (qc, ql, m8, data, start)
        if cs.cut_matters(tsw.sw_scores_stream_carry_plain, where, i, args,
                          state, kw):
            matters.add(i)
        d1, *state = tsw.sw_scores_stream_carry_plain(*args, *state, **kw)
        d2, *bands = tsw.sw_scores_stream_carry_long(*args, *bands,
                                                     tile_rows=band, **kw)
        assert torch.equal(d1, d2), f"chunk {i}: dumps differ"
    assert matters == {c for c, _, _ in where}


@pytest.mark.parametrize("nq,nseqs,wide,form", [
    (16, 32, True, "rows"),         # wide-genome: the chromosome lane
    (16, 32, False, "rows"),        # the tblastn carry series
    (16, 32, False, "rows"),        # segment-proteome's titin
    (16, 64, False, "rows"),        # a giant carry series of 64 lanes
    (4, 64, False, "rows"),         # chip_smoke's compact check series
    (132, 32, False, "rows"),       # a warp an SM
    (16, 2048, True, "rows"),       # a wide launch of many lanes
    (16, 2048, False, "flow"),      # the proteome's flow chunk
    (16, 1024, False, "flow"),      # a flow drain
    (1, 1024, False, "flow"),       # one slot's drain
])
def test_carry_form(monkeypatch, nq, nseqs, wide, form):
    # the rule by the launch's lanes and matrix, and sw_scores_stream_carry's
    # dispatch by it whatever the launch's queries; block profiles do
    # not enter
    assert tsw.carry_form(nseqs, wide) == form
    assert tsw.carry_form(tsw.FLOW_LANES, False) == "flow"
    assert tsw.carry_form(tsw.FLOW_LANES - 1, False) == "rows"
    took = []
    for name in ("rows", "flow"):
        monkeypatch.setattr(tsw, f"sw_scores_stream_carry_{name}",
                            lambda *a, name=name, **k: took.append(name))
    h = torch.zeros((nq, 16, nseqs), dtype=torch.int32)
    m = torch.zeros((32, 32), dtype=torch.int32 if wide else torch.int8)
    for dprof in (None, torch.zeros(1)):
        tsw.sw_scores_stream_carry(
            torch.zeros((nq, 16), dtype=torch.int32), None, m, None, None,
            h, h, h[:, 0], gapopenextend=12, gapextend=1, dprof=dprof)
    assert took == [form, form]


@pytest.mark.parametrize("qlen_pad,band,split", [
    (32, 128, False), (128, 128, False), (129, 256, False),
    (256, 256, False), (512, 512, False), (1024, 512, True),
    (1536, 512, True)])
def test_flow_host_plan(qlen_pad, band, split):
    # the flow form's launches (stream_plan, shared with K2): bands of
    # 128, 256 and 512 rows (4, 8 and 16 a thread) by qlen_pad, two or
    # more 512-row bands over 512 with the queries split so that the
    # planes between bands, [2, step, L, nseqs] int32, stay within 1 GiB
    for nq, L, nseqs in ((16, 1792, 2048), (16, 128, 1024),
                         (16, 65536, 2048), (3, 8192, 2048)):
        got_band, step = tsw.stream_plan(nq, qlen_pad, L, nseqs)
        assert got_band == band and band // 32 in (4, 8, 16)
        assert step == (max(1, min(nq, (1 << 30) // (8 * L * nseqs)))
                        if split else nq)
        if split:
            assert step * 8 * L * nseqs <= 1 << 30 or step == 1


def test_cpu_takes_the_plain_version_of_both_forms(series):
    chunks, qc, ql, m8 = series
    ch = chunks[0]
    data, start, _, _ = tsw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                          ch.lane, "cpu")
    width = -(-ch.nseqs // 32) * 32
    kw = dict(gapopenextend=12, gapextend=1, carry_in=False)
    want = tsw.sw_scores_stream_carry_plain(
        qc, ql, m8, data, start, *tsw.make_stream_state(5, QLEN_PAD, width),
        **kw)
    n = (trace.launched("swipe_carry_flow"),
         trace.launched("swipe_carry_rows"))
    for fn in (tsw.sw_scores_stream_carry, tsw.sw_scores_stream_carry_flow,
               tsw.sw_scores_stream_carry_rows):
        got = fn(qc, ql, m8, data, start,
                 *tsw.make_stream_state(5, QLEN_PAD, width), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (trace.launched("swipe_carry_flow"),
            trace.launched("swipe_carry_rows")) == n
