"""The port's segment-packed scoring (plain versions, on the CPU) against
the JAX package: pack_database byte for byte; the shared plain loop of
K8 and K9 against JAX sw_scores_lax (int8 and int32 profiles), the
interpret-mode Pallas kernel and the NumPy oracle, padded segments at
zero; the wide (int32-matrix) carry loop against the lax carry twin;
the wide hint pieces against JAX hint_endpoints_many; the peak probe's
plain chain against a NumPy transcription of the TPU probe.  Exact.

K8 (sw_tiled) is never run under the interpreter here: one small case
takes minutes on the CPU.  It shares its contract and plain loop with
K9, and the card tests hold the CUDA kernel against that loop."""

import numpy as np
import pytest
import torch

from swipe_tpu.batching import pack_database as jax_pack_database
from swipe_tpu.batching import pack_stream_carry as jax_pack_stream_carry
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import align_hint as jah
from swipe_tpu.ops import sw_pallas as jsp
from swipe_tpu.ops import sw_stream as jsw
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch import trace
from swipe_tpu_torch.batching import pack_database, pack_stream_carry
from swipe_tpu_torch.ops import align_hint as tah
from swipe_tpu_torch.ops import peak
from swipe_tpu_torch.ops import sw_stream as tsw
from swipe_tpu_torch.ops.sw_segmented import (build_qpt, segment_plan,
                                              sw_scores_segmented,
                                              sw_scores_segmented_plain)
from swipe_tpu_torch.ops.sw_tiled import sw_scores_tiled

# (matrix, gapopen, gapextend): BLOSUM62 in int8; the scaled nucleotide
# scoring of the JAX package's wide-matrix tests, outside int8
M62 = (ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1), 11, 1)
WIDE = (ScoreMatrix.nucleotide(200, -300, 400, 200), 400, 200)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seqs(rng, n, lo, hi, alphabet=(1, 26)):
    return [rng.integers(*alphabet, size=int(rng.integers(lo, hi)),
                         dtype=np.int8) for _ in range(n)]


@pytest.mark.parametrize("nseqs,max_cols", [(8, 16384), (16, 256), (8, 96)])
def test_pack_database_identical(nseqs, max_cols):
    rng = np.random.default_rng(nseqs + max_cols)
    seqs = _seqs(rng, 150, 1, 300)
    got = pack_database(seqs, nseqs=nseqs, max_cols=max_cols)
    want = jax_pack_database(seqs, nseqs=nseqs, max_cols=max_cols)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("data", "seg_ids", "seqnos", "lengths"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def _case(wide, seed):
    """Queries, a packed chunk with several segments and a padded one,
    the qpt and the gaps."""
    (m, go, ge), alphabet = (WIDE, (1, 15)) if wide else (M62, (1, 26))
    rng = np.random.default_rng(seed)
    queries = _seqs(rng, 3, 10, 128, alphabet)
    seqs = _seqs(rng, 40, 5, 300, alphabet)
    ch = pack_database(seqs, nseqs=8)[0]
    assert ch.nsegs == 8 and int(ch.seg_ids.max()) == 4   # 3 padded
    qpt = build_qpt(queries, m.matrix, 128,
                    dtype=np.int32 if wide else np.int8)
    return m, go, ge, queries, seqs, ch, qpt


@pytest.mark.parametrize("wide", [False, True], ids=["int8", "int32"])
def test_segmented_plain_matches_lax_and_oracle(wide):
    m, go, ge, queries, seqs, ch, qpt = _case(wide, 3 + wide)
    kw = dict(nsegs=ch.nsegs, gapopenextend=go + ge, gapextend=ge)
    got = sw_scores_segmented(_t(qpt), _t(ch.data), _t(ch.seg_ids),
                              **kw).numpy()
    want = np.asarray(jsp.sw_scores_lax(qpt, ch.data, ch.seg_ids, **kw))
    assert np.array_equal(got, want)
    oracle = np.stack([sw_numpy_many(q, seqs, m.matrix, go, ge)
                       for q in queries])
    named = ch.seqnos >= 0
    assert np.array_equal(got[:, named], oracle[:, ch.seqnos[named]])
    # the segments no block names are 0
    assert not got[:, int(ch.seg_ids.max()) + 1:].any()
    if not wide:
        with pytest.raises(ValueError, match="int8"):
            sw_scores_tiled(_t(qpt.astype(np.int32)), _t(ch.data),
                            _t(ch.seg_ids), **kw)


def test_segmented_plain_matches_pallas_interpret():
    _, go, ge, _, _, ch, qpt = _case(False, 5)
    kw = dict(nsegs=ch.nsegs, gapopenextend=go + ge, gapextend=ge)
    want = np.asarray(jsp.sw_scores_segmented(qpt, ch.data, ch.seg_ids,
                                              interpret=True, **kw))
    got = sw_scores_segmented_plain(_t(qpt), _t(ch.data), _t(ch.seg_ids),
                                    **kw).numpy()
    assert np.array_equal(got, want)
    # K8's wrapper on the CPU: the same plain loop, the same scores
    tiled = sw_scores_tiled(_t(qpt), _t(ch.data), _t(ch.seg_ids), **kw)
    assert np.array_equal(tiled.numpy(), want)


@pytest.mark.parametrize("wide", [False, True], ids=["int8", "int32"])
def test_segment_plan_lengths_band_and_split(wide):
    """The card kernel's host plan: query lengths derived from qpt equal
    the lengths given to build_qpt (empty, sub-64, a row either side of a
    band edge, over 512 rows), the port's qpt equals the JAX package's,
    the band is K2's for int8 and 256 rows for int32, the queries split
    over launches only when a query can take two bands, and a negative
    gap open penalty raises."""
    m = WIDE[0] if wide else M62[0]
    dtype = np.int32 if wide else np.int8
    rng = np.random.default_rng(12)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8)
          for n in (0, 1, 40, 255, 256, 257, 511, 700)]
    for qlen_pad, band in ((64, 128), (256, 256), (512, 512), (768, 512)):
        fit = [q for q in qs if len(q) <= qlen_pad]
        qpt = build_qpt(fit, m.matrix, qlen_pad, dtype=dtype)
        assert np.array_equal(qpt, jsp.build_qpt(fit, m.matrix, qlen_pad,
                                                 dtype=dtype))
        for L, nseqs in ((16384, 512), (65536, 512)):
            qlens, got_band, step = segment_plan(_t(qpt), L, nseqs, 12, 1)
            assert qlens.tolist() == [len(q) for q in fit]
            assert got_band == (256 if wide else band)
            # the planes [2, step, L, nseqs] int32 stay within 1 GiB
            split = qlen_pad > got_band
            assert step == (min(len(fit), (1 << 30) // (8 * L * nseqs))
                            if split else len(fit))
    with pytest.raises(ValueError, match="negative gap open"):
        segment_plan(_t(qpt), 16384, 512, 1, 2)


def test_chip_smoke_segment_bound_terms():
    """chip_smoke.py's work and critical-path terms of a segment kernel
    call: the cells of the query lengths against the real residues, and
    rows + columns - 1 of the longest query against the widest segment.
    seg_ids' last entry repeats the last block's segment and is no block
    of its own, so a chunk whose last segment is the widest counts its
    width, not one block more."""
    cs = _chip_smoke_terms()
    m, go, ge = M62
    rng = np.random.default_rng(13)
    queries = _seqs(rng, 3, 10, 60)
    # three 2-block segments: the chunk's rounding to 512 columns
    # stretches the last one to 12 blocks
    ch = pack_database(_seqs(rng, 24, 33, 64), nseqs=8)[0]
    widths = np.bincount(ch.seg_ids[:-1])
    assert widths.tolist() == [2, 2, 12]
    qpt = build_qpt(queries, m.matrix, 64)
    args = (_t(qpt), _t(ch.data), _t(ch.seg_ids))
    out = sw_scores_segmented(*args, nsegs=ch.nsegs, gapopenextend=go + ge,
                              gapextend=ge)
    nbytes, alu, ops, _ = cs._work("sw_scores_segmented", args, {}, out)
    cells = sum(len(q) for q in queries) * int((ch.data != 31).sum())
    assert (alu, ops) == (cells * cs.CELL_OPS[0], cells * cs.CELL_OPS[1])
    rows, cols = max(len(q) for q in queries), widths.max() * 32
    assert cs._chain("sw_scores_segmented", args, {}) == \
        (rows + cols - 1) * cs.CHAIN_OPS


@pytest.mark.parametrize("carry_in,carry_out", [(True, True),
                                               (False, False)])
def test_chip_smoke_flow_bound_terms(carry_in, carry_out):
    """chip_smoke.py's work and critical-path terms of a call of K3's flow
    form: the cells of the query lengths against the real residues; the
    bytes of the inputs, the dump and the carried state once for each
    way it moves (no block profiles); rows + columns - 1 of the longest
    query against the longest sequence between a lane's start bits."""
    from swipe_tpu_torch.batching import pack_stream_flow
    cs = _chip_smoke_terms()
    rng = np.random.default_rng(17)
    queries = _seqs(rng, 3, 10, 60)
    seqs = _seqs(rng, 300, 5, 90) + _seqs(rng, 2, 200, 260)
    ch = pack_stream_flow(seqs, nseqs=32, max_cols=128, drain_cols=32)[0]
    data, start, _, _ = tsw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                          ch.lane, "cpu")
    qc, ql = (_t(a) for a in tsw.build_qcodes(queries, 64))
    m8 = _t(tsw.build_matrix8(M62[0].matrix))
    state = tsw.make_stream_state(3, 64, 32)
    args = (qc, ql, m8, data, start, *state)
    kw = dict(gapopenextend=12, gapextend=1, carry_in=carry_in,
              carry_out=carry_out)
    out = tsw.sw_scores_stream_carry_flow(*args, **kw)
    nbytes, alu, ops, _ = cs._work("sw_scores_stream_carry_flow", args, kw,
                                   out)
    real = int((ch.data_t != 31).sum())
    cells = sum(len(q) for q in queries) * real
    assert (alu, ops) == (cells * cs.CELL_OPS[0], cells * cs.CELL_OPS[1])
    nblocks = ch.data_t.shape[1] // 16
    inputs = 3 * 64 * 4 + 3 * 4 + 32 * 32 + ch.data_t.size + nblocks * 32
    dump = 3 * nblocks * 32 * 4
    state_bytes = (2 * 3 * 64 * 32 + 3 * 32) * 4
    assert nbytes == inputs + dump + state_bytes * (carry_in + carry_out)
    # the longest sequence between start bits, lane by lane
    longest = 0
    for lane in range(32):
        run = 0
        for b in range(ch.start.shape[0]):
            if ch.start[b, lane]:
                run = 0
            run += int((ch.data_t[lane, b * 16:(b + 1) * 16] != 31).sum())
            longest = max(longest, run)
    rows = max(len(q) for q in queries)
    assert cs._chain("sw_scores_stream_carry_flow", args, kw) == \
        (rows + longest - 1) * cs.CHAIN_OPS


def _chip_smoke_terms():
    """chip_smoke.py as a module, for its bound terms."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_terms", os.path.join(os.path.dirname(__file__),
                                         os.pardir, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_tiled_rejects_qlen_off_the_tile():
    _, go, ge, queries, _, ch, _ = _case(False, 6)
    qpt = build_qpt(queries, M62[0].matrix, 160)
    with pytest.raises(ValueError, match="multiple of TQ=64"):
        sw_scores_tiled(_t(qpt), _t(ch.data), _t(ch.seg_ids),
                        nsegs=ch.nsegs, gapopenextend=go + ge, gapextend=ge)


@pytest.mark.parametrize("option", ["clamp", "dprof"])
def test_wide_carry_rejects_int8_only_options(option):
    """The wide carry is matrix lookup only, with no clamp: both options
    raise rather than run a path the kernel does not have."""
    m, go, ge = WIDE
    ch = pack_stream_carry([np.ones(40, dtype=np.int8)], nseqs=8,
                           max_cols=64)[0]
    qc, ql = tsw.build_qcodes([np.ones(10, dtype=np.int8)], 16)
    state = tsw.make_stream_state(1, 16, ch.nseqs)
    extra = ({"clamp": 50} if option == "clamp" else
             {"dprof": torch.zeros((ch.data.shape[0] // tsw.KSEG, 32,
                                    tsw.KSEG, ch.nseqs), dtype=torch.int32)})
    with pytest.raises(ValueError, match="int8-matrix only"):
        tsw.sw_scores_stream_carry(
            _t(qc), _t(ql), _t(tsw.build_matrix_wide(m.matrix)),
            _t(ch.data), _t(ch.start), *state, gapopenextend=go + ge,
            gapextend=ge, **extra)


def test_wide_carry_plain_matches_lax_twin():
    m, go, ge = WIDE
    rng = np.random.default_rng(23)
    queries = _seqs(rng, 2, 20, 60, (1, 15))
    seqs = _seqs(rng, 5, 30, 120, (1, 15)) + [
        rng.integers(1, 15, size=900, dtype=np.int8)]
    chunks = pack_stream_carry(seqs, nseqs=8, max_cols=256)
    jchunks = jax_pack_stream_carry(seqs, nseqs=8, max_cols=256)
    assert len(chunks) >= 3
    qlen_pad = 64
    qc, ql = tsw.build_qcodes(queries, qlen_pad)
    mw = tsw.build_matrix_wide(m.matrix)
    assert np.array_equal(mw, jsw.build_matrix_wide(m.matrix))
    width = chunks[0].nseqs
    state = tsw.make_stream_state(2, qlen_pad, width)
    jstate = jsw.make_stream_state_lax(2, qlen_pad, width)
    kw = dict(gapopenextend=go + ge, gapextend=ge)
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    rows = np.arange(qlen_pad)[None, :, None] < ql[:, None, None]
    for i, (ch, jch) in enumerate(zip(chunks, jchunks)):
        out, *state = tsw.sw_scores_stream_carry(
            _t(qc), _t(ql), _t(mw), _t(ch.data), _t(ch.start), *state,
            carry_in=i > 0, carry_out=i < len(chunks) - 1, **kw)
        jout, *jstate = jsw.sw_scores_stream_lax_carry(
            qc, ql, mw, jch.data, jch.start, *jstate, **kw)
        assert np.array_equal(out.numpy(), np.asarray(jout))
        if i < len(chunks) - 1:
            # the carried rows (the port stores E advanced into the next
            # column) and the running max
            jh, je, js = (np.asarray(x) for x in jstate)
            je = np.maximum(je - ge, jh - (go + ge))
            for a, b in zip(state[:2], (jh, je)):
                assert np.array_equal(np.where(rows, a.numpy(), 0),
                                      np.where(rows, b, 0))
            assert np.array_equal(state[2].numpy(), js)
        if len(ch.seqnos):
            got[:, ch.seqnos] = tsw.gather_scores(
                out, _t(ch.end_block.astype(np.int64)),
                _t(ch.lane.astype(np.int64))).numpy()
    want = np.stack([sw_numpy_many(q, seqs, m.matrix, go, ge)
                     for q in queries])
    assert np.array_equal(got, want)


def test_wide_hint_pieces_match_jax(monkeypatch):
    """A wide-matrix bin with a chromosome-scale subject: the port's
    entry point runs the hint kernel's wide instantiation (its plain
    version here) in one launch on the subject's overlapped pieces with
    their first tracked columns beside the bin's other subjects; the JAX
    package's NumPy pass is the reference.  The giant threshold is cut
    to fit the CPU."""
    m, go, ge = WIDE
    rng = np.random.default_rng(9)
    q = rng.integers(1, 15, size=30, dtype=np.int8)
    giant = rng.integers(1, 15, size=5000, dtype=np.int8)
    for pos in (700, 2040, 4300):      # copies inside and across cuts
        giant[pos:pos + 30] = q
    subjects = [giant] + _seqs(rng, 6, 20, 200, (1, 15))
    subjects[3][5:35] = q
    for mod in (jah, tah):
        monkeypatch.setattr(mod, "GIANT_HINT_MIN", 1000)
    monkeypatch.setattr(tah, "_on_cuda", lambda device: True)
    real = tsw.sw_hint_stream
    calls = trace.launched("swipe_hint")
    seen = []

    def spy(qc, ql, mat, *a, **k):
        seen.append(mat.dtype)
        return real(qc, ql, mat, *a, **k)

    monkeypatch.setattr(tsw, "sw_hint_stream", spy)
    got = tah.hint_endpoints_grid([(q, subjects)], m.matrix, go, ge,
                                  device="cpu")[0]
    want = jah.hint_endpoints_many(q, subjects, m.matrix, go, ge)
    assert got == [tuple(w) for w in want]
    assert seen == [torch.int32]                # the pieces among the rest
    # the plain version launches nothing
    assert trace.launched("swipe_hint") == calls
    assert got[0][0] > 0 and got[3][0] > 0


def test_peak_plain_matches_numpy_probe():
    """peak_chain's plain version against a transcription of the TPU
    probe's body (tools/mfu_stream.py measure_vpu_peak), CHAIN = the
    port's PEAK_STEPS steps per iteration."""
    rng = np.random.default_rng(10)
    x0 = rng.integers(-1000, 1000, size=(8, 256), dtype=np.int32)
    iters = 3

    x, y = x0.copy(), x0 + 1
    for _ in range(iters):
        for _ in range(peak.PEAK_STEPS):
            x = np.maximum(x + 1, y)
            y = np.maximum(y - 1, x)
    want = x + y
    for dpx in (False, True):
        got = peak.peak_chain(_t(x0), iters, dpx=dpx)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(peak.peak_chain_plain(_t(x0[:1]), 5).numpy(),
                          2 * x0[:1] + 10)
