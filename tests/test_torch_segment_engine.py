"""The port's segment-packed route end to end on the CPU against the JAX
engine: ``backend="pallas"`` (K8's plain loop) and ``"pallas_v1"`` (K9's)
against JAX ``backend="lax"`` on a protein database with giants (forced
by a small chunk height, on the carry series); a blastn search whose
scores fall outside int8 (K9 on an int32 profile, the wide carry series,
the wide hint route) on the stream and the segment backends; and the
CLI's bytes with ``--backend pallas_interpret``.  Hit lists (scores,
alignments), totalhits, obvious and the cascade counters must be
equal."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from swipe_tpu.cli import main as jax_cli_main
from swipe_tpu.io.db import FastaDatabase as JaxFastaDatabase
from swipe_tpu.io.fasta import preprocess_query as jax_preprocess_query
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.pipeline import SearchEngine as JaxSearchEngine
from swipe_tpu.pipeline import SearchParams as JaxSearchParams
from swipe_tpu.pipeline import SearchTimings as JaxSearchTimings
from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.ops import sw_segmented as tseg
from swipe_tpu_torch.ops import sw_tiled as ttiled
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hit_key(hl):
    return ([(h.seqno, h.score, h.qstrand, h.qframe, h.dstrand, h.dframe,
              h.score_align, h.align_q_start, h.align_q_end,
              h.align_d_start, h.align_d_end, h.alignment)
             for h in hl.hits], hl.totalhits, hl.obvious)


def run_both(fasta, dbtype, queries, symtype, params, jax_backend,
             backend, **engine_kw):
    """The same batch through the JAX engine on ``jax_backend`` and the
    port on ``backend`` (CPU); asserts equal hit lists and counters and
    returns the port's engine and hit keys."""
    results = []
    for jax in (True, False):
        Db, Eng, Par, Tim, prep = (
            (JaxFastaDatabase, JaxSearchEngine, JaxSearchParams,
             JaxSearchTimings, jax_preprocess_query) if jax else
            (FastaDatabase, SearchEngine, SearchParams, SearchTimings,
             preprocess_query))
        kw = dict(backend=jax_backend) if jax else \
            dict(backend=backend, device="cpu")
        eng = Eng(Db(io.StringIO(fasta), dbtype, title="t"),
                  Par(symtype=symtype, querystrands=3, **params),
                  **engine_kw, **kw)
        tim = Tim()
        hls = eng.search_batch([prep(f"q{i}", q, symtype, 3)
                                for i, q in enumerate(queries)], tim)
        results.append(([hit_key(h) for h in hls], tim.compute, tim.rounds))
    assert results[0] == results[1]
    return eng, results[1][0]


def _protein_db(rng, queries):
    recs = ["".join(rng.choice(list(AA), int(rng.integers(20, 200))))
            for _ in range(120)]
    for i, q in enumerate(queries):        # planted homologs
        recs[3 + 7 * i] = q[5:70]
        recs[4 + 7 * i] = q[:40] + "A" * 5 + q[40:]
    # giants over the 256-column chunk height, one with a planted copy
    recs.append("".join(rng.choice(list(AA), 900)) + queries[0][10:90]
                + "".join(rng.choice(list(AA), 60)))
    recs.append("".join(rng.choice(list(AA), 700)))
    return "".join(f">s{i} seq {i}\n{s}\n" for i, s in enumerate(recs))


@pytest.mark.parametrize("backend", ["pallas", "pallas_v1"])
def test_segment_backends_match_jax_lax(backend):
    rng = np.random.default_rng(41)
    queries = ["".join(rng.choice(list(AA), n)) for n in (70, 130, 95)]
    fasta = _protein_db(rng, queries)
    counts = (trace.launched("swipe_segment_tiled"),
              trace.launched("swipe_segment"),
              trace.launched("swipe_carry_flow"),
              trace.launched("swipe_carry_rows"))
    calls = []
    real = tseg.sw_scores_segmented_plain

    def spy(qpt, *a, **k):
        calls.append(tuple(qpt.shape))
        return real(qpt, *a, **k)

    mods = (tseg, ttiled)
    for m in mods:
        m.sw_scores_segmented_plain = spy
    try:
        eng, hits = run_both(
            fasta, "aa", queries, 1, dict(descriptions=50, alignments=12),
            "lax", backend, nseqs=16, max_cols=256)
    finally:
        for m in mods:
            m.sw_scores_segmented_plain = real
    assert eng._giant_ids.size == 2 and len(eng.chunks) > 1
    # every slot at once, qlen_pad the longest query rounded to 64
    assert calls and set(calls) == {(3, 192, 32)}
    assert len(calls) == len(eng.chunks)
    # the plain versions launch nothing
    assert (trace.launched("swipe_segment_tiled"),
            trace.launched("swipe_segment"),
            trace.launched("swipe_carry_flow"),
            trace.launched("swipe_carry_rows")) == counts
    top = hits[0][0]
    seqs = [np.asarray(eng.db.get_sequence(i, 1)[0]) for i in range(122)]
    want = sw_numpy_many(preprocess_query("q", queries[0], 1, 3).aa[0],
                         seqs, eng.matrix.matrix, 11, 1)
    assert all(h[1] == want[h[0]] for h in top)
    assert {3, 4, 120} <= {h[0] for h in top}     # the homologs, the giant


def _nt_db(rng, q):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    recs = ["".join(rng.choice(list(NT), int(rng.integers(40, 150))))
            for _ in range(30)]
    recs[4] = q[3:50]
    recs[9] = "".join(comp[c] for c in reversed(q))
    giant = ("".join(rng.choice(list(NT), 1200)) + q[:45]
             + "".join(rng.choice(list(NT), 300)))
    recs.append(giant)
    return "".join(f">n{i} nt {i}\n{s}\n" for i, s in enumerate(recs))


# port backend -> the JAX engine's backend of the same route
WIDE_BACKENDS = {"stream": "stream_interpret", "pallas": "lax"}


@pytest.mark.parametrize("backend", sorted(WIDE_BACKENDS))
def test_wide_matrix_matches_jax(backend):
    """blastn at +200/-300, gaps 400/200 (outside int8): K9 on an int32
    profile for the records, the carry series on the int32 matrix for the
    giant, whatever the backend."""
    rng = np.random.default_rng(43)
    q = "".join(rng.choice(list(NT), 60))
    fasta = _nt_db(rng, q)
    params = dict(matchscore=200, mismatchscore=-300, gapopen=400,
                  gapextend=200, descriptions=20, alignments=6)
    eng, hits = run_both(fasta, "nt", [q], 0, params,
                         WIDE_BACKENDS[backend], backend, max_cols=256)
    assert not eng.matrix.fits_int8 and eng._giant_ids.size == 1
    assert eng._segment_route and eng._seg_shape == (
        (512, 16384) if backend == "stream" else (512, 256))
    seqs = {(i, d): np.asarray(eng.db.get_sequence(i, 0, d)[0])
            for i in range(31) for d in (0, 1)}
    qn = preprocess_query("q", q, 0, 3).nt[0]
    for h in hits[0][0]:
        assert h[1] == int(sw_numpy_many(qn, [seqs[h[0], h[4]]],
                                         eng.matrix.matrix, 400, 200)[0])
    assert {h[0] for h in hits[0][0][:3]} >= {4, 9, 30}


VOLATILE = {
    "0": ("Search started", "Search completed", "Elapsed", "Speed"),
    "8": (),
}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(45)
    queries = ["".join(rng.choice(list(AA), int(n))) for n in (50, 80)]
    recs = ["".join(rng.choice(list(AA), int(rng.integers(30, 150))))
            for _ in range(150)]
    recs[7] = queries[0][3:45]
    recs[60] = queries[1][10:70]
    (d / "db.fa").write_text("".join(f">d{i} seq {i}\n{s}\n"
                                     for i, s in enumerate(recs)))
    (d / "q.fa").write_text("".join(f">q{i} query {i}\n{q}\n"
                                    for i, q in enumerate(queries)))
    return d


@pytest.mark.parametrize("view", sorted(VOLATILE))
def test_cli_pallas_interpret_bytes_match_jax(cli_files, view):
    argv = ["-i", str(cli_files / "q.fa"), "-d", str(cli_files / "db.fa"),
            "-m", view, "-v", "20", "-b", "5", "--backend",
            "pallas_interpret"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jax_cli_main(argv) == 0
    port = subprocess.run(
        [sys.executable, "-m", "swipe_tpu_torch", *argv], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert port.returncode == 0, port.stderr

    def mask(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(VOLATILE[view])]

    assert mask(port.stdout) == mask(buf.getvalue())
    assert "d7" in port.stdout and "d60" in port.stdout
