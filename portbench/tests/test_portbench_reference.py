"""The plain reference against a scalar Smith-Waterman, and against the
port's CPU path on a tiny configuration."""

import json
import math
import os

import numpy as np
import pytest
import torch

from portbench import check, workload
from portbench.reference import search, sw

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scalar_sw(q, d, mat, go, ge):
    """Gotoh local alignment, one cell at a time."""
    m, n = len(q), len(d)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), -10**9, np.int64)
    F = np.full((m + 1, n + 1), -10**9, np.int64)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1], H[i, j - 1] - go) - ge
            F[i, j] = max(F[i - 1, j], H[i - 1, j] - go) - ge
            H[i, j] = max(0, H[i - 1, j - 1] + mat[q[i - 1], d[j - 1]],
                          E[i, j], F[i, j])
            best = max(best, H[i, j])
    return best


def subjects_of(seqs):
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return sw.Subjects(np.concatenate(seqs).astype(np.uint8), starts, lens,
                       "cpu")


@pytest.mark.parametrize("matrix,go,ge", [("BLOSUM62", 11, 1),
                                          ("ACGT", 5, 2)])
def test_scan_matches_scalar(matrix, go, ge):
    rng = np.random.default_rng(5)
    if matrix == "ACGT":
        letters, mat = sw.nucleotide_matrix(1, -3)
    else:
        letters, mat = sw.load_matrix(matrix)
        mat = mat[:20, :20]
    a = len(mat)
    q = rng.integers(0, a, 37)
    seqs = [rng.integers(0, a, n) for n in (1, 5, 36, 37, 90, 200)]
    # a planted copy with a gap, so gaps and F chains matter
    seqs.append(np.concatenate([q[:15], rng.integers(0, a, 3), q[15:]]))
    subj = subjects_of(seqs)
    want = [scalar_sw(q, s, mat, go, ge) for s in seqs]
    assert list(sw.sw_scan([q], subj, mat, go, ge)[0]) == want
    # the same cut into overlapped pieces, and over several batches
    assert list(sw.sw_scan([q], subj, mat, go, ge, piece=40,
                           elems=64, cells=200)[0]) == want
    # beside a longer and a shorter query in one pass
    q2 = rng.integers(0, a, 50)
    got = sw.sw_scan([q[:9], q, q2], subj, mat, go, ge)
    assert list(got[1]) == want
    assert list(got[0]) == [scalar_sw(q[:9], s, mat, go, ge) for s in seqs]
    assert list(got[2]) == [scalar_sw(q2, s, mat, go, ge) for s in seqs]


def test_int16_and_int32_agree():
    rng = np.random.default_rng(6)
    letters, mat = sw.load_matrix("BLOSUM62")
    mat = mat[:20, :20]
    q = rng.integers(0, 20, 60)
    seqs = [np.concatenate([rng.integers(0, 20, 10), q, q])]
    subj = subjects_of(seqs)
    a = sw.sw_scan([q], subj, mat, 11, 1)[0]                   # int16
    b = sw.sw_scan([q], subj, mat, 11, 1, saturate=1 << 30)[0]  # int32
    assert list(a) == list(b) == [scalar_sw(q, seqs[0], mat, 11, 1)]


def test_saturation_is_the_control():
    rng = np.random.default_rng(7)
    letters, mat = sw.load_matrix("BLOSUM62")
    mat = mat[:20, :20]
    q = rng.integers(0, 20, 80)
    subj = subjects_of([q, rng.integers(0, 20, 80)])
    exact = sw.sw_scan([q], subj, mat, 11, 1)[0]
    sat = sw.sw_scan([q], subj, mat, 11, 1, saturate=127)[0]
    assert exact[0] > 127 and sat[0] == 127
    assert sat[1] == min(exact[1], 127)


def test_walk():
    mat = np.eye(4, dtype=np.int64) * 2 - 1
    q = np.array([0, 1, 2, 3])
    d = np.array([0, 1, 3, 2, 3])
    # M2 I1 M2: q[0:2]~d[0:2], skip d[2], q[2:4]~d[3:5]
    assert search.walk("M2I1M2", q, d, 0, 0, mat, 1, 1) == (2 - 2 + 2, 3, 4)
    assert search.walk("M9", q, d, 0, 0, mat, 1, 1) is None
    assert search.walk("", q, d, 0, 0, mat, 1, 1) is None


def test_statistics_match_the_port():
    from swipe_tpu_torch.stats import EvalueModel
    stats = {"lambda": 0.267, "K": 0.041, "alpha": 1.9, "beta": -30.0}
    for qlen, n, N in ((300, 205_700_000, 570_000), (17, 40_000, 300),
                       (1024, 10**9, 10**6)):
        ref = search.Statistics(stats, qlen, n, N)
        port = EvalueModel(1, qlen, N, n, matrixname="BLOSUM62", gapopen=11,
                           gapextend=1)
        assert math.isclose(ref.kmn, port.Kmn, rel_tol=1e-15)
        assert ref.min_score(10.0) == port.min_score_for_expect(10.0)


def tiny(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    reh = c["rehearsal"]
    return {**c, "database": {**c["database"], **reh["database"]},
            "queries": {**c["queries"], **reh.get("queries", {})}}


@pytest.mark.parametrize("name", ["swissprot-blastp", "ecoli-k12-blastn"])
def test_reference_agrees_with_the_port_on_the_cpu(tmp_path, name):
    """The port's plain CPU path, fed the benchmark's inputs, returns what
    the reference works out: hit lists, alignments, E-values."""
    from swipe_tpu_torch.io.db import FastaDatabase
    from swipe_tpu_torch.io.fasta import preprocess_query
    from swipe_tpu_torch.pipeline import SearchEngine, SearchParams
    from portbench.harness import ProgramList
    torch.set_num_threads(2)
    c = tiny(name)
    w = workload.build(c, {"batch": 1, "length": [1, 90], "pool": 2,
                           "rounds": 1, "check": 2}, 21)
    path = tmp_path / "db.fa"
    path.write_bytes(w.corpus.fasta())
    db = FastaDatabase(str(path), w.corpus.kind)
    p = SearchParams(symtype=c["symtype"], querystrands=c["strands"],
                     matrixname=c.get("matrix", "BLOSUM62"),
                     matchscore=c.get("match", 1),
                     mismatchscore=c.get("mismatch", -3),
                     gapopen=c["gapopen"], gapextend=c["gapextend"])
    eng = SearchEngine(db, p, device="cpu")
    qs = [preprocess_query("q", q.decode(), c["symtype"], c["strands"])
          for q in w.queries]
    hls = eng.search_batch(qs)
    ref = check.Reference(c, w.corpus, "cpu")
    nums = check.judge(ref, [(q, ProgramList(h))
                             for q, h in zip(w.queries, hls)])
    assert nums == {"lists_wrong": 0, "alignments_wrong": 0,
                    "evalue_gap": 0.0}
    assert all(h.count for h in hls)


def test_control_fails_the_comparison():
    """The reference at SWIPE's first 8-bit precision, put in the
    program's place, reads as not correct."""
    c = tiny("swissprot-blastp")
    w = workload.build(c, {"batch": 1, "length": [1, 90], "pool": 3,
                           "rounds": 1, "check": 3}, 31)
    ref = check.Reference(c, w.corpus, "cpu")
    sample = [(q, check.ControlList(ref, q, sc)) for q, sc in zip(
        w.queries, ref.scores(w.queries, check.ControlList.CEILING))]
    nums = check.judge(ref, sample, aligned=False)
    nums["alignments_wrong"] = nums["requests_failed"] = 0
    assert nums["lists_wrong"] > 0
    assert not check.verdict(nums, c["check"])


@pytest.mark.cuda
def test_scan_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    letters, mat = sw.load_matrix("BLOSUM62")
    mat = mat[:20, :20]
    q = rng.integers(0, 20, 300)
    seqs = [rng.integers(0, 20, n) for n in rng.integers(1, 3000, 500)]
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.concatenate(seqs).astype(np.uint8)
    qs = [q, q[:100]]
    cpu = sw.sw_scan(qs, sw.Subjects(flat, starts, lens, "cpu"), mat, 11, 1)
    gpu = sw.sw_scan(qs, sw.Subjects(flat, starts, lens, "cuda"), mat, 11,
                     1)
    assert (cpu == gpu).all()
