"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip without one.  They
import neither jax nor swipe_tpu, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import io

import numpy as np
import pytest
import torch

from swipe_tpu_torch.batching import pack_stream
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import sw_stream as sw
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunk(dev):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 200, size=3000)]
    ch = pack_stream(seqs, nseqs=1024, max_cols=512)[0]
    m8 = sw.build_matrix8(ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)
    data, start, eb, ln = sw.chunk_tensors(ch.data_t, ch.start,
                                           ch.end_block, ch.lane, dev)
    return torch.from_numpy(m8).to(dev), data, start


def test_dprofile_kernel_matches_plain(chunk):
    m8, data, _ = chunk
    n = sw.build_dprofile_series.launches
    got = sw.build_dprofile_series(m8, data)
    assert sw.build_dprofile_series.launches == n + 1
    assert torch.equal(got, sw.build_dprofile_series_plain(m8, data))


@pytest.mark.parametrize("dprof,clamp", [(False, None), (True, None),
                                         (True, 50)])
def test_stream_kernel_matches_plain(dev, chunk, dprof, clamp):
    m8, data, start = chunk
    rng = np.random.default_rng(1)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (5, 64, 130)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 160))
    kw = dict(gapopenextend=12, gapextend=1, clamp=clamp,
              dprof=sw.build_dprofile_series(m8, data) if dprof else None)
    got = sw.sw_scores_stream(qc, ql, m8, data, start, **kw)
    assert torch.equal(got, sw.sw_scores_stream_plain(qc, ql, m8, data,
                                                      start, **kw))


def test_hint_kernel_matches_plain(dev, chunk):
    m8 = chunk[0]
    rng = np.random.default_rng(2)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in (30, 90)]
    db = np.full((2, 256, 1024), 31, np.int8)
    for b, q in enumerate(qs):
        for j in range(1024):
            s = np.concatenate([q, q]) if j % 2 else rng.integers(
                1, 26, size=int(rng.integers(1, 256)), dtype=np.int8)
            db[b, :len(s), j] = s[:256]
    db[:, :, -40:] = 31                 # empty lanes
    starts = np.zeros((2, 1024), np.int32)
    starts[:, 3::5] = 17
    args = [torch.from_numpy(a).to(dev)
            for a in (*sw.build_qcodes(qs, 128), db, starts)]
    args.insert(2, m8)
    for R in (1, 150):
        got = sw.sw_hint_stream(*args, gapopenextend=R + 11, gapextend=R)
        want = sw.sw_hint_stream_plain(*args, gapopenextend=R + 11,
                                       gapextend=R)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_hint_grid_route_on_card_matches_host_pass(dev):
    from swipe_tpu_torch.ops import align_hint
    rng = np.random.default_rng(4)
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    jobs = []
    for nsub in (1, 5, 33, 70, 16, 2):       # over 4 bins: the kernel route
        q = rng.integers(1, 26, size=int(rng.integers(20, 200)),
                         dtype=np.int8)
        jobs.append((q, [rng.integers(1, 26, size=int(n), dtype=np.int8)
                         for n in rng.integers(1, 900, size=nsub)]))
    n = sw.sw_hint_stream.launches
    got = align_hint.hint_endpoints_grid(jobs, m, 11, 1, device=dev)
    assert sw.sw_hint_stream.launches > n
    assert got == [align_hint.hint_endpoints_many(q, subs, m, 11, 1)
                   for q, subs in jobs]


def test_engine_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    recs = ["".join(rng.choice(aa, int(n)))
            for n in rng.integers(20, 300, size=500)]
    q = "".join(rng.choice(aa, 150))
    recs[9] = q[10:120]
    fasta = "".join(f">s{i}\n{s}\n" for i, s in enumerate(recs))
    params = dict(descriptions=50, alignments=20)
    hits = []
    for device in (dev, "cpu"):
        eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "aa", title="t"),
                           SearchParams(**params), device=device)
        hl = eng.search(preprocess_query("q", q, 1, 3))
        hits.append([(h.seqno, h.score, h.alignment) for h in hl.hits])
    assert hits[0] == hits[1] and hits[0][0][0] == 9
