"""The port's in-process multi-device scoring (parallel/distributed.py) on
a mesh of 8 CPU devices against the JAX module on its 8 virtual CPU
devices (tests/conftest.py): the gathered per-device top-k lists, the
merged top-K, the units and the cell counter, at mesh shapes (8, 1),
(2, 4) and (1, 8), with ties planted across devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swipe_tpu.parallel import distributed as jd
from swipe_tpu_torch.batching import pack_database, pack_stream
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch.ops.sw_segmented import build_qpt
from swipe_tpu_torch.ops.sw_stream import build_matrix8, build_qcodes
from swipe_tpu_torch.parallel import distributed as td

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(8, 1), (2, 4), (1, 8)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blosum62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _inputs(seed, n_q, nseqs, tied=0):
    """Queries (n_q of them, a multiple of every mesh's q axis) and db
    sequences; ``tied`` copies of one sequence spread over the pack, so
    equal scores meet at the top-k boundary of several devices."""
    rng = np.random.default_rng(seed)
    queries = [rng.integers(1, 24, size=int(L), dtype=np.int8)
               for L in rng.integers(20, 50, size=n_q)]
    seqs = [rng.integers(1, 24, size=int(L), dtype=np.int8)
            for L in rng.integers(5, 90, size=nseqs)]
    if tied:
        twin = np.concatenate([queries[0][5:25], seqs[0][:10]])
        for i in np.linspace(0, nseqs - 1, tied).astype(int):
            seqs[i] = twin
    return queries, seqs


def _oracle_topk(queries, seqs, matrix, k):
    want = np.stack([sw_numpy_many(q, seqs, matrix, 11, 1)
                     for q in queries])
    return want, np.sort(want, axis=1)[:, ::-1][:, :k]


@pytest.mark.parametrize("n_db,n_q", SHAPES)
@pytest.mark.parametrize("tied", [0, 40])
def test_sharded_stream_topk_matches_jax(blosum62, n_db, n_q, tied):
    queries, seqs = _inputs(n_db * 10 + n_q, 8, 500, tied)
    ch = pack_stream(seqs, nseqs=16 * n_db)[0]
    eb, ln, un = td.shard_stream_chunk(ch, n_db)
    assert all(np.array_equal(a, b) for a, b in
               zip((eb, ln, un), jd.shard_stream_chunk(ch, n_db)))
    qc, ql = build_qcodes(queries, 64)
    m8 = build_matrix8(blosum62.matrix)
    k = 8
    args = (qc, ql, m8, ch.data, ch.start, eb, ln, un)
    kw = dict(gapopenextend=12, gapextend=1, k=k)
    got = td.sharded_stream_topk(td.make_mesh(n_db, n_q, CPU8), *args, **kw)
    want = jd.sharded_stream_topk(jd.make_mesh(n_db, n_q),
                                  *map(jnp.asarray, args), backend="lax",
                                  **kw)
    # the gathered lists themselves, tie order and sentinels included
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[2] == int(want[2]) == len(seqs) * len(queries)
    s, u, cnt = td.merge_topk(got[0], got[1], k)
    ws, wu, wcnt = jd.merge_topk(np.asarray(want[0]), np.asarray(want[1]),
                                 k)
    assert np.array_equal(s, ws) and np.array_equal(u, wu)
    assert np.array_equal(cnt, wcnt)
    full, top = _oracle_topk(queries, seqs, blosum62.matrix, k)
    assert np.array_equal(s, top)
    assert all(full[q, uu] == ss for q in range(len(queries))
               for uu, ss in zip(u[q], s[q]))


@pytest.mark.parametrize("n_db,n_q", SHAPES)
def test_sharded_topk_scores_matches_jax(blosum62, n_db, n_q):
    queries, seqs = _inputs(n_db * 7 + n_q, 8, 160, tied=24)
    ch = pack_database(seqs, nseqs=8 * n_db, max_cols=256)[0]
    qpt = build_qpt(queries, blosum62.matrix, 64)
    unit_ids = np.asarray(ch.seqnos, dtype=np.int32)
    args = (qpt, ch.data, ch.seg_ids, unit_ids)
    kw = dict(nsegs=ch.seqnos.shape[0], gapopenextend=12, gapextend=1, k=16)
    got = td.sharded_topk_scores(td.make_mesh(n_db, n_q, CPU8), *args, **kw)
    want = jd.sharded_topk_scores(jd.make_mesh(n_db, n_q),
                                  *map(jnp.asarray, args), backend="lax",
                                  **kw)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[2] == int(want[2]) == int((unit_ids >= 0).sum()) * 8
    s, u, _ = td.merge_topk(got[0], got[1], 16)
    full = np.stack([sw_numpy_many(q, seqs, blosum62.matrix, 11, 1)
                     for q in queries])
    assert all(full[q, uu] == ss for q in range(len(queries))
               for uu, ss in zip(u[q], s[q]))


def test_sharded_stream_topk_sentinel_trim(blosum62):
    """Fewer real sequences than k on every shard: the sentinels (unit
    -1, score -1) never surface through merge_topk."""
    queries, seqs = _inputs(7, 1, 12)
    ch = pack_stream(seqs, nseqs=64)[0]
    eb, ln, un = td.shard_stream_chunk(ch, 4)
    qc, ql = build_qcodes(queries, 64)
    s, u, cnt = td.merge_topk(*td.sharded_stream_topk(
        td.make_mesh(4, 1, CPU8), qc, ql, build_matrix8(blosum62.matrix),
        ch.data, ch.start, eb, ln, un, gapopenextend=12, gapextend=1,
        k=16)[:2], 16)
    assert u.shape[1] == len(seqs) and (cnt == len(seqs)).all()
    assert (u >= 0).all()
    want = sw_numpy_many(queries[0], seqs, blosum62.matrix, 11, 1)
    assert np.array_equal(s[0], np.sort(want)[::-1])


def test_mesh_devices(monkeypatch):
    """The mesh fills row by row, as the JAX module reshapes its device
    list; by default it takes every visible CUDA device and raises when
    there is none."""
    devs = [torch.device("cpu")] * 6
    mesh = td.make_mesh(3, 2, devs)
    assert mesh.shape == {"db": 3, "q": 2} and mesh.axis_names == ("db", "q")
    assert td.make_mesh(n_q=2, devices=devs).shape == {"db": 3, "q": 2}
    with pytest.raises(ValueError, match="needs 8 devices"):
        td.make_mesh(4, 2, devs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        td.local_devices(["cuda:0"])
    assert len(jax.devices()) == 8
