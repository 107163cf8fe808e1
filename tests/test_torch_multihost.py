"""The port's multi-host engine (parallel/multihost.py) against the JAX
package: its host decisions on random inputs, the single-host pieces it
needs (unit_metas, the align phase's align_prepare, hint_endpoints_grid
and align_finish), in-process
engines of one rank against SearchEngine and JAX's MultiHostEngine, and
two-process gloo runs of ``python -m swipe_tpu_torch --mh-procs 2``
against the single-process ``swipe_tpu.cli`` bytes."""

import io
import os
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swipe_tpu.cli import main as jax_cli_main
from swipe_tpu.hits import HitList as JaxHitList
from swipe_tpu.io.blastdb import BlastDatabase as JaxBlastDatabase
from swipe_tpu.io.db import FastaDatabase as JaxFastaDatabase
from swipe_tpu.io.fasta import preprocess_query as jax_preprocess_query
from swipe_tpu.ops.align_hint import hint_endpoint as jax_hint_endpoint
from swipe_tpu.ops.sw_stream import sw_scores_stream_lax
from swipe_tpu.parallel import multihost as jmh
from swipe_tpu.pipeline import SearchParams as JaxSearchParams
from swipe_tpu.pipeline import SearchTimings as JaxSearchTimings
from swipe_tpu.stats import EvalueModel as JaxEvalueModel
from swipe_tpu_torch.batching import pack_stream
from swipe_tpu_torch.cli import BACKENDS
from swipe_tpu_torch.hits import HitList
from swipe_tpu_torch.io.blastdb import BlastDatabase
from swipe_tpu_torch.io.blastdb_writer import make_deflines
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import sw_stream
from swipe_tpu_torch.ops.align_hint import hint_endpoints_grid
from swipe_tpu_torch.parallel import multihost as tmh
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings
from swipe_tpu_torch.stats import EvalueModel

from torch_cli_cases import AA, NT, fasta, mask, run_cli, seqs, write_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed_volumes(d, plans, seed, plant=None, name="sv"):
    """A multi-volume BLAST aa database (one volume a (count, length)
    plan), written by the port's writer, behind ``<name>.pal``."""
    rng = np.random.default_rng(seed)
    vols, sno = [], 0
    for v, (n, L) in enumerate(plans):
        strs = []
        for _ in range(n):
            s = "".join(rng.choice(list(AA), L))
            if plant is not None and sno == 3:
                s = s[:10] + plant + s[10:]
            strs.append(s)
            sno += 1
        write_db(str(d / f"{name}{v}"), strs, "aa", title=f"{name}{v}")
        vols.append(f"{name}{v}")
    (d / f"{name}.pal").write_text(
        f"TITLE  {name} test\nDBLIST {' '.join(vols)}\n")
    return str(d / name)


# ---- host decisions ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_assign_and_stabilize_match_jax(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 500, size=300)
    lens[rng.integers(0, 300, size=5)] = 0           # giants off the curve
    cum = np.concatenate([[0], np.cumsum(lens)])
    cuts = np.sort(rng.choice(np.arange(1, 300), size=6, replace=False))
    segments = [(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])]
    for n in (2, 3, 5):
        w = rng.random(n) * 10
        w[rng.integers(0, n)] = 0.0 if seed % 2 else w[0]
        assert tmh.assign_ranges(segments, w, cum) == \
            jmh.assign_ranges(segments, w, cum)
        prev = rng.random(n) + 0.5 if seed % 3 else None
        for drift in (1.10, 1.8):
            got = tmh.stabilize_speeds(prev, w, drift)
            want = jmh.stabilize_speeds(prev, w, drift)
            assert np.array_equal(got, want)
            assert (got is prev) == (want is prev)
    assert tmh.assign_ranges([], np.ones(2), cum) == [[], []]
    for use, lpd, qlen in ((False, 1024, 2048), (True, 1024, 512),
                           (True, 2048, 512), (True, 2048, 640),
                           (True, 1024, 1152)):
        assert tmh._pick_stream_mode(use, lpd, qlen) == \
            jmh._pick_stream_mode(use, lpd, qlen)


def test_split_seqnos_matches_jax(tmp_path):
    """Residue-balanced cuts, snapped to volume starts only within the
    balance tolerance, on near-balanced and skewed volumes and FASTA."""
    for plans, seed in (((7, 30), (5, 30), (9, 30)), 3), \
            (((30, 400), (5, 40), (5, 40), (5, 40)), 11):
        base = _skewed_volumes(tmp_path, plans, seed, name=f"s{seed}_")
        for n_hosts in (1, 2, 3):
            got = tmh.split_seqnos(BlastDatabase(base, "aa"), n_hosts)
            assert got == jmh.split_seqnos(JaxBlastDatabase(base, "aa"),
                                           n_hosts)
            assert got[0][0] == 0 and got[-1][1] == sum(n for n, _ in plans)
    fa = ">a x\nARN\n>b y\nDCQWW\n>c z\nEGH\n"
    assert tmh.split_seqnos(FastaDatabase(io.StringIO(fa), "aa"), 2) == \
        jmh.split_seqnos(JaxFastaDatabase(io.StringIO(fa), "aa"), 2)


def test_unit_metas_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    nt = seqs(rng, 9, 10, 80, NT)
    write_db(str(tmp_path / "nt"), nt, "nt", make_deflines(
        [f"n{i}" for i in range(9)], taxids=[100 * (i % 3) for i in
                                             range(9)]))
    (tmp_path / "taxids.txt").write_text("100\n200\n")
    for symtype, taxids in ((0, None), (3, None), (4, "taxids.txt"),
                            (0, "taxids.txt")):
        kw = dict(taxid_file=str(tmp_path / taxids) if taxids else None)
        got = BlastDatabase(str(tmp_path / "nt"), "nt",
                            **kw).unit_metas(symtype)
        want = JaxBlastDatabase(str(tmp_path / "nt"), "nt",
                                **kw).unit_metas(symtype)
        assert np.array_equal(got, want) and got.shape[1] == 3
        assert (taxids is None) == (0 in got[:, 0])
        units = list(BlastDatabase(str(tmp_path / "nt"), "nt",
                                   **kw).search_units(symtype))
        assert np.array_equal(got, [(u.seqno, u.dstrand, u.dframe)
                                    for u in units])
    fa = fasta(seqs(rng, 5, 5, 30, AA))
    assert np.array_equal(
        FastaDatabase(io.StringIO(fa), "aa").unit_metas(1),
        JaxFastaDatabase(io.StringIO(fa), "aa").unit_metas(1))


def test_lane_pack_from_fresh_carry_state_is_k2():
    """The "lax" route's wide lane packs: the carry kernel's row form from
    a fresh state (plain version here, K3r on the card) computes the
    stream kernel's function — against the plain K2 with the int8
    matrix, and against the JAX lax twin with the int8 and an int32
    matrix."""
    rng = np.random.default_rng(8)
    ch = pack_stream([rng.integers(1, 24, size=int(n), dtype=np.int8)
                      for n in rng.integers(5, 200, size=300)],
                     nseqs=64)[0]
    qs = [rng.integers(1, 24, size=int(n), dtype=np.int8)
          for n in (1, 37, 128, 250)]
    qc, ql = sw_stream.build_qcodes(qs, 256)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1).matrix
    for mat in (sw_stream.build_matrix8(m),
                sw_stream.build_matrix_wide(np.asarray(m) * 100)):
        qct, qlt, matt = (torch.from_numpy(x) for x in (qc, ql, mat))
        data, start, _, _ = sw_stream.chunk_tensors(
            ch.data_t, ch.start, ch.end_block, ch.lane, "cpu")
        kw = dict(gapopenextend=1200 if mat.dtype == np.int32 else 12,
                  gapextend=100 if mat.dtype == np.int32 else 1)
        got = tmh._scores_lax(qct, qlt, matt, data, start, **kw)
        want = np.asarray(sw_scores_stream_lax(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(mat),
            jnp.asarray(ch.data), jnp.asarray(ch.start), **kw))
        assert np.array_equal(got.numpy(), want)
        h, e, s = sw_stream.make_stream_state(4, 256, 64)
        rows = sw_stream.sw_scores_stream_carry_rows(
            qct, qlt, matt, data, start, h, e, s, carry_in=False,
            carry_out=False, **kw)[0]
        assert np.array_equal(rows.numpy(), want)
        if mat.dtype == np.int8:
            assert np.array_equal(sw_stream.sw_scores_stream(
                qct, qlt, matt, data, start, **kw).numpy(), want)


# ---- the single-host pieces the align phase needs ---------------------------

def test_hint_endpoint_and_fill_hit_match_jax():
    # the port's hint pass against JAX's hint_endpoint a subject, then its
    # align phase (align_prepare -> hint_endpoints_grid -> align_finish)
    # against JAX's fill_hit and align_all
    rng = np.random.default_rng(12)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1).matrix
    q = rng.integers(1, 24, size=60, dtype=np.int8)
    subs = []
    for i in range(12):
        d = rng.integers(1, 24, size=int(rng.integers(1, 300)),
                         dtype=np.int8)
        if i % 3 == 0:
            # the query's window twice: tied endpoints
            d = np.concatenate([d[:20], q[10:40], d[20:50], q[10:40]])
        subs.append(d)
    assert hint_endpoints_grid([(q, subs)], m, 11, 1)[0] == \
        [jax_hint_endpoint(q, d, m, 11, 1) for d in subs]
    assert hint_endpoints_grid([(q, subs)], m * 100, 1100, 100)[0] == \
        [jax_hint_endpoint(q, d, m * 100, 1100, 100) for d in subs]

    qstr = "".join(rng.choice(list(AA), 60))
    recs = seqs(rng, 40, 20, 150, AA)
    recs[5] = qstr[5:50]
    recs[9] = qstr[20:55] + recs[9] + qstr[20:55]
    fa = fasta(recs)
    lists = []
    for Hits, Ev, Db, prep, routes in (
            (HitList, EvalueModel, FastaDatabase, preprocess_query,
             ("phases",)),
            (JaxHitList, JaxEvalueModel, JaxFastaDatabase,
             jax_preprocess_query, ("fill", "all"))):
        db = Db(io.StringIO(fa), "aa")
        query = prep("q", qstr, 1, 3)
        ev = Ev(1, query.length, db.seqcount_masked(),
                db.symcount_masked(), matrixname="BLOSUM62", gapopen=11,
                gapextend=1)
        out = []
        for route in routes:
            hl = Hits(25, 10, 1, 2**63 - 1, 0.0, 1e9, ev, db, 1, 3)
            sc = np.array([int(db.get_sequence(s, 1)[0].sum(
                dtype=np.int64)) % 97 for s in range(40)])
            hl.enter_batch(np.arange(40), sc, 0, 0, np.zeros(40, int),
                           np.zeros(40, int))
            hl.finalize()
            if route == "phases":
                shown, bins = hl.align_prepare(query)
                res = hint_endpoints_grid(
                    [(qs, [h.dseq for _, h in items]) for qs, items in bins],
                    m, 11, 1)
                hints = {i: r for (_, items), rs in zip(bins, res)
                         for (i, _), r in zip(items, rs) if r[1] > 0 and r[2]}
                hl.align_finish(query, m, 11, 1, shown, hints)
            elif route == "fill":
                for i, h in enumerate(hl.hits):
                    hl.fill_hit(i, h, query, m, 11, 1)
            else:
                hl.align_all(query, m, 11, 1)
            out.append([(h.seqno, h.score, h.score_align, h.align_q_start,
                         h.align_d_start, h.align_q_end, h.align_d_end,
                         h.alignment, h.header, h.dlen) for h in hl.hits])
        assert all(o == out[0] for o in out)
        lists.append(out[0])
    assert lists[0] == lists[1] and len(lists[0]) == 25


# ---- one rank in process ----------------------------------------------------

def _hit_key(hl):
    return [(h.seqno, h.qstrand, h.qframe, h.dstrand, h.dframe, h.score,
             h.alignment) for h in hl.hits], hl.totalhits, hl.obvious


def _engines(fasta_text, dbtype, params, queries, *, backend, devices,
             max_cols=None, strands=3):
    """The port's MultiHostEngine of one rank against SearchEngine (hit
    lists, alignments, counters) and against JAX's MultiHostEngine on
    the lax backend (the cascade counters, which count per chunk)."""
    symtype = params["symtype"]
    mh = tmh.MultiHostEngine(FastaDatabase(io.StringIO(fasta_text), dbtype),
                             SearchParams(**params), backend=backend,
                             devices=devices, max_cols=max_cols)
    sh = SearchEngine(FastaDatabase(io.StringIO(fasta_text), dbtype),
                      SearchParams(**params), device="cpu")
    jx = jmh.MultiHostEngine(JaxFastaDatabase(io.StringIO(fasta_text),
                                              dbtype),
                             JaxSearchParams(**params), backend="lax",
                             max_cols=max_cols)
    tm, ts, tj = SearchTimings(), SearchTimings(), JaxSearchTimings()
    got = mh.search_batch([preprocess_query(f"q{i}", q, symtype, strands)
                           for i, q in enumerate(queries)], tm)
    want = sh.search_batch([preprocess_query(f"q{i}", q, symtype, strands)
                            for i, q in enumerate(queries)], ts)
    jgot = jx.search_batch([jax_preprocess_query(f"q{i}", q, symtype,
                                                 strands)
                            for i, q in enumerate(queries)], tj)
    assert [_hit_key(h) for h in got] == [_hit_key(h) for h in want] == \
        [_hit_key(h) for h in jgot]
    assert tm.compute == ts.compute == tj.compute
    if backend == "lax" and devices is None:
        assert tm.rounds == tj.rounds
    return mh, got


@pytest.fixture(scope="module")
def mh_fasta():
    rng = np.random.default_rng(9)
    qp = "".join(rng.choice(list(AA), 70))
    recs = seqs(rng, 120, 40, 150, AA)
    recs[17] = qp[5:60]
    recs[93] = recs[93][:20] + qp[10:45] + recs[93][20:]
    return qp, fasta(recs, "s")


@pytest.mark.parametrize("backend,devices", [("lax", ["cpu"]),
                                             ("stream", CPU2),
                                             ("lax", ["cpu"] * 3)])
def test_one_rank_blastp(mh_fasta, backend, devices):
    qp, fa = mh_fasta
    params = dict(symtype=1, gapopen=11, gapextend=1, descriptions=40,
                  alignments=10)
    mh, got = _engines(fa, "aa", params, [qp, qp[::-1]], backend=backend,
                       devices=devices)
    assert {h.seqno for h in got[0].hits[:2]} == {17, 93}
    assert mh._nseqs_local == (2048 if backend == "stream" else 513
                               if len(devices) == 3 else 512)


def test_one_rank_wide_matrix_and_giant():
    """A score matrix outside int8 (blastn +2/-300) on the "lax" route
    (the carry kernel's row form from a fresh state), and a giant unit
    past max_cols on the owner's carry series."""
    rng = np.random.default_rng(13)
    qn = "".join(rng.choice(list(NT), 60))
    recs = seqs(rng, 40, 50, 150, NT)
    recs[7] = recs[7][:20] + qn + recs[7][20:]
    recs.append("".join(rng.choice(list(NT), 3000)))
    recs[-1] = recs[-1][:1500] + qn[::-1] + recs[-1][1500:]
    params = dict(symtype=0, matchscore=2, mismatchscore=-300, gapopen=5,
                  gapextend=2, descriptions=20, alignments=5, expect=1e12)
    mh, got = _engines(fasta(recs), "nt", params, [qn], backend="lax",
                       devices=CPU2, max_cols=2048)
    assert list(mh._giant_ids) == [40]
    assert {h.seqno for h in got[0].hits[:3]} >= {7}


def test_one_rank_segmented_giant_and_translated_ties():
    """The stream backend's giants on overlapped pieces (the segmented
    route), and identical translated sequences tying en masse at the
    per-device top-k boundary."""
    rng = np.random.default_rng(77)
    q = "".join(rng.choice(list(AA), 40))
    giant = "".join(rng.choice(list(AA), 5000)) + q + \
        "".join(rng.choice(list(AA), 60))
    fa = f">g0 giant\n{giant}\n" + fasta(seqs(rng, 16, 30, 60, AA))
    params = dict(symtype=1, gapopen=11, gapextend=1, descriptions=20,
                  alignments=2, expect=1e9)
    mh = tmh.MultiHostEngine(FastaDatabase(io.StringIO(fa), "aa"),
                             SearchParams(**params), backend="stream",
                             devices=CPU2, max_cols=2048)
    slots = [(None, 1, 0, preprocess_query("q", q, 1, 3).aa[0])]
    (ids, sc), = list(mh._iter_carry_scores(slots, 128))
    assert list(ids) == [0]
    from swipe_tpu_torch.ops.sw_ref import sw_numpy
    assert int(sc[0, 0]) == sw_numpy(slots[0][3], mh._giant_seqs[0],
                                     mh.matrix.matrix, 11, 1)

    s = "".join(rng.choice(list(NT), 90))
    same = "".join(f">t{i} same {i}\n{s}\n" for i in range(150))
    params = dict(symtype=3, gapopen=11, gapextend=1, descriptions=10,
                  alignments=0, expect=1e9)
    _, got = _engines(same, "nt", params,
                      ["".join(rng.choice(list(AA), 30))], backend="lax",
                      devices=CPU2)
    assert len(got[0].hits) == 10


def test_work_curve_and_wave2_cache():
    """The work curve leaves giants out; the shard decoded at init
    serves wave packs by range; a repeated search reuses the wave-2
    pack; the cache holds two assignments, least recently used out."""
    rng = np.random.default_rng(21)
    recs = seqs(rng, 40, 50, 200, AA)
    recs[7] = "".join(rng.choice(list(AA), 5000))
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=40, alignments=0, expect=1e9)
    eng = tmh.MultiHostEngine(FastaDatabase(io.StringIO(fasta(recs)), "aa"),
                              params, max_cols=2048, backend="lax",
                              devices=["cpu"])
    lens = np.array([len(s) for s in recs])
    assert int(eng._cum_work[-1]) == int(np.where(lens > 2048, 0,
                                                  lens).sum())
    assert eng._cum_work[8] - eng._cum_work[7] == 0
    ids_a, seqs_a = eng._units_for_range(3, 17)
    ids_b, seqs_b = eng._load_units(3, 17, keep_giants=False)
    assert list(ids_a) == list(ids_b) and 7 not in set(
        eng.unit_meta[ids_a, 0])
    assert all(np.array_equal(a, b) for a, b in zip(seqs_a, seqs_b))
    calls = []
    orig = eng._pack_ranges
    eng._pack_ranges = lambda pieces: (calls.append(tuple(pieces)),
                                       orig(pieces))[1]
    query = preprocess_query("q", "".join(rng.choice(list(AA), 60)), 1, 3)
    r1 = eng.search_batch([query])[0]
    npacks = len(calls)
    r2 = eng.search_batch([query])[0]
    assert len(calls) == npacks >= 1
    assert _hit_key(r1) == _hit_key(r2) and r1.count > 0

    eng._wave2_cache = {}
    packs = []
    eng._pack_ranges = lambda mine: (packs.append(tuple(mine)),
                                     ["pack", tuple(mine)])[1]
    a, b, c = [(0, 50)], [(0, 80)], [(0, 30)]
    for mine in (a, b, a, b):
        assert eng._wave2_for(mine) == ["pack", tuple(mine)]
    assert packs == [tuple(a), tuple(b)]
    eng._wave2_for(c)
    eng._wave2_for(b)
    assert len(packs) == 3
    eng._wave2_for(a)
    assert packs[-1] == tuple(a) and len(packs) == 4


def test_engine_devices(monkeypatch):
    """CUDA devices unless the caller asks for the CPU, as the CLI does
    for a CPU backend (cli.BACKENDS); without a card that raises."""
    fa = ">a x\nACDEFGHIKL\n"
    eng = tmh.MultiHostEngine(FastaDatabase(io.StringIO(fa), "aa"),
                              SearchParams(), backend="stream_interpret",
                              devices=[BACKENDS["stream_interpret"][1]])
    assert eng._devices == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "stream", "pallas", "lax"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmh.MultiHostEngine(FastaDatabase(io.StringIO(fa), "aa"),
                                SearchParams(), backend=backend)


# ---- two processes ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_multi(tmp_path, args, nproc=2, extra_env=None):
    """``python -m swipe_tpu_torch --backend lax --mh-procs N`` in N
    processes on one host; returns (rank 0's output, every rank's
    stderr)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           **(extra_env or {})}
    out = tmp_path / "multi.txt"
    procs = []
    for r in range(nproc):
        cmd = [sys.executable, "-m", "swipe_tpu_torch", *args, "--backend",
               "lax", "--mh-procs", str(nproc), "--mh-rank", str(r),
               "--mh-coord", f"localhost:{port}"]
        if r == 0:
            cmd += ["-o", str(out)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1].decode()[-4000:])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    return out.read_text(), errs


@pytest.fixture(scope="module")
def two_proc_files(tmp_path_factory, mh_fasta):
    d = tmp_path_factory.mktemp("mh2")
    qp, fa = mh_fasta
    (d / "db.fa").write_text(fa)
    (d / "qp.fa").write_text(f">q mh query\n{qp}\n")
    rng = np.random.default_rng(9)
    qn = "".join(rng.choice(list(NT), 90))
    recs = seqs(rng, 60, 60, 220, NT)
    recs[11] = recs[11][:30] + qn + recs[11][30:]
    (d / "dbn.fa").write_text(fasta(recs, "n"))
    (d / "qn.fa").write_text(f">qn mh nt query\n{qn}\n")
    giant = "".join(rng.choice(list(NT), 20000))
    (d / "dbg.fa").write_text(fasta(recs[:24], "g") + ">gX giant contig\n"
                              + giant[:9000] + qn + giant[9000:] + "\n")
    _skewed_volumes(d, ((20, 300), (4, 50), (4, 50)), 23, plant=qp[5:55],
                    name="skewed")
    return d


CASES = {
    "blastp-m0": ["-p", "blastp", "-m", "0", "-d", "db.fa", "-i", "qp.fa"],
    "tblastn-m9": ["-p", "tblastn", "-m", "9", "-e", "1000", "-d", "dbn.fa",
                   "-i", "qp.fa"],
    "blastn-strands": ["-p", "blastn", "-m", "0", "-e", "1000", "-d",
                       "dbn.fa", "-i", "qn.fa"],
    "blastn-giant": ["-p", "blastn", "-m", "9", "-e", "1000", "-d",
                     "dbg.fa", "-i", "qn.fa"],
    "blastn-wide": ["-p", "blastn", "-r", "2", "-q", "-300", "-G", "5",
                    "-E", "2", "-m", "8", "-e", "1e12", "-d", "dbn.fa",
                    "-i", "qn.fa"],
    "skewed-volumes": ["-p", "blastp", "-m", "9", "-e", "1000", "-d",
                       "skewed", "-i", "qp.fa"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_print_single_process_bytes(two_proc_files, case):
    args = [str(two_proc_files / a) if (two_proc_files / a).exists()
            or a == "skewed" else a for a in CASES[case]]
    single = mask(run_cli(jax_cli_main, args + ["--backend", "lax"]))
    multi, errs = _run_multi(two_proc_files, args)
    assert mask(multi) == single
    assert len(single) > 8
    for r, err in enumerate(errs):
        assert re.search(rf"rank {r} wave2 residues \d+ ", err), err


def test_slow_rank_gets_smaller_dynamic_share(two_proc_files):
    """A rank slowed by the JAX package's test hook (a sleep before each
    of its chunks) measures a lower speed; the wave-2 assignment becomes
    dynamic and gives it the smaller share.  Checks the assignment, not
    wall times; the output stays the single process's."""
    args = ["-p", "blastp", "-m", "9", "-d", str(two_proc_files / "db.fa"),
            "-i", str(two_proc_files / "qp.fa")]
    single = mask(run_cli(jax_cli_main, args + ["--backend", "lax"]))
    multi, errs = _run_multi(two_proc_files, args, extra_env={
        "SWIPE_TPU_TEST_SLOW_RANK": "0", "SWIPE_TPU_TEST_CHUNK_SLEEP": "1.5"})
    assert mask(multi) == single
    shares = {}
    for err in errs:
        m = re.search(r"rank (\d+) wave2 residues (\d+) \(speed \d+/s, "
                      r"dynamic\)", err)
        assert m, err
        shares[int(m.group(1))] = int(m.group(2))
    assert shares[0] < shares[1], shares
