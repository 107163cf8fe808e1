"""The port end to end on the CPU against the JAX package: packs, engine
hit lists, CLI bytes, the device rule and the import rule (the port
imports neither jax nor swipe_tpu)."""

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from swipe_tpu import native as jax_native
from swipe_tpu.batching import pack_stream as jax_pack_stream
from swipe_tpu.cli import main as jax_cli_main
from swipe_tpu.io.db import FastaDatabase as JaxFastaDatabase
from swipe_tpu.io.fasta import preprocess_query as jax_preprocess_query
from swipe_tpu.pipeline import SearchEngine as JaxSearchEngine
from swipe_tpu.pipeline import SearchParams as JaxSearchParams
from swipe_tpu.pipeline import SearchTimings as JaxSearchTimings
from swipe_tpu_torch import native as torch_native
from swipe_tpu_torch.batching import pack_stream
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops: one intra-op thread is
    several times faster than a pool contended by other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(rng, n, lo, hi, alphabet):
    return ["".join(rng.choice(list(alphabet), int(rng.integers(lo, hi))))
            for _ in range(n)]


def _fasta(recs):
    return "".join(f">seq{i} description {i}\n{s}\n"
                   for i, s in enumerate(recs))


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("data_t", "start", "seqnos", "lane", "end_block"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert g.residues == w.residues


@pytest.mark.parametrize("nseqs,max_cols", [(1024, 8192), (8, 64),
                                            (16, 32)])
def test_pack_stream_identical_python(nseqs, max_cols):
    rng = np.random.default_rng(nseqs + max_cols)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 200, size=600)]
    seqs[5] = rng.integers(1, 26, size=300, dtype=np.int8)   # oversized
    _assert_chunks_equal(pack_stream(seqs, nseqs=nseqs, max_cols=max_cols),
                         jax_pack_stream(seqs, nseqs=nseqs,
                                         max_cols=max_cols))


def test_pack_stream_identical_native(monkeypatch):
    if not torch_native.pack_available():
        pytest.skip("no host library: g++ or native/ sources missing")
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(1, 400, size=5000)]
    # the JAX package's Python loop is the reference
    monkeypatch.setattr(jax_native, "pack_available", lambda: False)
    for nseqs, max_cols in ((1024, 256), (2048, 8192)):
        _assert_chunks_equal(
            pack_stream(seqs, nseqs=nseqs, max_cols=max_cols),
            jax_pack_stream(seqs, nseqs=nseqs, max_cols=max_cols))


def _hit_key(hl):
    return ([(h.seqno, h.score, h.qstrand, h.qframe, h.dstrand, h.dframe,
              h.score_align, h.align_q_start, h.align_q_end,
              h.align_d_start, h.align_d_end, h.alignment)
             for h in hl.hits], hl.totalhits, hl.obvious)


# name -> (symtype, strands, alphabet, nqueries, params)
ENGINE_CASES = {
    "blastp": (1, 3, AA, 1, dict(descriptions=60, alignments=20)),
    "blastp_batch5": (1, 3, AA, 5, dict(descriptions=30, alignments=10,
                                        maxscore=60)),
    "blastn_both": (0, 3, NT, 2, dict(descriptions=40, alignments=15)),
    "tblastn": (3, 3, AA, 2, dict(descriptions=40, alignments=10,
                                  db_gencode=11)),
}

# a back-translation of each amino acid (tblastn plants)
CODON = {"A": "GCT", "R": "CGT", "N": "AAT", "D": "GAT", "C": "TGT",
         "Q": "CAA", "E": "GAA", "G": "GGT", "H": "CAT", "I": "ATT",
         "L": "CTG", "K": "AAA", "M": "ATG", "F": "TTT", "P": "CCG",
         "S": "TCT", "T": "ACC", "W": "TGG", "Y": "TAT", "V": "GTT"}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_hitlists_match_jax(case):
    symtype, strands, alphabet, nq, kw = ENGINE_CASES[case]
    rng = np.random.default_rng(len(case))
    queries = _seqs(rng, nq, 60, 120, alphabet)
    if symtype == 3:
        # a translated nucleotide database: six frames a record, planted
        # back-translated homologs on both strands
        comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
        recs = _seqs(rng, 80, 60, 450, NT)
        for i, q in enumerate(queries):
            nt = "".join(CODON[c] for c in q)
            recs[3 + 7 * i] = "GA" + nt[15:210]
            recs[4 + 7 * i] = "".join(comp[c] for c in reversed(nt[:120]))
    else:
        recs = _seqs(rng, 400, 20, 150, alphabet)
        for i, q in enumerate(queries):       # planted homologs
            recs[3 + 7 * i] = q[5:70]
            recs[4 + 7 * i] = q[:40] + alphabet[0] * 5 + q[40:]
    fasta = _fasta(recs)
    dbtype = "aa" if symtype == 1 else "nt"
    params = dict(symtype=symtype, querystrands=strands, **kw)
    jeng = JaxSearchEngine(
        JaxFastaDatabase(io.StringIO(fasta), dbtype, title="t"),
        JaxSearchParams(**params), backend="lax")
    teng = SearchEngine(FastaDatabase(io.StringIO(fasta), dbtype, title="t"),
                        SearchParams(**params), device="cpu")
    # more units than kbase, so the top-K reduction runs
    assert teng.unit_count > max(kw.values()) + 64
    jt, tt = JaxSearchTimings(), SearchTimings()
    want = jeng.search_batch(
        [jax_preprocess_query(f"q{i}", q, symtype, strands)
         for i, q in enumerate(queries)], jt)
    got = teng.search_batch(
        [preprocess_query(f"q{i}", q, symtype, strands)
         for i, q in enumerate(queries)], tt)
    for g, w in zip(got, want):
        assert _hit_key(g) == _hit_key(w)
        assert g.count > 0
    assert tt.compute == jt.compute and tt.rounds == jt.rounds
    if symtype == 3:
        assert {h.dstrand for hl in got for h in hl.hits[:4]} == {0, 1}


VOLATILE = {
    "0": re.compile(r"^(Search started|Search completed|Elapsed|Speed)"),
    "8": re.compile(r"(?!)"),        # nothing volatile
    "99": re.compile(r"\s*<search(Started|Completed|ElapsedTime|Speed)>"),
}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(21)
    queries = _seqs(rng, 5, 40, 60, AA)
    recs = _seqs(rng, 120, 40, 120, AA)
    recs[7] = queries[0][3:50]
    (d / "db.fa").write_text(_fasta(recs))
    (d / "q.fa").write_text("".join(f">q{i} query {i}\n{q}\n"
                                    for i, q in enumerate(queries)))
    return d


@pytest.mark.parametrize("view", sorted(VOLATILE))
def test_cli_bytes_match_jax(cli_files, view):
    argv = ["-i", str(cli_files / "q.fa"), "-d", str(cli_files / "db.fa"),
            "-m", view, "-v", "20", "-b", "5", "--backend", "lax"]
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
                if not VOLATILE[view].match(ln)]

    assert mask(port.stdout) == mask(buf.getvalue())
    assert "seq7" in port.stdout


def test_engine_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = FastaDatabase(io.StringIO(">a\nACDEFGHIK\n"), "aa", title="t")
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchEngine(db, SearchParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchEngine(db, SearchParams(), device="cuda")
    assert SearchEngine(db, SearchParams(), device="cpu").device.type == \
        "cpu"


def test_import_rule():
    """Every port module and chip_smoke.py import with jax and swipe_tpu
    blocked."""
    code = r"""
import importlib, importlib.util, os, pkgutil, sys
for name in ("jax", "jaxlib", "swipe_tpu"):
    sys.modules[name] = None
import swipe_tpu_torch
names = {m.name for m in pkgutil.walk_packages(swipe_tpu_torch.__path__,
                                               "swipe_tpu_torch.")}
# the host-only modules and both multi-device modules are walked too
assert {"swipe_tpu_torch.io.dump", "swipe_tpu_torch.io.blastdb_writer",
        "swipe_tpu_torch.parallel.distributed",
        "swipe_tpu_torch.parallel.multihost"} <= names, names
for name in sorted(names - {"swipe_tpu_torch.__main__"}):
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "swipe_tpu")
       and sys.modules[n] is not None]
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
