"""Smoke run of swipe_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — compile the CUDA kernels (nvcc, sm_90a) and the host library
             from the sources in this checkout;
2. check   — hold each kernel against its plain PyTorch version on the
             card, exact equality (integer DP): the profile build and the
             stream kernel on a 2048-lane, 64-block chunk with 4 queries of
             32-512 rows (with and without profiles, with a clamp), the
             hint kernel on 1024-lane bins with forced ties;
3. search  — the port's normal entry points (FastaDatabase ->
             SearchEngine.search_batch -> Reporter) on a Swiss-Prot-scale
             database: 570,000 random sequences with the published
             Swiss-Prot composition and length model, 16 queries of
             200 aa, BLOSUM62 11/1, -v 250 -b 100.  Every kernel's launch
             count must be > 0; the top 20 hit scores of every query and
             the scores of its three planted homologs must equal the
             NumPy oracle, and every shown alignment must re-walk to its
             hit's score.  The search then runs once more under
             torch.profiler for the device time by kernel and the busy
             share;
4. time    — each kernel, its plain version and its bound at the inputs of
             its largest launch in the search (the kernel is held against
             its plain version there too), and the stream kernel there
             without profiles too.  The bound counts the real cells and
             the least instructions a cell takes on sm_90a;
5. cli     — ``python -m swipe_tpu_torch -m 8`` on a small FASTA database.

The last three lines are the kernels' JSON record, the card's name and
power limit (nvidia-smi), and the result line.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from swipe_tpu_torch import _build
from swipe_tpu_torch.batching import PAD_SYMBOL, pack_stream
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import sw_stream as sw
from swipe_tpu_torch.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings
from swipe_tpu_torch.report import Reporter

REPO = os.path.dirname(os.path.abspath(__file__))

# UniProtKB/Swiss-Prot amino-acid composition (release statistics, %) and
# a log-normal length model fitted to its median (292) and mean (361),
# clipped at titin (35,213) — the JAX package's bench_corpus.py model
SWISSPROT_AA_PERCENT = {
    "A": 8.25, "R": 5.53, "N": 4.06, "D": 5.45, "C": 1.38,
    "Q": 3.93, "E": 6.75, "G": 7.07, "H": 2.27, "I": 5.96,
    "L": 9.66, "K": 5.84, "M": 2.42, "F": 3.86, "P": 4.70,
    "S": 6.56, "T": 5.34, "W": 1.08, "Y": 2.92, "V": 6.87,
}
LEN_MU, LEN_SIGMA, LEN_MIN, LEN_MAX = 5.677, 0.651, 2, 35213

# H100 SXM (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; 67 TFLOP/s fp32,
# an FMA counted as two, on 128 lanes per SM at 1.98 GHz.  No SM issues
# more than 4 warp instructions (128 lanes) a clock, whatever the pipe, so
# 33.5 T thread instructions a second is the ceiling of any instruction
# mix; the int32 pipe alone has 64 lanes per SM, 16.75 T a second.  Both
# are derived from the data sheet, not measured on the card.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# Instructions per DP cell.  The least on sm_90a, with the DPX
# instructions: h = max(diag + p, E, 0) (__viaddmax_s32_relu), h =
# max(h, F), S = max(S, h), t = h - Q, E = max(E - R, t) and
# F = max(F - R, t) (__viaddmax_s32): 6.  The hint kernel keeps a column
# max and its row instead of S: a packed (score, row) key and its max, 7.
# The kernels as written use two-operand int32 add/max: 10 and 13.
OPS_PER_CELL, HINT_OPS_PER_CELL = 6, 7
INT32_OPS_PER_CELL, HINT_INT32_OPS_PER_CELL = 10, 13

KERNELS = {   # wrapper -> (source, TPU kernel it replaces)
    "build_dprofile_series": ("swipe_tpu_torch/csrc/dprofile.cu",
                              "swipe_tpu/ops/sw_stream.py:154"),
    "sw_scores_stream": ("swipe_tpu_torch/csrc/stream.cu",
                         "swipe_tpu/ops/sw_stream.py:568"),
    "sw_hint_stream": ("swipe_tpu_torch/csrc/hint.cu",
                       "swipe_tpu/ops/sw_stream.py:990"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def swissprot_fasta(path: str, n: int, nq: int, qlen: int,
                    rng: np.random.Generator):
    """Write n Swiss-Prot-like protein records to ``path`` (one line per
    sequence; all residues from one draw) and make nq queries of qlen
    residues.  Each query is a window of a database sequence with a
    fifth of its residues redrawn, and two more mutated copies are
    planted in other records, so every query has true homologs besides
    the random hits.  Returns (residue count, query strings, each
    query's three homologous records: its source and the two copies)."""
    letters = np.frombuffer("".join(SWISSPROT_AA_PERCENT).encode(),
                            dtype=np.uint8)
    freqs = np.array(list(SWISSPROT_AA_PERCENT.values()))
    freqs /= freqs.sum()
    lens = np.clip(rng.lognormal(LEN_MU, LEN_SIGMA, n).astype(np.int64),
                   LEN_MIN, LEN_MAX)
    res = rng.choice(letters, size=int(lens.sum()), p=freqs)
    starts = np.cumsum(lens) - lens
    hosts = rng.choice(np.flatnonzero(lens >= qlen), size=3 * nq,
                       replace=False)

    def mutate(seq):
        seq = seq.copy()
        pos = rng.random(qlen) < 0.2
        seq[pos] = rng.choice(letters, size=int(pos.sum()), p=freqs)
        return seq

    queries = []
    for i in range(nq):
        src = res[starts[hosts[3 * i]]:][:qlen]
        q = mutate(src)
        queries.append(q.tobytes().decode())
        for h in hosts[3 * i + 1: 3 * i + 3]:
            res[starts[h]: starts[h] + qlen] = mutate(q)
    blob = res.tobytes()
    with open(path, "wb") as f:
        for i, (st, L) in enumerate(zip(starts.tolist(), lens.tolist())):
            f.write(b">s%d seq %d\n%s\n" % (i, i, blob[st:st + L]))
    return int(lens.sum()), queries, hosts.reshape(nq, 3).tolist()


def swissprot_letters(n: int, rng: np.random.Generator) -> str:
    freqs = np.array(list(SWISSPROT_AA_PERCENT.values()))
    return "".join(rng.choice(list(SWISSPROT_AA_PERCENT), size=n,
                              p=freqs / freqs.sum()))


# ---- phase 2: kernels against their plain versions -------------------------

def _compare(name, got, want, report):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, bad = 0, 0
    for g, w in zip(got, want):
        d = (g.long() - w.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        bad += int((d != 0).sum())
    r = report.setdefault(name, {"max_abs_err": 0, "mismatches": 0,
                                 "launches": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["mismatches"] += bad
    r["launches"] += 1        # one kernel launch per comparison


def check_kernels(dev, report, nseqs=2048, nblocks=64, seed=1):
    rng = np.random.default_rng(seed)
    m62 = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    m8 = torch.from_numpy(sw.build_matrix8(m62.matrix)).to(dev)
    # a chunk of exactly nblocks blocks: random sequences LPT-packed
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(1, 300, size=nseqs * nblocks * 16 // 140)]
    ch = pack_stream(seqs, nseqs=nseqs, max_cols=nblocks * 16)[0]
    data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                         ch.lane, dev)
    dp = sw.build_dprofile_series(m8, data)
    _compare("build_dprofile_series", dp,
             sw.build_dprofile_series_plain(m8, data), report)
    qs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
          for L in (32, 200, 377, 512)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 512))
    for prof, clamp in ((dp, None), (None, None), (dp, 80)):
        kw = dict(gapopenextend=12, gapextend=1, clamp=clamp, dprof=prof)
        _compare("sw_scores_stream",
                 sw.sw_scores_stream(qc, ql, m8, data, start, **kw),
                 sw.sw_scores_stream_plain(qc, ql, m8, data, start, **kw),
                 report)
    # hint bins: the query repeated, low-complexity subjects and a start
    # mask give ties at several endpoints
    nb, L = 4, 512
    hq = [rng.integers(1, 26, size=int(n), dtype=np.int8)
          for n in (40, 120, 200, 250)]
    dense = np.full((nb, L, 1024), 31, dtype=np.int8)
    for b, q in enumerate(hq):
        for j in range(1024):
            kind = j % 3
            if kind == 0:
                s = np.concatenate([q[:60], q[:60]])
            elif kind == 1:
                s = np.full(int(rng.integers(5, 200)), q[0], np.int8)
            else:
                s = rng.integers(1, 26, size=int(rng.integers(1, L)),
                                 dtype=np.int8)
            dense[b, :len(s), j] = s
    dense[:, :, -40:] = PAD_SYMBOL     # empty lanes, as in a bin's last warp
    starts = np.zeros((nb, 1024), np.int32)
    starts[:, 1::7] = rng.integers(0, 100, size=starts[:, 1::7].shape)
    args = [torch.from_numpy(a).to(dev) for a in
            (*sw.build_qcodes(hq, 256), dense, starts)]
    args.insert(2, m8)
    for go in (11, 150):        # gapopenextend > 128 too
        kw = dict(gapopenextend=go + 1, gapextend=1)
        _compare("sw_hint_stream", sw.sw_hint_stream(*args, **kw),
                 sw.sw_hint_stream_plain(*args, **kw), report)
    sync(dev)


# ---- phase 3: the search ---------------------------------------------------

def record_calls(names):
    """Wrap the kernel wrappers so each one's arguments at its largest
    call are kept for the timing phase; the wrapped functions (and their launch counts)
    are the originals."""
    calls, sizes = {}, {}

    def wrap(name, fn):
        def recorded(*a, **k):
            size = max(t.numel() for t in a if torch.is_tensor(t))
            if size >= sizes.get(name, 0):   # keep the largest call
                calls[name], sizes[name] = (a, k), size
            return fn(*a, **k)
        return recorded

    originals = {n: getattr(sw, n) for n in names}
    for n, fn in originals.items():
        setattr(sw, n, wrap(n, fn))
    return calls, originals


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def search(dev, workdir, nseq, nq, card, seed=2):
    rng = np.random.default_rng(seed)
    t0 = time.time()
    path = os.path.join(workdir, "swissprot_like.fa")
    residues, qstr, homologs = swissprot_fasta(path, nseq, nq, 200, rng)
    db = FastaDatabase(path, "aa", title="swissprot-like")
    os.remove(path)
    queries = [preprocess_query(f"q{i}", s, 1, 3)
               for i, s in enumerate(qstr)]
    t1 = time.time()
    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    engine = SearchEngine(db, params, device=dev)
    t2 = time.time()
    log(f"search: {nseq} sequences, {residues} residues, {nq} queries of "
        f"200 aa; data {t1 - t0:.1f} s, pack {t2 - t1:.1f} s, "
        f"{len(engine.chunks)} chunks of {engine.chunks[0].nseqs} lanes")

    for fn in KERNELS:
        getattr(sw, fn).launches = 0
    calls, originals = record_calls(KERNELS)
    try:
        timings = SearchTimings()
        sync(dev)
        w0 = time.time()
        hitlists = engine.search_batch(queries, timings)
        sync(dev)
        wall = time.time() - w0
    finally:
        for n, fn in originals.items():
            setattr(sw, n, fn)
    launches = {fn: getattr(sw, fn).launches for fn in KERNELS}
    cells = residues * 200 * nq
    log(f"search: launches {json.dumps(launches)}")
    for fn, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{fn} was not launched by the search")

    buf = io.StringIO()
    for q, hl, homs in zip(queries, hitlists, homologs):
        Reporter(buf, 0, 1, engine.matrix.matrix, query=q).show(hl, "db")
        top = hl.hits[:20]
        want = [int(sw_numpy_many(q.aa[0], [h.dseq], engine.matrix.matrix,
                                  11, 1)[0]) for h in top]
        if [h.score for h in top] != want:
            raise RuntimeError(f"{q.description}: top scores "
                               f"{[h.score for h in top]} != oracle {want}")
        # a lane or sequence the kernels dropped would lose a true hit
        found = {h.seqno: h.score for h in hl.hits}
        for rec in homs:
            want = int(sw_numpy_many(q.aa[0], [db.get_sequence(rec, 1)[0]],
                                     engine.matrix.matrix, 11, 1)[0])
            if found.get(rec) != want:
                raise RuntimeError(f"{q.description}: homolog s{rec} "
                                   f"scored {found.get(rec)}, oracle {want}")
        for h in hl.hits[:hl.showalignments]:
            if h.score_align != h.score:
                raise RuntimeError(f"{q.description}: seq {h.seqno} aligns "
                                   f"to {h.score_align}, scored {h.score}")
    gcups = cells / timings.elapsed / 1e9
    log(f"search: scoring {timings.elapsed:.3f} s = {gcups:.1f} GCUPS "
        f"({cells} cells), align phase {wall - timings.elapsed:.3f} s, "
        f"wall {wall:.3f} s, report {len(buf.getvalue())} bytes; "
        f"top scores ({sum(min(20, h.count) for h in hitlists)} hits) and "
        f"3 homologs of each of {nq} queries equal the oracle [{card}]")
    stats = {"gcups": gcups, "scoring_s": timings.elapsed,
             "align_s": wall - timings.elapsed, "wall_s": wall,
             "cells": cells}
    stats["profile"] = profile_search(engine, queries, cells)
    return launches, calls, stats


def profile_search(engine, queries, cells):
    """The same search again (chunks now resident on the card) under
    torch.profiler: device time by kernel and the device's busy share of
    the wall time.  The launch counts were read before."""
    from torch.profiler import ProfilerActivity, profile
    timings = SearchTimings()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.search_batch(queries, timings)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_ms = {}
    for e in prof.key_averages():     # device-side events only
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.self_device_time_total / 1e3
            dev_ms[e.key] = dev_ms.get(e.key, 0.0) + t
    busy = sum(dev_ms.values())
    top = {k.split("(")[0].strip(): v
           for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]}
    out = {"wall_s": wall, "scoring_s": timings.elapsed,
           "gcups": cells / timings.elapsed / 1e9,
           "device_busy_ms": busy, "busy_share": busy / 1e3 / wall,
           "device_ms_by_kernel": top}
    log(f"profile: {json.dumps(out)}")
    return out


# ---- phase 4: kernel times and bounds --------------------------------------

def _time(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _work(name, args, kw, out):
    """(bytes the function must move, its least instruction count, its
    two-operand int32 operation count) for one call: inputs read once,
    outputs written once, the cells of the true query lengths against
    the real residues (PAD columns excluded)."""
    if name == "build_dprofile_series":
        m8, db = args
        return _nbytes(m8, db, out), 0, 0
    if name == "sw_scores_stream":
        qc, ql, m8, db, start = args
        cells = int(ql.sum()) * int((db != PAD_SYMBOL).sum())
        extra = kw.get("clamp") is not None          # one min a cell
        return (_nbytes(qc, ql, m8, db, start, kw.get("dprof"), out),
                cells * (OPS_PER_CELL + extra),
                cells * (INT32_OPS_PER_CELL + extra))
    qc, ql, m8, db, starts = args
    residues = (db != PAD_SYMBOL).sum(dim=(1, 2))     # per bin
    cells = int((ql.long() * residues).sum())
    return (_nbytes(qc, ql, m8, db, starts, *out), cells * HINT_OPS_PER_CELL,
            cells * HINT_INT32_OPS_PER_CELL)


def time_without_profiles(args, kw, out, ms, report):
    """K2 at the search's call with the scores looked up in the matrix in
    shared memory, beside the profile path (K1 then K2)."""
    kw0 = dict(kw, dprof=None)
    _compare("sw_scores_stream", sw.sw_scores_stream(*args, **kw0), out,
             report)
    ms0 = _time(lambda: sw.sw_scores_stream(*args, **kw0), 5)
    k1 = _time(lambda: sw.build_dprofile_series(args[2], args[3]), 5)
    log(f"time: sw_scores_stream without profiles {ms0:.3f} ms; with "
        f"profiles {ms:.3f} ms + build_dprofile_series {k1:.3f} ms = "
        f"{ms + k1:.3f} ms")


def time_kernels(calls, report):
    rows = {}
    counts = {name: getattr(sw, name).launches for name in KERNELS}
    for name in KERNELS:
        args, kw = calls[name]
        fn = getattr(sw, name)
        plain = getattr(sw, name + "_plain")
        out = fn(*args, **kw)
        ref = plain(*args, **kw)          # also the plain version's warm-up
        _compare(name, out, ref, report)
        del ref
        ms = _time(lambda: fn(*args, **kw), 5)
        plain_ms = _time(lambda: plain(*args, **kw), 1, warm=False)
        nbytes, ops, int32_ops = _work(name, args, kw, out)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ISSUE_PER_S * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations")
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"time: {name} at {shapes}: {ms:.3f} ms, plain {plain_ms:.1f} "
            f"ms, bound {rows[name]['bound_ms']:.4f} ms "
            f"({rows[name]['bound_by']}; bytes {bytes_ms:.4f} ms, "
            f"{ops} least instructions {ops_ms:.4f} ms; as two-operand "
            f"int32 on the int32 pipe "
            f"{int32_ops / INT32_OPS_PER_S * 1e3:.4f} ms)")
        if name == "sw_scores_stream" and kw.get("dprof") is not None:
            time_without_profiles(args, kw, out, ms, report)
    for name, n in counts.items():      # timing launches are not the path's
        getattr(sw, name).launches = n
    return rows


# ---- phase 5: the CLI ------------------------------------------------------

def cli(workdir):
    rng = np.random.default_rng(3)
    recs = [swissprot_letters(int(n), rng)
            for n in rng.integers(30, 600, size=3000)]
    qs = [swissprot_letters(150, rng), recs[11][10:200]]
    db, qf = os.path.join(workdir, "db.fa"), os.path.join(workdir, "q.fa")
    with open(db, "w") as f:
        f.writelines(f">d{i} seq {i}\n{s}\n" for i, s in enumerate(recs))
    with open(qf, "w") as f:
        f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(qs))
    r = subprocess.run([sys.executable, "-m", "swipe_tpu_torch", "-i", qf,
                        "-d", db, "-m", "8"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"CLI exited {r.returncode}:\n{r.stderr}")
    lines = r.stdout.splitlines()
    if not any(ln.startswith("q1\td11") for ln in lines):
        raise RuntimeError("CLI: the planted hit q1 -> d11 is missing")
    log(f"cli: python -m swipe_tpu_torch -m 8: exit 0, {len(lines)} hit "
        "lines")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.time()
    _build.build_kernels()
    native = _build.native_library()
    log(f"build: kernels {sorted(_build.build_kernels())} and host library "
        f"({'built' if native else 'not built: NumPy host paths'}) in "
        f"{time.time() - t:.1f} s")

    report: dict = {}
    check_kernels(dev, report)
    log(f"check: {json.dumps(report)}")
    for name, r in report.items():
        if r["mismatches"]:
            raise RuntimeError(f"{name} differs from its plain version")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches, calls, stats = search(dev, workdir, 570_000, 16, card)
        rows = time_kernels(calls, report)
        del calls
        for name, r in report.items():
            if r["mismatches"]:
                raise RuntimeError(f"{name} differs from its plain version "
                                   "at the search's shapes")
        cli(workdir)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    max_abs_err=report[name]["max_abs_err"],
                    library_ms=None, **rows[name])
               for name, (src, rep) in KERNELS.items()]
    log(f"search: {json.dumps(stats)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
