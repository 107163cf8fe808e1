"""Smoke run of swipe_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build    — compile the CUDA kernels (nvcc, sm_90a, one process per
              source) and the host library from the sources in this
              checkout;
2. check    — hold each kernel against its plain PyTorch version on the
              card, exact equality (integer DP): the profile build and the
              stream kernel on a 2048-lane, 64-block chunk with 4 queries
              of 32-512 rows (without and with a clamp), the stream kernel
              at every band height on tests/torch_row_cases.py's launches
              (query lengths at the band edges, over one band, lanes
              refilled at column 16, windows planted across strip and band
              edges, with and without a clamp), the
              hint kernel on 1024-lane bins with forced ties and first
              tracked columns (also with BLOSUM62 scaled by 100: the wide
              instantiation) and on tests/torch_row_cases.py's bins
              (queries at strip and band edges, over one band and over
              1,100 rows, ties across the edges; wide at 255-300 rows),
              directly and through both routes that launch it against
              the host pass, the carry kernel's flow form over a
              2048-lane flow series (lane permutes, a narrowing drain, no
              carry-in at its head, no carry-out at its tail; 128- and
              512-row bands, one with a clamp) and a compact carry series
              (lanes refilled mid-chunk; 256-row bands and three of 512
              rows), its row form over the compact series with queries
              that end inside a strip, at a strip edge, at a band edge,
              take three bands, and an empty slot (int8, with a clamp,
              wide), lanes planted across the compact series' cuts,
              every chunk's dump and carried state, no block profiles,
              the
              wavefront kernel over torch_row_cases' 3-segment giant
              (alignments with long horizontal gaps across slab edges and
              the segment cuts) with 1, 3 and 16 queries and over a
              1,024-column tail segment, the tile pass over four 512-row
              tiles of a 1024-lane, 64-block chunk (queries ending inside
              tile 1, inside tile 3, at a tile edge, and an empty slot;
              and torch_row_cases' tile queries, one row into tile 3, at
              and inside a strip of tile 2, with query windows planted
              across those edges; without and with a clamp), the tile
              carry pass over a
              compact carry series (the same kinds of query ends, with and
              without a clamp), the
              segment kernel of both entry points (the untiled one with
              int8 and int32 profiles, the tiled one) on a 512-lane
              pack_database chunk of 24 segments and 8 padded ones with
              queries of 20-700 rows (the 700-row one in two int8 bands
              and three int32 ones, planes between them), and the peak
              probe (both forms, 8 chains a thread and 1);
3. peak     — the card's int32 and DPX add-max rates and the rate its
              ALU pipe issues the chains' instructions (ops/peak.py,
              slope timing), which the operation bounds of phase 8 divide
              by;
4. search   — the port's normal entry points (FastaDatabase ->
              SearchEngine.search_batch -> Reporter) on a Swiss-Prot-scale
              database: 570,000 random sequences with the published
              Swiss-Prot composition and length model, 16 queries of
              200 aa, BLOSUM62 11/1, -v 250 -b 100 (the plain-pack route).
              The top 20 hit scores of every query and the scores of its
              three planted homologs must equal the NumPy oracle, and every
              shown alignment must re-walk to its hit's score.  The search
              then runs once more under torch.profiler for the device time
              by kernel and the busy share.  long-search: on the same
              engine, 4 queries of 1,537-2,048 aa (20%-mutated copies of
              database records, their planted homologs): one slot group at
              qlen_pad 2048 on the long route (1024 lanes x 16,384
              columns, four 512-row tile passes a chunk, no profiles),
              the same checks.  segment-search: the same database and
              queries with backend "pallas" (pack_database at 512 lanes x
              16,384 columns, the tiled entry point of the segment
              kernel): every hit list must equal the plain-pack route's;
5. proteome — the flow route (K3's flow form, every chunk one launch, no
              block profiles): 20,000 sequences from the same model (the
              size of UniProt's human reference proteome, UP000005640)
              plus one of 35,213 aa (the model's titin-length clip); the
              same queries' shape, scoring and checks.  long-proteome: 16
              mutated copies of its records of 1,100-4,000 aa, several
              slot groups of at most 4 on the plain pack at 1024 lanes
              (not the flow series), the titin's chunk past 16,384
              columns.  segment-proteome: backend "pallas_v1" (the
              untiled entry point), the titin a giant on the carry
              series: every hit list must equal the flow route's;
6. genome   — blastn, +1/-3, gaps 5/2, 16 queries of 500 nt, against one
              chromosome of E. coli K-12 MG1655's length (4,641,652 bp,
              NC_000913.3) at its GC share (50.8%), synthesised from a
              seed, beside 4,000 gene-length records (200-3,000 nt) cut
              from it: the chromosome takes the segmented giant route, the
              genes the plain pack.  Each query has mutated copies planted
              on both strands of the chromosome, one of them inside a gene.
              long-genome: a 16S-length query (1,542 nt, a 10%-mutated copy
              of a chromosome window inside a gene) on both strands: the
              genes in tile passes, the chromosome on the carry series in
              tile passes (K6), hints on the hint kernel over 1,542 rows.
              wide-genome: 8 of the queries with the scoring scaled by 100
              (-r 100 -q -300 -G 500 -E 200, outside int8): the genes on
              the segmented kernel with an int32 profile, the chromosome's
              567 chunks on the wide carry kernel's row form (one launch a
              chunk, none of the flow form), hints on the wide hint
              kernel; planted windows at their oracle, every hit of the
              int8 search a hit here at exactly 100 x its score;
7. tblastn  — the same database under tblastn (db_gencode 11), 16 queries
              of 400 aa with mutated back-translated copies planted the
              same way: the six chromosome frames take the wavefront
              kernel; then the same search with WAVEFRONT_MAX_GIANTS = 0
              (the carry series on K3's row form, one launch a chunk),
              whose hit list must be the same.
              Chromosome hits are held against the oracle over a window
              of +-2 query lengths around each plant, gene hits against
              the oracle over the whole gene;
8. time     — every kernel a search launched held against its plain
              version at that search's largest call of it (the inputs as
              they came in, exact equality), so each path is checked at
              its own shapes (the profile build, which no search
              launches, at the proteome's largest flow chunk); then each
              kernel's time and bound at its largest call over all the
              searches, its plain version's
              time at that call, and the wavefront kernel there with one
              query too; the tile passes of the long-search chunk summed,
              beside one stream-kernel pass over the same 2,048 rows; the
              warp-a-pair kernels (K3's row form, K6) at each search's
              largest call; and each kernel's device time summed over
              every launch of the searches (CUDA events around each
              wrapper call), with the loss it implies against the bound.
              The bound is the largest of three
              terms: the bytes at the data sheet's rate, the real cells'
              least sm_90a instructions (those of the ALU pipe at the rate
              phase 3 measured, all of them at the issue ceiling), and the
              DP's critical path (rows + columns - 1 cells of the longest
              sequence, 3 dependent instructions each at the latency phase
              3 measured);
9. cli      — ``python -m swipe_tpu_torch -m 8`` on a small FASTA database
              (3,000 records);
10. several devices and processes — distributed (right after the
              search phase): parallel/distributed.py's sharded_stream_topk
              (K2) and sharded_topk_scores (K9) on a mesh of two cells of
              the one card over a chunk of the Swiss-Prot model, merged
              top-K and cells equal to one device's over the whole chunk;
              multihost and multihost-wide: MultiHostEngine in this
              process over two cells of the card on the CLI database, 8
              queries, BLOSUM62 (K2, K4) and BLOSUM62 x 100 from a matrix
              file (K3's row form from a fresh state), hit lists equal to
              SearchEngine's; multihost-2proc: ``--mh-procs 2`` in two
              processes on the one card (blastp -m 0 and -m 8 on the CLI
              database, blastn on a small nt database with a 70,000-nt
              record, a giant on its owner's route), rank 0's report
              equal to the single process's but for times and speeds,
              each rank's wave-2 line and launch counts printed (K2 on
              each rank, a giant route's kernel on the long record's
              owner); dump: ``-N 1`` on the CLI
              database gives every record back.

Every search phase sets the launch counts to 0 before it runs and reads
them after; each kernel its route runs must have launched.  Each search
also splits its align phase into host seconds by step (finalize, fetch
and bin, the hint pass with the hint kernel's share, traceback).  The
last three
lines are the kernels' JSON record, the card's name and power limit
(nvidia-smi), and the result line.
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

from swipe_tpu_torch import _build, trace
from swipe_tpu_torch.alphabet import GENETIC_CODES, SYM_NCBI_AA
from swipe_tpu_torch.hits import HitList
from swipe_tpu_torch.batching import (PAD_SYMBOL, SEG_BLK, pack_database,
                                      pack_stream, pack_stream_carry,
                                      pack_stream_flow)
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.matrices import ScoreMatrix
from swipe_tpu_torch.ops import align_hint, peak
from swipe_tpu_torch.ops import sw_segmented as seg
from swipe_tpu_torch.ops import sw_stream as sw
from swipe_tpu_torch.ops import sw_tiled as tiled
from swipe_tpu_torch.ops import sw_wavefront as wf
from swipe_tpu_torch.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings
from swipe_tpu_torch.report import Reporter

REPO = os.path.dirname(os.path.abspath(__file__))
# the row-form kernels' hard inputs, shared with the tests (numpy only)
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_row_cases as rc  # noqa: E402

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
# 33.5 T thread instructions a second is the data sheet's ceiling of any
# instruction mix; the int32 ALU pipe alone has 64 lanes per SM, 16.75 T
# a second.  The peak phase measures the ALU pipe's rate on the card (K10,
# ops/peak.py: the DP's add-max chains, which compile to VIADDMNMX).
HBM_BYTES_PER_S = 3.35e12
DATASHEET_ISSUE_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
PEAK: dict = {}       # the peak phase's measured rates (measure_peak)
# CUDA events around every kernel wrapper call of the searches, by kernel
DEVICE_EVENTS: dict = {}
# Instructions per DP cell: (on the ALU pipe, all, as two-operand int32).
# The least on sm_90a, with the DPX instructions: h = max(diag + p, E, 0)
# (__viaddmax_s32_relu), h = max(h, F), S = max(S, h), t = h - Q,
# E = max(E - R, t) and F = max(F - R, t) (__viaddmax_s32): 6, of which
# the DPX and IMNMX instructions, 5, must take the ALU pipe and t = h - Q
# may issue as an IMAD on the FMA pipe.  The hint kernel keeps a column
# max and its row instead of S: a packed (score, row) key (an IMAD) and
# its max, 7 with 5 on the ALU pipe.  A clamp adds one min (ALU).  The
# kernels as written use two-operand int32 add/max: 10 and 13.  A step
# of K10's chains is two VIADDMNMX, four two-operand add/max.  The
# operation bound is the larger of the ALU instructions over the ALU
# pipe's measured rate and all instructions over the issue ceiling.
CELL_OPS, HINT_CELL_OPS = (5, 6, 10), (5, 7, 13)
CLAMP_OPS, PEAK_STEP_OPS = (1, 1, 1), (2, 2, 4)
# The DP's critical path: a cell depends on the cells above, left and
# diagonal, so a launch takes at least the longest chain of cells, rows +
# columns - 1 of one sequence against one query, times the dependent
# instructions a cell adds to it, h = max(diag + p, E, F, 0), t = h - Q,
# F = max(F - R, t): 3, each at the latency per instruction the peak phase
# measured (K10's DPX chain, two instructions a step).  A step of K10's
# chain is two.  The least time of a launch is the largest of the bytes,
# the operations and this term.
CHAIN_OPS, PEAK_CHAIN_OPS = 3, 2

KERNELS = {   # wrapper -> (its module, source, TPU kernel it replaces)
    "build_dprofile_series": (sw, "swipe_tpu_torch/csrc/dprofile.cu",
                              "swipe_tpu/ops/sw_stream.py:154"),
    "sw_scores_stream": (sw, "swipe_tpu_torch/csrc/carry_rows.cu",
                         "swipe_tpu/ops/sw_stream.py:568"),
    "sw_scores_stream_carry_flow": (sw, "swipe_tpu_torch/csrc/carry_rows.cu",
                                    "swipe_tpu/ops/sw_stream.py:733"),
    "sw_scores_stream_carry_rows": (sw, "swipe_tpu_torch/csrc/carry_rows.cu",
                                    "swipe_tpu/ops/sw_stream.py:733"),
    "sw_hint_stream": (sw, "swipe_tpu_torch/csrc/hint.cu",
                       "swipe_tpu/ops/sw_stream.py:990"),
    "sw_wavefront_giants": (wf, "swipe_tpu_torch/csrc/wavefront.cu",
                            "swipe_tpu/ops/sw_wavefront.py:227"),
    "stream_tile_pass": (sw, "swipe_tpu_torch/csrc/carry_rows.cu",
                         "swipe_tpu/ops/sw_stream.py:1263"),
    "stream_tile_carry_pass": (sw, "swipe_tpu_torch/csrc/carry_rows.cu",
                               "swipe_tpu/ops/sw_stream.py:1419"),
    # K8 and K9: two entry points of one kernel (segment_rows_kernel),
    # counted and timed apart
    "sw_scores_tiled": (tiled, "swipe_tpu_torch/csrc/segment.cu",
                        "swipe_tpu/ops/sw_tiled.py:146"),
    "sw_scores_segmented": (seg, "swipe_tpu_torch/csrc/segment.cu",
                            "swipe_tpu/ops/sw_pallas.py:175"),
    "peak_chain": (peak, "swipe_tpu_torch/csrc/peak.cu",
                   "tools/mfu_stream.py:50"),
}
# each wrapper's C entry, whose launches count in trace.launched(entry)
ENTRIES = {"build_dprofile_series": "swipe_dprofile",
           "sw_scores_stream": "swipe_stream_rows",
           "sw_scores_stream_carry_flow": "swipe_carry_flow",
           "sw_scores_stream_carry_rows": "swipe_carry_rows",
           "sw_hint_stream": "swipe_hint",
           "sw_wavefront_giants": "swipe_wavefront",
           "stream_tile_pass": "swipe_stream_tile",
           "stream_tile_carry_pass": "swipe_stream_tile_carry",
           "sw_scores_tiled": "swipe_segment_tiled",
           "sw_scores_segmented": "swipe_segment", "peak_chain": "swipe_peak"}
# plain versions not named <wrapper>_plain in the wrapper's module (K8
# shares K9's)
PLAIN = {"sw_scores_tiled": seg.sw_scores_segmented_plain,
         "sw_scores_stream_carry_flow": sw.sw_scores_stream_carry_plain,
         "sw_scores_stream_carry_rows": sw.sw_scores_stream_carry_plain,
         "peak_chain": lambda x, iters, dpx=False, block=256:
         peak.peak_chain_plain(x, iters * peak.PEAK_STEPS)}
# state arguments each wrapper updates in place (cloned before a replay)
STATE_ARGS = {"sw_scores_stream_carry_flow": (5, 6, 7),
              "sw_scores_stream_carry_rows": (5, 6, 7),
              "stream_tile_pass": (6, 7, 8),
              "stream_tile_carry_pass": (6, 7, 8, 9, 10)}
# the kernels' times at their largest calls before their redesign as a
# warp a (query, lane) (ms, this script on an NVIDIA H100 80GB HBM3,
# 700.00 W), printed in brackets beside this run's
REDESIGNED_FROM_MS = {"stream_tile_pass": 247.789, "sw_hint_stream": 115.292,
                      "sw_scores_stream": 108.812,
                      "sw_scores_tiled": 54.596,
                      "sw_scores_segmented": 83.401,
                      "sw_scores_stream_carry_flow": 19.296}
# the align phase's steps, timed on the host in every search: step ->
# (owner, attribute); the hint kernel's seconds are part of the hint pass
ALIGN_STEPS = {"finalize": (HitList, "finalize"),
               "fetch_and_bin": (HitList, "align_prepare"),
               "hint_pass": (align_hint, "hint_endpoints_grid"),
               "hint_kernel": (sw, "sw_hint_stream"),
               "traceback": (HitList, "align_finish")}

# E. coli K-12 MG1655 (NCBI NC_000913.3): length and GC share
ECOLI_BP, ECOLI_GC = 4_641_652, 0.508
# the genome searches: gene records beside the chromosome, queries and
# their lengths (blastn nucleotides, tblastn residues)
GENOME_GENES, GENOME_QUERIES, NT_QUERY_LEN, AA_QUERY_LEN = 4000, 16, 500, 400
# the long-genome query: a 16S rRNA gene's length (E. coli rrsA, 1,542 nt)
LONG_NT_QUERY_LEN = 1542
# the wide-genome search: the first queries of the genome phase (16
# slots, one carry group)
WIDE_GENOME_QUERIES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def swissprot_fasta(path: str, n: int, nq: int, qlen: int,
                    rng: np.random.Generator, longest: int | None = None):
    """Write n Swiss-Prot-like protein records to ``path`` (one line per
    sequence; all residues from one draw) and make nq queries of qlen
    residues.  Each query is a window of a database sequence with a
    fifth of its residues redrawn, and two more mutated copies are
    planted in other records, so every query has true homologs besides
    the random hits.  ``longest`` sets the last record's length.
    Returns (the records' lengths, query strings, each query's three
    homologous records: its source and the two copies)."""
    letters = np.frombuffer("".join(SWISSPROT_AA_PERCENT).encode(),
                            dtype=np.uint8)
    freqs = np.array(list(SWISSPROT_AA_PERCENT.values()))
    freqs /= freqs.sum()
    lens = np.clip(rng.lognormal(LEN_MU, LEN_SIGMA, n).astype(np.int64),
                   LEN_MIN, LEN_MAX)
    if longest is not None:
        lens[-1] = longest
    res = rng.choice(letters, size=int(lens.sum()), p=freqs)
    starts = np.cumsum(lens) - lens
    hosts = rng.choice(np.flatnonzero(lens[:n - 1] >= qlen), size=3 * nq,
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
    return lens, queries, hosts.reshape(nq, 3).tolist()


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
    return err


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
    # one run stopped below on symbols outside 0..31: name the stage that
    # made them if it recurs (the native packer, or the upload)
    if not 0 <= int(ch.data_t.min()) <= int(ch.data_t.max()) < 32:
        raise RuntimeError("check: the packer wrote symbols outside 0..31")
    if not torch.equal(data.t().cpu(), torch.from_numpy(ch.data_t)):
        raise RuntimeError("check: the chunk changed on its way to the card")
    dp = sw.build_dprofile_series(m8, data)
    _compare("build_dprofile_series", dp,
             sw.build_dprofile_series_plain(m8, data), report)
    qs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
          for L in (32, 200, 377, 512)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 512))
    for clamp in (None, 80):
        kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
        _compare("sw_scores_stream",
                 sw.sw_scores_stream(qc, ql, m8, data, start, **kw),
                 sw.sw_scores_stream_plain(qc, ql, m8, data, start, **kw),
                 report)
    check_stream_bands(dev, m8, rng, report)
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
    # BLOSUM62 scaled by 100 (gaps too): a matrix outside int8, for the
    # wide instantiations of the hint and carry kernels
    mw = torch.from_numpy(sw.build_matrix_wide(m62.matrix * 100)).to(dev)
    for mat, go, ge in ((m8, 11, 1), (m8, 150, 1), (mw, 1100, 100)):
        kw = dict(gapopenextend=go + ge, gapextend=ge)   # go + ge > 128 too
        hargs = [*args[:2], mat, *args[2:]]
        _compare("sw_hint_stream", sw.sw_hint_stream(*hargs, **kw),
                 sw.sw_hint_stream_plain(*hargs, **kw), report)
    check_hint_bands(dev, m62, rng, report)
    check_carry(dev, m8, mw, qc, ql, rng, report)
    check_wavefront(dev, m8, rng, report)
    check_tiles(dev, m8, rng, report)
    check_segments(dev, m62, rng, report)
    check_peak(dev, rng, report)
    sync(dev)


def check_stream_bands(dev, m8, rng, report):
    """K2 at every band height on torch_row_cases' launches (STREAM_LENGTHS:
    query lengths at the band edges, over one band, empty slots) against
    a 1024-lane, 64-block chunk whose lanes are refilled at column 16
    (every fifth lane's start bit at block 1) and query windows planted
    across strip and band edges; without and with a clamp."""
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(50, 300, size=1024 * 64 * 16 // 170)]
    ch = pack_stream(seqs, nseqs=1024, max_cols=64 * 16)[0]
    start = ch.start.copy()
    start[1, ::5] = 1
    st = torch.from_numpy(start).to(dev)
    for lengths in rc.STREAM_LENGTHS:
        qs = [rng.integers(1, 26, size=n, dtype=np.int8) for n in lengths]
        data_t = ch.data_t.copy()
        if not rc.plant_windows(rng, data_t.T, start, qs, rc.STREAM_EDGES):
            raise RuntimeError("check: no K2 band-edge window planted")
        data = torch.from_numpy(data_t).to(dev).t().contiguous()
        qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
            qs, -(-max(lengths) // 32) * 32))
        for clamp in (None, 80):
            kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
            _compare("sw_scores_stream",
                     sw.sw_scores_stream(qc, ql, m8, data, st, **kw),
                     sw.sw_scores_stream_plain(qc, ql, m8, data, st, **kw),
                     report)


def _hint_tensor(results):
    """Hint route results [[(S, bestq, bestpos)]] as one int64 tensor."""
    return torch.tensor([x for r in results for x in r], dtype=torch.int64)


def check_hint_bands(dev, m62, rng, report):
    """K4 on torch_row_cases' hint bins, against its plain version:
    queries one row either side of a strip edge and of a band edge,
    inside a strip, over one band (513-1024 rows) and over 1,100 rows,
    ties across strip and band edges, tails before a first tracked
    column, empty subjects and lanes; the int8 matrix at gaps 11/1 and
    150/2 and BLOSUM62 scaled by 100 at 255-300 rows (the wide
    instantiation's 256-row bands).  Then the entry point that launches
    it (hint_endpoints_grid) on every case, against its NumPy pass."""
    mat = m62.matrix.astype(np.int64)
    for lengths, go, ge, scale in rc.HINT_CASES.values():
        bins, tails = rc.hint_bins(rng, lengths, nsub=60, maxlen=600)
        starts = rc.hint_starts(rng, bins, tails, 64)
        cols = -(-max(len(x) for _, ss in bins for x in ss) // 16) * 16
        m = (sw.build_matrix_wide if scale > 1 else sw.build_matrix8)(
            mat * scale)
        hargs = [torch.from_numpy(a).to(dev) for a in (
            *sw.build_qcodes([q for q, _ in bins], max(lengths)), m,
            rc.hint_dense(bins, cols, 64), starts)]
        kw = dict(gapopenextend=go + ge, gapextend=ge)
        _compare("sw_hint_stream", sw.sw_hint_stream(*hargs, **kw),
                 sw.sw_hint_stream_plain(*hargs, **kw), report)
        host = align_hint.hint_endpoints_grid(bins, mat * scale, go, ge)
        got = align_hint.hint_endpoints_grid(bins, mat * scale, go, ge,
                                             device=dev)
        _compare("sw_hint_stream", _hint_tensor(got), _hint_tensor(host),
                 report)


def check_segments(dev, m62, rng, report):
    """K9 with an int8 and with an int32 profile (BLOSUM62, and BLOSUM62
    scaled by 100), and K8, against their plain loop on one
    pack_database chunk at 512 lanes: 24 segments and 8 padded ones,
    queries of 20-700 rows at qlen_pad 768 (the 700-row one in two int8
    bands of 512 rows and three int32 ones of 256, with planes between
    them)."""
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8)
            for n in rng.integers(5, 120, size=512 * 24)]
    ch = pack_database(seqs, nseqs=512, max_cols=16384)[0]
    named = int(ch.seg_ids.max()) + 1
    if named < 20 or ch.nsegs <= named:
        raise RuntimeError("check: the segment chunk lacks 20 segments or "
                           "padded ones")
    data = torch.from_numpy(ch.data).to(dev)
    seg_ids = torch.from_numpy(ch.seg_ids).to(dev)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8)
          for n in (20, 64, 200, 377, 512, 700)]
    for fn, scale, dtype in ((seg.sw_scores_segmented, 1, np.int8),
                             (seg.sw_scores_segmented, 100, np.int32),
                             (tiled.sw_scores_tiled, 1, np.int8)):
        qpt = torch.from_numpy(seg.build_qpt(qs, m62.matrix * scale, 768,
                                             dtype=dtype)).to(dev)
        kw = dict(nsegs=ch.nsegs, gapopenextend=12 * scale, gapextend=scale)
        _compare(fn.__name__, fn(qpt, data, seg_ids, **kw),
                 seg.sw_scores_segmented_plain(qpt, data, seg_ids, **kw),
                 report)


def check_peak(dev, rng, report):
    """K10, both forms, 8 chains a thread and 1, against its plain
    chain."""
    for chains, block in ((8, 256), (1, 32)):
        x = torch.from_numpy(rng.integers(-1000, 1000, (chains, 132 * block),
                                          dtype=np.int32)).to(dev)
        for dpx in (False, True):
            _compare("peak_chain", peak.peak_chain(x, 4, dpx=dpx, block=block),
                     peak.peak_chain_plain(x, 4 * peak.PEAK_STEPS), report)


def plant_cuts(chunks, queries, plants, span=24):
    """Copy into queries the symbols of carried lanes around chunk cuts,
    so that the best alignment of each planted (query, lane) runs
    diagonally from row x - 1 at a cut's last column into row x at the
    next chunk's first column.  With x a band's first row plus its strip
    height, that cell is the one whose diagonal a row-form kernel takes
    from the carried H of another thread.  plants: (query index, x)
    pairs, each given its own cut (a lane whose symbols no start bit or
    PAD breaks within span columns of the cut).  Returns the planted
    queries and each plant's (chunk index, query index, x)."""
    queries = [q.copy() for q in queries]
    cuts = []
    for c in range(1, len(chunks)):
        prev, cur = chunks[c - 1], chunks[c]
        for lane in range(min(prev.nseqs, cur.nseqs)):
            a, b = prev.data_t[lane, -span:], cur.data_t[lane, :span]
            tail = prev.start[-(span // sw.KSEG + 1):, lane]
            if (a != PAD_SYMBOL).all() and (b != PAD_SYMBOL).all() \
                    and not tail[1:].any() \
                    and not cur.start[:span // sw.KSEG + 1, lane].any():
                cuts.append((c, np.concatenate([a, b])))
    if len(cuts) < len(plants):
        raise RuntimeError("plant_cuts: too few carried lanes at cuts")
    where = []
    for (k, x), (c, sym) in zip(plants, cuts[::max(1, len(cuts)
                                                   // len(plants))]):
        a = min(span // 2, x)
        if x - a < 0 or x + span - a > len(queries[k]):
            raise RuntimeError(f"plant_cuts: row {x} outside query {k}")
        queries[k][x - a:x + span - a] = sym[span - a:2 * span - a]
        where.append((c, k, x))
    return queries, where


def cut_matters(plain, where, chunk, args, state, kw) -> bool:
    """Whether a planted chunk's dump depends on the carried H of row
    x - 1 at column -1, the diagonal into row x at column 0: plain (a
    carry series' plain step) on copies of the state with and without
    those rows zeroed."""
    rows = [(k, x) for c, k, x in where if c == chunk]
    if not rows:
        return False
    want = plain(*args, *(t.clone() for t in state), **kw)[0]
    h = state[0].clone()
    for k, x in rows:
        h[k, x - 1] = 0
    got = plain(*args, h, *(t.clone() for t in state[1:]), **kw)[0]
    return not torch.equal(got, want)


def check_carry(dev, m8, mw, qc, ql, rng, report):
    """K3's two forms, no block profiles.  The flow form over a 2048-lane
    flow series (cut chains continued on permuted lanes, a drain narrowed
    to 1024 lanes) through the entry point (carry_form picks it) at
    qlen_pad 512 (512-row bands) and called directly at qlen_pad 128 with
    a clamp (128-row bands), and over a compact carry series (two giants
    cut across chunks, short records refilling 16 lanes mid-chunk, the
    state wider than the chunks) called directly at qlen_pad 256 (256-row
    bands) and 1,536 (three 512-row bands, planes between them).  The row
    form through the entry point over the compact series with queries
    that end inside a strip, at a strip edge, at a band edge, take
    several bands, and an empty slot (0-1,100 rows at qlen_pad 1,536):
    int8, int8 with a clamp, int32.  On the compact series, lanes are
    planted across chunk cuts into a band's second strip (plant_cuts; a
    planted chunk's dump must depend on that diagonal).  No carry-in at
    a series' head, no carry-out at its tail; every chunk's dump and
    carried (h, e, s)."""
    lens = np.concatenate([rng.integers(5, 300, 6000), [3000, 2100],
                           [700] * 1100])
    seqs = [rng.integers(1, 26, size=int(n), dtype=np.int8) for n in lens]
    flow = pack_stream_flow(seqs, nseqs=2048, max_cols=256, drain_cols=128)
    giants = [rng.integers(1, 26, size=int(n), dtype=np.int8)
              for n in [20000, 15000] + list(rng.integers(1, 900, 40))]
    # 16 lanes: the short records refill lanes mid-chunk
    carry = pack_stream_carry(giants, nseqs=16, max_cols=2048)
    if {c.nseqs for c in flow} != {1024, 2048} or len(carry) < 3 \
            or not any(c.start[1:].any() for c in carry):
        raise RuntimeError("check: the K3 series lack a drain or chunks")
    long_qs = [rng.integers(1, 26, size=n, dtype=np.int8)
               for n in (300, 496, 512, 0, 1024, 1100)]
    short_qs = [rng.integers(1, 26, size=n, dtype=np.int8)
                for n in (256, 250, 100, 7, 0)]
    # the second strip of a band laid from the query's end: of the int8
    # bands of 512 rows (1100 - 512 + 16; the first band of 1024 and of
    # 512), of the int32 ones (256; the second band of 1024), and of the
    # flow form's 256-row bands (8 rows a thread: 256 rows from row 0,
    # and the third strip of 250 rows from row -6)
    planted = {}
    for key, qs, plants, pad in (
            ("int8", long_qs, [(5, 604), (4, 16), (2, 16)], 1536),
            ("int32", long_qs, [(5, 340), (4, 264)], 1536),
            ("256", short_qs, [(0, 8), (1, 10)], 256)):
        qs, where = plant_cuts(carry, qs, plants)
        planted[key] = (tuple(torch.from_numpy(a).to(dev)
                              for a in sw.build_qcodes(qs, pad)), where)
    q128 = tuple(torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
        [rng.integers(1, 26, size=n, dtype=np.int8)
         for n in (128, 100, 31, 0)], 128))
    flow_form, rows = sw.sw_scores_stream_carry_flow, \
        sw.sw_scores_stream_carry_rows
    entry = sw.sw_scores_stream_carry
    for chunks, width, mat, scale, clamp, fn, form, q, where in (
            (flow, 2048, m8, 1, None, entry, flow_form, (qc, ql), ()),
            (flow, 2048, m8, 1, 80, flow_form, flow_form, q128, ()),
            (carry, 64, m8, 1, None, flow_form, flow_form,
             *planted["256"]),
            (carry, 64, m8, 1, None, flow_form, flow_form,
             *planted["int8"]),
            (carry, 64, m8, 1, None, entry, rows, *planted["int8"]),
            (carry, 64, m8, 1, 80, entry, rows, *planted["int8"]),
            (carry, 64, mw, 100, None, entry, rows, *planted["int32"])):
        got = sw.make_stream_state(q[0].shape[0], q[0].shape[1], width, dev)
        want = tuple(x.clone() for x in got)
        for i, ch in enumerate(chunks):
            if i and chunks is flow:
                src = torch.from_numpy(ch.carry_src).to(dev)
                got = sw.permute_stream_state(*got, src)
                want = sw.permute_stream_state(*want, src)
            data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                                 ch.end_block, ch.lane, dev)
            kw = dict(gapopenextend=12 * scale, gapextend=scale, clamp=clamp,
                      carry_in=i > 0, carry_out=i < len(chunks) - 1)
            if clamp is None and any(c == i for c, _, _ in where) and \
                    not cut_matters(sw.sw_scores_stream_carry_plain, where,
                                    i, (*q, mat, data, start), want, kw):
                raise RuntimeError(f"check: chunk {i}'s planted cuts "
                                   "do not reach its dump")
            n = trace.launched(ENTRIES[form.__name__])
            d1, *got = fn(*q, mat, data, start, *got, **kw)
            if trace.launched(ENTRIES[form.__name__]) != n + 1:
                raise RuntimeError(f"check: {form.__name__} did not take "
                                   "the K3 launch")
            d2, *want = sw.sw_scores_stream_carry_plain(
                *q, mat, data, start, *want, **kw)
            _compare(form.__name__, (d1, *got), (d2, *want), report)


def check_wavefront(dev, m8, rng, report):
    """K7 on torch_row_cases' giant in three 4-strip segments (SEG_STRIPS
    cut down): alignments whose halves sit either side of horizontal gaps
    of 1,100 and 700 columns across slab edges and the segment cuts, and
    a hit across a cut; with its 3 queries (1,000, 600 and 40 rows), the
    first alone, and 16 (13 random ones of 1-1,024 rows added): every
    segment's H/E rows and running max, threaded segment by segment, and
    the scores through sw_wavefront_scores; then a tail segment of 1,024
    columns (a giant of 5,096)."""
    qs, seq = rc.wavefront_case(rng)
    qs = qs + [rng.integers(1, 26, size=int(n), dtype=np.int8)
               for n in rng.integers(1, 1025, size=13)]
    mq = torch.from_numpy(wf.build_mq(sw.build_qcodes(qs, 1024)[0],
                                      m8.cpu().numpy())).to(dev)
    kw = dict(gapopenextend=12, gapextend=1)
    dbd = torch.from_numpy(seq).to(dev)
    seg_strips, wf.SEG_STRIPS = wf.SEG_STRIPS, 4
    try:
        segs = wf._segments(len(seq))
        if len(segs) != 3:
            raise RuntimeError("check: the wavefront giant is not 3 segments")
        tail = wf._segments(len(seq[:5096]))
        if [w for _, w in tail] != [4096, 1024]:
            raise RuntimeError("check: no 1,024-column tail segment")
        for nq in (1, 3, 16):
            got = wf.make_wavefront_state(nq, 1024, dev)
            want = tuple(x.clone() for x in got)
            for pos, width in segs:
                wf.sw_wavefront(mq[:nq], dbd[pos:pos + width], *got, **kw)
                wf.sw_wavefront_plain(mq[:nq], dbd[pos:pos + width], *want,
                                      **kw)
                _compare("sw_wavefront", got, want, report)
            _compare("sw_wavefront", wf.sw_wavefront_scores(mq[:nq], seq,
                                                            **kw), want[2],
                     report)
        want = wf.sw_wavefront_plain(mq, dbd[:5096], *wf.make_wavefront_state(
            16, 1024, dev), **kw)[2]
        _compare("sw_wavefront", wf.sw_wavefront_scores(mq, seq[:5096],
                                                        **kw), want, report)
    finally:
        wf.SEG_STRIPS = seg_strips
    check_wavefront_giants(dev, m8, rng, report)


def check_wavefront_giants(dev, m8, rng, report):
    """K7 as the engine calls it: torch_row_cases' three giants, cut into
    the pieces the plans for 1, 3 and 16 queries of 128 rows make on this
    card, with alignments across every cut, gaps inside the overlaps and
    across slab edges; each plan in one launch against the plain
    version's whole giants."""
    rows, V = rc.WAVE_GIANT_ROWS, rc.WAVE_GIANT_V
    resident = wf.wavefront_resident(rows, dev)
    plans = {nq: wf.plan_pieces(rc.WAVE_GIANTS, nq, rows, V, resident)
             for nq in (1, 3, 16)}
    cuts = sorted({(p.giant, p.own[0]) for plan in plans.values()
                   for p in plan if p.own[0]})
    best = 1 + np.argsort(-np.diag(m8.cpu().numpy())[1:26].astype(int),
                          kind="stable")[:4]
    qs, giants = rc.wavefront_giants_case(rng, cuts, best)
    qc, ql = sw.build_qcodes(qs, rows)
    mq = torch.from_numpy(wf.build_mq(qc, m8.cpu().numpy())).to(dev)
    held = wf.hold_giants(giants, dev)
    kw = dict(overlap=V, gapopenextend=12, gapextend=1)
    want = wf.sw_wavefront_giants_plain(mq, ql, held, **kw)
    for nq, plan in plans.items():
        n = trace.launched("swipe_wavefront")
        got = wf.sw_wavefront_giants(mq[:nq].contiguous(), ql[:nq], held,
                                     **kw)
        if trace.launched("swipe_wavefront") != n + 1 or len(plan) <= 3:
            raise RuntimeError(f"check: {nq} queries' giants did not take "
                               "one launch of their pieces")
        _compare("sw_wavefront_giants", got, want[:nq], report)
    log(f"check: sw_wavefront_giants, {len(cuts)} piece cuts, resident "
        f"{resident} blocks at {rows} rows")


def plain_tiles(fn, *a, **k):
    """A tile-pass host loop (sw_scores_stream_long, ..._carry_long) run on
    the tile passes' plain versions."""
    saved = sw.stream_tile_pass, sw.stream_tile_carry_pass
    sw.stream_tile_pass = sw.stream_tile_pass_plain
    sw.stream_tile_carry_pass = sw.stream_tile_carry_pass_plain
    try:
        return fn(*a, **k)
    finally:
        sw.stream_tile_pass, sw.stream_tile_carry_pass = saved


def check_tiles(dev, m8, rng, report):
    """K5 over the four 512-row passes of a 1024-lane, 64-block chunk:
    queries ending inside tile 1, inside tile 3 and at the edge of tile
    1, and an empty slot; then torch_row_cases' tile queries (1,537,
    1,040, 1,047, 511, 512 and 0 rows) on the chunk with query windows
    planted across their edges; without and with a clamp: every pass's
    dump and planes.  K6 over a compact carry series of two giants
    cut across 1024-column chunks, no carry-in at its head, no carry-out
    at its tail, without and with a clamp, queries that end inside a
    strip, at a strip edge (528), at a tile edge (1,024), in the third
    tile, and an empty slot, lanes planted across chunk cuts into a
    tile's second strip (plant_cuts; a planted chunk's dump must depend
    on that diagonal): every chunk's dump and carried (h, e, s,
    bh0c)."""
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(1, 300, size=1024 * 64 * 16 // 140)]
    ch = pack_stream(seqs, nseqs=1024, max_cols=64 * 16)[0]
    data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                         ch.lane, dev)
    qs = [rng.integers(1, 26, size=n, dtype=np.int8)
          for n in (700, 1800, 1024, 0)]
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(qs, 2048))
    # and torch_row_cases' tile queries (one row into tile 3, one strip
    # into tile 2 and inside its second strip, a row short of a tile, a
    # whole tile, an empty slot) with query windows planted across those
    # edges
    edged = [rng.integers(1, 26, size=n, dtype=np.int8)
             for n in rc.tile_lengths(512)]
    host = data.cpu().numpy()
    if len(rc.plant_windows(rng, host, start.cpu().numpy(), edged, (
            16, 511, 512, 1024, 1040, 1047, 1536))) < 50:
        raise RuntimeError("check: too few K5 edge windows planted")
    edge_args = [torch.from_numpy(host).to(dev), *(
        torch.from_numpy(a).to(dev) for a in sw.build_qcodes(edged, 2048))]
    for clamp in (None, 80):
        kw = dict(gapopenextend=12, gapextend=1, tile_rows=512, clamp=clamp)
        for d, qc_, ql_ in ((data, qc, ql), edge_args):
            got = sw._tile_planes(qc_.shape[0], d.shape[0], 1024, dev)
            want = tuple(x.clone() for x in got)
            for t in range(4):
                sw.stream_tile_pass(qc_, ql_, t, m8, d, start, *got, **kw)
                sw.stream_tile_pass_plain(qc_, ql_, t, m8, d, start, *want,
                                          **kw)
                _compare("stream_tile_pass", got, want, report)
    giants = [rng.integers(1, 26, size=int(n), dtype=np.int8)
              for n in [5000, 4000] + list(rng.integers(1, 900, 40))]
    carry = pack_stream_carry(giants, nseqs=16, max_cols=1024)
    if len(carry) < 3 or not any(c.start[1:].any() for c in carry):
        raise RuntimeError("check: the K6 series has fewer than 3 chunks "
                           "or no refill")
    # a tile's second strip (row 16 of a 512-row tile), the partial
    # tile of the 600-row query among them
    qs, where = plant_cuts(carry, [
        rng.integers(1, 26, size=n, dtype=np.int8)
        for n in (600, 1100, 0, 1024, 528, 300)],
        [(1, 528), (3, 16), (0, 528)])
    qc, ql = (torch.from_numpy(a).to(dev)
              for a in sw.build_qcodes(qs, 1536))

    def plain(*a, **k):
        return plain_tiles(sw.sw_scores_stream_carry_long, *a, **k)

    for clamp in (None, 80):
        got = sw.make_stream_state_long(6, 1536, 64, 512, dev)
        want = tuple(x.clone() for x in got)
        for i, ch in enumerate(carry):
            data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                                 ch.end_block, ch.lane, dev)
            kw = dict(gapopenextend=12, gapextend=1, tile_rows=512,
                      clamp=clamp, carry_in=i > 0,
                      carry_out=i < len(carry) - 1)
            if clamp is None and any(c == i for c, _, _ in where) and \
                    not cut_matters(plain, where, i,
                                    (qc, ql, m8, data, start), want, kw):
                raise RuntimeError(f"check: K6 chunk {i}'s planted cuts "
                                   "do not reach its dump")
            d1, *got = sw.sw_scores_stream_carry_long(qc, ql, m8, data,
                                                      start, *got, **kw)
            d2, *want = plain(qc, ql, m8, data, start, *want, **kw)
            _compare("stream_tile_carry_pass", (d1, *got), (d2, *want),
                     report)


# ---- phases 3-7: the peak probe and the searches ----------------------------

def _call_size(name, a, k) -> int:
    """A kernel call's size, to pick a search's largest call: the elements
    of its tensor arguments; for a tile pass its cells (the tile's rows
    over the queries times the chunk), as its tensors are the same size
    in every pass."""
    if name in ("stream_tile_pass", "stream_tile_carry_pass"):
        T = k["tile_rows"]
        return int((a[1].long() - a[2] * T).clamp(0, T).sum()) \
            * a[4].numel()
    return sum(t.numel() for t in a if torch.is_tensor(t))


def record_calls(label, calls):
    """Wrap the kernel wrappers so each one's arguments at its largest
    call in the search ``label`` (_call_size) are kept in
    ``calls[label, name]`` for the timing phase, the state it updates in
    place cloned as it came in, and CUDA events around every call are
    kept in DEVICE_EVENTS (its device time, the wrapper's allocations
    included).  The wrapped functions (and their launch counts) are the
    originals.  Returns the originals."""
    def wrap(name, fn):
        def recorded(*a, **k):
            size = _call_size(name, a, k)
            if size >= calls.get((label, name), (0,))[0]:
                calls[label, name] = (size, _fresh(name, a), k)
            if not torch.cuda.is_available():
                return fn(*a, **k)
            ev = tuple(torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            DEVICE_EVENTS.setdefault(name, []).append(ev)
            return out
        return recorded

    originals = {n: getattr(mod, n) for n, (mod, _, _) in KERNELS.items()}
    for n, fn in originals.items():
        setattr(KERNELS[n][0], n, wrap(n, fn))
    return originals


def time_steps(split, dev):
    """Wrap the align phase's steps (ALIGN_STEPS) so their host seconds
    add up in ``split``; the hint kernel's are taken to its end on the
    card.  Returns the originals."""
    def wrap(step, fn):
        def timed(*a, **k):
            if step == "hint_kernel":
                sync(dev)
            t = time.time()
            try:
                return fn(*a, **k)
            finally:
                if step == "hint_kernel":
                    sync(dev)
                split[step] = split.get(step, 0.0) + time.time() - t
        return timed

    originals = {s: getattr(o, a) for s, (o, a) in ALIGN_STEPS.items()}
    for s, fn in originals.items():
        setattr(ALIGN_STEPS[s][0], ALIGN_STEPS[s][1], wrap(s, fn))
    return originals


def launch_counts(since: dict | None = None):
    """Each wrapper's launches so far, or since the counts ``since``."""
    since = since or {}
    return {n: trace.launched(ENTRIES[n]) - since.get(n, 0)
            for n in KERNELS}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_path(label, device, fn, expect, calls):
    """Run ``fn()`` (a path through the port's entry points) and count
    its launches; every kernel in ``expect`` must have launched.  Returns
    (fn's result, wall seconds, launch counts, the align phase's host
    seconds by step)."""
    base = launch_counts()
    originals = record_calls(label, calls)
    split: dict = {}
    steps = time_steps(split, device)
    try:
        sync(device)
        w0 = time.time()
        out = fn()
        sync(device)
        wall = time.time() - w0
    finally:
        for s, f in steps.items():
            setattr(ALIGN_STEPS[s][0], ALIGN_STEPS[s][1], f)
        for n, f in originals.items():
            setattr(KERNELS[n][0], n, f)
    launches = launch_counts(base)
    log(f"{label}: launches {json.dumps(launches)}; align phase by step "
        f"{json.dumps(split)}")
    for n in expect:
        if launches[n] <= 0:
            raise RuntimeError(f"{label}: {n} was not launched")
    return out, wall, launches, split


def run_search(label, engine, queries, expect, calls):
    """One search through the port's entry point (run_path).  Returns
    (hit lists, timings, wall seconds, launch counts, the align phase's
    host seconds by step)."""
    timings = SearchTimings()
    hitlists, wall, launches, split = run_path(
        label, engine.device, lambda: engine.search_batch(queries, timings),
        expect, calls)
    return hitlists, timings, wall, launches, split


def hit_keys(hitlists):
    """Every hit of every list: (seqno, query strand and frame, db strand
    and frame, score, alignment), and the list's totalhits."""
    return [([(h.seqno, h.qstrand, h.qframe, h.dstrand, h.dframe, h.score,
               h.alignment) for h in hl.hits], hl.totalhits)
            for hl in hitlists]


def peak_phase(dev, card, calls):
    """K10: the card's int32 and DPX add-max rates and the rate its ALU
    pipe issues the chains' instructions (ops/peak.py measure_peak),
    which the operation bounds of the time phase divide by."""
    rates, wall, launches, _ = run_path(
        "peak", dev, lambda: peak.measure_peak(dev), ("peak_chain",), calls)
    PEAK.update(rates)
    log(f"peak: {json.dumps(rates)}")
    log(f"peak: thread instructions {rates['thread_instructions_per_s']:.4e}"
        f"/s measured on the ALU pipe (data sheet {INT32_OPS_PER_S:.4e}/s; "
        f"issue ceiling {DATASHEET_ISSUE_PER_S:.4e}/s), int32 "
        f"add+max {rates['int32_ops_per_s']:.4e} ops/s, DPX add-max "
        f"{rates['dpx_ops_per_s']:.4e}/s, latency "
        f"{rates['plain_latency_ns_per_step']:.3f} ns (plain) and "
        f"{rates['dpx_latency_ns_per_step']:.3f} ns (DPX) a dependent step "
        f"of two lines; {wall:.1f} s [{card}]")
    return launches, rates


def segment_search(label, dev, db, queries, want, backend, kernel, card,
                   calls):
    """The segment-packed route (``backend`` "pallas": K8, "pallas_v1":
    K9) on a protein phase's database and queries: its hit lists must
    equal ``want``, the other route's on the same engine inputs, and no
    stream-route kernel may launch.  Returns (launches, stats)."""
    t0 = time.time()
    engine = SearchEngine(db, SearchParams(symtype=1, gapopen=11,
                                           gapextend=1),
                          device=dev, backend=backend)
    pack_s = time.time() - t0
    expect = (kernel, "sw_hint_stream") + (
        ("sw_scores_stream_carry_rows",) if engine._giant_ids.size else ())
    hitlists, timings, wall, launches, split = run_search(
        label, engine, queries, expect, calls)
    # the giants' carry series takes no profiles: K3's row form
    others = {"build_dprofile_series", "sw_scores_stream",
              "sw_wavefront_giants",
              "stream_tile_pass", "stream_tile_carry_pass",
              "sw_scores_stream_carry_flow", "sw_scores_tiled",
              "sw_scores_segmented"} - {kernel}
    if any(launches[n] for n in others):
        raise RuntimeError(f"{label}: a kernel of another route launched")
    if hit_keys(hitlists) != hit_keys(want):
        raise RuntimeError(f"{label}: the hit lists differ from the "
                           "other route's")
    residues = sum(int(c.lengths.sum()) for c in engine.chunks) + sum(
        len(s) for s in engine._giant_seqs)
    cells = residues * sum(len(q.aa[0]) for q in queries)
    stats = {"gcups": cells / timings.elapsed / 1e9,
             "scoring_s": timings.elapsed, "align_s": wall - timings.elapsed,
             "align_steps_s": split, "wall_s": wall, "cells": cells,
             "pack_s": pack_s, "chunks": len(engine.chunks),
             "giants": int(engine._giant_ids.size)}
    log(f"{label}: backend {backend}, {len(engine.chunks)} segment chunks "
        f"of {engine.chunks[0].nseqs} lanes (packed in {pack_s:.1f} s), "
        f"{engine._giant_ids.size} giants on the carry series; scoring "
        f"{timings.elapsed:.3f} s = {stats['gcups']:.1f} GCUPS, align phase "
        f"{stats['align_s']:.3f} s, wall {wall:.3f} s; every hit list "
        f"({sum(len(h.hits) for h in hitlists)} hits) equals the other "
        f"route's [{card}]")
    return launches, stats


def check_alignments(label, q, hl):
    for h in hl.hits[:hl.showalignments]:
        if h.score_align != h.score:
            raise RuntimeError(f"{label} {q.description}: seq {h.seqno} "
                               f"aligns to {h.score_align}, scored {h.score}")


def check_protein_hits(label, db, engine, queries, hitlists, homologs):
    """Top 20 hit scores and each query's planted homologs against the
    NumPy oracle; every shown alignment re-walks to its score.  Returns
    the report's bytes."""
    buf = io.StringIO()
    for q, hl, homs in zip(queries, hitlists, homologs):
        Reporter(buf, 0, 1, engine.matrix.matrix, query=q).show(hl, "db")
        top = hl.hits[:20]
        want = [int(sw_numpy_many(q.aa[0], [h.dseq], engine.matrix.matrix,
                                  11, 1)[0]) for h in top]
        if [h.score for h in top] != want:
            raise RuntimeError(f"{label} {q.description}: top scores "
                               f"{[h.score for h in top]} != oracle {want}")
        # a lane or sequence the kernels dropped would lose a true hit
        found = {h.seqno: h.score for h in hl.hits}
        for rec in homs:
            want = int(sw_numpy_many(q.aa[0], [db.get_sequence(rec, 1)[0]],
                                     engine.matrix.matrix, 11, 1)[0])
            if found.get(rec) != want:
                raise RuntimeError(f"{label} {q.description}: homolog "
                                   f"s{rec} scored {found.get(rec)}, oracle "
                                   f"{want}")
        check_alignments(label, q, hl)
    return len(buf.getvalue())


def search(dev, workdir, nseq, nq, card, calls, seed=2):
    """Phase 3: the Swiss-Prot-scale search on the plain-pack route."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    path = os.path.join(workdir, "swissprot_like.fa")
    lens, qstr, homologs = swissprot_fasta(path, nseq, nq, 200, rng)
    residues = int(lens.sum())
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
    hitlists, timings, wall, launches, split = run_search(
        "search", engine, queries, ("sw_scores_stream", "sw_hint_stream"),
        calls)
    no_profiles("search", launches)
    nbytes = check_protein_hits("search", db, engine, queries, hitlists,
                                homologs)
    cells = residues * 200 * nq
    gcups = cells / timings.elapsed / 1e9
    log(f"search: scoring {timings.elapsed:.3f} s = {gcups:.1f} GCUPS "
        f"({cells} cells), align phase {wall - timings.elapsed:.3f} s, "
        f"wall {wall:.3f} s, report {nbytes} bytes; "
        f"top scores ({sum(min(20, h.count) for h in hitlists)} hits) and "
        f"3 homologs of each of {nq} queries equal the oracle [{card}]")
    stats = {"gcups": gcups, "scoring_s": timings.elapsed,
             "align_s": wall - timings.elapsed, "align_steps_s": split,
             "wall_s": wall, "cells": cells}
    stats["profile"] = profile_search(engine, queries, cells)
    return launches, stats, engine, db, lens, queries, hitlists


def proteome(dev, workdir, nseq, nq, card, calls, seed=4):
    """Phase 4: a proteome-sized database with a titin-length record, on
    the flow route."""
    rng = np.random.default_rng(seed)
    path = os.path.join(workdir, "proteome_like.fa")
    lens, qstr, homologs = swissprot_fasta(path, nseq, nq, 200, rng,
                                           longest=LEN_MAX)
    residues = int(lens.sum())
    db = FastaDatabase(path, "aa", title="proteome-like")
    os.remove(path)
    queries = [preprocess_query(f"p{i}", s, 1, 3)
               for i, s in enumerate(qstr)]
    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    engine = SearchEngine(db, params, device=dev)
    if engine.chunks is not None or engine._flow_cols(2048) is None:
        raise RuntimeError("proteome: the engine did not take the flow route")
    nflow = len(engine._flow_chunks(2048))
    log(f"proteome: {nseq} sequences, {residues} residues (longest "
        f"{LEN_MAX}), flow route: {nflow} chunks, full height "
        f"{engine._flow_cols(2048)} columns")
    hitlists, timings, wall, launches, split = run_search(
        "proteome", engine, queries,
        ("sw_scores_stream_carry_flow", "sw_hint_stream"), calls)
    # every flow chunk (one slot group) on K3's flow form, no profiles
    check_carry_forms("proteome", launches, nflow, form="flow")
    no_profiles("proteome", launches)
    record_profile_call(calls)
    nbytes = check_protein_hits("proteome", db, engine, queries, hitlists,
                                homologs)
    cells = residues * 200 * nq
    stats = {"gcups": cells / timings.elapsed / 1e9,
             "scoring_s": timings.elapsed, "align_s": wall - timings.elapsed,
             "align_steps_s": split, "wall_s": wall, "cells": cells,
             "flow_chunks": nflow}
    log(f"proteome: scoring {timings.elapsed:.3f} s = {stats['gcups']:.1f} "
        f"GCUPS ({cells} cells), align phase {stats['align_s']:.3f} s, "
        f"wall {wall:.3f} s, report {nbytes} bytes; top scores and 3 "
        f"homologs of each of {nq} queries equal the oracle [{card}]")
    return launches, stats, engine, db, lens, queries, hitlists


def record_queries(db, recs, rng, label):
    """20%-mutated copies (Swiss-Prot composition) of database records,
    as queries named after ``label``."""
    letters = np.frombuffer("".join(SWISSPROT_AA_PERCENT).encode(),
                            dtype=np.uint8)
    freqs = np.array(list(SWISSPROT_AA_PERCENT.values()))
    sym = np.frombuffer(SYM_NCBI_AA.encode(), dtype=np.uint8)
    queries = []
    for i, rec in enumerate(recs):
        s = sym[np.asarray(db.get_sequence(int(rec), 1)[0])].copy()
        pos = rng.random(len(s)) < 0.2
        s[pos] = rng.choice(letters, size=int(pos.sum()), p=freqs / freqs.sum())
        queries.append(preprocess_query(f"{label}{i}", s.tobytes().decode(),
                                        1, 3))
    return queries


def track_groups(engine):
    """Record the engine's slot groups as (slots, qlen_pad, lanes, long)
    until untrack_groups."""
    groups = []
    orig = engine._search_stream_group

    def tracked(slots, qlen_pad, nseqs, timings, long=False):
        groups.append((len(slots), qlen_pad, nseqs, long))
        return orig(slots, qlen_pad, nseqs, timings, long)

    engine._search_stream_group = tracked
    return groups


def untrack_groups(engine):
    del engine._search_stream_group


def long_search(label, engine, db, lens, nq, lo, hi, expect, card, calls,
                seed):
    """Queries over 1024 rows on an engine of the protein phases: nq
    mutated copies of records of lo..hi residues (evenly spread over
    their lengths), their sources the planted homologs; the long route's
    slot groups must have taken the plain pack in tile passes.  Returns
    (launches, stats, slot groups)."""
    rng = np.random.default_rng(seed)
    pool = np.flatnonzero((lens >= lo) & (lens <= hi))
    pool = pool[np.argsort(lens[pool], kind="stable")]
    recs = pool[np.linspace(0, len(pool) - 1, nq).astype(np.int64)]
    queries = record_queries(db, recs, rng, label[0])
    groups = track_groups(engine)
    try:
        hitlists, timings, wall, launches, split = run_search(
            label, engine, queries, expect, calls)
    finally:
        untrack_groups(engine)
    if not groups or not all(g[3] and g[2] == 1024 and g[0] <= 4
                             for g in groups):
        raise RuntimeError(f"{label}: slot groups {groups} are not long "
                           "groups of at most 4 at 1024 lanes")
    if launches["sw_scores_stream_carry_flow"] \
            or launches["sw_scores_stream_carry_rows"] \
            or launches["sw_scores_stream"] \
            or launches["build_dprofile_series"]:
        raise RuntimeError(f"{label}: the long groups left the plain pack "
                           "in tile passes, or built profiles")
    nbytes = check_protein_hits(label, db, engine, queries, hitlists,
                                [[int(r)] for r in recs])
    cells = int(lens.sum()) * sum(len(q.aa[0]) for q in queries)
    stats = {"gcups": cells / timings.elapsed / 1e9,
             "scoring_s": timings.elapsed, "align_s": wall - timings.elapsed,
             "align_steps_s": split, "wall_s": wall, "cells": cells,
             "query_lens": [len(q.aa[0]) for q in queries],
             "groups": groups}
    log(f"{label}: {nq} queries of {min(stats['query_lens'])}-"
        f"{max(stats['query_lens'])} aa in slot groups {groups}; scoring "
        f"{timings.elapsed:.3f} s = {stats['gcups']:.1f} GCUPS ({cells} "
        f"cells), align phase {stats['align_s']:.3f} s, wall {wall:.3f} s, "
        f"report {nbytes} bytes; top scores and every source record equal "
        f"the oracle [{card}]")
    return launches, stats


# ---- the genome: one chromosome and its genes --------------------------------

NT_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMPLEMENT[_a] = _b


def revcomp(s: np.ndarray) -> np.ndarray:
    return COMPLEMENT[s[::-1]]


def back_translation(gencode: int):
    """amino-acid letter -> its codons (the genetic code's table)."""
    code = GENETIC_CODES[gencode]
    bases = "TCAG"
    codons: dict[str, list[bytes]] = {}
    for i, aa in enumerate(code[:64]):
        codons.setdefault(aa, []).append(
            (bases[i // 16] + bases[i // 4 % 4] + bases[i % 4]).encode())
    return codons


def genome(rng, nbp, ngenes, nt_queries, aa_queries, gene_lens=(200, 3000),
           nt_sub=0.1, aa_sub=0.2):
    """One chromosome of nbp bases at ECOLI_GC, synthesised from ``rng``,
    and ngenes records cut from it (windows of gene_lens bases, either
    strand).  For each query (nucleotide, then protein back-translated
    with random synonymous codons), two mutated copies (nt_sub or aa_sub
    of the residues redrawn) are planted in the chromosome on opposite
    strands, each in a region of its own; the first copy lies inside a
    gene.  Returns (chromosome bytes, gene records as (start, strand,
    bytes), plants per query as [(position, strand, nt length, gene
    index or -1)])."""
    gc = ECOLI_GC / 2
    chrom = rng.choice(NT_LETTERS, size=nbp,
                       p=[0.5 - gc, gc, gc, 0.5 - gc])
    codons = back_translation(11)
    aa_letters = np.frombuffer("".join(SWISSPROT_AA_PERCENT).encode(),
                               dtype=np.uint8)
    aa_freqs = np.array(list(SWISSPROT_AA_PERCENT.values()))
    aa_freqs /= aa_freqs.sum()

    def copy(q, nt):
        s = q.copy()
        pos = rng.random(len(s)) < (nt_sub if nt else aa_sub)
        if nt:
            s[pos] = rng.choice(NT_LETTERS, size=int(pos.sum()))
            return s
        s[pos] = rng.choice(aa_letters, size=int(pos.sum()), p=aa_freqs)
        return np.frombuffer(b"".join(
            codons[chr(a)][int(rng.integers(len(codons[chr(a)])))]
            for a in s), dtype=np.uint8)

    queries = list(nt_queries) + list(aa_queries)
    region = nbp // (2 * len(queries))
    plants, genes = [], []
    for k, q in enumerate(queries):
        plants.append([])
        for c in range(2):
            s = copy(q, k < len(nt_queries))
            strand = (k + c) % 2
            lo = (2 * k + c) * region
            pos = lo + int(rng.integers(gene_lens[0], region - len(s)
                                        - gene_lens[0]))
            chrom[pos:pos + len(s)] = s if strand == 0 else revcomp(s)
            gene = -1
            if c == 0:           # a gene around the copy
                glen = int(rng.integers(max(len(s) + 40, gene_lens[0]),
                                        gene_lens[1] + 1))
                gstart = pos - int(rng.integers(0, glen - len(s)))
                gene = len(genes)
                genes.append((gstart, glen, int(rng.integers(2))))
            plants[-1].append((pos, strand, len(s), gene))
    while len(genes) < ngenes:
        glen = int(rng.integers(gene_lens[0], gene_lens[1] + 1))
        genes.append((int(rng.integers(0, nbp - glen)), glen,
                      int(rng.integers(2))))
    records = []
    for gstart, glen, strand in genes:
        g = chrom[gstart:gstart + glen]
        records.append((gstart, strand, g if strand == 0 else revcomp(g)))
    return chrom, records, plants


def genome_fasta(path, chrom, genes):
    with open(path, "wb") as f:
        f.write(b">chr E. coli K-12 MG1655-length chromosome (synthetic)\n")
        f.write(chrom.tobytes() + b"\n")
        for i, (gstart, strand, g) in enumerate(genes):
            f.write(b">g%d gene at %d strand %d\n%s\n"
                    % (i, gstart, strand, g.tobytes()))


def window_oracle(engine, qcodes, subject, start, length, qlen, gaps):
    """The oracle score of a query against the window of ``subject``
    from 2 query lengths before ``start`` to 2 after start + length."""
    lo = max(start - 2 * qlen, 0)
    return int(sw_numpy_many(qcodes, [subject[lo:start + length + 2 * qlen]],
                             engine.matrix.matrix, *gaps)[0])


def check_genome_hits(label, db, engine, queries, hitlists, plants, gaps,
                      frames):
    """Chromosome hits (seqno 0) against the oracle over windows around
    the plants, strand by strand; the planted genes and the top 5 other
    hits against the oracle over the whole gene; every shown alignment
    re-walks to its score.  ``frames`` maps a chromosome strand to its
    scored sequences (one for blastn, three frames for tblastn)."""
    nbp = len(db.get_sequence(0, 0)[0])
    translated = engine.params.symtype == 3
    checked = 0
    for q, hl, qplants in zip(queries, hitlists, plants):
        qcodes = q.aa[0] if translated else q.nt[0]
        qlen = len(qcodes)
        best = {}
        for h in hl.hits:
            if h.seqno == 0:
                best[h.dstrand] = max(best.get(h.dstrand, 0), h.score)
        for pos, strand, ntlen, gene in qplants:
            # the copy in strand coordinates of the strand it reads on
            spos = pos if strand == 0 else nbp - pos - ntlen
            want = max(
                window_oracle(engine, qcodes, seq,
                              (spos - f) // 3 if translated else spos,
                              ntlen // 3 if translated else ntlen, qlen,
                              gaps)
                for f, seq in enumerate(frames[strand]))
            if best.get(strand) != want:
                raise RuntimeError(f"{label} {q.description}: chromosome "
                                   f"strand {strand} scored "
                                   f"{best.get(strand)}, window oracle "
                                   f"{want}")
            checked += 1
        genes = {p[3] + 1 for p in qplants if p[3] >= 0}   # seqno of gene
        others = [h for h in hl.hits if h.seqno != 0][:5]
        tocheck = others + [h for h in hl.hits if h.seqno in genes
                            and h not in others]
        subjects = [db.get_sequence(h.seqno, engine.params.symtype,
                                    h.dstrand, h.dframe)[0] for h in tocheck]
        want = sw_numpy_many(qcodes, subjects, engine.matrix.matrix, *gaps)
        for h, w in zip(tocheck, want):
            if h.score != int(w):
                raise RuntimeError(f"{label} {q.description}: gene "
                                   f"g{h.seqno - 1} scored {h.score}, oracle "
                                   f"{int(w)}")
        if not genes <= {h.seqno for h in hl.hits}:
            raise RuntimeError(f"{label} {q.description}: a planted gene "
                               "is not a hit")
        check_alignments(label, q, hl)
    return checked


def genome_searches(dev, workdir, card, calls, seed=5):
    """Phases 5 and 6: blastn, then tblastn twice, against one
    chromosome and its genes."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    nbp, nq = ECOLI_BP, GENOME_QUERIES
    nt_q = [rng.choice(NT_LETTERS, size=NT_QUERY_LEN) for _ in range(nq)]
    aa_q = [np.frombuffer(swissprot_letters(AA_QUERY_LEN, rng).encode(),
                          dtype=np.uint8) for _ in range(nq)]
    chrom, genes, plants = genome(rng, nbp, GENOME_GENES, nt_q, aa_q)
    path = os.path.join(workdir, "genome.fa")
    genome_fasta(path, chrom, genes)
    db = FastaDatabase(path, "nt", title="genome")
    os.remove(path)
    gbp = sum(len(g) for _, _, g in genes)
    log(f"genome: chromosome {nbp} bp (GC {ECOLI_GC}), {len(genes)} genes "
        f"of {gbp} bp, data {time.time() - t0:.1f} s")
    launches, stats = {}, {}

    # phase 5: blastn
    gaps = (5, 2)
    params = SearchParams(symtype=0, matchscore=1, mismatchscore=-3,
                          gapopen=5, gapextend=2)
    t1 = time.time()
    engine = SearchEngine(db, params, device=dev)
    queries = [preprocess_query(f"n{i}", q.tobytes().decode(), 0, 3)
               for i, q in enumerate(nt_q)]
    V = engine._overlap_bound(engine.qlen_bucket(NT_QUERY_LEN))
    if engine._giant_ids.size != 1 or V > engine._max_cols // 2:
        raise RuntimeError("genome: the chromosome is not a segmented giant")
    log(f"genome: blastn engine {time.time() - t1:.1f} s, 1 giant unit, "
        f"overlap bound {V} columns")
    hitlists, tim, wall, launches["genome"], split = run_search(
        "genome", engine, queries, ("sw_scores_stream", "sw_hint_stream"),
        calls)
    no_profiles("genome", launches["genome"])
    chrom_nt = db.get_sequence(0, 0)[0]
    frames = {0: [chrom_nt], 1: [np.asarray(db.get_sequence(0, 0, 1)[0])]}
    n = check_genome_hits("genome", db, engine, queries, hitlists,
                          plants[:nq], gaps, frames)
    stats["genome"] = {"scoring_s": tim.elapsed, "meter_gcups":
                       tim.speed / 1e9, "align_s": wall - tim.elapsed,
                       "align_steps_s": split, "wall_s": wall}
    log(f"genome: scoring {tim.elapsed:.3f} s ({tim.speed / 1e9:.1f} GCUPS "
        f"by the reference's meter), align phase {wall - tim.elapsed:.3f} s, "
        f"wall {wall:.3f} s; {n} chromosome copies and the planted genes "
        f"equal their oracles [{card}]")
    launches["long-genome"], stats["long-genome"] = long_genome(
        engine, db, chrom, genes, frames, card, calls)
    del engine
    launches["wide-genome"], stats["wide-genome"] = wide_genome(
        dev, db, nt_q, plants, hitlists, frames, card, calls)
    del frames

    # phase 6: tblastn, the wavefront and then the carry series
    gaps = (11, 1)
    params = SearchParams(symtype=3, gapopen=11, gapextend=1, db_gencode=11)
    t1 = time.time()
    engine = SearchEngine(db, params, device=dev)
    queries = [preprocess_query(f"t{i}", q.tobytes().decode(), 3, 3)
               for i, q in enumerate(aa_q)]
    V = engine._overlap_bound(engine.qlen_bucket(AA_QUERY_LEN))
    if engine._giant_ids.size != 6 or V <= engine._max_cols // 2 \
            or engine.WAVEFRONT_MAX_GIANTS < 6:
        raise RuntimeError("tblastn: the six frames do not take the "
                           "wavefront")
    log(f"tblastn: engine {time.time() - t1:.1f} s, 6 giant frames, overlap "
        f"bound {V} columns")
    frames = {d: [np.asarray(db.get_sequence(0, 3, d, f)[0])
                  for f in range(3)] for d in range(2)}
    keys = []
    for route, expect in (
            ("wavefront", ("sw_wavefront_giants", "sw_scores_stream",
                           "sw_hint_stream")),
            ("carry", ("sw_scores_stream_carry_rows", "sw_scores_stream",
                       "sw_hint_stream"))):
        label = f"tblastn-{route}"
        if route == "carry":
            engine.WAVEFRONT_MAX_GIANTS = 0
        hitlists, tim, wall, launches[label], split = run_search(
            label, engine, queries, expect, calls)
        no_profiles(label, launches[label])
        if route == "carry":
            check_carry_forms(label, launches[label],
                              len(engine._carry_chunks(1024)))
        n = check_genome_hits(label, db, engine, queries, hitlists,
                              plants[nq:], gaps, frames)
        keys.append([[(h.seqno, h.score, h.dstrand, h.dframe, h.score_align,
                       h.alignment) for h in hl.hits] for hl in hitlists])
        stats[label] = {"scoring_s": tim.elapsed, "meter_gcups":
                        tim.speed / 1e9, "align_s": wall - tim.elapsed,
                        "align_steps_s": split, "wall_s": wall}
        log(f"{label}: scoring {tim.elapsed:.3f} s ({tim.speed / 1e9:.1f} "
            f"GCUPS by the reference's meter), align phase "
            f"{wall - tim.elapsed:.3f} s, wall {wall:.3f} s; {n} chromosome "
            f"copies and the planted genes equal their oracles [{card}]")
    if keys[0] != keys[1]:
        raise RuntimeError("tblastn: the wavefront and carry hit lists differ")
    log("tblastn: the wavefront and carry series hit lists are equal")
    return launches, stats


def no_profiles(label, launches):
    """The card's stream and carry kernels take no block profiles: no
    search builds them."""
    if launches["build_dprofile_series"]:
        raise RuntimeError(f"{label}: block profiles were built")


def record_profile_call(calls):
    """K1 at the proteome's largest flow chunk, which no search launches
    it on: its call kept under a label of its own ("proteome-profiles",
    no search's launch counts), so the check and time phases hold and
    time it at the flow route's shape."""
    _, args, _ = calls["proteome", "sw_scores_stream_carry_flow"]
    m8, db = args[2], args[3]
    calls["proteome-profiles", "build_dprofile_series"] = (
        m8.numel() + db.numel(), (m8, db), {})


def check_carry_forms(label, launches, nchunks, form="rows"):
    """A carry or flow series of one slot group: every chunk one launch of
    K3's ``form`` ("rows": a giant carry series; "flow": a flow series),
    none of the other."""
    other = "flow" if form == "rows" else "rows"
    got = (launches[f"sw_scores_stream_carry_{form}"],
           launches[f"sw_scores_stream_carry_{other}"])
    if got != (nchunks, 0):
        raise RuntimeError(f"{label}: K3 launched {got[0]} times in the "
                           f"{form} form and {got[1]} in the {other} form, "
                           f"not {nchunks} and 0")


def track_hints(split):
    """Wrap align_hint's hint launch and NumPy pass (_hint_launch,
    _hint_host) so that lanes that took the NumPy pass on the card fail
    the run, and the largest query of a launch is kept in
    split["k4_rows"].  Returns the function that restores both."""
    launch, host = align_hint._hint_launch, align_hint._hint_host

    def launched(bins, *a, **k):
        split["k4_rows"] = max(split.get("k4_rows", 0),
                               max(len(q) for q, _ in bins))
        return launch(bins, *a, **k)

    def on_host(q, dseqs, *a, **k):
        raise RuntimeError(f"{len(dseqs)} hint lanes ({len(q)} rows) ran "
                           f"on the host")

    def restore():
        align_hint._hint_launch, align_hint._hint_host = launch, host

    align_hint._hint_launch, align_hint._hint_host = launched, on_host
    return restore


def long_genome(engine, db, chrom, genes, frames, card, calls, seed=6):
    """The long-genome phase on the blastn engine: a 16S-length query, a
    10%-mutated copy of a chromosome window inside a gene, on both
    strands."""
    rng = np.random.default_rng(seed)
    qlen = LONG_NT_QUERY_LEN
    gi = next(i for i, (_, _, g) in enumerate(genes) if len(g) >= qlen + 40)
    gstart, glen = genes[gi][0], len(genes[gi][2])
    pos = gstart + int(rng.integers(0, glen - qlen + 1))
    q = chrom[pos:pos + qlen].copy()
    flip = rng.random(qlen) < 0.1
    q[flip] = rng.choice(NT_LETTERS, size=int(flip.sum()))
    queries = [preprocess_query("l0", q.tobytes().decode(), 0, 3)]
    groups = track_groups(engine)
    hints: dict = {}
    untrack = track_hints(hints)
    try:
        hitlists, tim, wall, launches, split = run_search(
            "long-genome", engine, queries,
            ("stream_tile_pass", "stream_tile_carry_pass", "sw_hint_stream"),
            calls)
    finally:
        untrack()
        untrack_groups(engine)
    if groups != [(2, -(-qlen // 512) * 512, 1024, True)]:
        raise RuntimeError(f"long-genome: slot groups {groups}")
    if hints.get("k4_rows") != qlen:
        raise RuntimeError(f"long-genome: the hint kernel ran at "
                           f"{hints.get('k4_rows')} rows, not {qlen}")
    n = check_genome_hits("long-genome", db, engine, queries, hitlists,
                          [[(pos, 0, qlen, gi)]], (5, 2), frames)
    stats = {"scoring_s": tim.elapsed, "meter_gcups": tim.speed / 1e9,
             "align_s": wall - tim.elapsed, "align_steps_s": split,
             "wall_s": wall, "carry_chunks": len(engine._carry_chunks(1024))}
    log(f"long-genome: {qlen}-nt query from gene g{gi}, slot groups "
        f"{groups}; scoring {tim.elapsed:.3f} s ({tim.speed / 1e9:.1f} "
        f"GCUPS by the reference's meter), align phase "
        f"{wall - tim.elapsed:.3f} s, wall {wall:.3f} s; hint kernel at "
        f"{hints['k4_rows']} rows, no hint batch on the host; {n} "
        f"chromosome "
        f"window and the genes equal their oracles [{card}]")
    return launches, stats


def wide_genome(dev, db, nt_q, plants, int8_hits, frames, card, calls):
    """The genome phase's blastn scoring scaled by 100 (-r 100 -q -300 -G
    500 -E 200: -300 is outside int8) for its first WIDE_GENOME_QUERIES
    queries: the genes on K9 with an int32 profile, the chromosome on the
    wide carry kernel (K3, 8,192-column chunks), hints on the wide hint
    kernel.  Every planted window scores at its oracle under the scaled
    matrix, and every hit of the int8 genome search is a hit here whose
    score is exactly 100 x its int8 score (scaling every score and gap
    keeps the optimal alignments; no E-value cut here drops one)."""
    nq = WIDE_GENOME_QUERIES
    params = SearchParams(symtype=0, matchscore=100, mismatchscore=-300,
                          gapopen=500, gapextend=200, expect=1e300)
    t0 = time.time()
    engine = SearchEngine(db, params, device=dev)
    if engine.matrix.fits_int8 or not engine._segment_route \
            or engine._giant_ids.size != 1:
        raise RuntimeError("wide-genome: the engine did not take the "
                           "segment route with one giant")
    queries = [preprocess_query(f"n{i}", q.tobytes().decode(), 0, 3)
               for i, q in enumerate(nt_q[:nq])]
    log(f"wide-genome: engine {time.time() - t0:.1f} s, "
        f"{len(engine.chunks)} segment chunks, the chromosome in "
        f"{len(engine._carry_chunks(1024))} carry chunks")
    hints: dict = {}
    untrack = track_hints(hints)
    try:
        hitlists, tim, wall, launches, split = run_search(
            "wide-genome", engine, queries,
            ("sw_scores_segmented", "sw_scores_stream_carry_rows",
             "sw_hint_stream"), calls)
    finally:
        untrack()
    check_carry_forms("wide-genome", launches,
                      len(engine._carry_chunks(1024)))
    if any(launches[n] for n in ("build_dprofile_series", "sw_scores_stream",
                                 "sw_scores_tiled", "stream_tile_pass",
                                 "stream_tile_carry_pass",
                                 "sw_wavefront_giants")):
        raise RuntimeError("wide-genome: a kernel of another route launched")
    n = check_genome_hits("wide-genome", db, engine, queries, hitlists,
                          plants[:nq], (500, 200), frames)
    # with no E-value cut here, the scores' order being the int8 one,
    # every hit of the int8 list is in this one
    both = 0
    for q, hl, ref in zip(queries, hitlists, int8_hits):
        want = {(h.seqno, h.dstrand, h.dframe): h.score for h in ref.hits}
        got = {(h.seqno, h.dstrand, h.dframe): h.score for h in hl.hits}
        for key, w in want.items():
            if got.get(key) != 100 * w:
                raise RuntimeError(f"wide-genome {q.description}: seq "
                                   f"{key[0]} strand {key[1]} scored "
                                   f"{got.get(key)}, not 100 x the int8 {w}")
        both += len(want)
    stats = {"scoring_s": tim.elapsed, "meter_gcups": tim.speed / 1e9,
             "align_s": wall - tim.elapsed, "align_steps_s": split,
             "wall_s": wall, "int8_hits_scaled": both}
    log(f"wide-genome: {nq} queries of {NT_QUERY_LEN} nt; scoring "
        f"{tim.elapsed:.3f} s ({tim.speed / 1e9:.1f} GCUPS by the "
        f"reference's meter), align phase {wall - tim.elapsed:.3f} s, wall "
        f"{wall:.3f} s; hint kernel at {hints.get('k4_rows')} rows; {n} "
        f"chromosome copies and the planted genes equal their oracles; "
        f"all {both} hits of the int8 search are hits here at 100 x their "
        f"score [{card}]")
    return launches, stats


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


# ---- phase 8: kernel times and bounds --------------------------------------

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


def _ops(n, per, extra=False):
    """(ALU, all, two-operand int32) instructions of n cells or steps."""
    return tuple(n * (p + extra * c) for p, c in zip(per, CLAMP_OPS))


def _work(name, args, kw, out):
    """(bytes the function must move, its least instructions on the ALU
    pipe, its least instructions, its two-operand int32 operation count)
    for one call: inputs read once, outputs written once, the cells of
    the true query lengths against the real residues (PAD columns
    excluded)."""
    if name == "build_dprofile_series":
        m8, db = args
        return _nbytes(m8, db, out), 0, 0, 0
    if name in ("sw_scores_stream", "sw_scores_stream_carry_flow",
                "sw_scores_stream_carry_rows"):
        qc, ql, m8, db, start = args[:5]
        if isinstance(out, tuple):      # the dump and the state
            out = out[0]
        cells = int(ql.sum()) * int((db != PAD_SYMBOL).sum())
        extra = kw.get("clamp") is not None          # one min a cell
        state = args[5:]
        nbytes = _nbytes(qc, ql, m8, db, start, out)
        if state:   # the carried state read in and written out
            nbytes += _nbytes(*state) * (kw.get("carry_in", True)
                                         + kw.get("carry_out", True))
        return (nbytes, *_ops(cells, CELL_OPS, extra))
    if name in ("stream_tile_pass", "stream_tile_carry_pass"):
        qc, ql, tile, m8, db, start, bh, bf, sprev = args[:9]
        T = kw["tile_rows"]
        rows = (ql.long() - tile * T).clamp(0, T)
        cells = int(rows.sum()) * int((db != PAD_SYMBOL).sum())
        extra = kw.get("clamp") is not None
        # the planes and the dump read and written
        nbytes = _nbytes(qc, ql, m8, db, start) + 2 * _nbytes(bh, bf, sprev)
        if len(args) > 9:   # the tile's rows of the state, S and bh0c
            h, _, s, bh0c = args[9:]
            nbytes += 2 * 2 * h.shape[0] * T * h.shape[2] * 4 \
                + _nbytes(s, bh0c)
        return (nbytes, *_ops(cells, CELL_OPS, extra))
    if name in ("sw_scores_segmented", "sw_scores_tiled"):
        qpt, db, seg_ids = args
        rows = int(seg.query_lengths(qpt).sum())     # true query rows
        cells = rows * int((db != PAD_SYMBOL).sum())
        return (_nbytes(qpt, db, seg_ids, out), *_ops(cells, CELL_OPS))
    if name == "peak_chain":
        x, iters = args
        steps = x.numel() * iters * peak.PEAK_STEPS
        return (_nbytes(x, out), *_ops(steps, PEAK_STEP_OPS))
    if name == "sw_wavefront_giants":
        mq, ql, held = args
        cells = int(np.sum(ql)) * sum(held.lengths)
        return (_nbytes(mq, held.db, out), *_ops(cells, CELL_OPS))
    qc, ql, m8, db, starts = args
    residues = (db != PAD_SYMBOL).sum(dim=(1, 2))     # per bin
    cells = int((ql.long() * residues).sum())
    return (_nbytes(qc, ql, m8, db, starts, *out),
            *_ops(cells, HINT_CELL_OPS))


def _longest(start, db):
    """The longest sequence of a lane-packed chunk, in real columns: the
    non-PAD columns between a lane's start bits (a lane without one runs
    the whole chunk)."""
    st = start.cpu().numpy() != 0                      # [nblocks, NSEQS]
    nb, n = st.shape
    real = (db != PAD_SYMBOL).view(nb, sw.KSEG, n).sum(dim=1).cpu().numpy()
    key = np.cumsum(st, axis=0) * n + np.arange(n)
    return int(np.bincount(key.ravel(), weights=real.ravel()).max())


def _chain(name, args, kw):
    """The dependent instructions on the longest chain of one call (the
    critical path term of the bound)."""
    if name == "build_dprofile_series":
        return 0
    if name == "peak_chain":
        return args[1] * peak.PEAK_STEPS * PEAK_CHAIN_OPS
    if name in ("sw_scores_stream", "sw_scores_stream_carry_flow",
                "sw_scores_stream_carry_rows"):
        qc, ql, _, db, start = args[:5]
        rows = min(int(ql.max()), qc.shape[1])
        cols = _longest(start, db)
    elif name in ("stream_tile_pass", "stream_tile_carry_pass"):
        _, ql, tile, _, db, start = args[:6]
        T = kw["tile_rows"]
        rows = int((ql.long() - tile * T).clamp(0, T).max())
        cols = _longest(start, db)
    elif name in ("sw_scores_segmented", "sw_scores_tiled"):
        qpt, db, seg_ids = args
        rows = int(seg.query_lengths(qpt).max())
        # the widest segment (seg_ids' last entry repeats the last block's)
        cols = int(torch.bincount(seg_ids[:-1].long()).max()) * SEG_BLK
    elif name == "sw_wavefront_giants":
        # the longest chain: the longest piece the call walks
        mq, ql, held = args
        rows = int(np.max(ql))
        cols = max(p.walk[1] - p.walk[0] for p in wf.plan_pieces(
            held.lengths, len(ql), mq.shape[1], kw["overlap"],
            wf.wavefront_resident(mq.shape[1], mq.device)))
    else:                                              # sw_hint_stream
        _, ql, _, db, _ = args
        rows = int(ql.max())
        cols = int((db != PAD_SYMBOL).sum(dim=1).max())
    return (rows + cols - 1) * CHAIN_OPS if rows and cols else 0


def time_tiles(calls, report):
    """The long-search chunk's four tile passes (K5) summed, beside one K2
    pass over the same 2,048 rows (four bands), whose dump must be the
    same."""
    _, args, kw = calls["long-search", "stream_tile_pass"]
    qc, ql, _, m8, db, start = args[:6]
    kw = dict(gapopenextend=kw["gapopenextend"], gapextend=kw["gapextend"])
    long = sw.sw_scores_stream_long(qc, ql, m8, db, start, **kw)
    one = sw.sw_scores_stream(qc, ql, m8, db, start, **kw)
    _compare("sw_scores_stream", one, long, report)
    del long, one
    out = {"k5_passes_ms": _time(lambda: sw.sw_scores_stream_long(
               qc, ql, m8, db, start, **kw), 2),
           "k2_one_pass_ms": _time(lambda: sw.sw_scores_stream(
               qc, ql, m8, db, start, **kw), 2),
           "shape": [list(qc.shape), list(db.shape)]}
    log(f"time: long-search chunk {out['shape']}: four tile passes (K5) "
        f"{out['k5_passes_ms']:.3f} ms; one K2 pass over the same rows "
        f"{out['k2_one_pass_ms']:.3f} ms (same dump)")
    return out


def _fresh(name, args):
    """The arguments with the state a wrapper updates in place cloned."""
    return tuple(a.clone() if i in STATE_ARGS.get(name, ()) else a
                 for i, a in enumerate(args))


def _plain(name):
    return PLAIN.get(name) or getattr(KERNELS[name][0], name + "_plain")


def _checked(name, args):
    """A call's arguments as check_paths holds them against the plain
    version: K7's giants cut to the first 262,144 columns of the first
    (its plain version walks a column a step, about 77 s there; the
    tblastn phase holds the whole call's hit lists against the carry
    series')."""
    if name != "sw_wavefront_giants":
        return args
    mq, ql, held = args
    return mq, ql, wf.HeldGiants(held.db, held.starts[:1], (min(
        held.lengths[0], wf.SEG_STRIPS * wf.STRIP),))


def check_paths(calls, report):
    """Every kernel each search launched, held against its plain version
    at that search's largest call of it: the inputs as they came in, the
    state it updates in place cloned for each.  Returns (the plain
    version's ms by (search, kernel), max_abs_err by search and
    kernel)."""
    plain_ms, errs = {}, {}
    for (label, name), (_, args, kw) in calls.items():
        args = _checked(name, args)
        mod = KERNELS[name][0]
        out = getattr(mod, name)(*_fresh(name, args), **kw)
        plain, pargs, ref = _plain(name), _fresh(name, args), []
        plain_ms[label, name] = _time(
            lambda: ref.append(plain(*pargs, **kw)), 1, warm=False)
        errs.setdefault(label, {})[name] = _compare(name, out, ref[0],
                                                    report)
        del out, ref
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"check {label}: {name} at {shapes} equals its plain version "
            f"(max_abs_err {errs[label][name]}, plain "
            f"{plain_ms[label, name]:.1f} ms)")
    return plain_ms, errs


def time_kernels(calls, plain_ms, report):
    """Each kernel's time and bound at its largest call over all the
    searches, beside its plain version's time there (check_paths)."""
    rows = {}
    for name, (mod, _, _) in KERNELS.items():
        label = max((k for k in calls if k[1] == name),
                    key=lambda k: calls[k][0])[0]
        _, args, kw = calls[label, name]
        fn = getattr(mod, name)
        out = fn(*_fresh(name, args), **kw)
        reps = 2 if name == "sw_wavefront_giants" else 5
        ms = _time(lambda: fn(*args, **kw), reps)
        nbytes, alu, ops, int32_ops = _work(name, args, kw, out)
        chain = _chain(name, args, kw)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        alu_ms = alu / PEAK["thread_instructions_per_s"] * 1e3
        issue_ms = ops / DATASHEET_ISSUE_PER_S * 1e3
        path_ms = chain * PEAK["dpx_latency_ns_per_step"] / 2 * 1e-6
        terms = {"bytes": bytes_ms, "throughput": max(alu_ms, issue_ms),
                 "critical path": path_ms}
        term = max(terms, key=terms.get)
        rows[name] = dict(ms=ms, plain_ms=plain_ms[label, name],
                          bound_ms=terms[term],
                          bound_by="bytes" if term == "bytes"
                          else "operations", bound_term=term)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        was = f" [{REDESIGNED_FROM_MS[name]:.3f} ms before the redesign]" \
            if name in REDESIGNED_FROM_MS else ""
        log(f"time: {name} at {shapes} ({label}): {ms:.3f} ms{was}, plain "
            f"{rows[name]['plain_ms']:.1f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({term}; bytes "
            f"{bytes_ms:.4f} ms, {alu} least ALU instructions "
            f"{alu_ms:.4f} ms at the measured ALU rate, {ops} least "
            f"instructions {issue_ms:.4f} ms at the data sheet's issue "
            f"ceiling, {chain} dependent instructions on the critical path "
            f"{path_ms:.4f} ms; as two-operand int32 on the ALU pipe "
            f"{int32_ops / INT32_OPS_PER_S * 1e3:.4f} ms)")
        if name == "sw_wavefront_giants":
            rows[name].update(time_wavefront(args, kw, out, report))
    return rows


def time_wavefront(args, kw, out, report):
    """K7 at its largest call (every query against the six frames) with
    the first query alone, the usual tblastn search: its scores must be
    the first query's of the whole call (``out``); then one 262,144-column
    segment of the first giant through sw_wavefront, a chain a query,
    with the whole call's queries and with the first alone."""
    mq, ql, held = args
    one = (mq[:1].contiguous(), ql[:1], held)
    got = wf.sw_wavefront_giants(*one, **kw)
    _compare("sw_wavefront_giants", got, out[:1], report)
    pieces = wf.plan_pieces(held.lengths, 1, mq.shape[1], kw["overlap"],
                            wf.wavefront_resident(mq.shape[1], mq.device))
    times = {"one_query_ms": _time(
        lambda: wf.sw_wavefront_giants(*one, **kw), 3)}
    log(f"time: sw_wavefront_giants, one query of {mq.shape[1]} rows "
        f"against giants of {list(held.lengths)} in {len(pieces)} pieces: "
        f"{times['one_query_ms']:.3f} ms, the scores of the first query of "
        "the whole call")
    seg = held.db[:wf.SEG_STRIPS * wf.STRIP]
    gaps = dict(gapopenextend=kw["gapopenextend"], gapextend=kw["gapextend"])
    for key, q in (("segment_ms", len(ql)), ("segment_one_query_ms", 1)):
        full = mq[:q].contiguous()
        state = wf.make_wavefront_state(q, mq.shape[1], mq.device)
        times[key] = _time(lambda: wf.sw_wavefront(full, seg, *state,
                                                   **gaps), 3)
        log(f"time: sw_wavefront at {tuple(full.shape)} x {seg.shape[0]} "
            f"columns: {times[key]:.3f} ms")
    return times


def summed_device_ms():
    """Each kernel's device time summed over its launches in the searches
    (the CUDA events record_calls put around each wrapper call)."""
    torch.cuda.synchronize()
    return {n: sum(a.elapsed_time(b) for a, b in ev)
            for n, ev in DEVICE_EVENTS.items()}


def time_by_search(calls):
    """The warp-a-pair kernels (K3's row form, K4, K5, K6) at each
    search's largest call of them: ms a launch by search."""
    out = {}
    for (label, name), (_, args, kw) in calls.items():
        if name in ("sw_scores_stream_carry_rows", "stream_tile_carry_pass",
                    "stream_tile_pass", "sw_hint_stream"):
            fn = getattr(KERNELS[name][0], name)
            out[f"{label}/{name}"] = ms = _time(lambda: fn(*args, **kw), 3)
            log(f"time: {name} at {label}'s largest call: {ms:.3f} ms")
    return out


# ---- phase 9: the CLI ------------------------------------------------------

def cli(workdir):
    """``python -m swipe_tpu_torch -m 8`` on a database of 3,000 records;
    returns the database's and the queries' paths and the records."""
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
    return db, qf, recs


# ---- phase 10: several devices and several processes -----------------------

# the distributed phase: Swiss-Prot records in one chunk of each pack, and
# each device's top-k
DIST_SEQS, DIST_K = 20_000, 256
# lines of a report that differ between two runs: times and speeds
VOLATILE = ("Search started", "Search completed", "Elapsed", "Speed")


def distributed(dev, db, queries, card):
    """parallel/distributed.py on a mesh of two cells of the one card (two
    lane shards) over a chunk of the Swiss-Prot model, the search phase's
    16 queries: the merged top-K and the cells of sharded_stream_topk
    (K2) and sharded_topk_scores (K9) must equal one device's over the
    whole chunk.  Returns (launches, stats)."""
    from swipe_tpu_torch.parallel import distributed as dm
    seqs = [db.get_sequence(i, 1)[0] for i in range(DIST_SEQS)]
    qs = [q.aa[0] for q in queries]
    m = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    sch = pack_stream(seqs, nseqs=2048, max_cols=8192)[0]
    pch = pack_database(seqs, nseqs=512, max_cols=16384)[0]
    qc, ql = sw.build_qcodes(qs, 256)
    qpt = seg.build_qpt(qs, m, 256)
    kw = dict(gapopenextend=12, gapextend=1, k=DIST_K)

    def run(n_db):
        mesh = dm.make_mesh(n_db, 1, [dev] * n_db)
        st = dm.sharded_stream_topk(
            mesh, qc, ql, sw.build_matrix8(m), sch.data, sch.start,
            *dm.shard_stream_chunk(sch, n_db), **kw)
        sg = dm.sharded_topk_scores(
            mesh, qpt, pch.data, pch.seg_ids, pch.seqnos.astype(np.int32),
            nsegs=pch.seqnos.shape[0], **kw)
        return [(dm.merge_topk(sc, un, DIST_K), cells)
                for sc, un, cells in (st, sg)]

    got, wall, launches, _ = run_path(
        "distributed", dev, lambda: run(2),
        ("sw_scores_stream", "sw_scores_segmented"), {})
    want = run(1)
    units = (len(sch.seqnos), int((pch.seqnos >= 0).sum()))
    for name, n, ((s, u, _), c), ((ws, wu, _), wc) in zip(
            ("sharded_stream_topk", "sharded_topk_scores"), units, got,
            want):
        # ties at the k-th score may keep other members on two shards
        above = s > s[:, -1:]
        if c != wc or c != n * len(qs) or not np.array_equal(s, ws) or any(
                set(u[i][above[i]]) != set(wu[i][above[i]])
                for i in range(len(qs))):
            raise RuntimeError(f"distributed: {name} on two lane shards "
                               "differs from one device's")
    log(f"distributed: sharded_stream_topk and sharded_topk_scores on a "
        f"2 x 1 mesh of {dev} over {DIST_SEQS} Swiss-Prot records "
        f"({sch.n_cols} x {sch.nseqs} and {pch.data.shape[0]} x "
        f"{pch.nseqs} chunks), {len(qs)} queries, top {DIST_K} a shard: "
        f"merged top-K and cells equal one device's; {wall:.3f} s [{card}]")
    return launches, {"wall_s": wall}


def cli_in_process(argv) -> str:
    """The port's CLI in this process; its standard output."""
    from contextlib import redirect_stdout

    from swipe_tpu_torch.cli import main as cli_main
    buf = io.StringIO()
    with redirect_stdout(buf):
        if cli_main(argv) != 0:
            raise RuntimeError(f"CLI {argv} exited non-zero")
    return buf.getvalue()


def masked(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith(VOLATILE)]


def multihost(dev, dbpath, recs, workdir, card):
    """MultiHostEngine in this process (a world of one) over two cells of
    the one card, on the CLI phase's database: 8 queries (mutated windows
    of its records) with BLOSUM62 (the lane pack on K2, hints on K4), then
    with BLOSUM62 scaled by 100 from a matrix file (scores outside int8:
    the lane pack on K3's row form from a fresh state).  Hit lists and
    cell counts must equal SearchEngine's.  Returns (launches by run,
    stats)."""
    from swipe_tpu_torch.parallel.multihost import MultiHostEngine
    rng = np.random.default_rng(12)
    queries = []
    for i, rec in enumerate(rng.choice(len(recs), 8, replace=False)):
        q = list(recs[rec][:150])
        for j in np.flatnonzero(rng.random(len(q)) < 0.2):
            q[j] = swissprot_letters(1, rng)
        queries.append(preprocess_query(f"m{i}", "".join(q), 1, 3))
    src = os.path.join(os.path.dirname(_build.__file__), "data",
                       "blosum62.mat")
    wide = os.path.join(workdir, "blosum62x100.mat")
    with open(src) as f, open(wide, "w") as g:
        for ln in f:
            parts = ln.split()
            if len(parts) > 1 and not ln.startswith("#") and all(
                    x.lstrip("-").isdigit() for x in parts[1:]):
                ln = " ".join([parts[0]] + [str(100 * int(x))
                                            for x in parts[1:]]) + "\n"
            g.write(ln)
    db = FastaDatabase(dbpath, "aa", title="cli db")
    launches, stats = {}, {}
    for label, matrix, go, ge, expect in (
            ("multihost", "BLOSUM62", 11, 1,
             ("sw_scores_stream", "sw_hint_stream")),
            ("multihost-wide", wide, 1100, 100,
             ("sw_scores_stream_carry_rows",))):
        params = SearchParams(symtype=1, matrixname=matrix, gapopen=go,
                              gapextend=ge)
        t0 = time.time()
        eng = MultiHostEngine(db, params, devices=[dev, dev])
        pack_s = time.time() - t0
        tm, ts = SearchTimings(), SearchTimings()
        got, wall, launches[label], _ = run_path(
            label, dev, lambda: eng.search_batch(queries, tm), expect, {})
        want = SearchEngine(db, params, device=dev).search_batch(queries,
                                                                 ts)
        if hit_keys(got) != hit_keys(want) or tm.compute[7] != \
                ts.compute[7]:
            raise RuntimeError(f"{label}: the hit lists differ from "
                               "SearchEngine's")
        stats[label] = {"wall_s": wall, "pack_s": pack_s,
                        "scoring_s": tm.elapsed}
        log(f"{label}: MultiHostEngine on [{dev}, {dev}] "
            f"({eng._nseqs_local} lanes), {len(queries)} queries, matrix "
            f"{os.path.basename(matrix)}: {sum(len(h.hits) for h in got)} "
            "hits equal SearchEngine's; "
            f"pack {pack_s:.3f} s, scoring {tm.elapsed:.3f} s, wall "
            f"{wall:.3f} s [{card}]")
    return launches, stats


def genome_db(workdir, rng):
    """A small nt database: 200 gene-length records beside one of 70,000
    nt (a unit over the 65,536-column giant threshold), and a 400-nt
    query with mutated copies in the long record and in a short one."""
    nt = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = [rng.choice(nt, int(n)) for n in rng.integers(200, 600, 200)]
    recs.append(rng.choice(nt, 70_000))
    q = rng.choice(nt, 400)
    for rec, at in ((200, 41_000), (17, 50)):
        w = q.copy()
        pos = rng.random(len(w)) < 0.1
        w[pos] = rng.choice(nt, int(pos.sum()))
        recs[rec][at: at + len(w)] = w
    dbpath = os.path.join(workdir, "nt.fa")
    qpath = os.path.join(workdir, "nt_q.fa")
    with open(dbpath, "w") as f:
        f.writelines(f">g{i} record {i}\n{r.tobytes().decode()}\n"
                     for i, r in enumerate(recs))
    with open(qpath, "w") as f:
        f.write(f">nq planted\n{q.tobytes().decode()}\n")
    return dbpath, qpath


# a rank's launch counts, on a line of its standard error
RANK_LAUNCHES = "chip_smoke rank launches "


def mh_rank(argv) -> int:
    """One rank of the multihost-2proc phase: the port's CLI, then the
    launch counts of the whole run and of the owner's giant route
    (MultiHostEngine._mh_score_giants, with the giants this rank owns)
    printed to standard error."""
    from swipe_tpu_torch import cli as port_cli
    from swipe_tpu_torch.parallel.multihost import MultiHostEngine
    base = launch_counts()
    giants = {"owned": 0, "launches": dict.fromkeys(KERNELS, 0)}
    score_giants = MultiHostEngine._mh_score_giants

    def counted(self, *a, **k):
        before = launch_counts()
        try:
            return score_giants(self, *a, **k)
        finally:
            giants["owned"] = int(self._giant_ids.size)
            for n, v in launch_counts().items():
                giants["launches"][n] += v - before[n]

    MultiHostEngine._mh_score_giants = counted
    rc = port_cli.main(argv)
    print(RANK_LAUNCHES + json.dumps({"run": launch_counts(base),
                                      "giants": giants}), file=sys.stderr)
    return rc


def multihost_procs(dbpath, qpath, workdir, card):
    """``python -m swipe_tpu_torch --mh-procs 2`` in two processes on the
    one card (both ranks on cuda:0, a gloo group at a free localhost
    port), each through mh_rank: blastp -m 0 and -m 8 on the CLI phase's
    database, and blastn on genome_db, whose 70,000-nt record takes its
    owner's giant route.  Rank 0's report must equal the single-process
    run's bytes but for the times and speeds; each rank must have
    launched K2, and in blastn-giant the rank that owns the long record
    a giant route's kernel there.  Returns stats."""
    import socket
    ntdb, ntq = genome_db(workdir, np.random.default_rng(13))
    cases = {"blastp-m0": ["-i", qpath, "-d", dbpath, "-m", "0"],
             "blastp-m8": ["-i", qpath, "-d", dbpath, "-m", "8"],
             "blastn-giant": ["-p", "blastn", "-i", ntq, "-d", ntdb, "-m",
                              "0"]}
    t0 = time.time()
    procs = {}
    try:
        for case, args in cases.items():
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            for r in range(2):
                out = os.path.join(workdir, f"{case}.{r}.txt")
                procs[case, r] = (out, subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     "sys.exit(chip_smoke.mh_rank(sys.argv[1:]))", *args,
                     "--mh-procs", "2", "--mh-rank", str(r), "--mh-coord",
                     f"localhost:{port}", "-o", out], cwd=REPO,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True))
        # the single-process runs, meanwhile
        single = {case: masked(cli_in_process(args))
                  for case, args in cases.items()}
        errs = {key: p.communicate(timeout=600)[1]
                for key, (_, p) in procs.items()}
    finally:
        for _, p in procs.values():
            p.kill()
            p.wait()
    wall = time.time() - t0
    counts = {}
    for (case, r), (out, p) in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"multihost-2proc {case} rank {r} exited "
                               f"{p.returncode}:\n{errs[case, r][-3000:]}")
        lines = errs[case, r].splitlines()
        wave = [ln for ln in lines if "wave2" in ln]
        log(f"multihost-2proc {case}: {wave[-1] if wave else 'no wave2 line'}")
        if not wave:
            raise RuntimeError(f"multihost-2proc {case} rank {r}: no wave2 "
                               "line")
        got = [json.loads(ln[len(RANK_LAUNCHES):]) for ln in lines
               if ln.startswith(RANK_LAUNCHES)]
        if not got:
            raise RuntimeError(f"multihost-2proc {case} rank {r}: no launch "
                               "counts")
        counts[case, r] = got[0]
        log(f"multihost-2proc {case} rank {r}: launches "
            f"{json.dumps(got[0])}")
        if got[0]["run"]["sw_scores_stream"] <= 0:
            raise RuntimeError(f"multihost-2proc {case} rank {r}: "
                               "sw_scores_stream was not launched")
    owners = [r for r in range(2)
              if counts["blastn-giant", r]["giants"]["owned"]]
    if len(owners) != 1 or not any(
            counts["blastn-giant", owners[0]]["giants"]["launches"][n] > 0
            for n in ("sw_scores_stream", "sw_wavefront_giants",
                      "sw_scores_stream_carry_rows",
                      "stream_tile_carry_pass")):
        raise RuntimeError("multihost-2proc blastn-giant: no rank scored "
                           "the long record on a giant route's kernel")
    for case in cases:
        with open(procs[case, 0][0]) as f:
            got = masked(f.read())
        if got != single[case] or len(got) < 10:
            raise RuntimeError(f"multihost-2proc {case}: rank 0's report "
                               "differs from the single process's")
    if not any(ln.startswith("nq\tg200") or "g200 record" in ln
               for ln in single["blastn-giant"]):
        raise RuntimeError("multihost-2proc: the long record's hit is "
                           "missing")
    log(f"multihost-2proc: {len(cases)} runs of two ranks on one card, "
        f"rank 0's reports equal the single process's; the long record "
        f"scored by rank {owners[0]}; {wall:.1f} s [{card}]")
    return {"wall_s": wall,
            "launches": {f"{case}.{r}": c["run"]
                         for (case, r), c in counts.items()}}


def dump(dbpath, recs, card):
    """``-N 1`` on the CLI phase's database: every record back, its
    sequence in 80-column lines.  Host only."""
    t0 = time.time()
    text = cli_in_process(["-d", dbpath, "-N", "1"])
    wall = time.time() - t0
    back = [r.split("\n", 1) for r in text.split(">")[1:]]
    if [s.replace("\n", "") for _, s in back] != recs or any(
            len(ln) > 80 for ln in text.splitlines()):
        raise RuntimeError("dump: -N 1 did not give the records back")
    log(f"dump: -N 1 gave {len(back)} records back in {wall:.3f} s [{card}]")
    return {"wall_s": wall}


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
    t = time.time()
    check_kernels(dev, report)
    log(f"check: {json.dumps(report)} in {time.time() - t:.1f} s")
    for name, r in report.items():
        if r["mismatches"]:
            raise RuntimeError(f"{name} differs from its plain version")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    calls: dict = {}
    launches: dict = {}
    stats: dict = {}
    launches["peak"], stats["peak"] = peak_phase(dev, card, calls)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        t = time.time()
        (launches["search"], stats["search"], engine, db, lens, queries,
         hitlists) = search(dev, workdir, 570_000, 16, card, calls)
        launches["distributed"], stats["distributed"] = distributed(
            dev, db, queries, card)
        launches["long-search"], stats["long-search"] = long_search(
            "long-search", engine, db, lens, 4, 1537, 2048,
            ("stream_tile_pass", "sw_hint_stream"), card, calls, seed=7)
        del engine
        launches["segment-search"], stats["segment-search"] = segment_search(
            "segment-search", dev, db, queries, hitlists, "pallas",
            "sw_scores_tiled", card, calls)
        del db, lens, queries, hitlists
        (launches["proteome"], stats["proteome"], engine, db, lens, queries,
         hitlists) = proteome(dev, workdir, 20_000, 16, card, calls)
        launches["long-proteome"], stats["long-proteome"] = long_search(
            "long-proteome", engine, db, lens, 16, 1100, 4000,
            ("stream_tile_pass", "sw_hint_stream"), card, calls, seed=8)
        titin = max(c.data_t.shape[1] for c in engine._stream_chunks(
            1024, engine.LONG_MAX_COLS))
        if titin <= engine.LONG_MAX_COLS:
            raise RuntimeError("long-proteome: the titin did not stretch its "
                               f"chunk past {engine.LONG_MAX_COLS} columns")
        if len({g[1] for g in stats["long-proteome"]["groups"]}) < 2:
            raise RuntimeError("long-proteome: one qlen_pad group only")
        del engine
        launches["segment-proteome"], stats["segment-proteome"] = \
            segment_search("segment-proteome", dev, db, queries, hitlists,
                           "pallas_v1", "sw_scores_segmented", card, calls)
        if stats["segment-proteome"]["giants"] != 1:
            raise RuntimeError("segment-proteome: the titin is not a giant")
        del db, lens, queries, hitlists
        more, st = genome_searches(dev, workdir, card, calls)
        launches.update(more)
        stats.update(st)
        log(f"searches: {time.time() - t:.1f} s; launches by search "
            f"{json.dumps(launches)}")
        summed = summed_device_ms()
        DEVICE_EVENTS.clear()
        t = time.time()
        plain_ms, errs = check_paths(calls, report)
        log(f"check: max_abs_err by search and kernel {json.dumps(errs)} "
            f"in {time.time() - t:.1f} s")
        for name, r in report.items():
            if r["mismatches"]:
                raise RuntimeError(f"{name} differs from its plain version "
                                   "at a search's shapes")
        t = time.time()
        rows = time_kernels(calls, plain_ms, report)
        stats["time-tiles"] = time_tiles(calls, report)
        stats["time-by-search"] = time_by_search(calls)
        del calls
        log(f"time: {time.time() - t:.1f} s")
        if any(r["mismatches"] for r in report.values()):
            raise RuntimeError("sw_scores_stream over 2,048 rows, or "
                               "sw_wavefront_giants with one query, "
                               "differs")
        dbpath, qpath, recs = cli(workdir)
        more, st = multihost(dev, dbpath, recs, workdir, card)
        launches.update(more)
        stats.update(st)
        stats["multihost-2proc"] = multihost_procs(dbpath, qpath, workdir,
                                                   card)
        stats["dump"] = dump(dbpath, recs, card)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(n[name] for n in launches.values()),
                    max_abs_err=report[name]["max_abs_err"],
                    library_ms=None, summed_ms=summed.get(name, 0.0),
                    **rows[name])
               for name, (_, src, rep) in KERNELS.items()]
    # the loss against the bound: the summed device time of the launches
    # times the share of the largest call's time above its bound
    for k in kernels:
        k["loss_ms"] = k["summed_ms"] * max(0.0, 1 - k["bound_ms"] / k["ms"])
    log("time: summed device ms and loss by kernel, largest loss first: "
        + "; ".join(f"{k['name']} {k['summed_ms']:.1f} ms over "
                    f"{k['launches']} launches (largest call {k['ms']:.3f} "
                    f"ms), loss {k['loss_ms']:.1f} ms"
                    for k in sorted(kernels, key=lambda k: -k["loss_ms"])))
    log(f"search: {json.dumps(stats)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
