"""Check and time K7 (the wavefront) and K2 (the plain-pack stream kernel)
on one CUDA card.

    python3 scripts/stream_wave.py [--check-only]

First each kernel is held against its plain version on small inputs,
exactly: K7 over a giant cut into segments (hits and long horizontal gaps
across slab edges and segment cuts; 1 and 3 queries, 40-1,000 rows), K2
at every band height (query lengths at the band edges, a start bit inside
the first 32 columns, with and without a clamp).  Then, inputs from fixed
seeds:

* K7 at tblastn's segment, 16 queries of 400 aa (qlen_pad 512) against
  262,144 residues; one query; a tail segment of 1,024 columns;
* K2 at chip_smoke.py's shapes: Swiss-Prot (16 x 200 aa, qlen_pad 256, a
  2048-lane x 8,192-column chunk of Swiss-Prot-like records), genome (16 x
  500 nt, qlen_pad 512, 2048 x 8,192 of gene-length records, +1/-3, gaps
  5/2), 513-1,024 rows (16 queries of 600-1,024 aa, qlen_pad 1024, 1024 x
  8,192) and the long-search chunk over 2,048 rows (4 queries of 1,537-
  2,048 aa, 1024 x 16,384).

One JSON line a result, with the card and its power limit: ms a launch
(CUDA events over a few launches after a warm-up).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.join(REPO, "tests"))

from row_kernels import card, lengths, seqs_of, timed  # noqa: E402
import torch_row_cases as rc  # noqa: E402

def equal(name, got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bad = sum(int((g.cpu().long() != w.cpu().long()).sum())
              for g, w in zip(got, want))
    if bad:
        raise RuntimeError(f"{name}: {bad} values differ from the plain "
                           "version")


def check_wavefront(wf, sw, m8, dev, emit):
    """K7 against the plain version on torch_row_cases' giant, segment by
    segment, with 1 and 3 queries."""
    rng = np.random.default_rng(11)
    qs, seq = rc.wavefront_case(rng)
    mq = torch.from_numpy(wf.build_mq(sw.build_qcodes(qs, 1024)[0],
                                      m8.cpu().numpy())).to(dev)
    db = torch.from_numpy(seq).to(dev)
    kw = dict(gapopenextend=12, gapextend=1)
    cuts = range(0, len(seq), rc.WAVE_SEGMENT)
    want = {}
    for nq in (1, len(qs)):
        st = wf.make_wavefront_state(nq, 1024, dev)
        for pos in cuts:
            wf.sw_wavefront_plain(mq[:nq], db[pos:pos + rc.WAVE_SEGMENT],
                                  *st, **kw)
            want[nq, pos] = tuple(x.clone() for x in st)
    for nq in (1, len(qs)):
        got = wf.make_wavefront_state(nq, 1024, dev)
        for pos in cuts:
            wf.sw_wavefront(mq[:nq], db[pos:pos + rc.WAVE_SEGMENT], *got,
                            **kw)
            equal(f"sw_wavefront {nq} queries at column {pos}", got,
                  want[nq, pos])
    emit(check="K7", ok=True)


def check_stream(sw, batching, m8, dev, emit):
    """K2's row form at every band height against its plain version."""
    rng = np.random.default_rng(12)
    seqs = seqs_of(rng, rng.integers(1, 300, 1024 * 64 * 16 // 140), 20)
    ch = batching.pack_stream(seqs, nseqs=1024, max_cols=64 * 16)[0]
    data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start, ch.end_block,
                                         ch.lane, dev)
    for qlens in rc.STREAM_LENGTHS:
        qs = seqs_of(rng, qlens, 20)
        host = data.cpu().numpy()
        rc.plant_windows(rng, host, start.cpu().numpy(), qs,
                         rc.STREAM_EDGES)
        d = torch.from_numpy(host).to(dev)
        qpad = -(-max(qlens) // 32) * 32
        qc, ql = (torch.from_numpy(a).to(dev)
                  for a in sw.build_qcodes(qs, qpad))
        for clamp in (None, 80):
            kw = dict(gapopenextend=12, gapextend=1, clamp=clamp)
            equal(f"sw_scores_stream {qlens} clamp {clamp}",
                  sw.sw_scores_stream(qc, ql, m8, d, start, **kw),
                  sw.sw_scores_stream_plain(qc, ql, m8, d, start, **kw))
        emit(check="K2", qlens=list(qlens), band=sw.stream_band(qpad),
             ok=True)


def wave_times(wf, sw, m8, dev, emit):
    rng = np.random.default_rng(13)
    qs = seqs_of(rng, [400] * 16, 20)
    mq = torch.from_numpy(wf.build_mq(sw.build_qcodes(qs, 512)[0],
                                      m8.cpu().numpy())).to(dev)
    seg = torch.from_numpy(seqs_of(rng, [262144], 20)[0]).to(dev)
    kw = dict(gapopenextend=12, gapextend=1)
    for nq, L in ((16, 262144), (1, 262144), (16, 1024)):
        st = wf.make_wavefront_state(nq, 512, dev)
        ms = timed(lambda: wf.sw_wavefront(mq[:nq], seg[:L], *st, **kw), 3)
        emit(kernel="K7", queries=nq, columns=L, ms=ms)


def stream_shapes(sw, batching, dev):
    from swipe_tpu_torch.matrices import ScoreMatrix
    m8 = sw.build_matrix8(ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)
    nt = sw.build_matrix8(ScoreMatrix.nucleotide(1, -3, 5, 2).matrix)
    rng = np.random.default_rng(14)
    for name, recs, qlens, qpad, mat, alphabet, gaps, n, cols in (
            ("swissprot", seqs_of(rng, lengths(rng, 60_000), 20), [200] * 16,
             256, m8, 20, (12, 1), 2048, 8192),
            ("genome", seqs_of(rng, rng.integers(200, 3001, 12000), 4),
             [500] * 16, 512, nt, 4, (7, 2), 2048, 8192),
            ("rows-513-1024", seqs_of(rng, lengths(rng, 30_000), 20),
             list(rng.integers(600, 1025, 16)), 1024, m8, 20, (12, 1), 1024,
             8192),
            ("long-search", seqs_of(rng, lengths(rng, 50_000), 20),
             [1537, 1700, 1900, 2048], 2048, m8, 20, (12, 1), 1024, 16384)):
        chunks = batching.pack_stream(recs, nseqs=n, max_cols=cols)
        ch = max((c for c in chunks if c.data_t.shape[1] <= cols),
                 key=lambda c: int((c.data_t != 31).sum()))
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
            seqs_of(rng, qlens, alphabet), qpad))
        yield name, qc, ql, torch.from_numpy(mat).to(dev), data, start, gaps


def stream_times(sw, batching, dev, emit):
    for name, qc, ql, mat, data, start, (Q, R) in stream_shapes(
            sw, batching, dev):
        kw = dict(gapopenextend=Q, gapextend=R)
        ms = timed(lambda: sw.sw_scores_stream(qc, ql, mat, data, start,
                                               **kw), 3)
        emit(kernel="K2", shape=name, dims=[*qc.shape, *data.shape],
             band=sw.stream_band(qc.shape[1]), ms=ms)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    global torch
    import torch
    from swipe_tpu_torch import _build as build
    from swipe_tpu_torch import batching
    from swipe_tpu_torch.matrices import ScoreMatrix
    from swipe_tpu_torch.ops import sw_stream as sw
    from swipe_tpu_torch.ops import sw_wavefront as wf
    if not torch.cuda.is_available():
        print("stream_wave: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = dict(card=card())
    build.build_kernels()

    def emit(**kw):
        print(json.dumps(dict(info, **kw)), flush=True)

    m8 = torch.from_numpy(sw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)).to(dev)
    check_wavefront(wf, sw, m8, dev, emit)
    check_stream(sw, batching, m8, dev, emit)
    if args.check_only:
        return 0
    wave_times(wf, sw, m8, dev, emit)
    stream_times(sw, batching, dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
