"""Time the row-form kernels (K3's two forms, K4, K5, K6, K8, K9) on one
CUDA card.

    python3 scripts/row_kernels.py [--root DIR] [--tag T] [--only K8,K9,...]

Inputs come from fixed seeds, built as the engine builds them:

* K5, one 512-row tile pass (tile 0: every query fills it) of
  long-search   4 queries of 1,537-2,048 aa against a full 1024-lane x
                16,384-column chunk of Swiss-Prot-like records;
  long-proteome 4 queries against the 1024-lane chunk that a titin-length
                record (35,213 aa) stretches past 35,000 columns, among
                20,000 proteome-sized records;
  long-genome   2 queries of 1,542 nt against the 1024-lane chunk of
                4,000 gene-length records (200-3,000 nt), +1/-3, gaps 5/2;
* K4, one launch of
  titin-bins    16 bins of 200-aa queries with 32 subjects each, one of
                them the titin;
  tblastn       one 400-aa query against 960 pieces of 14,528 columns (a
                chromosome's six frames cut for the hint pass);
  wide          one 500-nt query against 1,007 pieces of 5,358 columns
                with blastn scores scaled by 100 (the int32 matrix, two
                256-row bands);
* K6, a pass of long-genome's tile 0 (2 queries of 1,542 nt, 32 lanes x
  8,192 columns, one chromosome lane), and K3's row form at wide-genome's
  chunk (16 x 500 nt, the int32 matrix) and tblastn-carry's (16 x 400 aa,
  six frame lanes);
* K8 and K9 (the segment kernel's two entry points), one launch of 16
  queries against the fullest 512-lane x 16,384-column pack_database
  chunk of
  segment-search    200 aa (K8, BLOSUM62 11/1, qlen_pad 256), records
                    of the Swiss-Prot length model;
  segment-proteome  200 aa (K9, an int8 profile), 20,000 proteome-sized
                    records;
  wide-genome       500 nt (K9, an int32 profile: blastn +100/-300, gaps
                    500/200, qlen_pad 512), 4,000 gene-length records;
  long-segment      600-1,024 aa (K8, qlen_pad 1024: two bands),
                    segment-search's chunk;
* K3 on the flow series, one launch of 16 queries of 200 aa (qlen_pad
  256), the carried state read and written, at
  flow-chunk  the proteome's largest flow chunk, 2,048 lanes x 1,792
              columns (pack_stream_flow of 20,000 proteome-sized records
              and a titin-length one at the engine's chunk height),
  one-shot    its largest drain, the series' one-shot end at 1,024
              lanes (7,168 columns), and
  drain       one of its titin chain's drains, 1,024 lanes x 128
              columns;
  through the entry point (the flow form), or in a tree with the lane
  form, the lane form with the block profiles built beforehand (its
  launch alone) and the profile build alone;
* where K3's forms cross: 16 queries of 200 and of 500 residues
  (BLOSUM62, gaps 11/1) against one chunk of 2,048 columns whose 32 to
  2,048 lanes all hold random records (a start bit every 19 blocks on
  average): the row form and the flow form, or in a tree with the lane
  form, the row form and the lane form with block profiles
  (build_dprofile_series and the launch, as the flow route ran it), their
  dumps and states held equal.

``--only`` runs some of the groups: K5, K4, K6, K3r, K3f (the flow
series' shapes), K8, K9, forms (the crossover) and sass.  ``--root``
imports the package from another checkout, for instance a parent
commit's unpacked into a directory that .gitignore lists, to time its
kernels on the same inputs (the wrappers' contracts are the same).
Each result is one JSON line with the card and its power limit: ms a
launch (CUDA events over 5 launches after a warm-up, 3 for the
crossover) and a digest of the outputs of one fresh launch, equal
across trees when their results are.  Last, for each
kernel function of the tree's built carry_rows, hint and segment
libraries (cuobjdump), its registers, SASS instructions and the count of
each opcode class that the walker's cost turns on.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the Swiss-Prot length model of chip_smoke.py (log-normal, clipped at
# titin)
LEN_MU, LEN_SIGMA, LEN_MIN, LEN_MAX = 5.677, 0.651, 2, 35213


def lengths(rng, n):
    x = np.exp(rng.normal(LEN_MU, LEN_SIGMA, size=n)).astype(np.int64)
    return np.clip(x, LEN_MIN, LEN_MAX)


def seqs_of(rng, lens, alphabet):
    return [rng.integers(1, alphabet + 1, size=int(n), dtype=np.int8)
            for n in lens]


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def tile_shapes(sw, batching, dev):
    """(name, qcodes, qlens, matrix, db, start, (Q, R)) of each K5 shape."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    m8 = sw.build_matrix8(ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)
    nt = sw.build_matrix8(ScoreMatrix.nucleotide(1, -3, 5, 2).matrix)
    rng = np.random.default_rng(7)
    out = []
    for name, recs, qlens, mat, alphabet, gaps in (
            ("long-search", seqs_of(rng, lengths(rng, 50_000), 20),
             (1537, 1700, 1900, 2048), m8, 20, (12, 1)),
            ("long-proteome", seqs_of(rng, list(lengths(rng, 20_000))
                                      + [LEN_MAX], 20),
             (1100, 1600, 2400, 3182), m8, 20, (12, 1)),
            ("long-genome", seqs_of(rng, rng.integers(200, 3001, 4000), 4),
             (1542, 1542), nt, 4, (7, 2))):
        chunks = batching.pack_stream(recs, nseqs=1024, max_cols=16384)
        ch = max(chunks, key=lambda c: (c.data_t.shape[1],
                                        int((c.data_t != 31).sum())))
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        qs = seqs_of(rng, qlens, alphabet)
        qpad = -(-max(qlens) // 512) * 512
        qc, ql = (torch.from_numpy(a).to(dev)
                  for a in sw.build_qcodes(qs, qpad))
        out.append((name, qc, ql, torch.from_numpy(mat).to(dev), data,
                    start, gaps))
    return out


def hint_shapes(sw, dev):
    """(name, qcodes, qlens, matrix, db, starts, (Q, R)) of each K4
    shape."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    rng = np.random.default_rng(8)
    m62 = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    out = []

    def dense(bins, lanes):
        cols = -(-max(len(s) for _, ss in bins for s in ss) // 16) * 16
        db = np.full((len(bins), cols, lanes), 31, np.int8)
        for b, (_, ss) in enumerate(bins):
            for i, s in enumerate(ss):
                db[b, :len(s), i] = s
        return db

    def piece_starts(n, lanes, owned):
        st = np.zeros((1, lanes), np.int32)
        st[0, 1:n] = owned
        return st

    titin = seqs_of(rng, [LEN_MAX], 20)[0]
    bins = [(seqs_of(rng, [200], 20)[0],
             [titin] + seqs_of(rng, lengths(rng, 31), 20))
            for _ in range(16)]
    out.append(("titin-bins", bins, sw.build_matrix8(m62),
                np.zeros((16, 32), np.int32), (12, 1), 32))
    q = seqs_of(rng, [400], 20)[0]
    pieces = seqs_of(rng, [14_528] * 960, 20)
    out.append(("tblastn", [(q, pieces)], sw.build_matrix8(m62),
                piece_starts(960, 960, 4800), (12, 1), 960))
    q = seqs_of(rng, [500], 4)[0]
    pieces = seqs_of(rng, [5_358] * 1007, 4)
    wide = sw.build_matrix_wide(
        ScoreMatrix.nucleotide(100, -300, 500, 200).matrix)
    out.append(("wide", [(q, pieces)], wide,
                piece_starts(1007, 1024, 750), (700, 200), 1024))
    res = []
    for name, bins, mat, starts, gaps, lanes in out:
        qc, ql = sw.build_qcodes([q for q, _ in bins],
                                 max(len(q) for q, _ in bins))
        res.append((name, *(torch.from_numpy(a).to(dev) for a in (
            qc, ql, mat, dense(bins, lanes), starts)), gaps))
    return res


def carry_shapes(sw, dev):
    """(kernel, shape, wrapper, a function making its arguments with a
    fresh state, keywords) of K6 and K3's row form at the main path's
    shapes."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    rng = np.random.default_rng(9)

    def put(*a):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in a]

    def chunk(alphabet, real):
        db = np.full((8192, 32), 31, np.int8)
        db[:, :real] = rng.integers(1, alphabet + 1, size=(8192, real))
        return put(db, np.zeros((512, 32), np.int8))

    def queries(nq, n, pad, alphabet):
        return put(*sw.build_qcodes(seqs_of(rng, [n] * nq, alphabet), pad))

    mn, mw, m8 = put(
        sw.build_matrix8(ScoreMatrix.nucleotide(1, -3, 5, 2).matrix),
        sw.build_matrix_wide(
            ScoreMatrix.nucleotide(100, -300, 500, 200).matrix),
        sw.build_matrix8(ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix))
    nt, aa = chunk(4, 1), chunk(20, 6)
    return [
        ("K6", "long-genome", sw.stream_tile_carry_pass,
         lambda: (*queries(2, 1542, 2048, 4), 0, mn, *nt,
                  *sw._tile_planes(2, 8192, 32, dev),
                  *sw.make_stream_state_long(2, 2048, 32, 512, dev)),
         dict(gapopenextend=7, gapextend=2, tile_rows=512)),
        ("K3r", "wide-genome", sw.sw_scores_stream_carry_rows,
         lambda: (*queries(16, 500, 512, 4), mw, *nt,
                  *sw.make_stream_state(16, 512, 32, dev)),
         dict(gapopenextend=700, gapextend=200)),
        ("K3r", "tblastn-carry", sw.sw_scores_stream_carry_rows,
         lambda: (*queries(16, 400, 448, 20), m8, *aa,
                  *sw.make_stream_state(16, 448, 32, dev)),
         dict(gapopenextend=12, gapextend=1))]


def segment_shapes(batching, dev):
    """(kernel, name, wrapper, qpt, db, seg_ids, keywords) of K8 and K9
    at the segment route's chunks."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    from swipe_tpu_torch.ops import sw_segmented as seg
    from swipe_tpu_torch.ops import sw_tiled
    rng = np.random.default_rng(10)
    m62 = ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix
    nt = ScoreMatrix.nucleotide(100, -300, 500, 200).matrix

    def chunk(recs):
        # the segment route's giants (over a chunk's height) stay out
        recs = [r for r in recs if len(r) <= 16384]
        ch = max(batching.pack_database(recs, nseqs=512, max_cols=16384),
                 key=lambda c: (c.data.shape[0], int((c.data != 31).sum())))
        return ch.data, ch.seg_ids, ch.nsegs

    def put(qlens, alphabet, matrix, dtype, qlen_pad):
        return torch.from_numpy(seg.build_qpt(
            seqs_of(rng, qlens, alphabet), matrix, qlen_pad,
            dtype=dtype)).to(dev)

    search = chunk(seqs_of(rng, lengths(rng, 50_000), 20))
    proteome = chunk(seqs_of(rng, lengths(rng, 20_000), 20))
    genes = chunk(seqs_of(rng, rng.integers(200, 3001, 4000), 4))
    aa = dict(gapopenextend=12, gapextend=1)
    out = []
    for kernel, name, fn, (data, seg_ids, nsegs), qpt, kw in (
            ("K8", "segment-search", sw_tiled.sw_scores_tiled, search,
             put([200] * 16, 20, m62, np.int8, 256), aa),
            ("K9", "segment-proteome", seg.sw_scores_segmented, proteome,
             put([200] * 16, 20, m62, np.int8, 256), aa),
            ("K9", "wide-genome", seg.sw_scores_segmented, genes,
             put([500] * 16, 4, nt, np.int32, 512),
             dict(gapopenextend=700, gapextend=200)),
            ("K8", "long-segment", sw_tiled.sw_scores_tiled, search,
             put(rng.integers(600, 1025, 16), 20, m62, np.int8, 1024),
             aa)):
        out.append((kernel, name, fn, qpt, torch.from_numpy(data).to(dev),
                    torch.from_numpy(seg_ids).to(dev),
                    dict(kw, nsegs=nsegs)))
    return out


def flow_shapes(sw, batching, dev):
    """(name, qcodes, qlens, matrix, db, start) of K3 at the proteome's
    largest flow chunk, its one-shot drain and one of its 1,024 x 128
    drains: 20,000 proteome-sized records and a titin-length one packed
    as the engine packs them (SearchEngine._flow_cols, _flow_chunks), 16
    queries of 200 aa at qlen_pad 256."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    rng = np.random.default_rng(11)
    recs = seqs_of(rng, list(lengths(rng, 20_000)) + [LEN_MAX], 20)
    avg_lane = sum(len(r) for r in recs) / 2048
    cols = min(max((int(avg_lane) // 2 + 64) // 128 * 128, 256), 8192)
    chunks = batching.pack_stream_flow(recs, nseqs=2048, max_cols=cols,
                                       drain_cols=128)
    m8 = torch.from_numpy(sw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)).to(dev)
    qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
        seqs_of(rng, [200] * 16, 20), 256))

    def fullest(cs):
        return max(cs, key=lambda c: (c.data_t.size,
                                      int((c.data_t != 31).sum())))

    # the largest call by its tensors (chip_smoke's pick: a full chunk,
    # whose state is twice a drain's), the largest drain (the series'
    # one-shot end) and a drain of the titin's chain
    full = fullest([c for c in chunks if c.nseqs == 2048])
    oneshot = fullest([c for c in chunks if c.nseqs == 1024])
    drain = next(c for c in chunks if c.nseqs == 1024
                 and c.data_t.shape[1] == 128)
    out = []
    for name, ch in (("flow-chunk", full), ("one-shot", oneshot),
                     ("drain", drain)):
        data, start, _, _ = sw.chunk_tensors(ch.data_t, ch.start,
                                             ch.end_block, ch.lane, dev)
        out.append((name, qc, ql, m8, data, start))
    return out


def time_flow(sw, qc, ql, m8, data, start):
    """{form: ms a launch} of K3 at a flow series' shape, the carried
    state read and written, and the digest of one launch's dump and state
    from a fresh state (the same in every tree)."""
    kw = dict(gapopenextend=12, gapextend=1)
    nseqs = data.shape[1]

    st = sw.make_stream_state(16, qc.shape[1], nseqs, data.device)

    def call(fn, **k):
        return fn(qc, ql, m8, data, start, *st, **kw, **k)

    ms = {}
    if hasattr(sw, "sw_scores_stream_carry_flow"):
        dig = digest(sw.sw_scores_stream_carry(
            qc, ql, m8, data, start, *sw.make_stream_state(
                16, qc.shape[1], nseqs, data.device), **kw))
        ms["flow"] = timed(lambda: call(sw.sw_scores_stream_carry))
    else:
        dp = sw.build_dprofile_series(m8, data)
        dig = digest(sw.sw_scores_stream_carry_lanes(
            qc, ql, m8, data, start, *sw.make_stream_state(
                16, qc.shape[1], nseqs, data.device), dprof=dp, **kw))
        ms["lanes"] = timed(lambda: call(sw.sw_scores_stream_carry_lanes,
                                         dprof=dp))
        ms["dprofile"] = timed(lambda: sw.build_dprofile_series(m8, data))
    return ms, dig


def crossover(sw, dev):
    """(pairs, rows, {form: ms}, digest) of K3's forms at each shape,
    their outputs held equal: the row form and the flow form, or in a
    tree with the lane form, the row form and the lane form with block
    profiles (built in each timed call, as the flow route built them)."""
    import torch
    from swipe_tpu_torch.matrices import ScoreMatrix
    rng = np.random.default_rng(1)
    m8 = torch.from_numpy(sw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)).to(dev)
    kw = dict(gapopenextend=12, gapextend=1)
    forms = [("rows", sw.sw_scores_stream_carry_rows, False)]
    if hasattr(sw, "sw_scores_stream_carry_flow"):
        forms.append(("flow", sw.sw_scores_stream_carry_flow, False))
    else:
        forms.append(("lanes_profiles", sw.sw_scores_stream_carry_lanes,
                      True))
    out = []
    for qlen, qlen_pad in ((200, 256), (500, 512)):
        qc, ql = (torch.from_numpy(a).to(dev) for a in sw.build_qcodes(
            seqs_of(rng, [qlen] * 16, 20), qlen_pad))
        for nseqs in (32, 128, 256, 512, 1024, 2048):
            db = torch.from_numpy(rng.integers(
                1, 21, size=(2048, nseqs)).astype(np.int8)).to(dev)
            start = torch.from_numpy((rng.random((2048 // sw.KSEG, nseqs))
                                      < 1 / 19).astype(np.int8)).to(dev)
            got, ms = [], {}
            for name, fn, prof in forms:
                st = sw.make_stream_state(16, qlen_pad, nseqs, dev)

                def call(fn=fn, prof=prof, st=st):
                    dp = sw.build_dprofile_series(m8, db) if prof else None
                    return fn(qc, ql, m8, db, start, *st, dprof=dp, **kw)

                got.append([x.clone() for x in call()])
                ms[name] = timed(call, reps=3)
            if not all(torch.equal(a, b) for r in got[1:]
                       for a, b in zip(got[0], r)):
                raise RuntimeError(f"K3's forms differ at 16 x {nseqs}, "
                                   f"{qlen} rows")
            out.append((16 * nseqs, qlen, ms, digest(got[0])))
    return out


# opcode classes counted in each kernel function's SASS
OPCODES = ("VIADDMNMX", "VIMNMX3", "SHFL.UP", "BAR", "LDS", "STS", "LDG",
           "STG", "ATOMG", "REDG")


def sass_stats(build):
    """{kernel function: (registers, SASS instructions, {opcode class:
    count})} of the built carry_rows, hint and segment libraries."""
    tool = build.cuda_tool("cuobjdump")
    out = {}
    for lib in ("carry_rows", "hint", "segment"):
        path = build.kernel_library(lib)
        res = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True).stdout
        regs = dict(re.findall(r"Function (\S+):\s*REG:(\d+)", res))
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True).stdout
        for part in sass.split("Function : ")[1:]:
            name = part.split()[0]
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", part)
            out[name] = (int(regs.get(name, -1)), len(ops),
                         {k: sum(o.startswith(k) for o in ops)
                          for k in OPCODES})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", default="K5,K4,K6,K3r,K3f,K8,K9,forms,sass",
                    help="comma-separated groups to run (default: all)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from swipe_tpu_torch import _build as build
    from swipe_tpu_torch import batching
    from swipe_tpu_torch.ops import sw_stream as sw
    if not torch.cuda.is_available():
        print("row_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = dict(tag=args.tag, root=args.root, card=card())
    build.build_kernels()

    def emit(**kw):
        print(json.dumps(dict(info, **kw)), flush=True)

    for name, qc, ql, mat, data, start, (Q, R) in tile_shapes(sw, batching,
                                                               dev) \
            if "K5" in only else ():
        kw = dict(gapopenextend=Q, gapextend=R, tile_rows=512)
        nq, L, n = qc.shape[0], data.shape[0], data.shape[1]
        planes = sw._tile_planes(nq, L, n, dev)
        sw.stream_tile_pass(qc, ql, 0, mat, data, start, *planes, **kw)
        dig = digest(planes)
        ms = timed(lambda: sw.stream_tile_pass(qc, ql, 0, mat, data, start,
                                               *planes, **kw))
        emit(kernel="K5", shape=name, ms=ms, digest=dig,
             dims=[nq, 512, L, n])

    for name, qc, ql, mat, db, starts, (Q, R) in hint_shapes(sw, dev) \
            if "K4" in only else ():
        kw = dict(gapopenextend=Q, gapextend=R)
        dig = digest(sw.sw_hint_stream(qc, ql, mat, db, starts, **kw))
        ms = timed(lambda: sw.sw_hint_stream(qc, ql, mat, db, starts, **kw))
        emit(kernel="K4", shape=name, ms=ms, digest=dig, dims=list(db.shape),
             rows=int(ql.max()))

    for kernel, name, fn, make, kw in carry_shapes(sw, dev):
        if kernel not in only:
            continue
        a = make()
        out = fn(*a, **kw)
        dig = digest([x for x in out if torch.is_tensor(x)])
        a = make()
        ms = timed(lambda: fn(*a, **kw))
        emit(kernel=kernel, shape=name, ms=ms, digest=dig)

    for kernel, name, fn, qpt, data, seg_ids, kw in segment_shapes(
            batching, dev) if only & {"K8", "K9"} else ():
        if kernel not in only:
            continue
        dig = digest([fn(qpt, data, seg_ids, **kw)])
        ms = timed(lambda: fn(qpt, data, seg_ids, **kw))
        emit(kernel=kernel, shape=name, ms=ms, digest=dig,
             dims=[*qpt.shape[:2], *data.shape], dtype=str(qpt.dtype))

    for name, *a in flow_shapes(sw, batching, dev) if "K3f" in only else ():
        ms, dig = time_flow(sw, *a)
        emit(kernel="K3", shape=name, digest=dig,
             dims=[*a[0].shape, *a[3].shape], **ms)

    for pairs, qlen, ms, dig in crossover(sw, dev) if "forms" in only \
            else ():
        emit(kernel="K3 forms", pairs=pairs, qlen=qlen, digest=dig, **ms)

    for name, (regs, n, ops) in sorted(sass_stats(build).items()) \
            if "sass" in only else ():
        emit(function=name, registers=regs, sass_instructions=n, **ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
