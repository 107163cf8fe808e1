"""Time the two forms of the carry kernel (K3) on one CUDA card.

    python3 scripts/carry_forms.py

Where the forms cross: 16 queries of 200 and of 500 residues (BLOSUM62,
gaps 11/1) against one chunk of 2,048 columns whose 32 to 2,048 lanes
all hold random records (a start bit every 19 blocks on average).  At
each shape it times the row form (sw_scores_stream_carry_rows), the
lane form without block profiles (sw_scores_stream_carry_lanes) and the
lane form with them (build_dprofile_series and the launch, as the flow
route runs it), and holds the three dumps and states equal.  Then the
row-form kernels at the main path's shapes: a K6 pass of the
long-genome search (2 queries of 1,542 nt at qlen_pad 2048, tile 0 of
512 rows, 32 lanes x 8,192 columns, one chromosome lane) and a K3
row-form chunk of the wide-genome search (16 queries of 500 nt at
qlen_pad 512, the int32 matrix of +100/-300, gaps 500/200) and of the
tblastn carry series (16 queries of 400 aa at qlen_pad 448, six frame
lanes).  Last, the DPX instructions in the built carry_rows library
(cuobjdump).  Prints one JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from swipe_tpu_torch import _build                     # noqa: E402
from swipe_tpu_torch.batching import PAD_SYMBOL        # noqa: E402
from swipe_tpu_torch.matrices import ScoreMatrix       # noqa: E402
from swipe_tpu_torch.ops import sw_stream as sw        # noqa: E402


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queries(rng, nq, qlen, qlen_pad, alphabet, dev):
    qs = [rng.integers(1, alphabet + 1, size=qlen, dtype=np.int8)
          for _ in range(nq)]
    return tuple(torch.from_numpy(a).to(dev)
                 for a in sw.build_qcodes(qs, qlen_pad))


def chunk(rng, L, nseqs, alphabet, dev, real_lanes=None, refill=0.0):
    """One chunk of a carry series: real_lanes lanes of random symbols
    (all by default), the rest PAD; a start bit at each block with
    probability refill."""
    real = nseqs if real_lanes is None else real_lanes
    db = np.full((L, nseqs), PAD_SYMBOL, np.int8)
    db[:, :real] = rng.integers(1, alphabet + 1, size=(L, real))
    start = (rng.random((L // sw.KSEG, nseqs)) < refill).astype(np.int8)
    return torch.from_numpy(db).to(dev), torch.from_numpy(start).to(dev)


def crossover(dev, rng, m8):
    rows = []
    kw = dict(gapopenextend=12, gapextend=1)
    for qlen, qlen_pad in ((200, 256), (500, 512)):
        qc, ql = queries(rng, 16, qlen, qlen_pad, 20, dev)
        for nseqs in (32, 128, 256, 512, 1024, 2048):
            db, start = chunk(rng, 2048, nseqs, 20, dev, refill=1 / 19)
            got, ms = [], {}
            for name, fn, prof in (
                    ("rows", sw.sw_scores_stream_carry_rows, False),
                    ("lanes", sw.sw_scores_stream_carry_lanes, False),
                    ("lanes_profiles", sw.sw_scores_stream_carry_lanes,
                     True)):
                st = sw.make_stream_state(16, qlen_pad, nseqs, dev)

                def call(fn=fn, prof=prof, st=st):
                    dp = sw.build_dprofile_series(m8, db) if prof else None
                    return fn(qc, ql, m8, db, start, *st, dprof=dp, **kw)

                got.append([x.clone() for x in call()])
                ms[name] = timed(call)
            if not all(torch.equal(a, b) for r in got[1:]
                       for a, b in zip(got[0], r)):
                raise RuntimeError(f"the forms differ at 16 x {nseqs}, "
                                   f"{qlen} rows")
            ms["dprofile"] = timed(lambda: sw.build_dprofile_series(m8, db))
            row = {"pairs": 16 * nseqs, "qlen": qlen, **ms}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main_path(dev, rng, m8):
    mn = torch.from_numpy(sw.build_matrix8(
        ScoreMatrix.nucleotide(1, -3, 5, 2).matrix)).to(dev)
    mw = torch.from_numpy(sw.build_matrix_wide(
        ScoreMatrix.nucleotide(100, -300, 500, 200).matrix)).to(dev)
    qc, ql = queries(rng, 2, 1542, 2048, 4, dev)
    db, start = chunk(rng, 8192, 32, 4, dev, real_lanes=1)
    h, e, s, bh0c = sw.make_stream_state_long(2, 2048, 32, 512, dev)
    bh, bf, out = sw._tile_planes(2, 8192, 32, dev)
    k6 = timed(lambda: sw.stream_tile_carry_pass(
        qc, ql, 0, mn, db, start, bh, bf, out, h, e, s, bh0c,
        gapopenextend=7, gapextend=2, tile_rows=512), reps=5)
    qc, ql = queries(rng, 16, 500, 512, 4, dev)
    st = sw.make_stream_state(16, 512, 32, dev)
    k3w = timed(lambda: sw.sw_scores_stream_carry_rows(
        qc, ql, mw, db, start, *st, gapopenextend=700, gapextend=200),
        reps=5)
    qc, ql = queries(rng, 16, 400, 448, 20, dev)
    db, start = chunk(rng, 8192, 32, 20, dev, real_lanes=6)
    st = sw.make_stream_state(16, 448, 32, dev)
    k3 = timed(lambda: sw.sw_scores_stream_carry_rows(
        qc, ql, m8, db, start, *st, gapopenextend=12, gapextend=1), reps=5)
    return {"k6_pass_ms": k6, "k3_rows_wide_ms": k3w, "k3_rows_int8_ms": k3}


def dpx_count() -> dict:
    tool = _build.cuda_tool("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass",
                           _build.kernel_library("carry_rows")],
                          capture_output=True, text=True).stdout
    return {k: sass.count(k) for k in ("VIADDMNMX", "VIMNMX3", "SHFL.UP")}


def main() -> int:
    if not torch.cuda.is_available():
        print("carry_forms: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    m8 = torch.from_numpy(sw.build_matrix8(
        ScoreMatrix.builtin("BLOSUM62", 11, 1).matrix)).to(dev)
    rng = np.random.default_rng(1)
    result = {"card": card, "crossover": crossover(dev, rng, m8),
              "main_path": main_path(dev, rng, m8), "sass": dpx_count()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
