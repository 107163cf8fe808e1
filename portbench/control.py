"""The control of the comparison that decides ``correct``, at a cell's own
size: the plain reference at SWIPE's first 8-bit precision (every cell
saturating at 127, with no rescoring pass), put in the program's place.
It has to read as not correct.

    python3 portbench/control.py --workload NAME --seeds N [N ...]

For each seed it makes the cell's inputs as a run does, draws the judged
queries as a run does from the stream's first ``--served`` queries, and
prints the comparison's numbers for the control.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from portbench import check, harness, workload  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--served", type=int, default=64)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    _, cell, config, traffic = harness.load_cell(args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        work = workload.build(config, traffic, seed)
        served = [i for idx in work.requests(int(traffic["batch"]))
                  for i in idx][:args.served]
        picked = harness.sample(seed, served, [len(q) for q in work.queries],
                                int(traffic["check"]))
        ref = check.Reference(config, work.corpus, "cuda")
        qs = [work.queries[i] for i in picked]
        sample = [(q, check.ControlList(ref, q, sc)) for q, sc in zip(
            qs, ref.scores(qs, check.ControlList.CEILING))]
        numbers = check.judge(ref, sample, aligned=False)
        limits = {k: config["check"][k] for k in numbers}
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "queries": [len(work.queries[i]) for i in picked],
                          "control": numbers, "limits": limits,
                          "correct": check.verdict(numbers, limits),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
