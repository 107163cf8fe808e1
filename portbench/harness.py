"""The port's benchmark: one cell of ``BENCHMARK.json`` per run.

A run makes the cell's database and request stream from ``--seed``,
builds ``swipe_tpu_torch``'s ``SearchEngine`` on the card as the CLI does,
warms every query-length bucket the stream uses, then serves requests in
a closed loop with one client (the CLI reading a query file ``--batch``
queries at a time): one ``SearchEngine.search_batch`` call, then
``Reporter.show`` of each query into a buffer, in the plain view.  The
window ends at the first request that completes after ``--seconds``.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
window under ``torch.profiler`` and prints its per-layer metrics, each
read by ``metrics/<name>.py``.  Either way the window's answers are then
judged against the plain reference (``check.py``) on a sample drawn from
the seed, after the program's state is freed.

Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``), database generators (``generators/``), search
modes (``modes/<SWIPE program>.py``, by the configuration's ``symtype``)
and per-layer metrics (``metrics/``) are found by name; adding one is
adding files.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "swipe_tpu")
SPAN_PREFIX = "portbench."


@dataclass
class Request:
    """One request of the window, on the host clock."""

    t0: float
    t1: float = 0.0
    queries: int = 0
    cells: int = 0              # query residues x strands x db residues
    prog_cells: float = 0.0     # the program's meter: speed x elapsed
    prog_scoring_s: float = 0.0
    align_s: float = 0.0
    report_s: float = 0.0
    failed: bool = False


@dataclass
class Run:
    """What a per-layer metric reads: the window's requests and, in a
    traced run, the device's timeline."""

    requests: list
    timeline: object = None


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) \
            if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, rehearse: bool):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    with open(os.path.join(HERE, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    if rehearse:
        over = config.get("rehearsal", {})
        config = deep_merge(config, {k: v for k, v in over.items()
                                     if k != "traffic"})
        traffic = deep_merge(traffic, over.get("traffic", {}))
        # a round fills at least one request
        traffic["pool"] = max(traffic["pool"], traffic["batch"])
    return spec, cell, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q of the
    values at or below it."""
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def end_to_end(reqs: list, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics: every request's cells over the window's
    seconds, the 90th percentile of request times, and the set-up."""
    return {"setup_s": setup_s,
            "gcups_wall": sum(r.cells for r in reqs) / window_s / 1e9,
            "query_s_p90": percentile([r.t1 - r.t0 for r in reqs], 0.9)}


def card_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()[0]
        limit = float(limit)
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": 0, "power_limit_w": limit}


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Spans:
    """Host-clock spans of the benchmark's own code; while tracing, each
    is also a ``record_function`` range of the trace."""

    def __init__(self, tracing: bool):
        self.tracing = tracing

    @contextlib.contextmanager
    def __call__(self, name: str, out: dict | None = None):
        import torch
        rf = torch.profiler.record_function(SPAN_PREFIX + name) \
            if self.tracing else contextlib.nullcontext()
        t = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if out is not None:
                    out[name] = out.get(name, 0.0) + time.perf_counter() - t


def meter_class(spans: Spans):
    """A ``SearchTimings`` whose scoring phase (begin to end_batch) is also
    a ``scoring`` span of the trace."""
    from swipe_tpu_torch.pipeline import SearchTimings

    class Meter(SearchTimings):
        _span = None

        def begin(self):
            self._span = spans("scoring")
            self._span.__enter__()
            super().begin()

        def end_batch(self, *a, **k):
            super().end_batch(*a, **k)
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None

    return Meter


class Server:
    """The served path: search_batch, then Reporter.show per query."""

    def __init__(self, engine, config, queries, cells, spans):
        self.engine = engine
        self.config = config
        self.queries = queries
        self.cells = cells
        self.spans = spans
        self.meter = meter_class(spans)
        self.symtype = config["symtype"]
        self.times: dict = {}
        orig = engine._align_phase

        def align_phase(*a, **k):
            with spans("align", self.times):
                return orig(*a, **k)

        engine._align_phase = align_phase

    def serve(self, idx: list[int], keep: dict | None = None) -> Request:
        from swipe_tpu_torch.report import Reporter
        sp = self.spans
        self.times = {}
        rec = Request(time.perf_counter(), queries=len(idx),
                      cells=sum(self.cells[i] for i in idx))
        qs = [self.queries[i] for i in idx]
        meter = self.meter()
        try:
            with sp("request"):
                with sp("search"):
                    hitlists = self.engine.search_batch(qs, meter)
                buf = io.StringIO()
                with sp("report", self.times):
                    for q, hl in zip(qs, hitlists):
                        Reporter(buf, 0, self.symtype,
                                 self.engine.matrix.matrix,
                                 query=q).show(hl, self.config["name"])
        except Exception as e:            # a failed request is counted
            print(f"request {idx} failed: {e!r}", file=sys.stderr)
            rec.failed = True
            hitlists = None
        rec.t1 = time.perf_counter()
        rec.prog_scoring_s = meter.elapsed
        rec.prog_cells = meter.speed * meter.elapsed
        rec.align_s = self.times.get("align", 0.0)
        rec.report_s = self.times.get("report", 0.0)
        if keep is not None and hitlists is not None:
            for i, hl in zip(idx, hitlists):
                keep[i] = ProgramList(hl)
        return rec


class Answer(NamedTuple):
    """What the judge reads of one returned hit."""

    seqno: int
    qstrand: int
    qframe: int
    dstrand: int
    dframe: int
    score: int
    alignment: str
    align_q_start: int
    align_d_start: int
    align_q_end: int
    align_d_end: int
    score_align: int


class ProgramList:
    """A hit list as the program returned it, copied into plain tuples so
    that the window keeps none of the program's objects alive."""

    def __init__(self, hl):
        self.hits = [Answer(h.seqno, h.qstrand, h.qframe, h.dstrand,
                            h.dframe, h.score, h.alignment,
                            h.align_q_start, h.align_d_start,
                            h.align_q_end, h.align_d_end, h.score_align)
                     for h in hl.hits]
        self.evalue = hl.evmodel.evalue


class GcClock:
    """The collector's passes and their seconds while it is entered."""

    def __init__(self):
        self.passes = [0, 0, 0]
        self.seconds = 0.0
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def __str__(self):
        return (f"gc passes {self.passes} by generation, "
                f"{self.seconds:.3f} s")


def split(reqs: list) -> str:
    """The window's seconds by phase, for the log."""
    sc = sum(r.prog_scoring_s for r in reqs)
    al = sum(r.align_s for r in reqs)
    rp = sum(r.report_s for r in reqs)
    tot = sum(r.t1 - r.t0 for r in reqs)
    return (f"scoring {sc:.3f} s, align {al:.3f} s, report {rp:.3f} s, "
            f"rest {tot - sc - al - rp:.3f} s")


@contextlib.contextmanager
def setup_steps(setup: dict):
    """Time the program's packing and uploads by shape while set-up runs
    (the window finds every pack built and on the card)."""
    from swipe_tpu_torch import pipeline
    from swipe_tpu_torch.ops import sw_stream

    def timed(fn, label):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                key = label(a, k)
                setup[key] = setup.get(key, 0.0) + time.perf_counter() - t
        return run

    pack, upload = pipeline.pack_stream, sw_stream.chunk_tensors
    pipeline.pack_stream = timed(pack, lambda a, k: "pack {}x{}".format(
        k.get("nseqs"), k.get("max_cols")))
    sw_stream.chunk_tensors = timed(upload, lambda a, k: "upload")
    try:
        yield
    finally:
        pipeline.pack_stream, sw_stream.chunk_tensors = pack, upload


def warm(server, stream, batch: int) -> None:
    """Serve one query of every row bucket that the stream's query rows
    (strands and frames, as the engine scores them) fall in, and one whole
    request where requests hold several: every pack and shape the window
    will use is built here."""
    engine = server.engine
    seen = set()
    for idx in stream:
        for i in idx:
            b = {engine.qlen_bucket(len(codes)) for _, _, codes in
                 engine.query_frames(server.queries[i])}
            if not b <= seen:
                seen |= b
                server.serve([i])
    if batch > 1:
        server.serve(stream[0])


def sample(seed: int, served: list[int], lengths: list[int], k: int):
    """The judged queries: the longest served, and k - 1 more drawn from
    the seed."""
    rng = np.random.default_rng([seed, 7])
    uniq = sorted(set(served))
    if not uniq:
        return []
    longest = max(uniq, key=lambda i: (lengths[i], -i))
    rest = [i for i in uniq if i != longest]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def set_up(args, config, traffic, mode, device, spans, setup: dict):
    """The cell's inputs, the database opened as the CLI opens a FASTA
    file, the engine, and every pack and kernel warmed.  Returns (the
    workload, the server, the request stream); ``setup`` gets the
    seconds of each step."""
    import torch
    from portbench import workload
    from swipe_tpu_torch import native
    from swipe_tpu_torch.io.db import FastaDatabase
    from swipe_tpu_torch.io.fasta import preprocess_query
    from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

    def step(name, t):
        setup[name] = time.perf_counter() - t

    if device.type == "cuda":
        from swipe_tpu_torch import _build
        t = time.perf_counter()
        _build.build_kernels()
        _build.native_library()
        step("kernels_build_or_load", t)
    t = time.perf_counter()
    work = workload.build(config, traffic, args.seed)
    step("data", t)
    native.tune_malloc()            # as the CLI's main does
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, config["name"] + ".fa")
        with open(path, "wb") as f:
            f.write(work.corpus.fasta())
        step("fasta_write", t)
        t = time.perf_counter()
        db = FastaDatabase(path, work.corpus.kind, title=config["name"])
    step("fasta_parse", t)
    symtype = config["symtype"]
    params = SearchParams(
        symtype=symtype, querystrands=config["strands"],
        matrixname=config.get("matrix", "BLOSUM62"),
        matchscore=config.get("match", 1),
        mismatchscore=config.get("mismatch", -3),
        gapopen=config["gapopen"], gapextend=config["gapextend"],
        descriptions=config["descriptions"],
        alignments=config["alignments"], minscore=config["minscore"],
        expect=config["expect"])
    queries = [preprocess_query(f"q{n}", q.decode(), symtype,
                                config["strands"])
               for n, q in enumerate(work.queries)]
    batch = int(traffic["batch"])
    stream = work.requests(batch)
    with setup_steps(setup):
        t = time.perf_counter()
        engine = SearchEngine(db, params,
                              device="cpu" if args.rehearse else None,
                              backend="stream")
        step("engine", t)
        cells = [mode.cells(q, config, work.corpus.residues)
                 for q in work.queries]
        server = Server(engine, config, queries, cells, spans)
        t = time.perf_counter()
        warm(server, stream, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step("warm", t)
    return work, server, stream


def window(server, stream, seconds: float, spans, device):
    """Serve the stream in a closed loop until the first request that
    completes after ``seconds``.  Returns (the requests, the hit lists
    served by query, the queries served in order, the window's
    seconds)."""
    import torch
    served: dict = {}
    order: list[int] = []
    reqs = []
    w0 = time.perf_counter()
    with spans("window"):
        while not reqs or reqs[-1].t1 < w0 + seconds:
            idx = stream[len(reqs) % len(stream)]
            reqs.append(server.serve(idx, served))
            if not reqs[-1].failed:
                order.extend(idx)
        if device.type == "cuda":
            torch.cuda.synchronize()
    return reqs, served, order, reqs[-1].t1 - w0


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, the kernels' plain "
                         "versions; prints no device metric")
    args = ap.parse_args(argv)
    spec, cell, config, traffic = load_cell(args.workload, args.rehearse)
    from portbench import check, timeline, workload
    mode = workload.load_mode(config)   # raises where modes/ has none

    import torch
    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)

    setup = {}
    if device.type == "cuda":
        t = time.perf_counter()
        torch.cuda.init()
        torch.zeros(1, device=device)
        setup["cuda_init"] = time.perf_counter() - t

    tracing = bool(args.trace)
    spans = Spans(tracing)
    work, server, stream = set_up(args, config, traffic, mode, device,
                                  spans, setup)
    prof = None
    if tracing:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        server.serve(stream[0])     # the profiler's own first-use cost
    setup_s = time.perf_counter() - t_start
    with GcClock() as gc_clock:
        reqs, served, order, window_s = window(server, stream, args.seconds,
                                               spans, device)
    tl = None
    if prof is not None:
        prof.stop()
        tl = timeline.from_profiler(prof)
        del prof
    dev = card_info(device)
    if device.type == "cuda":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(0))

    metrics = {}
    if tracing:
        run = Run(reqs, tl)
        for m in spec["per_layer"]:
            if applies(m, cell["name"]):
                v = workload.load_module("metrics", m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tl is not None and tl.ops:
            dev["busy_s"] = sum(e - s for s, e in tl.busy) / 1e9
            dev["window_s"] = tl.window_ns / 1e9
    else:
        e2e = end_to_end(reqs, window_s, setup_s)
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    # the judge, after the program's device state is freed
    failed = sum(r.failed for r in reqs)        # requests that raised
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = check.Reference(config, work.corpus, device)
    picked = sample(args.seed, order, [len(q) for q in work.queries],
                    int(traffic["check"]))
    numbers = check.judge(ref, [(work.queries[i], served[i])
                                for i in picked])
    numbers["requests_failed"] = failed
    limits = {k: config["check"][k] for k in numbers}

    print(f"{cell['name']} seed {args.seed}: setup {json.dumps(setup)}, "
          f"{len(reqs)} requests in {window_s:.3f} s ({split(reqs)}; "
          f"{gc_clock}), check "
          f"{time.perf_counter() - t:.1f} s on queries {picked} of lengths "
          f"{[len(work.queries[i]) for i in picked]} "
          f"[{dev['kind']}, {dev.get('power_limit_w')} W]", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in numbers.items():
        print(f"check {name} {v!r} limit {limits[name]!r}", file=sys.stderr)
    result = {"correct": check.verdict(numbers, limits),
              "attempted": sum(r.queries for r in reqs),
              "failed": sum(r.queries for r in reqs if r.failed),
              "metrics": metrics, "device": dev}
    if tl is not None and tl.ops:
        result["breakdown"] = {"device_ops": tl.top_ops(10),
                               "idle_gaps": tl.idle_by_span(10)}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    print(json.dumps(result), flush=True)
    return 0
