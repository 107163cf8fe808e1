"""The tblastn configuration over E. coli K-12's genome: its generator
(ORFs with no stop in frame, proteins for queries, the same lengths for
every seed, the published coverage and GC share), a rehearsal of
``ecoli-k12-tblastn.single`` on the CPU that reads correct and one whose
answer has a changed reading frame that does not, and the cell's three
per-layer metrics on a synthetic run."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from portbench import harness, program_spans, timeline, workload
from portbench.generators import coding_genome
from portbench.reference import translate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ecoli-k12-tblastn.single"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_portbench_program_metrics import MS, Ring  # noqa: E402


def config(rehearsal: bool) -> dict:
    with open(os.path.join(HERE, "configs", "ecoli-k12-tblastn.json")) as f:
        c = json.load(f)
    if rehearsal:
        c = harness.deep_merge(c, {"database": c["rehearsal"]["database"]})
    return c


TRAFFIC = {"batch": 1, "length": [1, 1024], "pool": 16, "rounds": 2,
           "check": 2}


@pytest.fixture(scope="module")
def genome():
    """The full-size chromosome of one seed, and its queries."""
    return workload.build(config(False), TRAFFIC, 2**31 + 1234)


def test_orfs_hold_no_stop_in_frame(genome):
    corpus = genome.corpus
    assert len(corpus.orfs) == 4288
    chrom = corpus.record(0)
    for i, (start, L, st) in enumerate(corpus.orfs.tolist()):
        aa = translate.translate(chrom[start:start + 3 * L + 3], st, 0)
        assert len(aa) == L + 1 and aa[0] == ord("M"), i
        assert aa[-1] == ord("*") and ord("*") not in aa[:-1], i


def test_coverage_and_gc_are_the_sources(genome):
    c = config(False)["database"]
    corpus = genome.corpus
    assert corpus.lens.tolist() == [4641652]
    coding = int((3 * corpus.orfs[:, 1] + 3).sum())
    assert abs(coding / 4641652 - 0.878) < 0.01
    # ORFs lie end to end, none overlapping another
    starts = np.sort(corpus.orfs[:, 0])
    ends = starts + 3 * corpus.orfs[np.argsort(corpus.orfs[:, 0]), 1] + 3
    assert (starts[1:] >= ends[:-1]).all() and ends[-1] <= 4641652
    gc = np.isin(corpus.record(0), np.frombuffer(b"GC", np.uint8)).mean()
    assert abs(gc - c["gc"]) < 0.005
    assert 0.4 < corpus.orfs[:, 2].mean() < 0.6         # either strand


def test_queries_are_proteins_with_a_true_frame(genome):
    assert sorted(map(len, genome.queries)) == sorted(
        coding_genome.query_lengths(config(False), 1, 1024, 16).tolist() * 2)
    for q in genome.queries:
        assert b"*" not in q and set(q) <= set(b"ACDEFGHIKLMNPQRSTVWY")
    # each query is a window of an ORF's protein, 20% redrawn: its best
    # ungapped match to the ORFs' proteins keeps most residues
    prots = [coding_genome.orf_protein(genome.corpus, i).tobytes()
             for i in range(len(genome.corpus.orfs))]
    q = genome.queries[0]
    best = max(sum(a == b for a, b in zip(q, p[s:s + len(q)]))
               for p in prots if len(p) >= len(q)
               for s in range(len(p) - len(q) + 1))
    assert best >= 0.7 * len(q)


def test_every_seed_gets_the_same_lengths():
    c = config(True)
    a = workload.build(c, TRAFFIC, 3)
    b = workload.build(c, TRAFFIC, 2**31 + 77)
    assert sorted(a.corpus.orfs[:, 1]) == sorted(b.corpus.orfs[:, 1])
    assert sorted(map(len, a.queries)) == sorted(map(len, b.queries))
    assert a.corpus.fasta() != b.corpus.fasta()
    again = workload.build(c, TRAFFIC, 3)
    assert a.corpus.fasta() == again.corpus.fasta()
    assert a.queries == again.queries


def test_a_coverage_off_the_source_is_refused():
    db = {**config(True)["database"], "coding_share": 0.7}
    with pytest.raises(ValueError, match="cover"):
        coding_genome.build(db, np.random.default_rng(1))


def rehearse(capsys, seed):
    torch.set_num_threads(2)
    rc = harness.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", "0.1", "--trace", "0", "--rehearse"])
    cap = capsys.readouterr()
    return rc, json.loads(cap.out.strip().splitlines()[-1]), cap.err


def test_rehearsal_reads_correct(capsys):
    rc, res, err = rehearse(capsys, 2**31 + 4321)
    assert rc == 0 and res["correct"], err
    assert res["failed"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values()), res


def test_a_changed_frame_reads_not_correct(capsys, monkeypatch):
    from swipe_tpu_torch.hits import HitList
    orig = HitList.finalize

    def finalize(self):
        orig(self)
        if self.hits:
            h = self.hits[0]
            h.dframe = (h.dframe + 1) % 3

    monkeypatch.setattr(HitList, "finalize", finalize)
    rc, res, err = rehearse(capsys, 2**31 + 4323)
    assert rc == 0 and not res["correct"], err
    checks = res["checks"]
    assert checks["lists_wrong"]["value"] >= 1, checks


# ---- the cell's per-layer metrics on a synthetic run ----------------------

K7 = "void (anonymous namespace)::wavefront_kernel(signed char const*)"


def reader(name):
    return workload.load_module("metrics", name).read


def synthetic():
    """A request before the window (100-160 ms) and two inside it: pieces
    2 ms and wavefront 6 + 6 ms, translations 3 + 1 ms."""
    ring = Ring()
    ring.add("db.translate", 0, 10)                     # set-up
    with ring("search", 85, 99, counts={"giant.cells.wavefront": 5 * 10**9},
              queries=1):
        ring.add("giant.wavefront", 86, 95)
        ring.add("db.translate", 96, 98)
    with ring("search", 110, 130, queries=1, counts={
            "giant.cells.pieces": 6 * 10**9,
            "giant.cells.wavefront": 3 * 10**9}):
        ring.add("giant.pieces", 111, 113)
        ring.add("giant.wavefront", 113, 119)
        with ring("align", 119, 129):
            with ring("align.fetch", 119, 125):
                ring.add("db.translate", 120, 121)
                ring.add("db.translate", 122, 124)
    with ring("search", 135, 150, queries=1,
              counts={"giant.cells.wavefront": 3 * 10**9}):
        ring.add("giant.wavefront", 136, 142)
        ring.add("db.translate", 143, 144)
    ops = [("K2", 111 * MS, 112 * MS), (K7, 90 * MS, 94 * MS),
           (K7, 114 * MS, 118 * MS), (K7, 141.5 * MS, 142.5 * MS),
           (K7, 150 * MS, 151 * MS)]
    tl = timeline.Timeline((100 * MS, 160 * MS), ops, {})
    run = harness.Run([harness.Request(0, 1, queries=1),
                       harness.Request(1, 2, queries=1)], tl)
    return ring, run


NEW = ("giant_gcups", "wavefront_roofline", "translate_ms")


def test_new_metrics_read_the_known_values(monkeypatch):
    ring, run = synthetic()
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    # 12e9 cells in 14 ms of giant spans
    assert reader("giant_gcups")(run) == pytest.approx(12e9 / 14e-3 / 1e9)
    # 6e9 wavefront cells at 3 instructions over 33.5e12 a second, over
    # K7's 4 + 1 ms that overlap the window's wavefront spans (the one
    # that runs past its span counted whole, the one outside left out)
    assert reader("wavefront_roofline")(run) == pytest.approx(
        100 * 6e9 * 3 / 33.5e12 / 5e-3)
    # 3 + 1 ms of translation over two queries
    assert reader("translate_ms")(run) == pytest.approx(2.0)


def test_new_metrics_read_nothing_where_there_is_nothing(monkeypatch):
    ring, run = synthetic()
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    assert all(reader(n)(harness.Run(run.requests)) is None for n in NEW)
    monkeypatch.setattr(program_spans, "ring", lambda: None)
    assert all(reader(n)(run) is None for n in NEW)
    # a program with no giant or translate span or counter (a blastp
    # search, or an older checkout)
    bare = Ring()
    bare.add("search", 120, 130, counts={"h2d_bytes": 5}, queries=1)
    monkeypatch.setattr(program_spans, "ring", lambda: (bare.spans, 0))
    assert all(reader(n)(run) is None for n in NEW)
    # wavefront spans but no K7 on the device trace
    ring, run = synthetic()
    run.timeline.ops[:] = [op for op in run.timeline.ops if op[0] != K7]
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    assert reader("wavefront_roofline")(run) is None
