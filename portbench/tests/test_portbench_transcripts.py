"""The blastx configuration over Swiss-Prot: its generator (transcripts whose
one true frame, between the UTRs, encodes the planted protein with no
stop in frame; lengths in the traffic's range and the same for every
seed; both orientations), a rehearsal of ``swissprot-blastx.cdna`` on the
CPU that reads correct, and ``slots_per_pass`` on a synthetic run."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from portbench import harness, program_spans, timeline, workload
from portbench.generators import transcripts
from portbench.reference import translate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "swissprot-blastx.cdna"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_portbench_program_metrics import MS, Ring  # noqa: E402


def config() -> dict:
    """The cell's configuration over a tenth of Swiss-Prot's records,
    which still holds several records of every protein length the
    transcripts take."""
    with open(os.path.join(HERE, "configs", "swissprot-blastx.json")) as f:
        c = json.load(f)
    return harness.deep_merge(c, {"database": {"sequences": 57000}})


def traffic() -> dict:
    with open(os.path.join(HERE, "traffic", "cdna.json")) as f:
        return {**json.load(f), "rounds": 2}


@pytest.fixture(scope="module")
def made():
    """(configuration, corpus, [(transcript, protein, minus)]) of one
    seed."""
    c, t = config(), traffic()
    rng = np.random.default_rng(2**31 + 555)
    corpus = transcripts.build(c["database"], rng)
    pool = transcripts.query_lengths(c, *t["length"], t["pool"])
    rounds = [pool[rng.permutation(len(pool))] for _ in range(t["rounds"])]
    return c, corpus, transcripts.transcripts(corpus, c, rounds, rng)


def test_the_true_frame_encodes_the_protein(made):
    c, _, got = made
    utr5 = c["queries"]["utr5"]
    for t, protein, minus in got:
        t = np.frombuffer(t, np.uint8)
        aa = translate.translate(t, int(minus), utr5 % 3)
        first = utr5 // 3
        cds = aa[first:first + len(protein) + 1]
        assert cds[:-1].tobytes() == protein and cds[-1] == ord("*")
        assert ord("*") not in cds[:-1]
        assert len(t) == utr5 + 3 * len(protein) + 3 + c["queries"]["utr3"]


def test_the_protein_is_a_mutated_record(made):
    _, corpus, got = made
    # protein_corpus plants two mutated copies of each protein at the
    # start of longer records: each keeps about 0.8 * 0.8 of its residues
    for _, protein, _ in got[:4]:
        p = np.frombuffer(protein, np.uint8)
        same = [(corpus.record(i)[:len(p)] == p).mean()
                for i in np.flatnonzero(corpus.lens >= len(p))]
        assert sorted(same)[-2] > 0.5


def test_both_orientations_occur(made):
    minus = [m for _, _, m in made[2]]
    assert 0 < sum(minus) < len(minus)


def test_lengths_in_range_and_the_same_for_every_seed():
    c, t = config(), traffic()
    a = workload.build(c, t, 3)
    b = workload.build(c, t, 2**31 + 77)
    la = sorted(map(len, a.queries))
    assert la == sorted(map(len, b.queries))
    assert la == sorted(transcripts.query_lengths(
        c, *t["length"], t["pool"]).tolist() * t["rounds"])
    assert 3100 <= la[0] and la[-1] <= 4600
    # every frame of every transcript takes the long route (over 1,024
    # rows) in one slot group of 1,536 rows
    assert 1024 < (la[0] - 2) // 3 and la[-1] // 3 <= 1536
    assert a.queries != b.queries
    assert a.queries == workload.build(c, t, 3).queries


def test_no_transcript_fits_a_range_shorter_than_its_flanks():
    with pytest.raises(ValueError, match="holds a protein"):
        transcripts.query_lengths(config(), 100, 1000, 4)


def test_rehearsal_reads_correct(capsys):
    torch.set_num_threads(2)
    rc = harness.main(["--workload", CELL, "--seed", str(2**31 + 4321),
                       "--seconds", "0.1", "--trace", "0", "--rehearse"])
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"], cap.err
    assert res["failed"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values()), res


def test_slots_per_pass_reads_the_counters(monkeypatch):
    """A request before the window (100-160 ms) and two inside it: a
    blastx query's six frames in passes of four and two on the long
    route, then a pass of 5 slots on the plain pack."""
    ring = Ring()
    ring.add("search", 80, 95, queries=1, counts={
        "scoring.passes.stream": 1, "scoring.slots.stream": 16})
    ring.add("search", 110, 130, queries=1, counts={
        "scoring.passes.long": 2, "scoring.slots.long": 6})
    ring.add("search", 135, 150, queries=1, counts={
        "scoring.passes.stream": 1, "scoring.slots.stream": 5,
        "h2d_bytes": 10})
    tl = timeline.Timeline((100 * MS, 160 * MS), [], {})
    run = harness.Run([harness.Request(0, 1, queries=1),
                       harness.Request(1, 2, queries=1)], tl)
    read = workload.load_module("metrics", "slots_per_pass").read
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans[:2], 0))
    assert read(run) == 3.0
    monkeypatch.setattr(program_spans, "ring", lambda: (ring.spans, 0))
    assert read(run) == pytest.approx(11 / 3)
    # nothing to read: no trace, no ring, or a program without the
    # counters (an older checkout)
    assert read(harness.Run(run.requests)) is None
    monkeypatch.setattr(program_spans, "ring", lambda: None)
    assert read(run) is None
    bare = Ring()
    bare.add("search", 120, 130, counts={"h2d_bytes": 5}, queries=1)
    monkeypatch.setattr(program_spans, "ring", lambda: (bare.spans, 0))
    assert read(run) is None
