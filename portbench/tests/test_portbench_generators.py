"""The generators repeat from the seed, give every seed the same sizes,
and keep bench_corpus.py's Swiss-Prot model."""

import ast
import json
import os

import numpy as np
import pytest

from portbench import workload
from portbench.generators import genome, protein_corpus

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name, **over):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    reh = c["rehearsal"]
    c = {**c, "database": {**c["database"], **reh["database"]},
         "queries": {**c["queries"], **reh.get("queries", {})}}
    return c


TRAFFIC = {"batch": 1, "length": [1, 90], "pool": 4, "rounds": 3,
           "check": 2}


@pytest.mark.parametrize("name", ["swissprot-blastp", "ecoli-k12-blastn"])
def test_same_seed_same_inputs(name):
    a = workload.build(config(name), TRAFFIC, 2**33 + 5)
    b = workload.build(config(name), TRAFFIC, 2**33 + 5)
    c = workload.build(config(name), TRAFFIC, 11)
    assert a.corpus.fasta() == b.corpus.fasta()
    assert a.queries == b.queries
    assert a.corpus.fasta() != c.corpus.fasta()


@pytest.mark.parametrize("name", ["swissprot-blastp", "ecoli-k12-blastn"])
def test_every_seed_gets_the_same_sizes(name):
    a = workload.build(config(name), TRAFFIC, 3)
    b = workload.build(config(name), TRAFFIC, 4)
    assert sorted(a.corpus.lens) == sorted(b.corpus.lens)
    assert sorted(map(len, a.queries)) == sorted(map(len, b.queries))
    # each round holds the pool's lengths
    n = TRAFFIC["pool"]
    rounds = [sorted(map(len, a.queries[i:i + n]))
              for i in range(0, len(a.queries), n)]
    assert all(r == rounds[0] for r in rounds)


def bench_corpus_constants():
    """bench_corpus.py's module-level constants, read without importing it
    (it imports the JAX package's alphabet)."""
    tree = ast.parse(open(os.path.join(os.path.dirname(HERE),
                                       "bench_corpus.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = value
                elif isinstance(t, ast.Tuple):
                    out.update(zip((e.id for e in t.elts), value))
    return out


def test_protein_model_is_bench_corpus():
    bc = bench_corpus_constants()
    with open(os.path.join(HERE, "configs", "swissprot-blastp.json")) as f:
        db = json.load(f)["database"]
    m = db["length_model"]
    assert (m["mu"], m["sigma"], m["min"], m["max"]) == (
        bc["LEN_MU"], bc["LEN_SIGMA"], bc["LEN_MIN"], bc["LEN_MAX"])
    assert db["composition"] == bc["SWISSPROT_AA_PERCENT"]
    # the quantile lengths have the published median and mean
    lens = protein_corpus.lengths(db, 570_000)
    # the release's longest record takes the last quantile's place
    assert lens[-1] == db["longest"] == bc["LEN_MAX"]
    assert lens[-2] < 7000
    assert abs(np.median(lens) - 292) <= 1
    assert abs(lens.mean() - 360.5) < 2
    assert abs(int(lens.sum()) - 205.7e6) < 1e6


def test_composition_table():
    comp = {"A": 8.25, "C": 1.38, "W": 1.08}
    lut = workload.letters_lut(comp)
    assert len(lut) == 1 << 16
    share = {c: np.count_nonzero(lut == ord(c)) / len(lut) for c in comp}
    tot = sum(comp.values())
    for c, p in comp.items():
        assert abs(share[c] - p / tot) <= 1 / (1 << 16)


def test_queries_copy_and_plant():
    c = config("swissprot-blastp")
    w = workload.build(c, TRAFFIC, 8)
    corpus = w.corpus
    for q in w.queries:
        qa = np.frombuffer(q, np.uint8)
        # the source record and the planted copies share about 80% (64%
        # for copies of the mutated query) of their residues with it
        same = [np.mean(corpus.record(i)[:len(qa)] == qa)
                for i in range(len(corpus.lens))
                if corpus.lens[i] >= len(qa)]
        assert sum(s > 0.5 for s in same) >= 1 + c["queries"]["plants"]


def test_genome_windows():
    c = config("ecoli-k12-blastn")
    w = workload.build(c, TRAFFIC, 9)
    chrom = w.corpus.record(0).tobytes()
    assert len(chrom) == c["database"]["chromosome_bp"]
    gc = (chrom.count(b"G") + chrom.count(b"C")) / len(chrom)
    assert abs(gc - c["database"]["gc"]) < 0.01
    assert {len(q) for q in w.queries} <= set(c["queries"]["lengths"])
    assert all(set(q) <= set(b"ACGT") for q in w.queries)
    for i in range(1, len(w.corpus.lens)):
        g = w.corpus.record(i).tobytes()
        assert g in chrom or genome.revcomp(
            np.frombuffer(g, np.uint8)).tobytes() in chrom


def test_genome_query_lengths_are_the_mlst_loci():
    with open(os.path.join(HERE, "configs", "ecoli-k12-blastn.json")) as f:
        c = json.load(f)
    loci = sorted(c["queries"]["lengths"])
    assert loci == [452, 460, 469, 478, 510, 518, 536]
    got = genome.query_lengths(c, 1, 1024, 64)
    assert len(got) == 64 and set(got.tolist()) == set(loci)
    # each locus in turn: no length is drawn more than once beyond another
    counts = [int((got == L).sum()) for L in loci]
    assert max(counts) - min(counts) <= 1
    assert genome.query_lengths(c, 460, 470, 4).tolist() == [460, 469] * 2
    with pytest.raises(ValueError):
        genome.query_lengths(c, 1, 100, 4)
