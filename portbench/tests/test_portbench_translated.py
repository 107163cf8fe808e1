"""The translated modes (blastx, tblastn, tblastx): the reference's own
translation, the mode modules' arithmetic against the port's, and each
mode end to end on the CPU (``--rehearse``) as a toy cell of new files
only, in a copy of the benchmark's folder: the port's answers read as
correct, and an answer whose reading frame is changed does not."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import harness, workload
from portbench.reference import search, translate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# nucleotide queries that encode pieces of the protein records, in a
# frame and on a strand drawn from the seed
BACKTRANSLATED = '''"""Test only: the protein corpus, and blastx queries that
encode pieces of its records."""

import numpy as np

from portbench.generators import protein_corpus
from portbench.generators.genome import revcomp
from portbench.reference.translate import CODE1

build = protein_corpus.build
_CODONS = {}
for _i, _aa in enumerate(CODE1):
    _CODONS.setdefault(_aa, []).append(
        "TCAG"[_i // 16] + "TCAG"[_i // 4 % 4] + "TCAG"[_i % 4])


def query_lengths(config, lo, hi, pool):
    return np.linspace(lo, hi, pool).astype(np.int64)


def queries(corpus, config, rounds, rng):
    out = []
    for targets in rounds:
        for L in targets.tolist():
            rec = corpus.record(int(rng.integers(0, len(corpus.lens))))
            n = min(L // 3, len(rec))
            s = int(rng.integers(0, len(rec) - n + 1))
            nt = "".join(rng.choice(_CODONS[chr(a)])
                         for a in rec[s:s + n].tolist())
            q = np.frombuffer(("ACG"[:int(rng.integers(0, 3))] + nt)
                              .encode(), np.uint8).copy()
            pos = np.flatnonzero(rng.random(len(q)) < 0.03)
            q[pos] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, size=len(pos))]
            out.append((revcomp(q) if rng.integers(0, 2) else q).tobytes())
    return out
'''

# protein queries translated from the genome's genes in a frame drawn
# from the seed
GENES = '''"""Test only: the genome, and tblastn queries translated from its
genes."""

import numpy as np

from portbench.generators import genome
from portbench.reference.translate import translate

build = genome.build

_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def query_lengths(config, lo, hi, pool):
    return np.linspace(lo, hi, pool).astype(np.int64)


def queries(corpus, config, rounds, rng):
    out = []
    for targets in rounds:
        for L in targets.tolist():
            gene = corpus.record(int(rng.integers(1, len(corpus.lens))))
            aa = translate(gene, int(rng.integers(0, 2)),
                           int(rng.integers(0, 3)))
            n = min(L, len(aa))
            s = int(rng.integers(0, len(aa) - n + 1))
            q = aa[s:s + n].copy()
            pos = np.flatnonzero((rng.random(n) < 0.1) | (q == ord("*")))
            q[pos] = _AA[rng.integers(0, len(_AA), size=len(pos))]
            out.append(q.tobytes())
    return out
'''

GENOME = {"generator": "genome", "chromosome_bp": 1500, "gc": 0.508,
          "genes": 8, "gene_length": [120, 300]}
BLOSUM62_GAPPED = {"lambda": 0.267, "K": 0.041, "H": 0.14, "alpha": 1.9,
                   "beta": -30.0}
# tblastx reads the matrix's ungapped row (stats.py, hits.cc:283-511)
BLOSUM62_UNGAPPED = {"lambda": 0.3176, "K": 0.134, "H": 0.4012,
                     "alpha": 0.7916, "beta": -3.2}

# name: (base configuration, changes, traffic lengths, generator source)
TOYS = {
    "blastx": ("swissprot-blastp", {
        "symtype": 2, "strands": 3,
        "database": {"generator": "toy_backtranslated", "sequences": 150,
                     "longest": 100, "length_model": {
                         "mu": 3.7, "sigma": 0.3, "min": 20, "max": 80}}},
        [45, 150], BACKTRANSLATED),
    "tblastn": ("ecoli-k12-blastn", {
        "symtype": 3, "matrix": "BLOSUM62", "gapopen": 11, "gapextend": 1,
        "statistics": BLOSUM62_GAPPED,
        "database": {**GENOME, "generator": "toy_genes"}},
        [20, 60], GENES),
    "tblastx": ("ecoli-k12-blastn", {
        "symtype": 4, "strands": 3, "matrix": "BLOSUM62", "gapopen": 11,
        "gapextend": 1, "statistics": BLOSUM62_UNGAPPED, "database": GENOME,
        "queries": {"lengths": [48, 60, 72, 90], "substitution": 0.03}},
        [48, 90], None),
}


def toy_cell(tmp_path, monkeypatch, program: str) -> str:
    """A copy of the folder with the toy cell ``toy-<program>.toy`` of new
    files only; returns its name."""
    base, over, lengths, gen = TOYS[program]
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(HERE, "configs", base + ".json")) as f:
        c = json.load(f)
    c = harness.deep_merge(c, {**over, "name": f"toy-{program}"})
    del c["rehearsal"]
    (pb / "configs" / f"toy-{program}.json").write_text(json.dumps(c))
    if gen is not None:
        (pb / "generators" / (c["database"]["generator"] + ".py")) \
            .write_text(gen)
    (pb / "traffic" / "toy.json").write_text(json.dumps(
        {"batch": 4, "length": lengths, "pool": 4, "rounds": 1,
         "check": 4}))
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = f"toy-{program}.toy"
    spec["workloads"].append({"name": cell, "config": c["name"],
                              "traffic": "toy", "chips": 1, "why": "a toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "HERE", str(pb))
    monkeypatch.setattr(workload, "HERE", str(pb))
    torch.set_num_threads(2)
    return cell


def run(capsys, cell, seed):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.1", "--trace", "0", "--rehearse"])
    cap = capsys.readouterr()
    return rc, json.loads(cap.out.strip().splitlines()[-1]), cap.err


@pytest.mark.parametrize("program", sorted(TOYS))
def test_translated_toy_reads_correct(tmp_path, monkeypatch, capsys,
                                      program):
    cell = toy_cell(tmp_path, monkeypatch, program)
    rc, res, err = run(capsys, cell, 2**31 + 41)
    assert rc == 0 and res["correct"], err
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values()), res


# the frame of the first hit that each mode's fault moves
CHANGED_FRAME = {"blastx": "qframe", "tblastn": "dframe",
                 "tblastx": "dframe"}


@pytest.mark.parametrize("program", sorted(TOYS))
def test_a_changed_frame_is_not_correct(tmp_path, monkeypatch, capsys,
                                        program):
    from swipe_tpu_torch.hits import HitList
    cell = toy_cell(tmp_path, monkeypatch, program)
    orig = HitList.finalize
    field = CHANGED_FRAME[program]

    def finalize(self):
        orig(self)
        if self.hits:
            h = self.hits[0]
            setattr(h, field, (getattr(h, field) + 1) % 3)

    monkeypatch.setattr(HitList, "finalize", finalize)
    rc, res, err = run(capsys, cell, 2**31 + 43)
    assert rc == 0 and not res["correct"], err
    checks = res["checks"]
    assert checks["lists_wrong"]["value"] \
        + checks["alignments_wrong"]["value"] >= 1, checks


def test_a_genetic_code_other_than_1_is_refused(tmp_path, monkeypatch,
                                                capsys):
    cell = toy_cell(tmp_path, monkeypatch, "tblastn")
    path = os.path.join(harness.HERE, "configs", "toy-tblastn.json")
    with open(path) as f:
        c = json.load(f)
    c["db_gencode"] = 11
    with open(path, "w") as f:
        json.dump(c, f)
    with pytest.raises(ValueError, match="db_gencode 11"):
        harness.main(["--workload", cell, "--seed", "1", "--seconds", "0.1",
                      "--rehearse"])
    assert capsys.readouterr().out == ""


def aa(letters: str, strand: int, frame: int) -> str:
    return translate.translate(np.frombuffer(letters.encode(), np.uint8),
                               strand, frame).tobytes().decode()


def test_translate_by_hand():
    # ATG GCC TAA on the plus strand; its reverse complement TTAGGCCAT
    assert [aa("ATGGCCTAA", 0, f) for f in range(3)] == ["MA*", "WP", "GL"]
    assert [aa("ATGGCCTAA", 1, f) for f in range(3)] == ["LGH", "*A", "RP"]
    assert aa("atggcctaa", 0, 0) == "MA*"
    assert aa("AT", 0, 0) == aa("ATG", 0, 1) == ""
    # an ambiguous base: one amino acid where every codon agrees, B over
    # D and N, Z over Q and E, a stop where both are stops, else X
    assert aa("GCNGAYRATSAATARNNNANNTGN", 0, 0) == "ADBZ*XXX"
    assert aa("NNNGCC", 1, 0) == "GX"


def test_translate_matches_the_port():
    from swipe_tpu_torch import alphabet
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"ACGTACGTACGTMRWSYKVHDBNU", np.uint8)
    for n in rng.integers(0, 40, size=60).tolist():
        seq = letters[rng.integers(0, len(letters), size=n)]
        codes = alphabet.encode(seq.tobytes(), alphabet.MAP_NCBI_NT16)
        for s in (0, 1):
            for f in range(3):
                port = alphabet.decode(alphabet.translate(codes, s, f, 1),
                                       alphabet.SYM_NCBI_AA)
                assert aa(seq.tobytes().decode(), s, f) == port


def test_keys_sort_as_the_port_breaks_ties():
    frames = [(qs, qf, ds, df) for qs in (0, 1) for qf in range(3)
              for ds in (0, 1) for df in range(3)]
    keys = [translate.key(*f) for f in frames]
    assert keys == sorted(keys) == list(range(36))
    assert [translate.unkey(k) for k in keys] == frames
    assert translate.key(1, 2, 0, 0) + translate.key(0, 0, 1, 1) \
        == translate.key(1, 2, 1, 1)


@pytest.mark.parametrize("symtype", [2, 3, 4])
@pytest.mark.parametrize("strands", [1, 2, 3])
def test_cells_and_statistics_are_the_ports(symtype, strands):
    """``cells`` is SWIPE's GCUPS count as the port's meter counts it, and
    ``stat_lengths`` give the port's search space."""
    from swipe_tpu_torch.io.fasta import preprocess_query
    from swipe_tpu_torch.pipeline import SearchTimings
    from swipe_tpu_torch.stats import EvalueModel
    mode = workload.load_mode({"name": "t", "symtype": symtype})
    config = {"strands": strands}
    q = b"ACGTTGCAAGCTTGCAGGATCCAATG" if symtype != 3 else b"MKVLATGGHW"
    corpus = workload.Corpus(np.zeros(0, np.uint8), np.zeros(3, np.int64),
                             np.array([300_000, 200_000, 91_001]), [], "nt")
    port_q = preprocess_query("q", q.decode(), symtype, strands)
    assert mode.cells(q, config, corpus.residues) == corpus.residues \
        * SearchTimings._work_multiplier(port_q, symtype, strands)
    stats = BLOSUM62_UNGAPPED if symtype == 4 else BLOSUM62_GAPPED
    ref = search.Statistics(stats, *mode.stat_lengths(q, corpus))
    port = EvalueModel(symtype, port_q.length, 3, corpus.residues,
                       matrixname="BLOSUM62", gapopen=11, gapextend=1)
    assert ref.kmn == pytest.approx(port.Kmn, rel=1e-15)
