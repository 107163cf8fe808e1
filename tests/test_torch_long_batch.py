"""Batches with long slots end to end on the CPU against the JAX engine on
its stream backend (interpret mode): blastn with short queries beside
three over 1024 nucleotides (six long slots on both strands, slot groups
of SLOT_BATCH_LONG = 4 and a power-of-two tail of 2), and blastx with a
transcript whose six frames pass 1024 residues.  Hit lists, totalhits,
obvious and the cascade counters must be equal."""

import numpy as np
import pytest
import torch
from test_torch_giants import AA, NT, run_both
from test_torch_long_engine import _fasta, _records, routes  # noqa: F401

# one codon of each amino acid (the standard code)
CODON = {"A": "GCT", "R": "CGT", "N": "AAT", "D": "GAT", "C": "TGT",
         "Q": "CAA", "E": "GAA", "G": "GGT", "H": "CAT", "I": "ATT",
         "L": "CTG", "K": "AAA", "M": "ATG", "F": "TTT", "P": "CCG",
         "S": "TCT", "T": "ACC", "W": "TGG", "Y": "TAT", "V": "GTT"}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _revcomp(s):
    return "".join(COMP[c] for c in reversed(s))


def test_blastn_batch_long_slots_split_in_fours(routes):
    rng = np.random.default_rng(51)
    shorts = ["".join(rng.choice(list(NT), n)) for n in (60, 90)]
    longs = ["".join(rng.choice(list(NT), n)) for n in (1025, 1040, 1060)]
    parts = [(f"n{i} nt {i}",
              "".join(rng.choice(list(NT), int(rng.integers(40, 100)))))
             for i in range(40)]
    parts[3] = ("n3 planted", longs[0][100:190])
    parts[8] = ("n8 planted rc", _revcomp(longs[2][500:600]))
    parts[11] = ("n11 planted", shorts[0][5:50])
    params = dict(matchscore=1, mismatchscore=-3, gapopen=5, gapextend=2,
                  descriptions=40, alignments=5, expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "nt", shorts + longs, 0, 3,
                               params)
    assert [g for g in routes["groups"] if g[3]] == \
        [(4, 1536, 1024, True), (2, 1536, 1024, True)]
    assert hits[2][0][0][0] == 3 and hits[4][0][0][0] == 8


def test_blastx_long_frames(routes):
    # a 3,100-nt transcript: frames of 1,032-1,033 residues, each strand's
    # three frames plus the other's first in one group of four
    rng = np.random.default_rng(52)
    parts = _records(rng, 40, 40, 100)
    target = parts[5][1]
    nt = "".join(CODON[c] for c in target[:40])
    transcript = ("".join(rng.choice(list(NT), 1001)) + nt
                  + "".join(rng.choice(list(NT), 3100 - 1001 - len(nt))))
    params = dict(gapopen=11, gapextend=1, descriptions=40, alignments=5,
                  expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "aa", [transcript], 2, 3,
                               params)
    assert [g for g in routes["groups"] if g[3]] == \
        [(4, 1536, 1024, True), (2, 1536, 1024, True)]
    top = hits[0][0][0]
    assert top[0] == 5 and (top[2], top[3]) == (0, 1001 % 3)
