"""The port's CLI against ``swipe_tpu.cli`` on the CPU (both in process,
``--backend lax``), byte for byte except the volatile lines: the XML and
tabular views, tblastx, sound mode, blastx with short queries, and BLAST
v4 input (a two-volume alias, a .msk subset, the -x taxid filter, -I and
-m 99 -H), the databases written by the port's writer."""

import struct

import numpy as np
import pytest
import torch

from swipe_tpu.cli import main as jax_cli_main
from swipe_tpu_torch.cli import main as torch_cli_main
from swipe_tpu_torch.io.asn1 import Defline, SeqId
from swipe_tpu_torch.io.blastdb_writer import make_deflines

from torch_cli_cases import AA, NT, fasta, mask, rich_deflines, run_cli, \
    seqs, write_db


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one codon of the standard code a residue
CODON = dict(A="GCT", R="CGT", N="AAT", D="GAT", C="TGT", Q="CAA", E="GAA",
             G="GGT", H="CAT", I="ATT", L="CTT", K="AAA", M="ATG", F="TTT",
             P="CCT", S="TCT", T="ACT", W="TGG", Y="TAT", V="GTT")


def _plant(rng, recs, query, at, alphabet, cut=(3, -3)):
    """Put a mutated window of ``query`` into records ``at``."""
    for i in at:
        w = list(query[cut[0]:len(query) + cut[1]])
        for j in rng.choice(len(w), len(w) // 8, replace=False):
            w[j] = rng.choice(list(alphabet))
        k = int(rng.integers(0, len(recs[i]) + 1))
        recs[i] = recs[i][:k] + "".join(w) + recs[i][k:]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(17)
    # blastp: 3 queries of 40-60 aa, 80 records
    qa = seqs(rng, 3, 40, 60, AA)
    aa = seqs(rng, 80, 40, 160, AA)
    _plant(rng, aa, qa[0], (4, 30), AA)
    _plant(rng, aa, qa[2], (51,), AA)
    (d / "qa.fa").write_text(fasta(qa, "qa"))
    (d / "aa.fa").write_text(fasta(aa))
    # translated modes: 2 queries of 60-90 nt, 20 records of 90-180 nt
    # (the port's CPU route scores 2048 lanes a column, most of them
    # empty here)
    qn = seqs(rng, 2, 60, 90, NT)
    nt = seqs(rng, 20, 90, 180, NT)
    _plant(rng, nt, qn[0], (3, 17), NT)
    (d / "qn.fa").write_text(fasta(qn, "qn"))
    (d / "nt.fa").write_text(fasta(nt))
    # blastx: short nt queries (100-150 nt) against the protein records,
    # one coding a window of a record on its minus strand
    qx = seqs(rng, 2, 40, 90, NT)
    code = "".join(CODON[c] for c in aa[30][5:25])
    qx[0] += code[::-1].translate(str.maketrans("ACGT", "TGCA"))
    (d / "qx.fa").write_text(fasta(qx, "qx"))
    # sound (symtype 5): its own 32-letter alphabet
    snd = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcde"
    qs = seqs(rng, 2, 30, 50, snd)
    ds = seqs(rng, 40, 30, 120, snd)
    _plant(rng, ds, qs[0], (9,), snd)
    (d / "qs.fa").write_text(fasta(qs, "qs"))
    (d / "sound.fa").write_text(fasta(ds))
    # the same records with every e read as d, for the byte comparison:
    # the JAX package scores an e as padding (its code 31 is PAD_SYMBOL,
    # ROADMAP Queue 3); test_sound_scores_match_oracle holds the port's
    # scores on the whole alphabet
    (d / "qs5.fa").write_text(fasta([s.replace("e", "d") for s in qs], "qs"))
    (d / "sound5.fa").write_text(fasta([s.replace("e", "d") for s in ds]))

    # BLAST v4: the protein records in two volumes behind an alias, with
    # several deflines a record and taxids
    write_db(str(d / "vol0"), aa[:50], "aa", rich_deflines(50, rng))
    write_db(str(d / "vol1"), aa[50:], "aa", make_deflines(
        [f"vol1 record {i}" for i in range(30)],
        taxids=[100 + i % 3 for i in range(30)]))
    (d / "two.pal").write_text("TITLE  two volumes\nDBLIST vol0 vol1\n")
    (d / "taxids.txt").write_text("101\n9607\n")
    write_db(str(d / "ntdb"), nt, "nt", rich_deflines(len(nt), rng))
    # a .msk subset of the even OIDs (membership bit 1 on their deflines)
    dls = [[Defline(title=f"m{i} masked db", memberships=int(i % 2 == 0),
                    seqids=[SeqId("gi", number=500 + i)])]
           for i in range(len(aa))]
    write_db(str(d / "base"), aa, "aa", dls)
    n = len(aa)
    bits = bytearray((n + 7) // 8)
    for i in range(0, n, 2):
        bits[i // 8] |= 1 << (7 - i % 8)
    (d / "sub.msk").write_bytes(struct.pack(">I", n) + bytes(bits))
    (d / "inner.pal").write_text(
        f"TITLE  subset\nDBLIST base\nOIDLIST sub.msk\nLENGTH 1\n"
        f"NSEQ {n // 2}\nMAXOID {n - 1}\nMEMB_BIT 1\n")
    (d / "sub.pal").write_text("TITLE  subset\nDBLIST inner\nMEMB_BIT 1\n")
    return d


CASES = {
    "blastp-m7": ["-i", "qa.fa", "-d", "aa.fa", "-m", "7"],
    "blastp-m9": ["-i", "qa.fa", "-d", "aa.fa", "-m", "9"],
    "tblastx-m0": ["-p", "4", "-i", "qn.fa", "-d", "nt.fa", "-m", "0"],
    "tblastx-m8": ["-p", "tblastx", "-i", "qn.fa", "-d", "nt.fa", "-m", "8"],
    "sound": ["-p", "5", "-i", "qs5.fa", "-d", "sound5.fa", "-m", "0"],
    "blastx-short": ["-p", "blastx", "-i", "qx.fa", "-d", "aa.fa", "-m",
                     "0"],
    "blastn-m9": ["-p", "blastn", "-i", "qn.fa", "-d", "nt.fa", "-m", "9"],
    "alias-two-volumes": ["-i", "qa.fa", "-d", "two", "-m", "0"],
    "alias-I-m8": ["-i", "qa.fa", "-d", "two", "-m", "8", "-I"],
    "alias-m99-H": ["-i", "qa.fa", "-d", "two", "-m", "99", "-H"],
    "taxid-filter": ["-i", "qa.fa", "-d", "two", "-m", "9", "-x",
                     "taxids.txt"],
    "msk-subset": ["-i", "qa.fa", "-d", "sub", "-m", "0", "-I"],
    "blastdb-tblastn": ["-p", "tblastn", "-i", "qa.fa", "-d", "ntdb", "-m",
                        "0"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_bytes_match_jax(files, case):
    argv = [str(files / a) if (files / a).exists() or a in ("two", "sub",
                                                            "ntdb")
            else a for a in CASES[case]]
    argv += ["-v", "20", "-b", "5", "--backend", "lax"]
    got = run_cli(torch_cli_main, argv)
    assert mask(got) == mask(run_cli(jax_cli_main, argv))
    assert len(mask(got)) >= 10


@pytest.mark.parametrize("backend", ["stream", "pallas_v1"])
def test_sound_scores_match_oracle(files, backend):
    """Sound mode over its whole alphabet, e included: every hit's score
    on both of the port's routes equals the NumPy oracle's, and every
    record the oracle scores above the list's last kept score is kept.
    The records are read with the JAX package's codes, in which e is 31,
    the padding code: scoring it as padding changes some of these
    scores, so the data shows that fault where it is present."""
    from swipe_tpu.alphabet import MAP_SOUND as JAX_MAP_SOUND
    from swipe_tpu.alphabet import encode as jax_encode
    from swipe_tpu.matrices import ScoreMatrix as JaxScoreMatrix
    from swipe_tpu.ops.sw_ref import sw_numpy
    from swipe_tpu_torch.io.db import FastaDatabase
    from swipe_tpu_torch.io.fasta import preprocess_query
    from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

    def records(path):
        return [(b.split("\n", 1)[0].split()[0],
                 b.split("\n", 1)[1].replace("\n", ""))
                for b in path.read_text().split(">")[1:]]

    qs, ds = records(files / "qs.fa"), records(files / "sound.fa")
    jmat = JaxScoreMatrix.builtin("IDENTITY_5_1", 15, 5, symtype=5).matrix
    padded = jmat.copy()
    padded[31, :] = padded[:, 31] = -128
    eng = SearchEngine(FastaDatabase(str(files / "sound.fa"), "sound"),
                       SearchParams(symtype=5, matrixname="IDENTITY_5_1",
                                    gapopen=15, gapextend=5,
                                    descriptions=len(ds), alignments=0,
                                    expect=1e9),
                       device="cpu", backend=backend)
    differs = 0
    for name, q in qs:
        hl = eng.search(preprocess_query(name, q, 5, 3))
        jq = jax_encode(q, JAX_MAP_SOUND)
        want = [sw_numpy(jq, jax_encode(d, JAX_MAP_SOUND), jmat, 15, 5)
                for _, d in ds]
        differs += sum(w != sw_numpy(jq, jax_encode(d, JAX_MAP_SOUND),
                                     padded, 15, 5)
                       for w, (_, d) in zip(want, ds))
        got = {h.seqno: h.score for h in hl.hits}
        assert len(got) >= 10
        assert all(want[s] == v for s, v in got.items())
        assert {s for s, w in enumerate(want)
                if w > min(got.values())} <= set(got)
    assert differs > 0
