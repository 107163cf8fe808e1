"""``-N 1`` and ``-N 2`` database dumps of the port against the JAX
package's, byte for byte: aa, nt, translated and sound databases, as
FASTA and as BLAST v4 with several deflines a sequence."""

import numpy as np
import pytest
import torch

from swipe_tpu.cli import main as jax_cli_main
from swipe_tpu_torch.cli import main as torch_cli_main

from torch_cli_cases import (AA, NT, fasta, rich_deflines, run_cli, seqs,
                             write_db)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dump")
    rng = np.random.default_rng(41)
    aa = seqs(rng, 12, 1, 200, AA)
    # ambiguity codes, a record over 80 columns and one of one base
    nt = seqs(rng, 10, 1, 300, NT) + ["NNACGTRYSWKMBDHVN" * 7, "A"]
    write_db(str(d / "aa"), aa, "aa", rich_deflines(len(aa), rng))
    write_db(str(d / "nt"), nt, "nt", rich_deflines(len(nt), rng))
    (d / "aa.fa").write_text(fasta(aa))
    (d / "nt.fa").write_text(fasta(nt))
    (d / "sound.fa").write_text(fasta(seqs(rng, 6, 5, 120,
                                           "ABCDEFGHIJKLMNOPQRSTUVWXYZ")))
    return d


@pytest.mark.parametrize("dump", ["1", "2"])
@pytest.mark.parametrize("db,mode", [
    ("aa", "blastp"), ("nt", "blastn"), ("nt", "tblastn"), ("aa", "blastx"),
    ("aa.fa", "blastp"), ("nt.fa", "blastn"), ("sound.fa", "5")])
def test_dump_bytes_match_jax(dbs, db, mode, dump):
    argv = ["-d", str(dbs / db), "-p", mode, "-N", dump]
    want = run_cli(jax_cli_main, argv)
    got = run_cli(torch_cli_main, argv)
    assert got == want
    assert got.count(">") >= 6


def test_dump_shows_taxids_and_every_defline(dbs):
    """-H adds link and membership fields; -N 2 gives one record a
    defline, so it prints more headers than -N 1 on the same sequences."""
    argv = ["-d", str(dbs / "aa"), "-N", "1", "-H"]
    got = run_cli(torch_cli_main, argv)
    assert got == run_cli(jax_cli_main, argv)
    assert "|memb|1" in got
    split = run_cli(torch_cli_main, ["-d", str(dbs / "aa"), "-N", "2"])
    assert split.count("\n>") > got.count("\n>")


def test_dump_runs_on_no_device(dbs, monkeypatch):
    """The dump is host only: it needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_cli(torch_cli_main, ["-d", str(dbs / "nt"), "-p", "blastn",
                                    "-N", "1"]).startswith(">")
