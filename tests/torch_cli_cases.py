"""Inputs and runners shared by the port's CLI tests (the port's BLAST v4
writer; the runners call either package's CLI in process)."""

import io
import re
from contextlib import redirect_stdout

from swipe_tpu_torch.alphabet import MAP_NCBI_AA, MAP_NCBI_NT16, encode
from swipe_tpu_torch.io.asn1 import Defline, SeqId
from swipe_tpu_torch.io.blastdb_writer import make_deflines, write_blastdb

AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"
DATE = "Jan 1, 2026  12:00 AM"

# lines that differ between two runs of one CLI: times and speeds
VOLATILE = re.compile(
    r"^(Search started|Search completed|Elapsed|Speed|# SWIPE|"
    r"\s*<searchStarted>|\s*<searchCompleted>|\s*<searchElapsedTime>|"
    r"\s*<searchSpeed>)")


def seqs(rng, n, lo, hi, alphabet):
    return ["".join(rng.choice(list(alphabet), int(rng.integers(lo, hi))))
            for _ in range(n)]


def fasta(recs, name="seq"):
    return "".join(f">{name}{i} description {i}\n{s}\n"
                   for i, s in enumerate(recs))


def rich_deflines(n, rng):
    """One to three deflines a record, with gi, sp, lcl and gnl ids,
    taxids, memberships and links, so the dump renders every id kind."""
    out = []
    for i in range(n):
        ds = [Defline(title=f"record {i} first title",
                      seqids=[SeqId("gi", number=1000 + i),
                              SeqId("sp", accession=f"P{10000 + i}",
                                    name=f"PROT{i}_HUMAN", version=1)],
                      taxid=9606 + i % 3, memberships=i % 2,
                      links=i % 4)]
        for j in range(int(rng.integers(0, 3))):
            ds.append(Defline(title=f"record {i} alias {j}",
                              seqids=[SeqId("lcl", id_string=f"r{i}_{j}")]
                              if j == 0 else
                              [SeqId("gnl", gnl_db="test",
                                     id_integer=i * 10 + j)],
                              taxid=10090 if j else 0))
        out.append(ds)
    return out


def write_db(base, strs, dbtype, deflines=None, title="test db"):
    """A BLAST v4 volume of ``strs`` (letters) written by the port."""
    mapping = MAP_NCBI_AA if dbtype == "aa" else MAP_NCBI_NT16
    codes = [encode(s, mapping) for s in strs]
    if deflines is None:
        deflines = make_deflines([f"{base.rsplit('/', 1)[-1]}_{i} "
                                  f"record {i}" for i in range(len(strs))])
    write_blastdb(base, codes, deflines, dbtype, title=title, date=DATE)


def run_cli(main, argv) -> str:
    """One CLI run in process: its standard output, after exit code 0."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def mask(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not VOLATILE.match(ln)]
