"""The port's BLAST v4 writer against the JAX package's: the same volume
files byte for byte, for aa and nt, with taxids, memberships and several
deflines a sequence, and a round trip through the port's reader."""

import numpy as np
import pytest

from swipe_tpu.io.asn1 import Defline as JaxDefline
from swipe_tpu.io.asn1 import SeqId as JaxSeqId
from swipe_tpu.io.blastdb_writer import make_deflines as jax_make_deflines
from swipe_tpu.io.blastdb_writer import write_blastdb as jax_write_blastdb
from swipe_tpu_torch.alphabet import MAP_NCBI_AA, MAP_NCBI_NT16, encode
from swipe_tpu_torch.io.blastdb import BlastDatabase
from swipe_tpu_torch.io.blastdb_writer import make_deflines, write_blastdb

from torch_cli_cases import AA, NT, DATE, rich_deflines, seqs


def _as_jax(deflines):
    """The port's Defline lists as the JAX package's (same fields)."""
    return [[JaxDefline(title=d.title, taxid=d.taxid,
                        memberships=d.memberships, links=d.links,
                        seqids=[JaxSeqId(**vars(s)) for s in d.seqids])
             for d in ds] for ds in deflines]


def _volume(base, ext):
    return {x: open(f"{base}.{ext}{x}", "rb").read()
            for x in ("in", "hr", "sq")}


CASES = {
    "aa": ("aa", lambda rng: seqs(rng, 30, 1, 400, AA)),
    # ambiguity runs: short ones (the 32-bit entries), and one over 16
    # bases, which takes the 64-bit entry format
    "nt": ("nt", lambda rng: seqs(rng, 20, 1, 500, NT)
           + ["ACGTNNNNRYACGT" * 5, "A", "N" * 40 + "ACGT" * 9]),
    "nt-short-runs": ("nt", lambda rng: [
        "".join(rng.choice(list("ACGTACGTACGTN"), int(n)))
        for n in rng.integers(1, 300, size=15)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("headers", ["rich", "plain", "seqids-taxids"])
def test_writer_bytes_match_jax(tmp_path, case, headers):
    dbtype, make = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + len(headers))
    strs = make(rng)
    mapping = MAP_NCBI_AA if dbtype == "aa" else MAP_NCBI_NT16
    codes = [encode(s, mapping) for s in strs]
    descs = [f"id{i} record number {i}" if i % 5 else ""
             for i in range(len(strs))]
    taxids = [int(t) for t in rng.integers(0, 4, size=len(strs)) * 1000]
    if headers == "rich":
        dls = rich_deflines(len(strs), rng)
        jdls = _as_jax(dls)
    elif headers == "plain":
        dls, jdls = make_deflines(descs), jax_make_deflines(descs)
    else:
        dls = make_deflines(descs, parse_seqids=True, taxids=taxids)
        jdls = jax_make_deflines(descs, parse_seqids=True, taxids=taxids)
    assert [[vars(d) | {"seqids": [vars(s) for s in d.seqids]} for d in ds]
            for ds in dls] == \
        [[vars(d) | {"seqids": [vars(s) for s in d.seqids]} for d in ds]
         for ds in jdls]
    write_blastdb(str(tmp_path / "port"), codes, dls, dbtype,
                  title=f"{case} {headers}", date=DATE)
    jax_write_blastdb(str(tmp_path / "jax"), codes, jdls, dbtype,
                      title=f"{case} {headers}", date=DATE)
    ext = "p" if dbtype == "aa" else "n"
    assert _volume(tmp_path / "port", ext) == _volume(tmp_path / "jax", ext)

    db = BlastDatabase(str(tmp_path / "port"), dbtype)
    symtype = 1 if dbtype == "aa" else 0
    assert db.seqcount() == len(strs)
    for i, c in enumerate(codes):
        got, ntlen = db.get_sequence(i, symtype)
        assert np.array_equal(got, c) and ntlen == len(c)
        assert len(db.get_defline_objects(i)) == len(dls[i])
