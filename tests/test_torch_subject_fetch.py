"""The align phase's subjects come from the engine's held units
(``SearchEngine.subject``, ``subject_length``) on nucleotide databases:
every frame of tblastn and tblastx, every blastn plus strand, and a
giant's minus strand made once from its plus strand.  On the CPU, with
``max_cols`` cut to 1,024 columns so that two records (and their frames)
are giants, each kept hit must carry the codes and lengths the database
gives, and the hit lists and alignments must equal those of hit lists
that read the database.  A search translates nothing: the frames were
translated once, at set-up."""

import io

import numpy as np
import pytest
import torch

from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

AA = "ARNDCQEGHILKMFPSTWYV"
MAX_COLS = 1024
PARAMS = dict(gapopen=11, gapextend=1, descriptions=60, alignments=12,
              expect=1e9)
NT_PARAMS = dict(matchscore=1, mismatchscore=-3, gapopen=5, gapextend=2,
                 descriptions=60, alignments=12, expect=1e9)
COUNTERS = ("align.subject.held", "align.subject.derived",
            "align.subject.db")
GIANTS = (6, 7)
# mode -> (symtype, query strands, whether the query is the protein)
MODES = {"tblastn": (3, 3, True), "tblastx": (4, 3, False),
         "blastn": (0, 3, False)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _codons(protein: str) -> str:
    """Stop-free codons of genetic code 1, one for each amino acid."""
    table = {"A": "GCT", "R": "CGT", "N": "AAT", "D": "GAT", "C": "TGT",
             "Q": "CAA", "E": "GAA", "G": "GGT", "H": "CAT", "I": "ATT",
             "L": "CTT", "K": "AAA", "M": "ATG", "F": "TTT", "P": "CCT",
             "S": "TCT", "T": "ACT", "W": "TGG", "Y": "TAT", "V": "GTT"}
    return "".join(table[a] for a in protein)


def _plant(record: str, at: int, nt: str, strand: int) -> str:
    if strand:
        nt = _revcomp(nt)
    return record[:at] + nt + record[at + len(nt):]


def _case():
    """(FASTA text, protein, its codons): six short records and two
    giants (3,600 and 3,300 bases), the codons planted on the plus strand
    of record 1 and the second giant, on the minus strand of record 2 and
    the first giant."""
    rng = np.random.default_rng(18)
    protein = "".join(rng.choice(list(AA), 20))
    nt = _codons(protein)
    recs = ["".join(rng.choice(list("ACGT"), int(rng.integers(100, 200))))
            for _ in range(6)]
    recs += ["".join(rng.choice(list("ACGT"), n)) for n in (3600, 3300)]
    recs[1] = _plant(recs[1], 30, nt, 0)
    recs[2] = _plant(recs[2], 20, nt, 1)
    recs[6] = _plant(recs[6], 2001, nt, 1)
    recs[7] = _plant(recs[7], 1000, nt, 0)
    fasta = "".join(f">r{i} record {i}\n{s}\n" for i, s in enumerate(recs))
    return fasta, protein, nt, recs


def _engine(fasta, symtype, strands):
    """An engine on the CPU; 1,024 lanes and the giants on the wavefront
    route keep the plain versions' padded work small."""
    params = NT_PARAMS if symtype == 0 else PARAMS
    eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "nt", title="t"),
                       SearchParams(symtype=symtype, querystrands=strands,
                                    **params),
                       device="cpu", nseqs=1024, max_cols=MAX_COLS)
    eng.SEGMENT_GIANTS = False
    return eng


def _key(hl):
    return [(h.seqno, h.score, h.qstrand, h.qframe, h.dstrand, h.dframe,
             h.dlen, h.dlennt, h.score_align, h.align_q_start,
             h.align_q_end, h.align_d_start, h.align_d_end, h.alignment,
             None if h.dseq is None else h.dseq.tobytes())
            for h in hl.hits], hl.totalhits, hl.obvious


def _counts(before):
    return {k: trace.counter(k) - before[k] for k in COUNTERS}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_subjects_come_from_the_engine(mode):
    symtype, strands, protein_query = MODES[mode]
    fasta, protein, nt, recs = _case()
    bases = trace.counter("translate.bases")
    eng = _engine(fasta, symtype, strands)
    # set-up translates each record's six frames once
    assert trace.counter("translate.bases") - bases == \
        (6 * sum(len(r) for r in recs) if symtype else 0)
    bases = trace.counter("translate.bases")
    assert eng._giant_ids.size == (12 if symtype else 2)
    query = preprocess_query("q0", protein if protein_query else nt,
                             symtype, strands)

    before = {k: trace.counter(k) for k in COUNTERS}
    since = trace.mark()
    hl = eng.search_batch([query])[0]
    got = _counts(before)
    # no translation inside the request
    assert trace.counter("translate.bases") == bases
    assert "db.translate" not in {s.name for s in trace.spans(since)}

    shown = hl.hits[:PARAMS["alignments"]]
    assert len(shown) == PARAMS["alignments"] < len(hl.hits)
    giant_seqnos = set(eng.unit_meta[eng._giant_ids, 0].tolist())
    assert giant_seqnos == set(GIANTS)
    if symtype:
        assert got == {"align.subject.held": len(shown),
                       "align.subject.derived": 0, "align.subject.db": 0}
    else:
        from_db = [h for h in shown
                   if h.dstrand and h.seqno not in giant_seqnos]
        derived = {h.seqno for h in shown
                   if h.dstrand and h.seqno in giant_seqnos}
        assert from_db and 6 in derived
        assert got == {"align.subject.held": len(shown) - len(from_db),
                       "align.subject.derived": len(derived),
                       "align.subject.db": len(from_db)}
        # the giant's minus strand is kept: a second search makes none
        before = {k: trace.counter(k) for k in COUNTERS}
        again = eng.search_batch([query])[0]
        assert _counts(before)["align.subject.derived"] == 0
        assert _key(again) == _key(hl)

    # each hit's codes and lengths are the database's
    db = eng.db
    for i, h in enumerate(hl.hits):
        want, ntlen = db.get_sequence(h.seqno, symtype, h.dstrand, h.dframe)
        if i < len(shown):
            assert np.array_equal(h.dseq, want), h
            assert (h.dlen, h.dlennt) == (len(want), ntlen), h
            if symtype or not h.dstrand or h.seqno in giant_seqnos:
                assert not h.dseq.flags.writeable
        else:
            assert h.dseq is None
            assert (h.dlen, h.dlennt) == db.get_length(
                h.seqno, symtype, h.dstrand, h.dframe) == (len(want), ntlen)
    codes, ntlen = eng.subject(6, 1 if symtype == 0 else 0, 0)
    with pytest.raises(ValueError):
        codes[0] = 0
    assert ntlen == len(recs[6])

    # the same hit lists and alignments as hit lists that read the
    # database
    def db_path(queries):
        lists = SearchEngine._hitlists(eng, queries)
        for lst in lists:
            lst.engine = None
        return lists

    eng._hitlists = db_path
    before = {k: trace.counter(k) for k in COUNTERS}
    assert _key(eng.search_batch([query])[0]) == _key(hl)
    assert _counts(before) == dict.fromkeys(COUNTERS, 0)


def test_protein_database_reads_the_database():
    rng = np.random.default_rng(18)
    recs = ["".join(rng.choice(list(AA), int(rng.integers(40, 120))))
            for _ in range(8)]
    q = recs[3][5:50]
    fasta = "".join(f">p{i}\n{s}\n" for i, s in enumerate(recs))
    eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "aa", title="t"),
                       SearchParams(symtype=1, querystrands=1, **PARAMS),
                       device="cpu")
    before = {k: trace.counter(k) for k in COUNTERS}
    hl = eng.search_batch([preprocess_query("q0", q, 1, 1)])[0]
    assert hl.hits[0].seqno == 3
    for h in hl.hits[:PARAMS["alignments"]]:
        assert np.array_equal(h.dseq, eng.db.get_sequence(h.seqno, 1)[0])
    assert _counts(before) == dict.fromkeys(COUNTERS, 0)
