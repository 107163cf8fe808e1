"""blastx of a transcript whose reading frames pass 1,024 residues, on the
port's CPU path (``SearchEngine.search_batch``, the long route's tile
passes), against the benchmark's plain reference (``portbench/reference``:
its own reading frames under genetic code 1, plain Smith-Waterman in
PyTorch ops, the hit list, the statistics and the alignment judge; no
JAX).

The transcript is a mutated copy of one record's protein, back-translated
between two random UTRs and reverse complemented, so its true frame lies
on the minus strand.  For each query strand setting the port must give
the reference's hit list (record, query strand and frame, score), its
E-values to 1e-9, shown alignments that re-walk over their frame to the
reference's score, and count its walks of the long pack and the live
slots they carried: a strand's three frames in one pass, six frames in a
pass of four and a pass of two."""

import io

import numpy as np
import pytest
import torch

from portbench.generators.genome import revcomp
from portbench.generators.transcripts import back_translate
from portbench.reference import search, sw, translate
from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

AA = "ARNDCQEGHILKMFPSTWYV"
GAPOPEN, GAPEXTEND = 11, 1
PARAMS = dict(gapopen=GAPOPEN, gapextend=GAPEXTEND, descriptions=60,
              alignments=12, expect=1e9, minscore=1)
# BLOSUM62 11/1, as the port's table and the benchmark's configurations
STATS = {"lambda": 0.267, "K": 0.041, "H": 0.14, "alpha": 1.9,
         "beta": -30.0}
UTR5, LENGTH = 1501, 3130


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """(records, transcript): 40 protein records of 30-79 aa; the
    transcript encodes record 5 with a fifth of its residues redrawn, in
    frame UTR5 % 3 of its minus strand."""
    rng = np.random.default_rng(21)
    recs = ["".join(rng.choice(list(AA), int(rng.integers(30, 80))))
            for _ in range(40)]
    protein = np.frombuffer(recs[5].encode(), np.uint8).copy()
    redraw = rng.random(len(protein)) < 0.2
    protein[redraw] = np.frombuffer(AA.encode(), np.uint8)[
        rng.integers(0, len(AA), int(redraw.sum()))]
    cds = back_translate(protein, rng)
    utr = np.frombuffer(b"ACGT", np.uint8)
    plus = np.concatenate([utr[rng.integers(0, 4, UTR5)], cds,
                           utr[rng.integers(0, 4, LENGTH - UTR5 - len(cds))]])
    return recs, revcomp(plus).tobytes()


@pytest.mark.parametrize("strands", [1, 2, 3])
def test_blastx_long_frames_match_reference(strands):
    recs, q = _inputs()
    rows = translate.query_frames(np.frombuffer(q, np.uint8),
                                  {"strands": strands})
    assert len(rows) == 3 * (1 + (strands == 3))
    assert all(len(r) > 1024 for _, r in rows)

    # the reference: every frame against every record
    letters, matrix = sw.load_matrix("BLOSUM62")
    flat = np.frombuffer("".join(recs).encode(), np.uint8)
    lens = np.array([len(r) for r in recs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    subjects = sw.Subjects(sw.encode(letters, flat), starts, lens, "cpu")
    best = sw.sw_scan([sw.encode(letters, r) for _, r in rows], subjects,
                      matrix, GAPOPEN, GAPEXTEND)
    keys = np.array([k for k, _ in rows])[:, None] + np.zeros_like(best)
    seqno = np.arange(len(recs))[None, :] + np.zeros_like(best)
    want = search.hit_list(best.ravel(), keys.ravel(), seqno.ravel(), 1,
                           PARAMS["descriptions"])
    stats = search.Statistics(STATS, len(q) // 3, int(lens.sum()),
                              len(recs))

    fasta = "".join(f">s{i} record {i}\n{r}\n" for i, r in enumerate(recs))
    eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "aa", title="t"),
                       SearchParams(symtype=2, querystrands=strands,
                                    **PARAMS), device="cpu")
    before = trace.counters()
    hl = eng.search_batch([preprocess_query("q0", q.decode(), 2,
                                            strands)])[0]
    after = trace.counters()

    def walked(name):
        return after.get(name, 0) - before.get(name, 0)

    # one walk of the long pack per slot group of at most four frames,
    # its live frames counted, the padding slot of 3 -> 4 not
    assert walked("scoring.passes.long") == (2 if strands == 3 else 1)
    assert walked("scoring.slots.long") == len(rows)
    assert walked("scoring.passes.stream") == walked("scoring.passes.flow") \
        == 0

    have = [(h.seqno, translate.key(h.qstrand, h.qframe, 0, 0), h.score)
            for h in hl.hits]
    assert have == want
    if strands & 2:             # the true frame leads
        assert have[0][:2] == (5, translate.key(1, UTR5 % 3, 0, 0))
    for h in hl.hits:
        assert hl.evmodel.evalue(h.score) == pytest.approx(
            stats.evalue(h.score), rel=1e-9, abs=0)
    shown = hl.hits[:PARAMS["alignments"]]
    assert len(shown) == PARAMS["alignments"]
    for h in shown:
        frame = translate.translate(np.frombuffer(q, np.uint8), h.qstrand,
                                    h.qframe)
        got = search.walk(h.alignment, sw.encode(letters, frame),
                          sw.encode(letters, recs[h.seqno].encode()),
                          h.align_q_start, h.align_d_start, matrix,
                          GAPOPEN, GAPEXTEND)
        assert h.score_align == h.score
        assert got == (h.score, h.align_q_end, h.align_d_end), h
