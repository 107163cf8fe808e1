"""tblastn over nucleotide records whose reading frames pass the giant
threshold, on each giant route, on the CPU against the benchmark's plain
reference (``portbench/reference``: its own translation under genetic
code 1 and plain Smith-Waterman in PyTorch ops, no JAX).

With ``max_cols`` cut to 2,048 columns, two records' frames (about 2,200
and 2,500 codons) are giants and the rest stay in the plain pack.  Each
route (overlapped pieces, the wavefront kernel, the carry series, forced
as ``test_torch_giants.py`` forces them) must give the reference's hit
list (record, strand and frame, score), shown alignments that re-walk to
the reference's score, its own ``giant.<route>`` span and the real cells
in ``giant.cells.<route>``; the database's translations are
``db.translate`` spans counted in ``translate.bases``, each frame once
at set-up and none in the search."""

import io

import numpy as np
import pytest
import torch

from portbench.reference import search, sw, translate
from portbench.workload import Corpus
from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams

AA = "ARNDCQEGHILKMFPSTWYV"
MAX_COLS = 2048
GAPOPEN, GAPEXTEND = 11, 1
PARAMS = dict(gapopen=GAPOPEN, gapextend=GAPEXTEND, descriptions=60,
              alignments=12, expect=1e9)

# route -> the engine attributes that force it
ROUTES = {
    "pieces": {},
    "wavefront": {"SEGMENT_GIANTS": False},
    "carry": {"SEGMENT_GIANTS": False, "WAVEFRONT_MAX_GIANTS": 0},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _codons(protein: str) -> str:
    """One codon of genetic code 1 for each amino acid."""
    first = {}
    for i, aa in enumerate(translate.CODE1):
        first.setdefault(aa, "TCAG"[i // 16] + "TCAG"[i // 4 % 4]
                         + "TCAG"[i % 4])
    return "".join(first[a] for a in protein)


def _plant(record: str, at: int, protein: str, strand: int,
           frame: int) -> str:
    """``record`` with ``protein`` encoded in reading frame ``frame`` of
    ``strand``, from that frame's codon ``at`` on."""
    s = _revcomp(record) if strand else record
    p = frame + 3 * at
    nt = _codons(protein)
    s = s[:p] + nt + s[p + len(nt):]
    return _revcomp(s) if strand else s


def _database(rng):
    """(FASTA text, the query): six short records and two giants, the
    query planted in frame 1 of the first giant's minus strand and a
    weaker copy in frame 2 of its plus strand."""
    q = "".join(rng.choice(list(AA), 45))
    weak = "".join(c if rng.random() > 0.3 else rng.choice(list(AA))
                   for c in q)
    recs = ["".join(rng.choice(list("ACGT"), int(rng.integers(60, 300))))
            for _ in range(6)]
    giant = "".join(rng.choice(list("ACGT"), 7500))
    giant = _plant(giant, 1700, q, 1, 1)
    giant = _plant(giant, 300, weak, 0, 2)
    recs += [giant, "".join(rng.choice(list("ACGT"), 6600))]
    return "".join(f">r{i} record {i}\n{s}\n" for i, s in enumerate(recs)), \
        q, recs


def _reference(recs, q):
    """(per-unit reference scores, units' seqno, key, letters, matrix,
    the frames as record_frames lays them)."""
    flat = np.frombuffer("".join(recs).encode(), np.uint8)
    lens = np.array([len(r) for r in recs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    corpus = Corpus(flat, starts, lens, [b""] * len(recs), "nt")
    letters, matrix = sw.load_matrix("BLOSUM62")
    fflat, fstarts, flens, seqno, keys = translate.record_frames(corpus)
    subjects = sw.Subjects(sw.encode(letters, fflat), fstarts, flens, "cpu")
    best = sw.sw_scan([sw.encode(letters, q.encode())], subjects, matrix,
                      GAPOPEN, GAPEXTEND)[0]
    return best, seqno, keys, letters, matrix, corpus, flens


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tblastn_giant_route_matches_reference(route):
    rng = np.random.default_rng(17)
    fasta, q, recs = _database(rng)
    best, seqno, keys, letters, matrix, corpus, flens = _reference(recs, q)
    giant_aa = int(flens[flens > MAX_COLS].sum())
    assert (flens > MAX_COLS).sum() == 12        # two records' six frames

    cells0 = {r: trace.counter(f"giant.cells.{r}") for r in ROUTES}
    bases0 = trace.counter("translate.bases")
    since = trace.mark()
    eng = SearchEngine(FastaDatabase(io.StringIO(fasta), "nt", title="t"),
                       SearchParams(symtype=3, querystrands=3, **PARAMS),
                       device="cpu", max_cols=MAX_COLS)
    for k, v in ROUTES[route].items():
        setattr(eng, k, v)
    assert eng._giant_ids.size == 12
    # every frame of every record translated once, at set-up
    assert "db.translate" in {s.name for s in trace.spans(since)}
    assert trace.counter("translate.bases") - bases0 \
        == 6 * sum(len(r) for r in recs)
    bases0 = trace.counter("translate.bases")
    hl = eng.search_batch([preprocess_query("q0", q, 3, 3)])[0]

    # the route's span and the real cells it walked, and no other route
    names = {s.name for s in trace.spans(since)}
    assert f"giant.{route}" in names
    assert not {f"giant.{r}" for r in ROUTES if r != route} & names
    for r in ROUTES:
        got = trace.counter(f"giant.cells.{r}") - cells0[r]
        assert got == (len(q) * giant_aa if r == route else 0), r
    # the search translates nothing: the align phase reads the frames
    # the engine holds
    assert trace.counter("translate.bases") == bases0

    # the hit list: record, strand and frame, score
    want = search.hit_list(best, keys, seqno, 1, PARAMS["descriptions"])
    have = [(h.seqno, translate.key(0, 0, h.dstrand, h.dframe), h.score)
            for h in hl.hits]
    assert have == want
    assert have[0][:2] == (6, translate.key(0, 0, 1, 1))
    # shown alignments re-walk over the frame to the reference's score
    qi = sw.encode(letters, q.encode())
    shown = hl.hits[:PARAMS["alignments"]]
    assert len(shown) == PARAMS["alignments"]
    for h in shown:
        frame = translate.translate(corpus.record(h.seqno), h.dstrand,
                                    h.dframe)
        walked = search.walk(h.alignment, qi, sw.encode(letters, frame),
                             h.align_q_start, h.align_d_start, matrix,
                             GAPOPEN, GAPEXTEND)
        assert h.score_align == h.score
        assert walked == (h.score, h.align_q_end, h.align_d_end), h
