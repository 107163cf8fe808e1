"""The port's giant routes end to end on the CPU against the JAX engine on
its stream backend (interpret mode): database units over the giant
threshold scored as overlapped pieces on the stream kernel, through the
wavefront kernel and through the carry series, with free gap extension,
with the segmented and the single-lane hint passes, and a blastn giant on
both strands.  Hit lists (scores, alignments), totalhits, obvious and the
cascade counters must be equal."""

import io

import numpy as np
import pytest
import torch

from swipe_tpu.io.db import FastaDatabase as JaxFastaDatabase
from swipe_tpu.io.fasta import preprocess_query as jax_preprocess_query
from swipe_tpu.ops import align_hint as jah
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.pipeline import SearchEngine as JaxSearchEngine
from swipe_tpu.pipeline import SearchParams as JaxSearchParams
from swipe_tpu.pipeline import SearchTimings as JaxSearchTimings
from swipe_tpu_torch import trace
from swipe_tpu_torch.io.db import FastaDatabase
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.ops import align_hint as tah
from swipe_tpu_torch.pipeline import SearchEngine, SearchParams, SearchTimings

AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hit_key(hl):
    return ([(h.seqno, h.score, h.qstrand, h.qframe, h.dstrand, h.dframe,
              h.score_align, h.align_q_start, h.align_q_end,
              h.align_d_start, h.align_d_end, h.alignment)
             for h in hl.hits], hl.totalhits, hl.obvious)


def run_both(fasta, dbtype, queries, symtype, strands, params, *,
             max_cols=None, attrs=None, nseqs=None):
    """The same batch through the JAX engine (stream backend, interpret
    mode) and the port (CPU); returns both engines after asserting equal
    hit lists and counters."""
    engines, results = [], []
    for jax in (True, False):
        Db, Eng, Par, Tim, prep = (
            (JaxFastaDatabase, JaxSearchEngine, JaxSearchParams,
             JaxSearchTimings, jax_preprocess_query) if jax else
            (FastaDatabase, SearchEngine, SearchParams, SearchTimings,
             preprocess_query))
        kw = dict(backend="stream_interpret") if jax else dict(device="cpu")
        eng = Eng(Db(io.StringIO(fasta), dbtype, title="t"),
                  Par(symtype=symtype, querystrands=strands, **params),
                  max_cols=max_cols, nseqs=nseqs, **kw)
        for k, v in (attrs or {}).items():
            setattr(eng, k, v)
        tim = Tim()
        hls = eng.search_batch([prep(f"q{i}", q, symtype, strands)
                                for i, q in enumerate(queries)], tim)
        engines.append(eng)
        results.append(([hit_key(h) for h in hls], tim.compute, tim.rounds))
    assert results[0] == results[1]
    return engines, results[1][0]


def _giant_db(rng):
    parts = [(f"s{i} normal {i}",
              "".join(rng.choice(list(AA), int(rng.integers(30, 120)))))
             for i in range(30)]
    q = "".join(rng.choice(list(AA), 45))
    body = list("".join(rng.choice(list(AA), 6500)))
    body[3000:3030] = list(q[8:38])          # a second, weaker copy
    parts.append(("s30 giant plain", "".join(rng.choice(list(AA), 5000))))
    parts.append(("s31 giant with planted hits",
                  "".join(body) + q + "".join(rng.choice(list(AA), 90))))
    return "".join(f">{d}\n{s}\n" for d, s in parts), q, parts


# route -> (engine attributes, gapextend, GIANT_HINT_MIN or None); with
# GIANT_HINT_MIN cut down the align phase hints the giants in pieces
# (segmented) or on one lane (free gap extension)
ROUTES = {
    "segmented_hint_pieces": ({}, 1, 1024),
    "carry": ({"SEGMENT_GIANTS": False, "WAVEFRONT_MAX_GIANTS": 0}, 1,
              None),
    "wavefront": ({"SEGMENT_GIANTS": False}, 1, None),
    "wavefront_free_gap_extension_solo_hint": ({}, 0, 1024),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_giant_routes_match_jax(route, monkeypatch):
    attrs, gapextend, hint_min = ROUTES[route]
    if hint_min is not None:
        monkeypatch.setattr(jah, "GIANT_HINT_MIN", hint_min)
        monkeypatch.setattr(tah, "GIANT_HINT_MIN", hint_min)
    rng = np.random.default_rng(31)
    fasta, q, parts = _giant_db(rng)
    params = dict(gapopen=11 + (gapextend == 0), gapextend=gapextend,
                  descriptions=40, alignments=4, expect=1e9)
    launches = {e: trace.launched(e) for e in
                ("swipe_stream_rows", "swipe_carry_flow",
                 "swipe_carry_rows")}
    (jeng, teng), hits = run_both(fasta, "aa", [q], 1, 3, params,
                                  max_cols=2048, attrs=attrs)
    assert teng._giant_ids.size == 2
    V = teng._overlap_bound(64)
    if route.startswith("segmented"):
        assert V <= teng._max_cols // 2
    elif route.startswith("wavefront") and gapextend == 0:
        assert V > teng._max_cols // 2         # no segmentation possible
    top = hits[0][0][0]
    seqs = [np.asarray(teng.db.get_sequence(i, 1)[0])
            for i in range(len(parts))]
    want = sw_numpy_many(preprocess_query("q", q, 1, 3).aa[0], seqs,
                         teng.matrix.matrix, params["gapopen"], gapextend)
    assert top[0] == 31 and top[1] == want[31] and top[11]
    for i, h in enumerate(hits[0][0]):
        assert h[1] == want[h[0]]
        assert i >= params["alignments"] or h[6] == h[1]   # re-walks
    # every kernel wrapper of the route took its plain version
    assert all(trace.launched(e) == n for e, n in launches.items())
    assert trace.launched("swipe_wavefront") == 0


def test_giant_blastn_both_strands():
    # a nucleotide giant: one unit, the query's reverse complement
    # planted, scored against both query strands
    rng = np.random.default_rng(33)
    q = "".join(rng.choice(list(NT), 60))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    qrc = "".join(comp[c] for c in reversed(q))
    giant = ("".join(rng.choice(list(NT), 2500)) + qrc
             + "".join(rng.choice(list(NT), 200)) + q[:40])
    parts = [(f"n{i} nt {i}",
              "".join(rng.choice(list(NT), int(rng.integers(40, 150)))))
             for i in range(12)] + [("n12 giant rc-planted", giant)]
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    params = dict(matchscore=1, mismatchscore=-3, gapopen=5, gapextend=2,
                  descriptions=13, alignments=3, expect=1e9)
    (_, teng), hits = run_both(fasta, "nt", [q], 0, 3, params,
                               max_cols=1024)
    assert teng._giant_ids.size == 1
    top = hits[0][0][0]
    assert top[0] == 12 and top[4] == 1 and top[1] == 60
