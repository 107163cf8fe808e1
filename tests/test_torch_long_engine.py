"""The port's long routes (queries over 1024 rows) end to end on the CPU
against the JAX engine on its stream backend (interpret mode): the plain
pack in query-tile passes, a giant on the carry series in tile passes,
and a flow-routed database whose long queries still take the plain pack.
Hit lists, totalhits, obvious and the cascade counters must be equal, and
the port must have taken the JAX engine's route."""

import numpy as np
import pytest
import torch
from test_torch_giants import AA, run_both

from swipe_tpu_torch.ops import sw_stream as tsw
from swipe_tpu_torch.pipeline import SearchEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def routes(monkeypatch):
    """Calls of the port's scoring entry points by name, and its slot
    groups as (slots, qlen_pad, lanes, long)."""
    calls = {"groups": []}
    for name in ("sw_scores_stream", "sw_scores_stream_long",
                 "sw_scores_stream_carry", "sw_scores_stream_carry_long",
                 "stream_tile_pass", "stream_tile_carry_pass"):
        def spy(*a, _fn=getattr(tsw, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tsw, name, spy)
    group = SearchEngine._search_stream_group

    def spy_group(self, slots, qlen_pad, nseqs, timings, long=False):
        calls["groups"].append((len(slots), qlen_pad, nseqs, long))
        return group(self, slots, qlen_pad, nseqs, timings, long)

    monkeypatch.setattr(SearchEngine, "_search_stream_group", spy_group)
    return calls


def _fasta(parts):
    return "".join(f">{d}\n{s}\n" for d, s in parts)


def _records(rng, n, lo, hi):
    return [(f"s{i} record {i}",
             "".join(rng.choice(list(AA), int(rng.integers(lo, hi)))))
            for i in range(n)]


def test_long_blastp_query_matches_jax(routes):
    # a 1,480-residue query (qlen_pad 1536: three 512-row tiles, the last
    # partial) on the plain pack at 1024 lanes x 16,384 columns
    rng = np.random.default_rng(12)
    q = "".join(rng.choice(list(AA), 80))
    parts = _records(rng, 40, 40, 150)
    parts[3] = ("s3 planted", q[5:70])
    parts[9] = ("s9 planted", q[:40] + "W" * 5 + q[40:])
    longq = "".join(rng.choice(list(AA), 1400)) + q
    params = dict(gapopen=11, gapextend=1, descriptions=40, alignments=5,
                  expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "aa", [longq], 1, 3, params)
    assert routes["groups"] == [(1, 1536, 1024, True)]
    nchunks = len(teng._stream_chunks(1024, teng.LONG_MAX_COLS))
    assert routes["sw_scores_stream_long"] == nchunks
    assert routes["stream_tile_pass"] == 3 * nchunks
    assert "sw_scores_stream" not in routes
    assert {h[0] for h in hits[0][0][:2]} == {3, 9}


def test_long_query_giant_matches_jax(routes):
    # a query over 1024 rows against a giant: the JAX engine neither
    # segments it nor sends it to the wavefront, but runs the carry
    # series in tile passes (three 256-column chunks here)
    rng = np.random.default_rng(34)
    q = "".join(rng.choice(list(AA), 1030))
    parts = _records(rng, 12, 30, 100)
    parts.append(("s12 giant with planted hit",
                  "".join(rng.choice(list(AA), 300)) + q[300:420]
                  + "".join(rng.choice(list(AA), 280))))
    params = dict(gapopen=11, gapextend=1, descriptions=13, alignments=3,
                  expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "aa", [q], 1, 3, params,
                               max_cols=256)
    assert teng._giant_ids.size == 1 and hits[0][0][0][0] == 12
    nchunks = len(teng._carry_chunks(1024))
    assert nchunks == 3
    assert routes["sw_scores_stream_carry_long"] == nchunks
    assert routes["stream_tile_carry_pass"] == 3 * nchunks
    assert "sw_scores_stream" not in routes      # no segmented pieces
    assert "sw_scores_stream_carry" not in routes


def test_flow_database_long_query_takes_plain_pack(routes):
    # a heavy length tail fires the flow heuristic: the short query's
    # group takes the flow series, the long query's the plain pack at
    # 1024 x 16,384 (the JAX engine's `not long` condition), each pack
    # cached under its own (lanes, chunk height)
    rng = np.random.default_rng(91)
    q = "".join(rng.choice(list(AA), 60))
    parts = _records(rng, 60, 20, 80)
    parts[5] = ("s5 long", "".join(rng.choice(list(AA), 200)) + q[10:55])
    parts[17] = ("s17 planted", q[5:50])
    longq = "".join(rng.choice(list(AA), 1000)) + q[:45]
    params = dict(gapopen=11, gapextend=1, descriptions=60, alignments=3,
                  expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "aa", [q, longq], 1, 3, params,
                               nseqs=1024, attrs={"FLOW_MIN_AVG_LANE": 0})
    assert teng._flow_cols(1024) is not None
    assert routes["groups"] == [(1, 64, 1024, False), (1, 1536, 1024, True)]
    assert routes["sw_scores_stream_carry"] == len(teng._flow_chunks(1024))
    # the constructor's plain pack (built before the heuristic was
    # lowered) and the long route's, apart
    assert set(teng._stream_packs) == {(1024, teng._max_cols),
                                       (1024, teng.LONG_MAX_COLS)}
    assert routes["sw_scores_stream_long"] == len(
        teng._stream_packs[1024, teng.LONG_MAX_COLS])
    assert {5, 17} <= {h[0] for h in hits[0][0]} and \
        {5, 17} <= {h[0] for h in hits[1][0]}
