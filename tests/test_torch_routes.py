"""More of the port's routes end to end on the CPU against the JAX engine
on its stream backend (interpret mode): the flow series on a heavy length
tail, tblastn against a translated "chromosome" whose six frames are
giants, and a batch over SLOT_BATCH slots with a giant.  Hit lists,
totalhits, obvious and the cascade counters must be equal."""

import numpy as np
import pytest
import torch
from test_torch_giants import AA, NT, run_both

from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu_torch import trace
from swipe_tpu_torch.io.fasta import preprocess_query
from swipe_tpu_torch.ops import sw_stream as tsw


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta(parts):
    return "".join(f">{d}\n{s}\n" for d, s in parts)


def test_flow_route_matches_jax(monkeypatch):
    # a heavy length tail: the flow series with cut chains and drains,
    # one sequence spanning several chunks, hits planted in long ones;
    # the route builds no block profiles, and every chunk takes K3's
    # flow form (its 1,024 lanes)
    def no_profiles(*a, **k):
        raise AssertionError("the flow route built block profiles")

    monkeypatch.setattr(tsw, "build_dprofile_series", no_profiles)
    forms = (tsw.sw_scores_stream_carry_flow, tsw.sw_scores_stream_carry_rows)
    took = []
    for name, fn in zip(("flow", "rows"), forms):
        def spy(*a, fn=fn, name=name, **k):
            took.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(tsw, f"sw_scores_stream_carry_{name}", spy)
    rng = np.random.default_rng(91)
    q = "".join(rng.choice(list(AA), 60))
    parts = [(f"s{i} rec {i}",
              "".join(rng.choice(list(AA), int(rng.integers(20, 120)))))
             for i in range(150)]
    parts[5] = ("s5 long", "".join(rng.choice(list(AA), 1500)) + q[10:55])
    parts[17] = ("s17 long", q[5:50] + "".join(rng.choice(list(AA), 900)))
    params = dict(gapopen=11, gapextend=1, descriptions=150, alignments=3,
                  expect=1e9)
    entries = ("swipe_carry_flow", "swipe_carry_rows")
    n = [trace.launched(e) for e in entries]
    (jeng, teng), hits = run_both(_fasta(parts), "aa", [q], 1, 3, params,
                                  nseqs=1024,
                                  attrs={"FLOW_MIN_AVG_LANE": 0})
    assert teng._flow_cols(1024) is not None and teng.chunks is not None
    assert len(teng._flow_chunks(1024)) > 3
    assert took == ["flow"] * len(teng._flow_chunks(1024))
    assert [trace.launched(e) for e in entries] == n   # the plain version
    got = {h[0]: h[1] for h in hits[0][0]}
    assert {5, 17} <= set(got)


def test_tblastn_translated_giant_matches_jax():
    # tblastn: a few-kbp "chromosome" whose six frames are giants at a
    # shrunk chunk height (the wavefront route), genes beside it; the
    # query's back-translation planted on both strands
    rng = np.random.default_rng(7)
    q = "".join(rng.choice(list(AA), 40))
    codon = {"A": "GCT", "R": "CGT", "N": "AAT", "D": "GAT", "C": "TGT",
             "Q": "CAA", "E": "GAA", "G": "GGT", "H": "CAT", "I": "ATT",
             "L": "CTG", "K": "AAA", "M": "ATG", "F": "TTT", "P": "CCG",
             "S": "TCT", "T": "ACC", "W": "TGG", "Y": "TAT", "V": "GTT"}
    nt = "".join(codon[c] for c in q)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(nt[:90]))
    chrom = ("".join(rng.choice(list(NT), 1500)) + nt
             + "".join(rng.choice(list(NT), 1301)) + rc
             + "".join(rng.choice(list(NT), 700)))
    parts = [(f"g{i} gene {i}",
              "".join(rng.choice(list(NT), int(rng.integers(60, 400)))))
             for i in range(10)]
    parts[3] = ("g3 gene with the query", "AC" + nt[30:] + "TTA")
    parts.append(("chr1 chromosome", chrom))
    params = dict(gapopen=11, gapextend=1, db_gencode=11, descriptions=30,
                  alignments=4, expect=1e9)
    (_, teng), hits = run_both(_fasta(parts), "nt", [q], 3, 3, params,
                               max_cols=1024)
    assert teng._giant_ids.size == 6              # the six frames
    assert teng._overlap_bound(64) > teng._max_cols // 2   # wavefront
    best = {}
    for h in hits[0][0]:
        best.setdefault(h[0], h[1])
    assert max(best, key=best.get) == 10
    frame = teng._unit_seqs[int(teng._giant_ids[0])]
    qa = preprocess_query("q", q, 3, 3).aa[0]
    assert best[10] == max(sw_numpy_many(qa, [teng._unit_seqs[int(i)]],
                                         teng.matrix.matrix, 11, 1)[0]
                           for i in teng._giant_ids)
    assert len(frame) > teng._max_cols


def test_batch_over_slot_batch_with_giant():
    # 17 queries: two slot groups, each followed by the giant route (the
    # wavefront, pinned: the cheapest route to run in interpret mode)
    rng = np.random.default_rng(43)
    parts = [(f"s{i} n", "".join(rng.choice(list(AA),
                                            int(rng.integers(30, 90)))))
             for i in range(8)]
    queries = ["".join(rng.choice(list(AA), 30)) for _ in range(17)]
    parts.append(("s8 giant", "".join(rng.choice(list(AA), 2600))
                  + queries[16] + "".join(rng.choice(list(AA), 200))))
    params = dict(gapopen=11, gapextend=1, descriptions=10, alignments=2,
                  expect=1e9)
    (_, teng), hits = run_both(
        _fasta(parts), "aa", queries, 1, 3, params, max_cols=2048,
        attrs={"SEGMENT_GIANTS": False})
    assert len(queries) > teng.SLOT_BATCH and teng._giant_ids.size == 1
    assert hits[16][0][0][0] == 8
