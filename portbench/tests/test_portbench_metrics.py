"""The metrics' arithmetic on synthetic requests and a synthetic device
timeline."""

import math

import pytest

from portbench import harness, timeline, workload
from portbench.harness import Request, Run


def reader(name):
    return workload.load_module("metrics", name).read


def test_p90_is_nearest_rank():
    assert harness.percentile(range(1, 101), 0.9) == 90
    assert harness.percentile(range(1, 11), 0.9) == 9
    assert harness.percentile([5.0], 0.9) == 5.0
    # at least ten samples beyond p90 need at least 100 requests
    v = list(range(100))
    assert sum(x > harness.percentile(v, 0.9) for x in v) == 10


def test_per_query_spans_and_program_meter():
    reqs = [Request(0.0, 1.0, queries=2, cells=4 * 10**9,
                    prog_cells=4e9, prog_scoring_s=0.5, align_s=0.2,
                    report_s=0.1),
            Request(1.0, 3.0, queries=1, cells=2 * 10**9,
                    prog_cells=2e9, prog_scoring_s=1.5, align_s=0.4,
                    report_s=0.05)]
    run = Run(reqs)
    assert reader("report_ms")(run) == pytest.approx(1e3 * 0.15 / 3)
    assert reader("align_ms")(run) == pytest.approx(1e3 * 0.6 / 3)
    assert reader("scoring_gcups")(run) == pytest.approx(6e9 / 2.0 / 1e9)
    # no trace: the device metrics have nothing to read
    assert reader("device_idle")(run) is None
    assert reader("score_roofline")(run) is None


def synthetic():
    ms = 10**6
    spans = {"window": [(0, 100 * ms)],
             "request": [(0, 50 * ms), (50 * ms, 100 * ms)],
             "search": [(0, 40 * ms), (50 * ms, 90 * ms)],
             "scoring": [(0, 30 * ms), (50 * ms, 80 * ms)],
             "align": [(30 * ms, 40 * ms), (80 * ms, 90 * ms)],
             "report": [(40 * ms, 50 * ms), (90 * ms, 100 * ms)]}
    ops = [("K2", 5 * ms, 20 * ms), ("topk", 15 * ms, 25 * ms),
           ("K2", 55 * ms, 70 * ms), ("Memcpy DtoH", 70 * ms, 72 * ms),
           ("K4", 82 * ms, 84 * ms), ("K2", 99 * ms, 120 * ms)]
    return timeline.Timeline(spans["window"][0], ops, spans)


def test_timeline_busy_idle_and_gaps():
    tl = synthetic()
    ms = 10**6
    # merged and clipped to the window: 5-25, 55-72, 82-84, 99-100
    assert tl.busy == [(5 * ms, 25 * ms), (55 * ms, 72 * ms),
                       (82 * ms, 84 * ms), (99 * ms, 100 * ms)]
    run = Run([], tl)
    assert reader("device_idle")(run) == pytest.approx(100 * (1 - 40 / 100))
    assert tl.busy_in("scoring") == (20 + 17) * ms
    idle = dict(tl.idle_by_span())
    # gaps: 0-5 scoring, 25-55 (mid 40: report starts at 40), 72-82 (mid
    # 77: scoring), 84-99 (mid 91.5: report)
    assert idle["scoring (2 gaps)"] == pytest.approx(0.015)
    assert idle["report (2 gaps)"] == pytest.approx(0.045)
    top = dict(tl.top_ops())
    assert top["K2"] == pytest.approx(0.031)
    assert top["topk"] == pytest.approx(0.010)


def test_roofline_least_time():
    from portbench.metrics import score_roofline as sr
    tl = synthetic()
    cells = 10**12
    run = Run([Request(0, 0.1, queries=1, cells=cells)], tl)
    least = cells * 3 / 33.5e12
    assert reader("score_roofline")(run) == pytest.approx(
        100 * least / 0.037)
    assert sr.INSTRUCTIONS_PER_CELL == 3 and sr.ISSUE_RATE == 33.5e12


def test_end_to_end_counts_every_request_over_the_window():
    reqs = [Request(0.0, 2.0, queries=1, cells=10**10),
            Request(2.0, 2.5, queries=1, cells=10**9)]
    e2e = harness.end_to_end(reqs, 2.5, 30.0)
    assert math.isclose(e2e["gcups_wall"], 4.4)
    assert e2e["query_s_p90"] == 2.0 and e2e["setup_s"] == 30.0


def test_merge_and_intersect():
    assert timeline.merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4),
                                                                (5, 8)]
    assert timeline.intersect([(0, 10), (20, 30)], [(5, 25)]) == [
        (5, 10), (20, 25)]
    assert timeline.clip([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]
