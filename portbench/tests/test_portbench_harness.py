"""The harness end to end on the CPU (``--rehearse``), in a copy of the
benchmark's folder: a toy configuration, mix and metric added as new
files are found by name, and a run whose timed path is broken reads as
not correct."""

import json
import os
import shutil

import pytest
import torch

from portbench import harness, workload

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY_METRIC = '''"""Queries served in the window (a toy metric)."""


def read(run):
    return float(sum(r.queries for r in run.requests))
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A copy of the folder with a toy cell of new files only."""
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(HERE, "configs", "swissprot-blastp.json")) as f:
        c = json.load(f)
    c["name"] = "toy-blastp"
    del c["rehearsal"]
    c["database"].update(sequences=150, longest=100, length_model={
        "mu": 3.7, "sigma": 0.3, "min": 20, "max": 80})
    (pb / "configs" / "toy-blastp.json").write_text(json.dumps(c))
    (pb / "traffic" / "toy4.json").write_text(json.dumps(
        {"batch": 4, "length": [1, 60], "pool": 4, "rounds": 1,
         "check": 4}))
    (pb / "metrics" / "toy_served.py").write_text(TOY_METRIC)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "toy-blastp.toy4",
                              "config": "toy-blastp", "traffic": "toy4",
                              "chips": 1, "why": "a toy"})
    spec["per_layer"].append({"name": "toy_served", "unit": "queries",
                              "better": "higher", "source": "host_clock",
                              "layer": "CLI and report",
                              "moves": "gcups_wall",
                              "workloads": ["toy-blastp.toy4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "HERE", str(pb))
    monkeypatch.setattr(workload, "HERE", str(pb))
    torch.set_num_threads(2)
    return tmp_path


def run(capsys, *args):
    rc = harness.main(["--workload", "toy-blastp.toy4", "--seed",
                       str(2**31 + 17), "--seconds", "0.1", "--rehearse",
                       *args])
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    run.err = cap.err
    return rc, json.loads(out[-1])


def test_new_files_are_found_by_name(toy, capsys):
    rc, res = run(capsys, "--trace", "1")
    assert rc == 0 and res["correct"]
    assert res["metrics"]["toy_served"]["value"] >= 4
    assert list(res)[-1] == "checks"
    rc, res = run(capsys, "--trace", "0")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"gcups_wall", "setup_s"}
    assert res["attempted"] >= 4 and res["failed"] == 0


def test_an_altered_answer_is_not_correct(toy, capsys, monkeypatch):
    from swipe_tpu_torch.hits import HitList
    orig = HitList.finalize

    def finalize(self):
        orig(self)
        if self.hits:
            self.hits[-1].score += 1

    monkeypatch.setattr(HitList, "finalize", finalize)
    rc, res = run(capsys, "--trace", "0")
    assert rc == 0 and not res["correct"]
    assert res["checks"]["lists_wrong"]["value"] > 0


def test_half_the_batch_left_out_is_not_correct(toy, capsys, monkeypatch):
    from swipe_tpu_torch.pipeline import SearchEngine
    orig = SearchEngine.search_batch

    def search_batch(self, queries, timings=None):
        half = len(queries) // 2
        rest = self._hitlists(queries[half:])
        for h in rest:
            h.finalize()
        return orig(self, queries[:half], timings) + rest

    monkeypatch.setattr(SearchEngine, "search_batch", search_batch)
    rc, res = run(capsys, "--trace", "0")
    assert rc == 0 and not res["correct"], run.err


def test_a_failed_request_is_not_correct(toy, capsys, monkeypatch):
    from swipe_tpu_torch.pipeline import SearchEngine
    orig = SearchEngine._align_phase
    calls = []

    def align_phase(self, *a, **k):
        calls.append(1)
        if len(calls) > 1:       # warm-up passes, the window fails
            raise RuntimeError("planted")
        return orig(self, *a, **k)

    monkeypatch.setattr(SearchEngine, "_align_phase", align_phase)
    rc, res = run(capsys, "--trace", "0")
    assert rc == 0 and not res["correct"]
    assert res["failed"] >= 1
    assert res["checks"]["requests_failed"]["value"] >= 1


def test_a_symtype_without_a_mode_module_raises(toy, capsys):
    """A configuration of a search mode that ``modes/`` does not know is
    refused before anything runs."""
    path = os.path.join(harness.HERE, "configs", "toy-blastp.json")
    with open(path) as f:
        c = json.load(f)
    c["symtype"] = 5                     # SWIPE's sound mode
    with open(path, "w") as f:
        json.dump(c, f)
    with pytest.raises(ValueError, match="modes/symtype5.py"):
        harness.main(["--workload", "toy-blastp.toy4", "--seed", "1",
                      "--seconds", "0.1", "--rehearse"])
    assert capsys.readouterr().out == ""


def test_a_new_mode_module_is_found_by_name(toy):
    """A mode module added as a file is what the harness and the reference
    use for its symtype."""
    pb = harness.HERE
    src = open(os.path.join(pb, "modes", "blastp.py")).read()
    toy_src = src.replace("SYMTYPE = 1", "SYMTYPE = 4").replace(
        "return len(query) * residues", "return 9 * len(query) * residues")
    with open(os.path.join(pb, "modes", "tblastx.py"), "w") as f:
        f.write(toy_src)
    mode = workload.load_mode({"name": "toy", "symtype": 4})
    assert mode.SYMTYPE == 4 and mode.cells(b"ACD", {}, 10) == 270
    with open(os.path.join(pb, "modes", "tblastx.py"), "w") as f:
        f.write(src)                     # a module of another symtype
    with pytest.raises(ValueError, match="symtype 1, not 4"):
        workload.load_mode({"name": "toy", "symtype": 4})


def test_no_card_no_result(toy, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "toy-blastp.toy4", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names():
    ok = ["swipe_tpu_torch", "swipe_tpu_torch.pipeline", "jaxtyping",
          "portbench.check", "numpy"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["swipe_tpu.alphabet", "jax",
                                           "flax.linen"]) == [
        "flax", "jax", "swipe_tpu"]
