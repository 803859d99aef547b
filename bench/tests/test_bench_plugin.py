"""A new decider's cell goes in as added files only.

A copy of ``bench/`` and ``BENCHMARK.json`` gains, as new files, a stub
agent's rules (``plugin/stub-agent.py``: a seeded plain-torch scorer
that gives margins), a configuration with an ``agent`` section, a
traffic mix, a limits file and the entries that name them; the stub's
program form is registered as a backend of the port (``plugin/drive.py``).
The copy's harness, unedited, runs the cell correct at its tiny size on
the CPU, follows a tie and counts it, and catches a decision turned
against its margin and a margin moved past its limit.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
from tiny import BENCH, cells

ROOT = BENCH.parent
CELL = "products-stub"
SKIP = shutil.ignore_patterns("__pycache__", "_cache")
LIMITS = {**cells.load_json(BENCH / "limits" / "products-rudder.json"),
          "agent_margin_gap": 1e-4, "decision_ties": 8}


def add_stub(root):
    """The stub's cell added, as files only, to the copy at ``root``."""
    bench = root / "bench"
    shutil.copy(BENCH / "tests" / "plugin" / "stub-agent.py",
                bench / "reference" / "deciders" / "stub-agent.py")
    cfg = cells.load_json(BENCH / "configs" / "sage-products.json")
    cfg["name"] = "stub-products"
    cfg["tiny"] = {"num_nodes": 12_000, "batch_size": 32}
    cfg["agent"] = {"hidden": 16, "source": "a stub: no published model",
                    "reduced": [], "assumed": ["a seeded random scorer of the step's metrics"]}
    (bench / "configs" / "stub-products.json").write_text(json.dumps(cfg, indent=2))
    traffic = {**cells.load_json(BENCH / "traffic" / "rudder-async.json"),
               "decider": "stub-agent"}
    (bench / "traffic" / "stub-async.json").write_text(json.dumps(traffic, indent=2))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS, indent=2))
    spec = cells.benchmark()
    spec["configs"].append({"name": "stub-products", "source": cfg["source"],
                            "file": "bench/configs/stub-products.json", "reduced": [],
                            "why": "the files-only test's stub agent"})
    spec["workloads"].append({"name": CELL, "config": "stub-products",
                              "traffic": "stub-async", "chips": 1,
                              "why": "the files-only test's stub agent"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("plugin")
    shutil.copytree(BENCH, root / "bench", ignore=SKIP)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    add_stub(root)
    return root


@pytest.fixture(scope="module")
def runs(copy):
    drive = copy / "bench" / "tests" / "plugin" / "drive.py"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, str(drive), "--src", str(ROOT / "src"), "--workload", CELL,
         "--scenarios", "sound", "tie", "all_ties", "flip", "shift"],
        cwd=copy, capture_output=True, text=True, timeout=600, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    return {r["scenario"]: r for r in lines}


def test_the_copy_keeps_every_file_it_had(copy, runs):
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and "_cache" not in path.parts:
            twin = copy / "bench" / path.relative_to(BENCH)
            assert twin.read_bytes() == path.read_bytes(), path
    spec, grown = cells.benchmark(), cells.benchmark(copy)
    for key in spec:
        if isinstance(spec[key], list) and key != "command" and key != "paths":
            assert grown[key][: len(spec[key])] == spec[key], key
        else:
            assert grown[key] == spec[key], key


def test_the_stub_cell_is_correct(runs):
    r = runs["sound"]
    assert r["correct"], r["checks"]
    assert r["numbers"]["decision_mismatch"] == 0
    assert r["numbers"]["decision_ties"] == 0
    assert r["numbers"]["agent_margin_gap"] <= LIMITS["agent_margin_gap"]


def test_a_tie_is_followed_and_counted(runs):
    r = runs["tie"]
    assert r["correct"], r["checks"]
    assert r["numbers"]["decision_mismatch"] == 0
    assert 1 <= r["numbers"]["decision_ties"] <= LIMITS["decision_ties"]


def test_an_agent_at_a_tie_on_every_answer_is_not_correct(runs):
    r = runs["all_ties"]
    assert r["numbers"]["decision_mismatch"] == 0
    assert r["numbers"]["decision_ties"] > LIMITS["decision_ties"]
    assert not r["correct"]


def test_a_decision_against_its_margin_is_caught(runs):
    r = runs["flip"]
    assert r["numbers"]["decision_mismatch"] >= 1
    assert not r["correct"]


def test_a_margin_past_its_limit_is_caught(runs):
    r = runs["shift"]
    assert r["numbers"]["decision_mismatch"] == 0
    assert r["checks"]["agent_margin_gap"]["value"] > r["checks"]["agent_margin_gap"]["limit"]
    assert not r["correct"]


@pytest.mark.parametrize("drop", ["agent_margin_gap", "decision_ties"])
def test_limits_without_the_margin_numbers_are_refused(copy, drop):
    path = copy / "bench" / "limits" / f"{CELL}.json"
    kept = path.read_text()
    try:
        path.write_text(json.dumps({k: v for k, v in LIMITS.items() if k != drop}))
        with pytest.raises(ValueError, match=drop):
            cells.find_cell(CELL, cells.benchmark(copy), bench=copy / "bench")
    finally:
        path.write_text(kept)
    assert cells.find_cell(CELL, cells.benchmark(copy), bench=copy / "bench").limits == LIMITS


def test_a_decider_with_no_file_is_refused(copy):
    spec = cells.benchmark(copy)
    traffic = copy / "bench" / "traffic" / "stub-async.json"
    kept = traffic.read_text()
    try:
        traffic.write_text(json.dumps({**json.loads(kept), "decider": "no-such-agent"}))
        with pytest.raises(FileNotFoundError, match="deciders/no-such-agent.py"):
            cells.find_cell(CELL, spec, bench=copy / "bench")
    finally:
        traffic.write_text(kept)
