"""BENCHMARK.json and the files it names, found by name."""

import re

import pytest
from tiny import BENCH, cells

SPEC = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    cell_names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", ())) <= cell_names, m["name"]


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = cells.find_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert {"variant", "batch_size", "fanouts", "buffer_frac", "store",
            "epochs_per_call"} <= set(cell.traffic)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert (BENCH / "reference" / "decisions" / f"{cell.traffic['variant']}.py").is_file()
    if cell.traffic["variant"] == "rudder":
        assert (BENCH / "reference" / "deciders" / f"{cell.traffic['decider']}.py").is_file()
    # Every cell reports setup_s and another end-to-end metric, and each of
    # its per-layer metrics moves one that it reports.
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    assert w["chips"] == 1


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = cells.load_json(BENCH.parent / c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    pub = cfg["published"]
    for key in pub:
        assert (cfg[key] != pub[key]) == (key in cfg["reduced"]), key
    # Only scale is cut: the average degree and the train share stay.
    for num, den in (("num_edges", "num_nodes"), ("train_nodes", "num_nodes")):
        assert abs(cfg[num] / cfg[den] / (pub[num] / pub[den]) - 1) < 1e-4, num
    cells.reference(cfg)
    tiny = cfg["tiny"]
    assert set(tiny) == {"num_nodes", "batch_size"}
    assert 0 < tiny["num_nodes"] <= cfg["num_nodes"] and 0 < tiny["batch_size"]
    if "agent" in cfg:
        assert {"source", "reduced", "assumed"} <= set(cfg["agent"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    reader = cells.metric_reader(m["name"])
    assert callable(reader.read)
    if hasattr(reader, "DISPATCHER"):
        assert callable(reader.cost)
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_unknown_cell():
    with pytest.raises(KeyError):
        cells.find_cell("no-such-cell")
