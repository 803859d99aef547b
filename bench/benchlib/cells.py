"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
lists its metrics; everything else sits in files of its own under
``bench/``, found by those names:

* ``bench/configs/<config>.json``: sizes, source, ``reduced``, ``assumed``;
* ``bench/traffic/<traffic>.json``: the settings of one traffic mix;
* ``bench/limits/<cell>.json``: the limits of the cell's correctness check;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric;
* ``bench/reference/<reference>.py``: the plain reference a configuration
  names.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries that hold in this cell
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: dict | None = None, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default) with
    its configuration, traffic mix and limits loaded."""
    spec = benchmark() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    config = load_json(bench / "configs" / f"{w['config']}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)],
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    """The module of ``bench/metrics/<name>.py``: a ``read(run)`` that
    returns the metric's value or None, and optionally ``DISPATCHER`` and
    ``cost(args, kwargs, out)`` for a kernel's roofline."""
    return load_module(bench / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def reference(config: dict, bench: Path = BENCH):
    """The plain reference module a configuration names."""
    name = config["reference"]
    return load_module(bench / "reference" / f"{name}.py", "bench_reference_" + name)
