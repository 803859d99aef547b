"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
lists its metrics; everything else sits in files of its own under
``bench/``, found by those names, so that a new cell, variant, decider
or metric goes in as added files:

* ``bench/configs/<config>.json``: sizes, source, ``reduced``, ``assumed``,
  ``tiny`` (the sizes of the CPU tests), and optionally ``agent``: the
  settings of the traffic's decider (its widths, layers held, dtype),
  with their own ``source``, ``reduced`` and ``assumed``;
* ``bench/traffic/<traffic>.json``: the settings of one traffic mix,
  ``variant`` and ``decider`` among them;
* ``bench/limits/<cell>.json``: the limits of the cell's correctness check;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric (a split
  metric ``<base>.<part>`` without a file of its own reads with
  ``<base>.py``); a metric without ``workloads`` holds in the cells that
  report the end-to-end metric it ``moves``;
* ``bench/reference/<reference>.py``: the plain reference a configuration
  names; its ``decisions/<variant>.py``: the variant's decisions;
* ``bench/reference/deciders/<decider>.py``: the rules of the decider a
  traffic mix names (``make(traffic, num_pes, agent, seed)``, one object
  a PE whose ``ask(m, recent, history)`` gives ``(replace, margin)``),
  optionally ``STREAMS`` (the program's further per-step streams that
  the harness keeps) and ``numbers(program_streams, reference_margins)``
  (further numbers of the check). A decider with ``numbers`` gives
  margins, and its cells' limits have to hold ``agent_margin_gap`` and
  ``decision_ties``.
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
    decider: object = None  # the module of the traffic's decider, if any


#: The limits a cell whose decider gives margins must hold: how far the
#: program's margins may lie from the reference's, and how many answers
#: may sit within that of a tie, where the reference follows the program.
MARGIN_LIMITS = ("agent_margin_gap", "decision_ties")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def per_layer_applies(metric: dict, cell: str, end_to_end: list) -> bool:
    """A per-layer metric holds in the cells its ``workloads`` lists, or,
    without that key, in every cell that reports the end-to-end metric
    it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in {m["name"] for m in end_to_end}


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
    mod = decider(traffic, bench)
    if mod is not None and hasattr(mod, "numbers"):
        lack = [k for k in MARGIN_LIMITS if k not in limits]
        if lack:
            raise ValueError(f"{name}: the decider {traffic['decider']!r} gives margins, "
                             f"but bench/limits/{name}.json has no {' or '.join(lack)}")
    end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=end_to_end,
        per_layer=[m for m in spec["per_layer"] if per_layer_applies(m, name, end_to_end)],
        decider=mod,
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
    ``cost(args, kwargs, out)`` for a kernel's roofline. A split metric
    ``<base>.<part>`` (the same quantity in cells that report another
    end-to-end metric) with no file of its own reads with ``<base>``'s."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        base = name.rsplit(".", 1)[0]
        path = bench / "metrics" / f"{base}.py"
        name = base
    return load_module(path, "bench_metric_" + name.replace(".", "_"))


def reference(config: dict, bench: Path = BENCH):
    """The plain reference module a configuration names."""
    name = config["reference"]
    return load_module(bench / "reference" / f"{name}.py", "bench_reference_" + name)


def decider(traffic: dict, bench: Path = BENCH):
    """The module of ``bench/reference/deciders/<decider>.py`` for the
    traffic's decider, None where the traffic names none; a decider with
    no file is refused, the error naming the file looked for."""
    name = traffic.get("decider")
    if not name:
        return None
    path = bench / "reference" / "deciders" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no rules for the decider {name!r}: looked for {path}")
    return load_module(path, "bench_decider_" + name.replace("-", "_").replace(".", "_"))
