"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import cells  # noqa: E402

#: Every cell of BENCHMARK.json, each tested at its configuration's
#: ``tiny`` sizes.
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2**31 + 77


def cut(cell: cells.Cell) -> cells.Cell:
    """``cell`` at its configuration's ``tiny`` sizes: the graph's nodes
    (papers needs more for its 1% train split to give every PE a full
    batch) and the batch. Edges and train nodes are cut in proportion to
    the nodes, so the average degree stays."""
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    cfg = cell.config
    nodes, batch = int(cfg["tiny"]["num_nodes"]), int(cfg["tiny"]["batch_size"])
    share = nodes / cfg["num_nodes"]
    cfg["num_edges"] = round(cfg["num_edges"] * share)
    cfg["train_nodes"] = round(cfg["train_nodes"] * share)
    cfg["num_nodes"] = nodes
    cell.traffic["batch_size"] = batch
    return cell


def tiny(name: str) -> cells.Cell:
    return cut(cells.find_cell(name))
