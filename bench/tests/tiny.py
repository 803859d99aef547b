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

#: Per cell: the graph's nodes (papers needs more for its 1% train split
#: to give every PE a full batch) and the batch. Edges and train nodes
#: are cut in proportion to the nodes, so the average degree stays.
SIZES = {"products-rudder": (12_000, 64), "products-distdgl": (12_000, 64),
         "papers-store-rudder": (110_000, 64)}
SEED = 2**31 + 77


def tiny(name: str) -> cells.Cell:
    cell = cells.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    nodes, batch = SIZES[name]
    cfg = cell.config
    share = nodes / cfg["num_nodes"]
    cfg["num_edges"] = round(cfg["num_edges"] * share)
    cfg["train_nodes"] = round(cfg["train_nodes"] * share)
    cfg["num_nodes"] = nodes
    cell.traffic["batch_size"] = batch
    return cell
