"""Readings that the limits of a cell's check are set from.

    python3 bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and warm-up call, the
call that the window would start with, then the check against the
reference, and the same check of the control (the reference in TF32 put
in the program's place) and of two faults planted in the reference (half
of each PE's batch left out; PE 0's gradient applied alone, the exchange
between PEs left out). A state left unchanged reads 1 on the parameters'
change and needs no run. Prints one JSON line per seed. Runs no window;
the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))

from benchlib import cells  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchlib.runner import run_cell

    cell = cells.find_cell(args.workload)
    for seed in args.seeds:
        out = run_cell(cell, seed, 0, False, device=args.device, window=False, controls=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": out.correct,
                          "program": out.numbers, "controls": out.controls}, default=float),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
