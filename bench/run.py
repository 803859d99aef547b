"""The benchmark of the PyTorch / CUDA port's GNN training loop.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on one card (see
``bench/benchlib/runner.py``) and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error). Exits non-zero, and
prints no result, without a card, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

#: Kernel and extension caches at fixed paths inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(BENCH / "_cache" / sub))

#: One thread in every library's pool. The host paces the loop from one
#: process on cores it may share; a parallel region on the host waits for
#: its slowest thread, so a run's speed would follow the other load.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

from benchlib import cells, imports  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(out) -> dict:
    line = {
        "correct": out.correct,
        "attempted": out.attempted,
        "failed": 0,
        "metrics": out.metrics,
        "device": out.device,
    }
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = out.checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = cells.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark runs only on a card", file=sys.stderr)
        return 2
    from benchlib.runner import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = imports.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
