"""A/B of the port's training step on one NVIDIA card.

Runs ``chip_smoke.py``'s phase-3 configuration (the raw loop: products
``scale=10``, 4 trainers, batch 2000, fanouts (10, 25), rudder variant, 3
epochs of GraphSAGE training on ``device="cuda"``) from two source trees
of ``repro_torch``, one process per run, in the order A, B, B, A, and
prints the host-clock medians of each run's ``step`` and ``train`` spans
(ms per step) and one JSON line of them. Compare A and B only within one
call, on one card.

    python3 src/repro_torch/gnn/train_ab.py --a OLD/src --b src

Each run prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict


class _Spans:
    """The smallest telemetry session the port's hooks accept: host seconds
    per span name, no kernel profiling."""

    profile_kernels = False

    def __init__(self):
        self.tracer = self
        self.registry = self
        self.seconds = defaultdict(list)

    def span(self, name, pe=-1, plane="", nbytes=0):
        return _Span(self, name)

    def begin(self, name, pe=-1, plane=""):
        return _Span(self, name).__enter__()

    def counter(self, name, shape=None):
        return self

    def add(self, value):
        pass


class _Span:
    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.seconds[self.name].append(time.perf_counter() - self.t0)
        return False


def run_one(src: str) -> dict:
    # Run as a script, this file's own directory heads sys.path: the tree
    # under test takes its place.
    sys.path[0] = src
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    if not torch.cuda.is_available():
        raise SystemExit("train_ab: no CUDA device")
    parts = partition_graph(generate("products", seed=0, scale=10), 4)
    trainer = DistributedTrainer(
        parts, device="cuda", variant="rudder", deciders=["gemma3-4b"],
        mode="async", batch_size=2000, fanouts=(10, 25), hidden_dim=64,
        buffer_frac=0.25, train_model=True, epochs=3,
    )
    spans = _Spans()
    torch.cuda.synchronize()
    with telemetry.active(spans):
        result = trainer.run()
    torch.cuda.synchronize()
    return {
        "src": src,
        "steps": len(result.losses),
        "step_ms_median": 1e3 * float(np.median(spans.seconds["step"])),
        "train_ms_median": 1e3 * float(np.median(spans.seconds["train"])),
        "train_ms_all": [round(1e3 * s, 3) for s in spans.seconds["train"]],
        "loss_last": float(result.losses[-1]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="source tree A (the directory holding repro_torch)")
    ap.add_argument("--b", help="source tree B")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    runs = []
    for tag, src in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        out = subprocess.run(
            [sys.executable, __file__, "--one", src],
            capture_output=True, text=True, check=True, timeout=900,
        ).stdout.strip().splitlines()[-1]
        row = dict(json.loads(out), tag=tag)
        runs.append(row)
        print(f"{tag} ({src}): step {row['step_ms_median']:.3f} ms, train "
              f"{row['train_ms_median']:.3f} ms (medians over {row['steps']} steps)")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
