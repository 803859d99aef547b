"""The program's side of the files-only test: the stub agent's program
form, registered as a backend of the port, and the runs of its cell.

    python drive.py --src <repo>/src --workload <cell> --scenarios sound tie ...

Run from a copy of ``bench/`` (this file's grandparent) to which the
test has added the stub's files. The program gives its trace hook each
PE's answer margin a step (``agent_margins``) as a program that serves
a model would. Each scenario runs the cell once at its ``tiny`` size on
the CPU, with no window, and prints one JSON line: ``correct``, the
checks and the numbers.

* ``sound``: the cell as its files state it;
* ``tie``: a request at minibatch 0 answered at a tie (margin 0), which
  the program's form reads as replace and the reference's as skip;
* ``all_ties``: every answer at a tie (the margins scaled by 0);
* ``flip``: the program's answer to minibatch 0's request turned
  against its margin;
* ``shift``: the margin the program reports for minibatch 0's request
  moved by 0.5, its answer kept.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent.parent.parent
SEED = 2**31 + 91


class StubBackend:
    """The stub agent's program form: the reference's scorer, written
    again, answering Rudder's prompts with its margin in the JSON."""

    name = "stub-agent"
    latency = 2.0
    flip_at: int | None = None
    shift_at: int | None = None

    def __init__(self, seed, hidden, scale=1.0, tie_at=None):
        g = torch.Generator().manual_seed(int(seed))
        self.w1 = torch.randn(int(hidden), 6, generator=g, dtype=torch.float32)
        self.w2 = torch.randn(int(hidden), generator=g, dtype=torch.float32)
        self.scale, self.tie_at = float(scale), tie_at

    def generate(self, prompt, metrics, history, graph, recent_hits):
        x = torch.tensor([metrics.pct_hits / 100.0,
                          metrics.comm_volume / max(metrics.buffer_capacity, 1),
                          metrics.buffer_occupancy, metrics.replaced_pct / 100.0,
                          metrics.progress, 1.0], dtype=torch.float32)
        if self.tie_at is not None and metrics.minibatch == self.tie_at:
            margin = 0.0
        else:
            margin = self.scale * float(self.w2 @ torch.tanh(self.w1 @ x))
        replace = margin >= 0.0
        if metrics.minibatch == self.flip_at:
            replace = not replace
        if metrics.minibatch == self.shift_at:
            margin += 0.5
        return json.dumps({"action": "replace" if replace else "skip",
                           "expected_hits": "flat", "reason": "stub", "margin": margin})


class MarginStream:
    """The trace hook driven as the program would drive it with each PE's
    answer margin a step: the margin of an answer that came this step,
    NaN elsewhere."""

    def __init__(self, recorder, controllers):
        self.recorder = recorder
        self.seen = [len(c.agent.decisions) for c in controllers]

    def record_step(self, **kw):
        margins = []
        for p, ctrl in enumerate(kw["controllers"]):
            made = ctrl.agent.decisions
            fresh = len(made) > self.seen[p]
            margins.append(json.loads(made[-1].raw)["margin"] if fresh else float("nan"))
            self.seen[p] = len(made)
        self.recorder.record_step(agent_margins=np.array(margins), **kw)

    def __getattr__(self, name):
        return getattr(self.recorder, name)


def install() -> None:
    from repro_torch.core import backends
    from repro_torch.gnn.train import DistributedTrainer

    backends.REGISTRY["stub-agent"] = StubBackend
    original = DistributedTrainer.make_trace_recorder

    def make_trace_recorder(self):
        recorder = original(self)
        return None if recorder is None else MarginStream(recorder, self.controllers)

    DistributedTrainer.make_trace_recorder = make_trace_recorder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--scenarios", nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH / "tests"), args.src]
    torch.set_num_threads(2)
    from benchlib.runner import run_cell
    from tiny import tiny

    install()
    for scenario in args.scenarios:
        cell = tiny(args.workload)
        agent = cell.config["agent"]
        StubBackend.flip_at = 0 if scenario == "flip" else None
        StubBackend.shift_at = 0 if scenario == "shift" else None
        if scenario == "tie":
            agent["tie_at"] = 0
        elif scenario == "all_ties":
            agent["scale"] = 0.0
        out = run_cell(cell, SEED, 0, False, device="cpu", window=False)
        print(json.dumps({"scenario": scenario, "correct": out.correct, "checks": out.checks,
                          "numbers": out.numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
