"""A stub agent, the reference's form, for the files-only test: a seeded
two-layer scorer of the step's metrics in plain torch whose output is
the margin of replace over skip. The test adds it to a copy of the
benchmark as ``bench/reference/deciders/stub-agent.py``.

Settings (the configuration's ``agent``): ``hidden`` (the scorer's
width), ``scale`` (multiplies the margin), ``tie_at`` (a request made at
this minibatch is answered with the margin 0: a tie, where the program's
form replaces and this one skips).
"""

from __future__ import annotations

import numpy as np
import torch

#: The program's stream of each PE's answer margin a step (NaN where no
#: answer came).
STREAMS = ("agent_margins",)


def features(m: dict) -> torch.Tensor:
    return torch.tensor([m["pct_hits"] / 100.0, m["comm"] / max(m["capacity"], 1),
                         m["occupancy"], m["replaced_pct"] / 100.0, m["progress"], 1.0],
                        dtype=torch.float32)


class Scorer:
    def __init__(self, agent: dict):
        g = torch.Generator().manual_seed(int(agent["seed"]))
        hidden = int(agent["hidden"])
        self.w1 = torch.randn(hidden, 6, generator=g, dtype=torch.float32)
        self.w2 = torch.randn(hidden, generator=g, dtype=torch.float32)
        self.scale = float(agent.get("scale", 1.0))
        self.tie_at = agent.get("tie_at")

    def ask(self, m: dict, recent: list, history: list) -> tuple[bool, float]:
        if self.tie_at is not None and m["minibatch"] == self.tie_at:
            margin = 0.0
        else:
            margin = self.scale * float(self.w2 @ torch.tanh(self.w1 @ features(m)))
        return margin > 0.0, margin


def make(traffic: dict, num_pes: int, agent: dict | None, seed: int):
    if agent is None:
        raise ValueError("the stub agent needs the configuration's agent settings")
    return [Scorer(agent) for _ in range(num_pes)]


def numbers(program_streams: list, reference_margins: list) -> dict:
    """``agent_margin_gap``: the largest gap between the program's margin
    and the reference's over the answers the reference gave; an answer
    whose margin the program did not report reads infinite."""
    gap = 0.0
    for prog, ref in zip(program_streams, reference_margins):
        for t, r in enumerate(ref):
            answered = ~np.isnan(r)
            if not answered.any():
                continue
            if t >= len(prog) or "agent_margins" not in prog[t]:
                return {"agent_margin_gap": float("inf")}
            p = np.asarray(prog[t]["agent_margins"], dtype=np.float64)[answered]
            if np.isnan(p).any():
                return {"agent_margin_gap": float("inf")}
            gap = max(gap, float(np.abs(p - r[answered]).max()))
    return {"agent_margin_gap": gap}
