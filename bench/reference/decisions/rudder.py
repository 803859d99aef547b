"""Decisions of the ``rudder`` variant in ``async`` mode: what every Rudder
agent shares, worked out again from the program's asynchronous request
queue (``core/queues.py``) and the agent's memory (``core/agent.py``),
importing nothing of the program. The rules that answer a request are
the decider's, from ``bench/reference/deciders/<decider>.py``.

Per PE an agent keeps the hit shares it was asked with (the last 16)
and its decisions (the last 64), each closed by the hit share of the
next request; they carry from call to call. Within a call, a request
made with step t's metrics is answered at step t + 2; steps in between
ask nothing, and the answered queue takes the current step's metrics.

A decider that gives margins (a model's answer, the score of replace
over skip) can sit at a tie, where rounding decides. At an answer whose
margin is within ``tie`` of 0 the agent takes the program's decision for
that step and PE, records it as its own, and says it followed.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

DECIDERS = Path(__file__).resolve().parent.parent / "deciders"


class Agent:
    LATENCY = 2.0     # steps from a request to its answer

    def __init__(self, rules):
        self.rules = rules
        self.recent: list[float] = []
        self.history: list[list] = []  # [replace, hits before, hits after]
        self.new_call()

    def new_call(self) -> None:
        """An empty request queue."""
        self.pending, self.ready = None, 0.0

    def tick(self, t: int, m: dict, program: bool | None = None,
             tie: float | None = None) -> tuple[bool, float | None, bool]:
        """Step t with its metrics ``m``: ``(replace, margin, followed)``,
        ``margin`` None where no answer came or the rules give none."""
        out = (False, None, False)
        if self.pending is not None and t >= self.ready:
            out = self.answer(self.pending, program, tie)
            self.pending = None
        if self.pending is None:
            self.pending, self.ready = m, t + self.LATENCY
        return out

    def answer(self, m: dict, program, tie) -> tuple[bool, float | None, bool]:
        self.recent = (self.recent + [m["pct_hits"]])[-16:]
        for h in self.history:
            if h[2] is None:
                h[2] = m["pct_hits"]
        replace, margin = self.rules.ask(m, self.recent, self.history)
        followed = (margin is not None and tie is not None and program is not None
                    and abs(margin) <= tie)
        if followed:
            replace = bool(program)
        self.history = (self.history + [[replace, m["pct_hits"], None]])[-64:]
        return bool(replace), margin, followed


def load_rules(name: str):
    """The module of ``bench/reference/deciders/<name>.py``."""
    path = DECIDERS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no rules for the decider {name!r}: looked for {path}")
    spec = importlib.util.spec_from_file_location(f"bench_decider_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(traffic: dict, num_pes: int, agent: dict | None = None, seed: int = 0):
    if traffic["mode"] != "async":
        raise NotImplementedError(f"no reference decisions for {traffic!r}")
    rules = load_rules(traffic["decider"]).make(traffic, num_pes, agent, seed)
    return [Agent(r) for r in rules]
