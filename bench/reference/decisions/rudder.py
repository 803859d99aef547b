"""Decisions of the ``rudder`` variant with the ``gemma3-4b`` decider in
``async`` mode, worked out again from the rules the program states
(``core/backends.py``'s surrogate of the paper's Gemma3-4B agent and the
asynchronous request queue of ``core/queues.py``), importing nothing of
the program.

Per PE an agent keeps the hit shares it was asked with (the last 16)
and its decisions (the last 64), each closed by the hit share of the
next request; they carry from call to call. Within a call, a request
made with step t's metrics is answered at step t + 2; steps in between
ask nothing, and the answered queue takes the current step's metrics.
"""

from __future__ import annotations


class Agent:
    LATENCY = 2.0     # steps from a request to its answer
    LOW_HITS = 50.0   # a hit share (%) below this asks for a refresh
    TOL = 1.0         # %-points: a trend within this is flat
    ENDGAME = 0.92    # no replacement past this share of the call

    def __init__(self):
        self.recent: list[float] = []
        self.history: list[list] = []  # [replace, hits before, hits after]
        self.new_call()

    def new_call(self) -> None:
        """An empty request queue."""
        self.pending, self.ready = None, 0.0

    def tick(self, t: int, m: dict) -> bool:
        answer = False
        if self.pending is not None and t >= self.ready:
            answer = self.ask(self.pending)
            self.pending = None
        if self.pending is None:
            self.pending, self.ready = m, t + self.LATENCY
        return answer

    def ask(self, m: dict) -> bool:
        self.recent = (self.recent + [m["pct_hits"]])[-16:]
        for h in self.history:
            if h[2] is None:
                h[2] = m["pct_hits"]
        replace = self.rule(m)
        self.history = (self.history + [[replace, m["pct_hits"], None]])[-64:]
        return replace

    def rule(self, m: dict) -> bool:
        if m["progress"] >= self.ENDGAME:
            return False
        if m["occupancy"] < 0.5:
            return True
        done = [h for h in self.history if h[0] and h[2] is not None]
        if done and done[-1][2] - done[-1][1] <= 0.0:
            # The last replacement did not raise the hit share: back off
            # once, while it is among the last three decisions.
            recent = [h for h in self.history[-3:] if h[0]]
            if recent and recent[-1] is done[-1]:
                return False
        trend = 0.0
        r = self.recent
        if len(r) >= 4:
            k = min(4, len(r) // 2)
            trend = sum(r[-k:]) / k - sum(r[-2 * k : -k]) / k
        if m["pct_hits"] < self.LOW_HITS:
            return True
        if abs(trend) <= self.TOL and m["replaced_pct"] < 1.0:
            if m["comm"] > max(m["capacity"], 1) * 0.5:
                return True
        return trend < -self.TOL


def make(traffic: dict, num_pes: int):
    if traffic.get("decider") != "gemma3-4b" or traffic["mode"] != "async":
        raise NotImplementedError(f"no reference decisions for {traffic!r}")
    return [Agent() for _ in range(num_pes)]
