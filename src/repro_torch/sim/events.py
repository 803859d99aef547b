"""Event taxonomy and log for the cluster simulation plane.

One :class:`SimEvent` is an interval on a named lane of the simulated
cluster. Lanes and kinds (see ``docs/ARCHITECTURE.md`` §"Simulation
plane"):

========  =========  ====================================================
lane      kind       meaning
========  =========  ====================================================
compute   ddp        trainer ``pe``'s forward+backward+allreduce compute
net       fetch      one aggregated feature-fetch RPC: trainer ``pe``
                     pulling ``nbytes`` from home partition ``src``
                     (``src == -1`` for the flat single-link model)
net       replace    the prefetcher's ReplaceandFetch RPC for nodes
                     admitted into the persistent buffer
agent     infer      the daemon inference thread busy on a decision
                     request (submit → complete)
cluster   barrier    the gradient all-reduce barrier closing the step
                     (``pe == -1``; ``t1`` is the step's cluster time)
========  =========  ====================================================

Times are *step-relative* seconds (every step starts at 0 at the
barrier); ``step`` is the global minibatch index. The log is a plain
append-only list of frozen tuples so two runs can be compared with
``==`` — the determinism contract of ``tests/test_sim.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SimEvent:
    """One interval on a simulated lane (step-relative seconds)."""

    step: int
    lane: str      # compute | net | agent | cluster
    kind: str      # ddp | fetch | replace | infer | barrier
    pe: int        # trainer PE (-1 for cluster-wide events)
    t0: float
    t1: float
    src: int = -1  # home partition served (net lane), else -1
    nbytes: int = 0

    def __post_init__(self):
        if self.t1 < self.t0:
            raise ValueError(f"event ends before it starts: {self}")


class EventLog:
    """Append-only, order-preserving record of one simulated run."""

    def __init__(self):
        self._events: list[SimEvent] = []

    def add(self, event: SimEvent) -> None:
        self._events.append(event)

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self._events)

    def __getitem__(self, i):
        return self._events[i]

    def as_tuples(self) -> list[tuple]:
        """Comparable/serializable rendering (determinism checks)."""
        return [
            (e.step, e.lane, e.kind, e.pe, e.t0, e.t1, e.src, e.nbytes)
            for e in self._events
        ]

    def lane(self, lane: str) -> list[SimEvent]:
        return [e for e in self._events if e.lane == lane]

    def summary(self) -> dict:
        """Per-kind counts and busy seconds (quick inspection helper)."""
        out: dict[str, dict] = {}
        for e in self._events:
            slot = out.setdefault(e.kind, {"count": 0, "busy_s": 0.0})
            slot["count"] += 1
            slot["busy_s"] += e.t1 - e.t0
        return out
