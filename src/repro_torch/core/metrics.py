"""Runtime metrics shared with the agent/classifier (paper §4.3).

Four groups, exactly as the paper classifies them:

* persistent buffer   — %-Hits, #nodes replaced (as % of buffer size)
* training            — communication volume (#remote nodes fetched),
                        current/pending #minibatches (progress awareness)
* replacement history — impact of past decisions (Δ%-Hits, Δcomm)
* graph static info   — |V|, |E| global and in the local partition
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict


@dataclass(frozen=True)
class GraphMeta:
    """Static graph/partition metadata (shared once, kept in context)."""

    name: str
    num_nodes: int
    num_edges: int
    part_nodes: int
    part_edges: int
    num_partitions: int


@dataclass(frozen=True)
class Metrics:
    """One observation enqueued by the prefetcher for the agent."""

    minibatch: int
    total_minibatches: int
    epoch: int
    total_epochs: int
    pct_hits: float              # % of sampled remote nodes found in buffer
    comm_volume: int             # remote nodes fetched this minibatch
    replaced_pct: float          # nodes replaced last round, % of capacity
    buffer_occupancy: float      # filled fraction of the buffer
    buffer_capacity: int

    @property
    def progress(self) -> float:
        total = self.total_minibatches * self.total_epochs
        done = self.epoch * self.total_minibatches + self.minibatch
        return done / total if total else 0.0

    @property
    def pending_minibatches(self) -> int:
        total = self.total_minibatches * self.total_epochs
        done = self.epoch * self.total_minibatches + self.minibatch
        return max(total - done, 0)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["progress"] = self.progress
        return d


@dataclass
class HistoryEntry:
    """CONTEXT BUILDER record: a decision and its later-observed impact."""

    minibatch: int
    decision: bool               # True = replace, False = skip
    predicted_hits_direction: str  # "up" | "flat" | "down"
    pre_pct_hits: float
    pre_comm_volume: int
    post_pct_hits: float | None = None
    post_comm_volume: int | None = None
    evaluated: bool = False

    @property
    def delta_hits(self) -> float | None:
        if self.post_pct_hits is None:
            return None
        return self.post_pct_hits - self.pre_pct_hits

    @property
    def delta_comm(self) -> int | None:
        if self.post_comm_volume is None:
            return None
        return self.post_comm_volume - self.pre_comm_volume

    def observed_direction(self, tol: float = 0.5) -> str | None:
        """Direction of the realised %-Hits change (tol in %-points)."""
        d = self.delta_hits
        if d is None:
            return None
        if d > tol:
            return "up"
        if d < -tol:
            return "down"
        return "flat"
