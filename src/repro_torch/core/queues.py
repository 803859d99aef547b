"""Request/response queue semantics (paper §4.5, Fig. 11, Algorithm 1).

The paper runs the prefetcher on CPU threads and the inference model in
a daemon thread, coordinating through shared queues with a pause/notify
protocol that avoids *stale requests* (a decision computed for obsolete
metrics). JAX dispatch is synchronous, so we reproduce those semantics
as a deterministic event-driven model over minibatch time:

* the trainer advances one minibatch per tick;
* the inference model takes ``latency`` ticks to answer;
* **asynchronous** (default): the prefetcher polls the response queue
  (non-blocking); when a decision arrives it is applied, the request
  queue is cleared of backlog, and the inference thread is notified with
  fresh metrics — minibatches processed while inference was busy get no
  decision (the replacement interval r >= 1);
* **synchronous**: the trainer blocks for every decision — r = 1 and the
  agent latency lands on the critical path (T_A/C + T_COMM per step).

The same model produces both the decision stream and the per-step time
accounting used by the §4.5.3 performance model. In the vectorized
runtime the queue hand-off is an explicit two-slot stage
(:class:`repro_torch.runtime.DecisionStage`, ``docs/ARCHITECTURE.md`` §3)
wrapped around this pipe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .. import telemetry as tel
from .metrics import Metrics


@dataclass
class PendingRequest:
    metrics: Metrics
    submitted_at: int
    ready_at: float


@dataclass
class StepOutcome:
    """What the prefetcher learns at one minibatch tick."""

    decision_available: bool
    replace: bool
    decision_for_minibatch: int | None
    stalled_ticks: float        # trainer stall (sync mode only)


class InferencePipe:
    """Deterministic twin of the daemon-thread + queue protocol."""

    def __init__(
        self,
        decide: Callable[[Metrics], bool],
        latency: float,
        mode: str = "async",
    ):
        if mode not in ("async", "sync"):
            raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
        self.decide = decide
        self.latency = float(latency)
        self.mode = mode
        self.busy_with: PendingRequest | None = None
        self.response: tuple[int, bool] | None = None
        self.decision_gaps: list[int] = []
        self._last_decision_mb: int | None = None

    def tick(self, now: int, metrics: Metrics) -> StepOutcome:
        """One minibatch tick: push metrics, poll for a decision."""
        if self.mode == "sync":
            # Trainer blocks: request -> inference -> response, every tick.
            replace = self.decide(metrics)
            self._note_gap(now)
            return StepOutcome(
                decision_available=True,
                replace=replace,
                decision_for_minibatch=now,
                stalled_ticks=self.latency,
            )

        # --- asynchronous ------------------------------------------------
        outcome = StepOutcome(False, False, None, 0.0)
        if self.busy_with is not None and now >= self.busy_with.ready_at:
            # Decision arrives on the response queue.
            replace = self.decide(self.busy_with.metrics)
            outcome = StepOutcome(
                decision_available=True,
                replace=replace,
                decision_for_minibatch=self.busy_with.submitted_at,
                stalled_ticks=0.0,
            )
            self._note_gap(now)
            self.busy_with = None

        if self.busy_with is None:
            # Queue cleared of backlog; notify with the *latest* metrics
            # (minibatches processed while busy never reach the model —
            # this is what bounds staleness).
            self.busy_with = PendingRequest(
                metrics=metrics,
                submitted_at=now,
                ready_at=now + max(self.latency, 1e-9),
            )
        return outcome

    def _note_gap(self, now: int) -> None:
        if self._last_decision_mb is not None:
            self.decision_gaps.append(now - self._last_decision_mb)
        self._last_decision_mb = now

    @property
    def replacement_interval(self) -> float:
        """Mean gap r between consecutive decisions (paper Table 2)."""
        if not self.decision_gaps:
            return float("nan")
        return sum(self.decision_gaps) / len(self.decision_gaps)


@dataclass
class BatchedStepOutcome:
    """What every PE's prefetcher learns at one minibatch tick."""

    decision_available: "np.ndarray"   # (P,) bool
    replace: "np.ndarray"              # (P,) bool
    decision_for_minibatch: "np.ndarray"  # (P,) int64; -1 where no decision
    stalled_ticks: "np.ndarray"        # (P,) float64 (sync mode only)


class BatchedInferencePipe:
    """All P trainers' inference pipes advanced as one array state.

    The vectorized twin of P :class:`InferencePipe` objects: busy flags,
    submission ticks and ready times live in dense ``(P,)`` arrays, and
    the per-tick poll (which requests came due? which queues take fresh
    metrics?) is a couple of vector compares instead of P Python
    branches. ``decide_batch(indices, metrics)`` answers every due
    request in one call — the hook the batched agent/classifier stage
    (:func:`repro_torch.core.agent.step_agents`) plugs into so prompt building
    and backend queries fan out across PEs.

    Per-PE latency accounting (decision gaps, the replacement interval
    r, sync-mode stall ticks) is bit-identical to running P scalar pipes
    side by side — asserted by ``tests/test_decision_plane.py``.
    """

    def __init__(
        self,
        decide_batch: Callable[["np.ndarray", list[Metrics]], "np.ndarray"],
        latencies,
        mode: str = "async",
    ):
        if mode not in ("async", "sync"):
            raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
        self.decide_batch = decide_batch
        self.latency = np.asarray(latencies, dtype=np.float64)
        self.mode = mode
        self.num_pes = P = len(self.latency)
        self.busy = np.zeros(P, dtype=bool)
        self.submitted_at = np.full(P, -1, dtype=np.int64)
        self.ready_at = np.zeros(P, dtype=np.float64)
        self.pending: list[Metrics | None] = [None] * P
        self.decision_gaps: list[list[int]] = [[] for _ in range(P)]
        self._last_decision_mb = np.full(P, -1, dtype=np.int64)

    def tick_batch(self, now: int, metrics_list: list[Metrics]) -> BatchedStepOutcome:
        """One minibatch tick for every PE: push metrics, poll decisions."""
        P = self.num_pes
        if len(metrics_list) != P:
            raise ValueError(f"expected {P} metrics, got {len(metrics_list)}")
        if self.mode == "sync":
            # Every trainer blocks: request -> inference -> response.
            everyone = np.arange(P, dtype=np.int64)
            if tel.enabled():
                tel.count("pipe.submitted", np.ones(P))
            replace = np.asarray(
                self.decide_batch(everyone, list(metrics_list)), dtype=bool
            )
            if tel.enabled():
                tel.count("pipe.ready", np.ones(P))
            self._note_gaps(everyone, now)
            return BatchedStepOutcome(
                decision_available=np.ones(P, dtype=bool),
                replace=replace,
                decision_for_minibatch=np.full(P, now, dtype=np.int64),
                stalled_ticks=self.latency.copy(),
            )

        # --- asynchronous ------------------------------------------------
        available = np.zeros(P, dtype=bool)
        replace = np.zeros(P, dtype=bool)
        for_mb = np.full(P, -1, dtype=np.int64)
        due = np.nonzero(self.busy & (now >= self.ready_at))[0]
        if due.size:
            # Decisions arrive on the response queues, computed for the
            # metrics that were current at submission (staleness bound).
            answers = np.asarray(
                self.decide_batch(due, [self.pending[i] for i in due]),
                dtype=bool,
            )
            available[due] = True
            replace[due] = answers
            for_mb[due] = self.submitted_at[due]
            self._note_gaps(due, now)
            self.busy[due] = False
            if tel.enabled():
                ready = np.zeros(P)
                ready[due] = 1.0
                tel.count("pipe.ready", ready)
        idle = np.nonzero(~self.busy)[0]
        if idle.size:
            # Queues cleared of backlog; notify with the *latest* metrics.
            for i in idle:
                self.pending[i] = metrics_list[i]
            self.submitted_at[idle] = now
            self.ready_at[idle] = now + np.maximum(self.latency[idle], 1e-9)
            self.busy[idle] = True
            if tel.enabled():
                fresh = np.zeros(P)
                fresh[idle] = 1.0
                tel.count("pipe.submitted", fresh)
        return BatchedStepOutcome(
            decision_available=available,
            replace=replace,
            decision_for_minibatch=for_mb,
            stalled_ticks=np.zeros(P, dtype=np.float64),
        )

    def _note_gaps(self, indices: "np.ndarray", now: int) -> None:
        for i in indices:
            last = self._last_decision_mb[i]
            if last >= 0:
                self.decision_gaps[i].append(int(now - last))
        self._last_decision_mb[indices] = now

    @property
    def replacement_interval(self) -> "np.ndarray":
        """Per-PE mean gap r between decisions; NaN before any gap."""
        return np.array(
            [
                sum(g) / len(g) if g else float("nan")
                for g in self.decision_gaps
            ],
            dtype=np.float64,
        )
