"""Replacement controllers — the *variants* of the paper's evaluation.

* ``NoPrefetchController``   — baseline DistDGL: no buffer at all.
* ``FixedController``        — DistDGL+fixed: replacement at every
                               minibatch (static prefetch w/ overlap).
* ``PeriodicController``     — MassiveGNN-style: fixed replacement
                               interval (default 32) with optional
                               degree-based warm start (§5.1 Fig. 15).
* ``AdaptiveController``     — DistDGL+Rudder: LLM agent or ML
                               classifier behind the async/sync queue
                               protocol decides when to replace.

Controllers see the same scoring policy (owned by the buffer); they only
answer "should a replacement round run before the next minibatch?". The
vectorized runtime advances all P trainers' controllers through one
:class:`DecisionPlane` per minibatch — heuristics as dense ``(P,)``
boolean masks, adaptive controllers through the batched inference pipe —
behind the double-buffered :class:`repro_torch.runtime.DecisionStage`
(``docs/ARCHITECTURE.md`` §3).
"""

from __future__ import annotations

import numpy as np

from .agent import LLMAgent, step_agents
from .classifiers import featurize
from .metrics import GraphMeta, Metrics
from .queues import BatchedInferencePipe, InferencePipe


class Controller:
    name: str = "base"
    uses_buffer: bool = True
    #: agent/classifier latency in minibatch units (0 for heuristics)
    inference_cost: float = 0.0

    def should_replace(self, metrics: Metrics) -> bool:
        raise NotImplementedError

    def step_stall(self) -> float:
        """Trainer stall ticks contributed this minibatch (sync only)."""
        return 0.0

    @property
    def replacement_interval(self) -> float:
        return 1.0


class NoPrefetchController(Controller):
    """Baseline DistDGL — every sampled remote node is fetched."""

    name = "distdgl"
    uses_buffer = False

    def should_replace(self, metrics: Metrics) -> bool:
        return False


class FixedController(Controller):
    """DistDGL+fixed — replacement decision at *every* minibatch."""

    name = "distdgl+fixed"

    def should_replace(self, metrics: Metrics) -> bool:
        return True


class PeriodicController(Controller):
    """MassiveGNN-style heuristic: replace every ``interval`` minibatches.

    MassiveGNN additionally prefetches high-degree remote nodes before
    training starts; the trainer honours that via ``warm_start``.
    """

    name = "massivegnn"

    def __init__(self, interval: int = 32, warm_start: bool = True):
        self.interval = int(interval)
        self.warm_start = warm_start
        self._count = 0

    def should_replace(self, metrics: Metrics) -> bool:
        self._count += 1
        return self._count % self.interval == 0

    @property
    def replacement_interval(self) -> float:
        return float(self.interval)


class AdaptiveController(Controller):
    """DistDGL+Rudder: adaptive decisions via agent or classifier."""

    name = "rudder"

    def __init__(self, decider, graph: GraphMeta, mode: str = "async"):
        """``decider`` is an ``LLMAgent`` or a fitted classifier."""
        self.graph = graph
        self.mode = mode
        self._stall = 0.0
        self._prev_metrics: Metrics | None = None
        self._recent_hits: list[float] = []
        self._recent_comm: list[int] = []
        if isinstance(decider, str):
            from .backends import make_backend

            decider = LLMAgent(make_backend(decider), graph)
        if isinstance(decider, LLMAgent):
            if decider.maker.graph is None:
                decider.maker.graph = graph
            self.agent: LLMAgent | None = decider
            self.classifier = None
            decide = lambda m: self.agent.step(m).replace
            latency = decider.latency
            self.name = f"rudder[{decider.name}]"
        else:
            self.agent = None
            self.classifier = decider
            decide = self._classifier_decide
            latency = getattr(decider, "latency", 0.2)
            self.name = f"rudder[{decider.name}]"
        self.inference_cost = latency
        self.pipe = InferencePipe(decide, latency, mode=mode)
        self._tick = 0

    def _classifier_decide(self, metrics: Metrics) -> bool:
        x = featurize(
            metrics, self._prev_metrics, self._recent_hits, self._recent_comm
        )
        return bool(self.classifier.decide(x))

    def should_replace(self, metrics: Metrics) -> bool:
        self._recent_hits.append(metrics.pct_hits)
        self._recent_hits = self._recent_hits[-16:]
        self._recent_comm.append(metrics.comm_volume)
        self._recent_comm = self._recent_comm[-16:]
        out = self.pipe.tick(self._tick, metrics)
        self._tick += 1
        self._prev_metrics = metrics
        self._stall = out.stalled_ticks
        if metrics.buffer_occupancy == 0.0 and metrics.buffer_capacity > 0:
            # Cold-buffer bootstrap: with an empty buffer a replacement
            # round is a pure insert into free slots (nothing to
            # pollute), so Algorithm 1 always fills it. Deferring to the
            # decider here can deadlock a skip-biased classifier: the
            # buffer stays empty, the metrics never change, and every
            # subsequent answer is the same skip. The pipe is still
            # ticked above so latency/staleness accounting is unchanged.
            return True
        return out.decision_available and out.replace

    def step_stall(self) -> float:
        return self._stall

    @property
    def replacement_interval(self) -> float:
        r = self.pipe.replacement_interval
        return r if r == r else 1.0  # NaN -> 1


class _AdaptiveGroup:
    """All same-mode :class:`AdaptiveController` PEs behind one batched pipe.

    The group owns a :class:`BatchedInferencePipe` whose ``decide_batch``
    fans due requests out across the member controllers' deciders:
    agents are stepped together through :func:`repro_torch.core.agent.
    step_agents` (batched prompts + backend queries), classifiers are
    featurized per PE. Decision-gap accounting is mirrored into each
    member's scalar ``pipe`` so ``ctrl.replacement_interval`` (read by
    benchmarks after a vectorized run) stays truthful.
    """

    def __init__(self, indices: list[int], controllers: list[AdaptiveController]):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.controllers = controllers
        self.pipe = BatchedInferencePipe(
            self._decide_batch,
            [c.inference_cost for c in controllers],
            mode=controllers[0].mode,
        )

    def _decide_batch(self, local_idx, metrics_list) -> np.ndarray:
        answers = np.zeros(len(local_idx), dtype=bool)
        agent_pos: list[int] = []
        agent_objs: list[LLMAgent] = []
        agent_metrics: list[Metrics] = []
        for j, k in enumerate(local_idx):
            ctrl = self.controllers[int(k)]
            if ctrl.agent is not None:
                agent_pos.append(j)
                agent_objs.append(ctrl.agent)
                agent_metrics.append(metrics_list[j])
            else:
                answers[j] = ctrl._classifier_decide(metrics_list[j])
        if agent_objs:
            decisions = step_agents(agent_objs, agent_metrics)
            for j, decision in zip(agent_pos, decisions):
                answers[j] = decision.replace
        return answers

    def step(self, now: int, metrics_list: list[Metrics]) -> tuple[np.ndarray, np.ndarray]:
        """Advance every member one tick; returns (decisions, stalls).

        Replicates :meth:`AdaptiveController.should_replace` phase by
        phase: recent-metrics windows advance *before* the pipe tick
        (classifier features read them at fire time), ``_prev_metrics``
        and the stall after, and the cold-buffer bootstrap overrides the
        pipe's answer last.
        """
        for ctrl, metrics in zip(self.controllers, metrics_list):
            ctrl._recent_hits.append(metrics.pct_hits)
            ctrl._recent_hits = ctrl._recent_hits[-16:]
            ctrl._recent_comm.append(metrics.comm_volume)
            ctrl._recent_comm = ctrl._recent_comm[-16:]
        out = self.pipe.tick_batch(now, metrics_list)
        for k in np.nonzero(out.decision_available)[0]:
            self.controllers[int(k)].pipe._note_gap(now)
        for k, (ctrl, metrics) in enumerate(zip(self.controllers, metrics_list)):
            ctrl._tick += 1
            ctrl._prev_metrics = metrics
            ctrl._stall = float(out.stalled_ticks[k])
        decisions = out.decision_available & out.replace
        cold = np.array(
            [
                m.buffer_occupancy == 0.0 and m.buffer_capacity > 0
                for m in metrics_list
            ],
            dtype=bool,
        )
        return decisions | cold, out.stalled_ticks


class DecisionPlane:
    """All P trainers' controllers advanced as one batched object.

    The vectorized decision plane: per minibatch, one :meth:`step` call
    answers "should a replacement round run?" for every PE at once.

    * :class:`NoPrefetchController` / :class:`FixedController` PEs are
      static entries of a dense ``(P,)`` boolean mask;
    * :class:`PeriodicController` PEs share one vectorized counter array
      (``count % interval == 0``) — the plane hosts the counters, the
      controller objects are left untouched;
    * :class:`AdaptiveController` PEs are grouped by queue mode behind a
      :class:`repro_torch.core.queues.BatchedInferencePipe` each, with prompt
      construction and backend queries batched across PEs and per-PE
      latency/staleness accounting mirrored back onto the controllers;
    * controller types the plane does not recognise (subclasses with
      overridden behaviour) degrade gracefully to per-PE
      ``should_replace`` calls.

    Decision/stall streams are bit-identical to calling every
    controller's ``should_replace`` in PE order — the contract
    ``tests/test_decision_plane.py`` and ``tests/test_runtime_parity.py``
    assert.
    """

    def __init__(self, controllers: list[Controller]):
        self.controllers = list(controllers)
        P = len(self.controllers)
        self.num_pes = P
        self.uses_buffer = np.array(
            [c.uses_buffer for c in self.controllers], dtype=bool
        )
        self.inference_cost = np.array(
            [c.inference_cost for c in self.controllers], dtype=np.float64
        )
        self._now = 0
        self._fixed_mask = np.array(
            [type(c) is FixedController for c in self.controllers], dtype=bool
        )
        periodic = [
            p for p, c in enumerate(self.controllers)
            if type(c) is PeriodicController
        ]
        self._periodic_idx = np.asarray(periodic, dtype=np.int64)
        self._periodic_interval = np.array(
            [self.controllers[p].interval for p in periodic], dtype=np.int64
        )
        self._periodic_count = np.array(
            [self.controllers[p]._count for p in periodic], dtype=np.int64
        )
        self._groups: list[_AdaptiveGroup] = []
        by_mode: dict[str, list[int]] = {}
        for p, c in enumerate(self.controllers):
            if type(c) is AdaptiveController:
                by_mode.setdefault(c.mode, []).append(p)
        for indices in by_mode.values():
            self._groups.append(
                _AdaptiveGroup(indices, [self.controllers[p] for p in indices])
            )
        known = (
            self._fixed_mask
            | np.isin(np.arange(P), self._periodic_idx)
            | np.array(
                [
                    type(c) in (NoPrefetchController, AdaptiveController)
                    for c in self.controllers
                ],
                dtype=bool,
            )
        )
        self._scalar_idx = np.nonzero(~known)[0]

    def step(self, metrics_list: list[Metrics]) -> tuple[np.ndarray, np.ndarray]:
        """One minibatch tick: ``(decisions, stall_ticks)`` over all PEs."""
        if len(metrics_list) != self.num_pes:
            raise ValueError(
                f"expected {self.num_pes} metrics, got {len(metrics_list)}"
            )
        decisions = np.zeros(self.num_pes, dtype=bool)
        stalls = np.zeros(self.num_pes, dtype=np.float64)
        decisions[self._fixed_mask] = True
        if self._periodic_idx.size:
            self._periodic_count += 1
            decisions[self._periodic_idx] = (
                self._periodic_count % self._periodic_interval == 0
            )
        for group in self._groups:
            group_metrics = [metrics_list[p] for p in group.indices]
            group_dec, group_stall = group.step(self._now, group_metrics)
            decisions[group.indices] = group_dec
            stalls[group.indices] = group_stall
        for p in self._scalar_idx:
            ctrl = self.controllers[p]
            decisions[p] = ctrl.should_replace(metrics_list[p])
            stalls[p] = ctrl.step_stall()
        self._now += 1
        return decisions, stalls

    @property
    def replacement_interval(self) -> np.ndarray:
        """Per-PE mean decision gap r (1.0 for heuristics, as scalar)."""
        return np.array(
            [c.replacement_interval for c in self.controllers],
            dtype=np.float64,
        )


def make_controller(
    variant: str,
    graph: GraphMeta | None = None,
    decider=None,
    mode: str = "async",
    interval: int = 32,
    warm_start: bool = True,
) -> Controller:
    if variant == "distdgl":
        return NoPrefetchController()
    if variant == "fixed":
        return FixedController()
    if variant == "massivegnn":
        return PeriodicController(interval=interval, warm_start=warm_start)
    if variant == "rudder":
        if decider is None or graph is None:
            raise ValueError("rudder variant needs decider and graph metadata")
        return AdaptiveController(decider, graph, mode=mode)
    raise KeyError(f"unknown variant {variant!r}")
