"""The LLM-agent workflow (paper §4.2, Fig. 9).

Three components orchestrate decision making:

* ``MetricsCollector`` — streams key execution metrics (%-Hits, remote
  communication volume, minibatch progress) as temporal context.
* ``ContextBuilder`` — tracks past replacement decisions and, when the
  next metrics arrive, evaluates the previous decision's effectiveness
  (the reflection step).
* ``DecisionMaker`` — combines static graph metadata with the dynamic
  context into a structured prompt, queries the backend, and parses the
  JSON answer (invalid responses are counted, per Table 2).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from .. import telemetry as tel
from . import backends as backends_mod
from . import prompt as prompt_mod
from .backends import DecisionBackend
from .metrics import GraphMeta, HistoryEntry, Metrics


@dataclass
class Decision:
    replace: bool
    expected_hits: str          # "up" | "flat" | "down"
    reason: str
    valid: bool                 # parsed successfully?
    raw: str
    minibatch: int
    latency: float              # backend response time (minibatch units)


def parse_response(raw: str) -> tuple[bool, str, str] | None:
    """Parse the JSON answer; None when non-compliant (invalid response)."""
    try:
        obj = json.loads(raw.strip())
    except (json.JSONDecodeError, ValueError):
        return None
    if not isinstance(obj, dict):
        return None
    action = str(obj.get("action", "")).lower()
    expected = str(obj.get("expected_hits", "flat")).lower()
    if action not in ("replace", "skip"):
        return None
    if expected not in ("up", "flat", "down"):
        expected = "flat"
    return action == "replace", expected, str(obj.get("reason", ""))


class MetricsCollector:
    """Streams metrics; keeps a short window for trend reasoning."""

    def __init__(self, window: int = 16):
        self.window = window
        self.recent_hits: list[float] = []
        self.recent_comm: list[int] = []
        self.latest: Metrics | None = None

    def observe(self, metrics: Metrics) -> Metrics:
        self.latest = metrics
        self.recent_hits.append(metrics.pct_hits)
        self.recent_comm.append(metrics.comm_volume)
        self.recent_hits = self.recent_hits[-self.window :]
        self.recent_comm = self.recent_comm[-self.window :]
        return metrics


class ContextBuilder:
    """Maintains decision history and evaluates prior decisions."""

    def __init__(self, max_history: int = 64):
        self.max_history = max_history
        self.history: list[HistoryEntry] = []

    def record_decision(self, decision: Decision, metrics: Metrics) -> HistoryEntry:
        entry = HistoryEntry(
            minibatch=metrics.minibatch,
            decision=decision.replace,
            predicted_hits_direction=decision.expected_hits,
            pre_pct_hits=metrics.pct_hits,
            pre_comm_volume=metrics.comm_volume,
        )
        self.history.append(entry)
        self.history = self.history[-self.max_history :]
        return entry

    def evaluate_pending(self, metrics: Metrics) -> None:
        """Upon availability of the next metrics, close open entries."""
        for h in self.history:
            if not h.evaluated:
                h.post_pct_hits = metrics.pct_hits
                h.post_comm_volume = metrics.comm_volume
                h.evaluated = True


class DecisionMaker:
    def __init__(self, backend: DecisionBackend, graph: GraphMeta):
        self.backend = backend
        self.graph = graph
        self.valid_responses = 0
        self.invalid_responses = 0

    def decide(
        self,
        metrics: Metrics,
        history: list[HistoryEntry],
        recent_hits: list[float],
    ) -> Decision:
        text = prompt_mod.build_prompt(metrics, history, self.graph, recent_hits)
        raw = self.backend.generate(text, metrics, history, self.graph, recent_hits)
        return self.finish(metrics, raw)

    def finish(self, metrics: Metrics, raw: str) -> Decision:
        """Parse a raw backend response into a Decision and account it.

        Split out of :meth:`decide` so the batched decision plane can
        fan prompt construction and backend queries out across PEs while
        keeping the valid/invalid response counting (Table 2) on this
        per-PE object, identical to the scalar path.
        """
        parsed = parse_response(raw)
        if parsed is None:
            # Non-compliant answer: treated as skip (no action taken).
            self.invalid_responses += 1
            return Decision(
                replace=False,
                expected_hits="flat",
                reason="invalid response",
                valid=False,
                raw=raw,
                minibatch=metrics.minibatch,
                latency=self.backend.latency,
            )
        self.valid_responses += 1
        replace, expected, reason = parsed
        return Decision(
            replace=replace,
            expected_hits=expected,
            reason=reason,
            valid=True,
            raw=raw,
            minibatch=metrics.minibatch,
            latency=self.backend.latency,
        )


class LLMAgent:
    """Full agentic loop: observe → contextualize → decide → reflect."""

    def __init__(self, backend: DecisionBackend, graph: GraphMeta):
        self.collector = MetricsCollector()
        self.context = ContextBuilder()
        self.maker = DecisionMaker(backend, graph)
        self.decisions: list[Decision] = []

    @property
    def name(self) -> str:
        return self.maker.backend.name

    @property
    def latency(self) -> float:
        return self.maker.backend.latency

    def step(self, metrics: Metrics) -> Decision:
        """One request/response round-trip (steps 5-8 of Fig. 9)."""
        self.collector.observe(metrics)
        self.context.evaluate_pending(metrics)
        decision = self.maker.decide(
            metrics, self.context.history, self.collector.recent_hits
        )
        self.context.record_decision(decision, metrics)
        self.decisions.append(decision)
        return decision

    # ------------------------------------------------------------------ #
    # accounting for Table 2 / Table 4
    # ------------------------------------------------------------------ #
    def response_validity(self) -> tuple[float, float]:
        v, i = self.maker.valid_responses, self.maker.invalid_responses
        total = max(v + i, 1)
        return 100.0 * v / total, 100.0 * i / total

    def decision_split(self) -> tuple[float, float]:
        """(+ve, -ve) decision percentages (replace vs skip)."""
        if not self.decisions:
            return 0.0, 0.0
        pos = sum(1 for d in self.decisions if d.replace)
        return 100.0 * pos / len(self.decisions), 100.0 * (
            len(self.decisions) - pos
        ) / len(self.decisions)


@tel.spanned("agent.infer", plane="agent")
def step_agents(agents: list[LLMAgent], metrics_list: list[Metrics]) -> list[Decision]:
    """One request/response round-trip for many agents at once.

    The batched twin of :meth:`LLMAgent.step`, used by the vectorized
    decision plane when several PEs' inference requests come due on the
    same minibatch tick. The four phases run batched across agents:

    1. observe + reflect (cheap per-agent bookkeeping, PE order);
    2. prompt construction via :func:`repro_torch.core.prompt.
       build_prompt_batch` (static sections shared across PEs);
    3. backend queries grouped by backend object through
       :func:`repro_torch.core.backends.generate_batch`;
    4. parse/record via :meth:`DecisionMaker.finish` (the per-PE
       valid/invalid counters advance exactly as in the scalar path).

    Each agent's own observe → contextualize → decide → reflect sequence
    is preserved, so results are identical to calling ``step`` on each
    agent in order. If the same agent object serves several PEs its
    history mutates between steps — the batch degenerates to the scalar
    sequence to keep that behaviour exact.
    """
    tel.count("agent.requests", len(agents))
    if len({id(a) for a in agents}) < len(agents):
        return [a.step(m) for a, m in zip(agents, metrics_list)]
    for agent, metrics in zip(agents, metrics_list):
        agent.collector.observe(metrics)
        agent.context.evaluate_pending(metrics)
    prompts = prompt_mod.build_prompt_batch(
        metrics_list,
        [a.context.history for a in agents],
        [a.maker.graph for a in agents],
        [a.collector.recent_hits for a in agents],
    )
    raws: list[str | None] = [None] * len(agents)
    by_backend: dict[int, tuple[DecisionBackend, list[int]]] = {}
    for i, agent in enumerate(agents):
        backend = agent.maker.backend
        by_backend.setdefault(id(backend), (backend, []))[1].append(i)
    for backend, idxs in by_backend.values():
        requests = [
            (
                prompts[i],
                metrics_list[i],
                agents[i].context.history,
                agents[i].maker.graph,
                agents[i].collector.recent_hits,
            )
            for i in idxs
        ]
        for i, raw in zip(idxs, backends_mod.generate_batch(backend, requests)):
            raws[i] = raw
    decisions = []
    for agent, metrics, raw in zip(agents, metrics_list, raws):
        decision = agent.maker.finish(metrics, raw)
        agent.context.record_decision(decision, metrics)
        agent.decisions.append(decision)
        decisions.append(decision)
    return decisions
