"""Decision backends for the LLM-agent loop (paper §2.2.3, Table 1b).

In the paper, the DECISION MAKER sends the structured prompt to a local
quantized LLM served by Ollama. This container has no network and no LLM
weights, so the backend is pluggable:

* ``OllamaBackend`` — the real deployment path: exact HTTP protocol for
  an Ollama ``/api/generate`` endpoint (kept import-safe; raises a clear
  error when used offline).
* ``ICLSurrogateBackend`` — a deterministic reasoning policy implementing
  the decision rationale the paper reports for its best agent
  (Gemma3-4B): trend analysis over recent %-Hits, communication pressure,
  progress awareness, and reflection on the history of its own decisions.
  This is labelled a *surrogate*: it reproduces the published decision
  behaviour, it is not a language model.
* Persona backends reproducing published failure modes: an aggressive
  always-replace model (Gemma3-1B "replacement bias", §5.3), a
  conservative low-rate replacer (Llama3.2-3B, 19-30% positive decisions),
  a noisy model with invalid responses and long latency (Qwen-1.5B, 44%
  valid), fast-but-poor SLMs (SmolLM2), and slow MoE personas (§5.6).

Every backend returns *raw response text*; the DecisionMaker parses it
(JSON), so invalid-response accounting (Table 2) is exercised for real.

``latency`` is the backend's response time measured in units of one
minibatch training step (T_A/C / T_DDP): it drives the asynchronous
replacement interval r (§4.5.1) in the queue simulation and the
performance model. Values are derived from the paper's Table 2 observed
replacement intervals.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Protocol

from .metrics import GraphMeta, HistoryEntry, Metrics


def _hash01(*parts) -> float:
    """Deterministic pseudo-random in [0, 1) from the decision context."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


class DecisionBackend(Protocol):
    name: str
    latency: float  # response time in minibatch-step units

    def generate(
        self,
        prompt: str,
        metrics: Metrics,
        history: list[HistoryEntry],
        graph: GraphMeta,
        recent_hits: list[float],
    ) -> str: ...


def _answer(action: str, expected: str, reason: str) -> str:
    return json.dumps(
        {"action": action, "expected_hits": expected, "reason": reason}
    )


# --------------------------------------------------------------------- #
# The faithful surrogate of the paper's best agent (Gemma3-4B behaviour)
# --------------------------------------------------------------------- #
@dataclass
class ICLSurrogateBackend:
    """Deterministic surrogate of the paper's Gemma3-4B agent.

    Decision trajectory per §4.3.1 / §5.5: replace selectively when the
    evolving trajectory indicates the current state is suboptimal
    (low/stagnating %-Hits with rising communication); skip near
    completion (progress awareness); reflect — if the previous
    replacement did not improve %-Hits, back off.
    """

    name: str = "gemma3-4b-surrogate"
    latency: float = 2.0          # T_A/C ≈ 2 minibatch steps (Table 2: r=10 at scale)
    low_hits: float = 50.0        # %-Hits below this is "suboptimal"
    stagnation_tol: float = 1.0   # %-points over the trend window
    endgame: float = 0.92         # skip replacements past this progress

    def generate(self, prompt, metrics, history, graph, recent_hits):
        # Progress awareness: a replacement this late cannot amortize.
        if metrics.progress >= self.endgame:
            return _answer("skip", "flat", "training nearly complete")

        # Cold buffer: filling it is almost always right.
        if metrics.buffer_occupancy < 0.5:
            return _answer("replace", "up", "buffer underfilled; admit sampled remotes")

        # Outcome calibration: once the buffer is full, replacing stale
        # tail entries rarely moves %-Hits within one observation — the
        # sound expectation is "flat" unless hits sit well below the
        # recent peak (reflection on history teaches exactly this).
        peak = max(recent_hits) if recent_hits else metrics.pct_hits
        expected_on_replace = (
            "up" if metrics.pct_hits < 0.7 * max(peak, 1e-9) else "flat"
        )

        # Reflection over history: if the last executed replacement did
        # not raise %-Hits, skip to let scores decay further.
        last_exec = next(
            (h for h in reversed(history) if h.decision and h.evaluated), None
        )
        if last_exec is not None and (last_exec.delta_hits or 0.0) <= 0.0:
            # Back off once, then allow the trend logic to re-engage.
            recent_execs = [h for h in history[-3:] if h.decision]
            if recent_execs and recent_execs[-1] is last_exec:
                return _answer(
                    "skip", "flat", "last replacement did not improve hits"
                )

        trend = 0.0
        if len(recent_hits) >= 4:
            k = min(4, len(recent_hits) // 2)
            trend = (sum(recent_hits[-k:]) / k) - (
                sum(recent_hits[-2 * k : -k]) / k
            )

        # Low hits → refresh the buffer.
        if metrics.pct_hits < self.low_hits:
            return _answer(
                "replace", expected_on_replace, "low pct_hits; refresh stale nodes"
            )

        # Healthy hits but stagnating while communication stays high:
        # refresh; steady state expected to hold (calibrated).
        if abs(trend) <= self.stagnation_tol and metrics.replaced_pct < 1.0:
            cap = max(metrics.buffer_capacity, 1)
            if metrics.comm_volume > cap * 0.5:
                return _answer(
                    "replace", "flat", "hits stagnating under high communication"
                )

        # Falling hits → content drifting; replace to arrest the decline.
        if trend < -self.stagnation_tol:
            return _answer(
                "replace", expected_on_replace, "pct_hits declining; content drift"
            )

        return _answer("skip", "flat", "buffer healthy; avoid churn")


# --------------------------------------------------------------------- #
# Persona backends reproducing published behaviours/failure modes
# --------------------------------------------------------------------- #
@dataclass
class AggressiveBackend:
    """Gemma3-1B persona (§5.3 'replacement bias'): as %-Hits rise it
    infers decline and keeps replacing — 100% positive decisions."""

    name: str = "gemma3-1b-persona"
    latency: float = 1.5
    invalid_rate: float = 0.0  # async: 100/0 valid (Table 2)

    def generate(self, prompt, metrics, history, graph, recent_hits):
        if _hash01(self.name, metrics.minibatch, metrics.epoch) < self.invalid_rate:
            return "I think the buffer should probably be replaced because"
        return _answer("replace", "up", "metrics suggest decline; replace")


@dataclass
class ConservativeBackend:
    """Llama3.2-3B persona: accurate, low-latency, replaces ~29% of the
    time (Table 2) — leans on the same trend logic but thresholded."""

    name: str = "llama3.2-3b-persona"
    latency: float = 1.0
    replace_rate: float = 0.29
    inner: ICLSurrogateBackend = field(
        default_factory=lambda: ICLSurrogateBackend(name="_inner", low_hits=35.0)
    )

    def generate(self, prompt, metrics, history, graph, recent_hits):
        raw = self.inner.generate(prompt, metrics, history, graph, recent_hits)
        decision = json.loads(raw)
        if decision["action"] == "replace" and metrics.buffer_occupancy >= 0.5:
            # Conservative gate: only follow through on a fraction of
            # replace-leaning states.
            if _hash01(self.name, metrics.minibatch, metrics.epoch) > self.replace_rate:
                return _answer("skip", "flat", "uncertain benefit; hold")
        if _hash01("miss", self.name, metrics.minibatch) < 0.01:
            return "action: replace expected_hits up"  # 99/1 valid
        return raw


@dataclass
class NoisyBackend:
    """Qwen-1.5B persona: long replacement interval (r=26), 44% valid
    responses in async mode; reasoning traces leak around the JSON."""

    name: str = "qwen-1.5b-persona"
    latency: float = 13.0
    valid_rate: float = 0.44

    def generate(self, prompt, metrics, history, graph, recent_hits):
        u = _hash01(self.name, metrics.minibatch, metrics.epoch)
        if u > self.valid_rate:
            return (
                "<think>We need to weigh pct_hits against comm volume. "
                "If hits are low we should... wait, let me reconsider."
                "</think> The answer might be to replace."
            )
        action = "replace" if u < self.valid_rate * 0.68 else "skip"
        return _answer(action, "up" if action == "replace" else "flat", "ok")


@dataclass
class SmolBackend:
    """SmolLM2 persona: fastest, poor reasoning — near-random decisions
    with some malformed outputs (87-92% valid, Pass@1 ~13-25)."""

    name: str = "smollm2-360m-persona"
    latency: float = 0.5
    valid_rate: float = 0.87

    def generate(self, prompt, metrics, history, graph, recent_hits):
        u = _hash01(self.name, metrics.minibatch, metrics.epoch)
        if u > self.valid_rate:
            return '{"action": "replace", "expected_hits": '  # truncated JSON
        act = "replace" if _hash01("a", self.name, metrics.minibatch) < 0.35 else "skip"
        exp = ["up", "flat", "down"][int(_hash01("e", self.name, metrics.minibatch) * 3)]
        return _answer(act, exp, "quick guess")


@dataclass
class MoEPersonaBackend:
    """Mixtral/Granite persona (§5.6): valid but slow, mildly accurate.

    Low-bit quantization degrades reasoning in the large models, so the
    decision quality does not beat the small dense surrogate despite the
    size — decisions follow the surrogate but with long latency and a
    bias toward replacing (Mixtral-8x22B: 86% positive decisions).
    """

    name: str = "mixtral-8x7b-persona"
    latency: float = 10.0
    positive_bias: float = 0.56
    inner: ICLSurrogateBackend = field(
        default_factory=lambda: ICLSurrogateBackend(name="_inner")
    )

    def generate(self, prompt, metrics, history, graph, recent_hits):
        raw = self.inner.generate(prompt, metrics, history, graph, recent_hits)
        decision = json.loads(raw)
        u = _hash01(self.name, metrics.minibatch, metrics.epoch)
        if decision["action"] == "skip" and u < self.positive_bias * 0.4:
            return _answer("replace", "up", "quantized reasoning flips to replace")
        return raw


# --------------------------------------------------------------------- #
# Real deployment path
# --------------------------------------------------------------------- #
@dataclass
class OllamaBackend:
    """HTTP client for a local Ollama server (paper §4.1).

    Sends the exact prompt built by ``prompt.build_prompt`` to
    ``/api/generate`` with ``format: json``. Unusable in this offline
    container; kept as the production integration point.
    """

    model: str = "gemma3:4b"
    host: str = "http://127.0.0.1:11434"
    name: str = "ollama"
    latency: float = 2.0
    timeout_s: float = 30.0

    def generate(self, prompt, metrics, history, graph, recent_hits):
        import urllib.request

        payload = json.dumps(
            {
                "model": self.model,
                "prompt": prompt,
                "stream": False,
                "format": "json",
                "options": {"num_ctx": 2048, "temperature": 0.0},
            }
        ).encode()
        req = urllib.request.Request(
            f"{self.host}/api/generate",
            data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())["response"]


# --------------------------------------------------------------------- #
# Batched querying (the vectorized decision plane's fan-out point)
# --------------------------------------------------------------------- #
#: One queued request: the arguments of ``DecisionBackend.generate``.
GenerateRequest = tuple[str, Metrics, list[HistoryEntry], GraphMeta, list[float]]


def generate_batch(
    backend: DecisionBackend, requests: list[GenerateRequest]
) -> list[str]:
    """Answer a batch of decision requests against one backend.

    Backends that implement ``generate_batch(requests)`` (e.g. a server
    with a batched completion endpoint) get the whole batch in one call;
    everything else falls back to per-request ``generate`` in request
    order, so decision streams are identical either way.
    """
    batched = getattr(backend, "generate_batch", None)
    if batched is not None:
        responses = list(batched(requests))
        if len(responses) != len(requests):
            raise ValueError(
                f"{backend.name}.generate_batch returned {len(responses)} "
                f"responses for {len(requests)} requests"
            )
        return responses
    return [backend.generate(*req) for req in requests]


REGISTRY: dict[str, type] = {
    "gemma3-4b": ICLSurrogateBackend,
    "gemma3-1b": AggressiveBackend,
    "llama3.2-3b": ConservativeBackend,
    "qwen-1.5b": NoisyBackend,
    "smollm2-360m": SmolBackend,
    "mixtral-8x7b": MoEPersonaBackend,
    "ollama": OllamaBackend,
}


def make_backend(name: str, **kwargs) -> DecisionBackend:
    if name not in REGISTRY:
        raise KeyError(f"unknown backend {name!r}; options: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
