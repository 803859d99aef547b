"""Rudder core: adaptive prefetching/replacement for distributed GNN training.

Numpy modules, identical in behaviour to the reference package's:

* :mod:`repro_torch.core.scoring`     — the what-to-replace policy zoo
* :mod:`repro_torch.core.buffer`      — the per-trainer persistent buffer
* :mod:`repro_torch.core.metrics`     — runtime observations shared with agents
* :mod:`repro_torch.core.prompt`      — structured zero-shot ICL prompts (+ batch)
* :mod:`repro_torch.core.backends`    — pluggable LLM decision backends
* :mod:`repro_torch.core.agent`       — MetricsCollector/ContextBuilder/DecisionMaker
* :mod:`repro_torch.core.classifiers` — the classifier featurizer
* :mod:`repro_torch.core.queues`      — async/sync request-response semantics
* :mod:`repro_torch.core.controller`  — the evaluation variants and the batched
  :class:`DecisionPlane` the runtime drives
"""

from .agent import Decision, LLMAgent, step_agents
from .backends import make_backend
from .buffer import PersistentBuffer
from .controller import DecisionPlane, make_controller
from .metrics import GraphMeta, Metrics
from .queues import BatchedInferencePipe, InferencePipe
from .scoring import ScoringPolicy, make_policy

__all__ = [
    "Decision",
    "DecisionPlane",
    "LLMAgent",
    "PersistentBuffer",
    "GraphMeta",
    "Metrics",
    "BatchedInferencePipe",
    "InferencePipe",
    "ScoringPolicy",
    "make_backend",
    "make_controller",
    "make_policy",
    "step_agents",
]
