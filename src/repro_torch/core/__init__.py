"""Rudder core: adaptive prefetching/replacement for distributed GNN training.

The reference package's modules, identical in behaviour (numpy, and
torch for the classifiers' gradient models):

* :mod:`repro_torch.core.scoring`     — the what-to-replace policy zoo
* :mod:`repro_torch.core.buffer`      — the per-trainer persistent buffer
* :mod:`repro_torch.core.metrics`     — runtime observations shared with agents
* :mod:`repro_torch.core.prompt`      — structured zero-shot ICL prompts (+ batch)
* :mod:`repro_torch.core.backends`    — pluggable LLM decision backends
* :mod:`repro_torch.core.agent`       — MetricsCollector/ContextBuilder/DecisionMaker
* :mod:`repro_torch.core.classifiers` — offline-trained ML classifier
  baselines (gradient models in torch, tree models in numpy)
* :mod:`repro_torch.core.queues`      — async/sync request-response semantics
* :mod:`repro_torch.core.controller`  — the evaluation variants and the batched
  :class:`DecisionPlane` the runtime drives
* :mod:`repro_torch.core.evaluate`    — Pass@1 %-Hits and CI reporting
"""

from .agent import Decision, LLMAgent, step_agents
from .backends import make_backend
from .buffer import PersistentBuffer
from .classifiers import make_classifier
from .controller import DecisionPlane, make_controller
from .evaluate import agent_report, pass_at_1
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
    "make_classifier",
    "make_controller",
    "make_policy",
    "step_agents",
    "agent_report",
    "pass_at_1",
]
