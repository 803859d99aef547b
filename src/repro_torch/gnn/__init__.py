"""GNN training substrate (GraphSAGE + distributed trainer)."""

from .sage import GraphSAGE, init_sage, params_from_jax
from .train import DistributedTrainer, RunResult, TimeModel

__all__ = [
    "GraphSAGE",
    "init_sage",
    "params_from_jax",
    "DistributedTrainer",
    "RunResult",
    "TimeModel",
]
