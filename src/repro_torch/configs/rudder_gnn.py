"""Rudder GNN experiment presets (the paper's §5 configurations, scaled).

``EXPERIMENTS[name]`` bundles the knobs one paper experiment varies, so
examples/benchmarks can reproduce a configuration by name::

    from repro_torch.configs.rudder_gnn import EXPERIMENTS, build_trainer
    trainer = build_trainer("products_25pct_rudder")               # the card
    trainer = build_trainer("products_25pct_rudder", device="cpu")

A copy of the reference's presets; :func:`build_trainer` takes the
port's ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RudderExperiment:
    dataset: str
    variant: str                 # distdgl | fixed | massivegnn | rudder
    buffer_frac: float = 0.25
    num_parts: int = 4
    batch_size: int = 16
    epochs: int = 10
    backend: str = "gemma3-4b"   # LLM backend (rudder variant)
    mode: str = "async"
    interval: int = 32           # massivegnn replacement interval
    scale: float = 0.12
    seed: int = 0


EXPERIMENTS: dict[str, RudderExperiment] = {
    # §5.1 baseline grid anchors
    "products_25pct_baseline": RudderExperiment("products", "distdgl"),
    "products_25pct_fixed": RudderExperiment("products", "fixed"),
    "products_25pct_rudder": RudderExperiment("products", "rudder"),
    "products_5pct_rudder": RudderExperiment("products", "rudder", buffer_frac=0.05),
    # §5.1 MassiveGNN comparison (Fig. 15)
    "products_massivegnn": RudderExperiment("products", "massivegnn"),
    # §5.3 synchronous ablation
    "products_rudder_sync": RudderExperiment("products", "rudder", mode="sync"),
    # §5.4 unseen datasets
    "yelp_rudder": RudderExperiment("yelp", "rudder"),
    "arxiv_rudder": RudderExperiment("arxiv", "rudder"),
    # §5.5 trajectory graph
    "papers_rudder": RudderExperiment("papers", "rudder", epochs=12),
    # §5.6 MoE agent
    "products_moe_agent": RudderExperiment("products", "rudder",
                                           backend="mixtral-8x7b"),
}


def build_trainer(name: str, train_model: bool = False, device="cuda"):
    """Instantiate the DistributedTrainer for a named experiment on
    ``device`` (``"cuda"``, ``"cpu"`` or ``False``, the staged loop)."""
    from ..gnn import DistributedTrainer
    from ..graph import generate, partition_graph

    exp = EXPERIMENTS[name]
    graph = generate(exp.dataset, seed=exp.seed, scale=exp.scale)
    parts = partition_graph(graph, exp.num_parts)
    deciders = [exp.backend] * exp.num_parts if exp.variant == "rudder" else None
    return DistributedTrainer(
        parts,
        variant=exp.variant,
        deciders=deciders,
        buffer_frac=exp.buffer_frac,
        batch_size=exp.batch_size,
        epochs=exp.epochs,
        mode=exp.mode,
        interval=exp.interval,
        train_model=train_model,
        seed=exp.seed,
        device=device,
    )
