"""Graph substrate: generation, partitioning, neighbor sampling."""

from .generate import (
    CONGESTION_PRESETS,
    DATASET_PRESETS,
    STRAGGLER_PRESETS,
    TOPOLOGIES,
    CongestionModel,
    Graph,
    StragglerModel,
    Topology,
    generate,
    make_congestion,
    make_stragglers,
    make_topology,
    validate_csr,
)
from .partition import partition_graph
from .sampler import NeighborSampler, SamplerPlane

__all__ = [
    "Graph",
    "generate",
    "DATASET_PRESETS",
    "Topology",
    "TOPOLOGIES",
    "make_topology",
    "StragglerModel",
    "STRAGGLER_PRESETS",
    "make_stragglers",
    "CongestionModel",
    "CONGESTION_PRESETS",
    "make_congestion",
    "validate_csr",
    "partition_graph",
    "NeighborSampler",
    "SamplerPlane",
]
