"""Cluster simulation plane — wall-clock models for the exact streams.

The three batched planes (sample → decide → fetch) produce *exact*
per-minibatch artifacts: hit/miss sets, fetched-node counts split by
home partition, decision streams, replacement rounds. This package
prices those streams in time, two interchangeable ways behind one
:class:`TimeEngine` interface (``DistributedTrainer(time_engine=...)``):

* ``"closed_form"`` — the paper's §4.5.3 formulas (the default);
* ``"event"`` — a deterministic discrete-event simulator with
  per-trainer/per-link timelines, max–min fair home-egress contention,
  straggler/jitter injection, a wall-clock agent-daemon lane, and
  prefetcher-thread replacement overlap.

With no dynamic conditions injected the event engine reproduces the
closed form **bit-identically** (the parity contract,
``tests/test_runtime_parity.py``); see ``docs/ARCHITECTURE.md``
§"Simulation plane".
"""

from __future__ import annotations

import numpy as np

from ..graph.generate import (
    CONGESTION_PRESETS,
    STRAGGLER_PRESETS,
    CongestionModel,
    StragglerModel,
    make_congestion,
    make_stragglers,
)
from .contention import Flow, simulate_flows
from .engine import (
    ClosedFormTimeEngine,
    EventTimeEngine,
    SimConfig,
    StepComm,
    TimeEngine,
    build_step_comm,
)
from .events import EventLog, SimEvent

#: Valid ``DistributedTrainer(time_engine=...)`` / ``--time-engine`` values.
TIME_ENGINES = ("closed_form", "event")


def make_time_engine(
    kind: str,
    *,
    tm,
    mode: str,
    inference_cost,
    feature_dim: int,
    num_pes: int,
    topology=None,
    stragglers: StragglerModel | None = None,
    congestion: CongestionModel | None = None,
    config: SimConfig | None = None,
    total_steps: int = 0,
) -> TimeEngine:
    """Build a fresh per-run time engine.

    The closed form cannot express dynamic conditions, so passing a
    straggler/congestion model (or a non-default :class:`SimConfig`)
    with ``kind="closed_form"`` is an error rather than a silent no-op.
    """
    inference_cost = np.asarray(inference_cost, dtype=np.float64)
    if kind == "closed_form":
        if stragglers is not None or congestion is not None or (
            config is not None and config != SimConfig(
                collect_events=config.collect_events
            )
        ):
            raise ValueError(
                "stragglers/congestion/SimConfig knobs require "
                "time_engine='event' (the closed form cannot express them)"
            )
        return ClosedFormTimeEngine(
            tm, mode, inference_cost, feature_dim, num_pes, topology
        )
    if kind == "event":
        return EventTimeEngine(
            tm, mode, inference_cost, feature_dim, num_pes,
            topology=topology, stragglers=stragglers, congestion=congestion,
            config=config, total_steps=total_steps,
        )
    raise ValueError(
        f"time_engine must be one of {TIME_ENGINES}, got {kind!r}"
    )


__all__ = [
    "TIME_ENGINES",
    "TimeEngine",
    "ClosedFormTimeEngine",
    "EventTimeEngine",
    "SimConfig",
    "StepComm",
    "build_step_comm",
    "make_time_engine",
    "EventLog",
    "SimEvent",
    "Flow",
    "simulate_flows",
    "StragglerModel",
    "STRAGGLER_PRESETS",
    "make_stragglers",
    "CongestionModel",
    "CONGESTION_PRESETS",
    "make_congestion",
]
