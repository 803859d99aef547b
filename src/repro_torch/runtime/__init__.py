"""Multi-trainer prefetch runtime.

* :class:`PrefetchEngine` — all per-PE persistent buffers as dense
  ``(P, C)`` numpy arrays (the trainer's warm-started state, and the
  staged loop's engine);
* :class:`DeviceEngine` — the same state as torch tensors on a device,
  advanced one single-launch frontier step per training step;
* :class:`SampleStage`, :class:`DecisionStage`, :class:`FetchStage`,
  :class:`FusedFetchStage` — the sample → decide → fetch pipeline, staged
  or device-resident;
* :func:`run_vectorized` — the minibatch loop of
  ``DistributedTrainer.run``: the staged loop, or :func:`run_device`, the
  device-resident one;
* :func:`run_sweep` — the one-process grid runner over
  (graph, num_parts, batch_size, fanout, controller, policy, topology)
  configurations (:mod:`repro_torch.runtime.sweep`).
"""

from .driver import run_device, run_vectorized
from .engine import DeviceEngine, EngineStats, PrefetchEngine
from .stage import DecisionStage, FetchStage, FusedFetchStage, SampleStage
from .sweep import (
    SweepConfig,
    default_grid,
    run_sweep,
    sweep_artifact,
    validate_rows,
    write_sweep_json,
)

__all__ = [
    "PrefetchEngine",
    "DeviceEngine",
    "EngineStats",
    "SampleStage",
    "DecisionStage",
    "FetchStage",
    "FusedFetchStage",
    "run_device",
    "run_vectorized",
    "SweepConfig",
    "default_grid",
    "run_sweep",
    "sweep_artifact",
    "validate_rows",
    "write_sweep_json",
]
