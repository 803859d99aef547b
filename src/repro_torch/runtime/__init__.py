"""Device-resident multi-trainer prefetch runtime.

* :class:`PrefetchEngine` — all per-PE persistent buffers as dense
  ``(P, C)`` numpy arrays (the trainer's warm-started state);
* :class:`DeviceEngine` — the same state as torch tensors on a device,
  advanced one single-launch frontier step per training step;
* :class:`SampleStage`, :class:`DecisionStage`, :class:`FusedFetchStage`
  — the sample → decide → fetch pipeline;
* :func:`run_device` — the minibatch loop of ``DistributedTrainer.run``.
"""

from .driver import run_device
from .engine import DeviceEngine, EngineStats, PrefetchEngine
from .stage import DecisionStage, FusedFetchStage, SampleStage

__all__ = [
    "PrefetchEngine",
    "DeviceEngine",
    "EngineStats",
    "SampleStage",
    "DecisionStage",
    "FusedFetchStage",
    "run_device",
]
