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
  device-resident one.
"""

from .driver import run_device, run_vectorized
from .engine import DeviceEngine, EngineStats, PrefetchEngine
from .stage import DecisionStage, FetchStage, FusedFetchStage, SampleStage

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
]
