"""Classifier features for Rudder's when-to-replace decision (paper §4.4).

Only the numpy featurizer lives here: :class:`repro_torch.core.controller.
AdaptiveController` featurizes each observation before it asks a fitted
classifier. The classifier models themselves come with a later slice.
"""

from __future__ import annotations

import numpy as np

from .metrics import Metrics

FEATURE_NAMES = (
    "pct_hits",
    "delta_hits",
    "comm_norm",
    "delta_comm",
    "replaced_pct",
    "occupancy",
    "progress",
    "hits_trend",
)
NUM_FEATURES = len(FEATURE_NAMES)


def featurize(
    metrics: Metrics,
    prev: Metrics | None = None,
    recent_hits: list[float] | None = None,
    recent_comm: list[int] | None = None,
) -> np.ndarray:
    """Map one observation to the classifier feature vector.

    Communication features are normalised by the *running* comm scale
    (scale-free across graph sizes) rather than buffer capacity, so an
    offline-trained classifier transfers across datasets the way the
    paper deploys it.
    """
    comm_scale = max(max(recent_comm) if recent_comm else 0, metrics.comm_volume, 1)
    delta_hits = (metrics.pct_hits - prev.pct_hits) / 100.0 if prev else 0.0
    delta_comm = (
        (metrics.comm_volume - prev.comm_volume) / comm_scale if prev else 0.0
    )
    trend = 0.0
    if recent_hits and len(recent_hits) >= 4:
        k = min(4, len(recent_hits) // 2)
        trend = (
            sum(recent_hits[-k:]) / k - sum(recent_hits[-2 * k : -k]) / k
        ) / 100.0
    return np.array(
        [
            metrics.pct_hits / 100.0,
            delta_hits,
            metrics.comm_volume / comm_scale,
            np.clip(delta_comm, -1.0, 1.0),
            metrics.replaced_pct / 100.0,
            metrics.buffer_occupancy,
            metrics.progress,
            trend,
        ],
        dtype=np.float32,
    )
