"""Fit TimeModel constants (alpha, link_bw) from measured streams.

The §4.5.3 clock prices a fetch of ``n`` bytes at
``alpha + n / link_bw`` seconds. The feature-store data plane records
what the same fetch *actually* cost (``fetch_time_measured`` +
``bytes_measured`` in store-enabled traces; ``store.gather`` spans with
``nbytes`` in telemetry sessions), so the two constants fall out of an
ordinary least-squares line through (bytes, seconds): the slope is
``1 / link_bw``, the intercept is ``alpha``. This closes the ROADMAP
item "fit TimeModel constants from the recorded fetch_time_measured
stream" — the modeled clock anchored to measured reality.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

__all__ = ["Calibration", "fit_alpha_bw", "calibrate_from_trace", "calibrate_from_session"]

# One process-wide warning when a fit degenerates (non-positive slope →
# link_bw = inf); sweeps fitting hundreds of cells should not drown in
# repeats. Reset is test-only: ``_warned_degenerate_fit = False``.
_warned_degenerate_fit = False


@dataclass
class Calibration:
    alpha: float
    link_bw: float
    n_samples: int
    max_abs_err_s: float

    def predict(self, nbytes) -> np.ndarray:
        return self.alpha + np.asarray(nbytes, dtype=np.float64) / self.link_bw

    def to_time_model(self, t_ddp: float | None = None, feature_bytes: int | None = None):
        """A TimeModel with the fitted constants (others keep defaults)."""
        from ..gnn.train import TimeModel

        kwargs = {"alpha": self.alpha, "link_bw": self.link_bw}
        if t_ddp is not None:
            kwargs["t_ddp"] = t_ddp
        if feature_bytes is not None:
            kwargs["feature_bytes"] = feature_bytes
        return TimeModel(**kwargs)

    def summary(self) -> dict:
        return {
            "alpha": self.alpha,
            "link_bw": self.link_bw,
            "n_samples": self.n_samples,
            "max_abs_err_s": self.max_abs_err_s,
        }


def fit_alpha_bw(nbytes, seconds) -> Calibration:
    """Least-squares ``seconds ~ alpha + nbytes / link_bw``.

    Zero-byte samples are dropped (the model prices an empty fetch at
    exactly 0, not alpha). Needs >= 2 samples with distinct byte counts;
    a fitted non-positive slope (measurement noise swamping the trend)
    degenerates to ``link_bw = inf`` with ``alpha = mean(seconds)``.
    """
    x = np.asarray(nbytes, dtype=np.float64).ravel()
    y = np.asarray(seconds, dtype=np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")
    keep = np.isfinite(x) & np.isfinite(y) & (x > 0)
    x, y = x[keep], y[keep]
    if x.size < 2 or np.unique(x).size < 2:
        raise ValueError(
            "calibration needs >= 2 samples with distinct byte counts, "
            f"got {x.size} usable samples"
        )
    slope, intercept = np.polyfit(x, y, 1)
    if slope <= 0:
        global _warned_degenerate_fit
        if not _warned_degenerate_fit:
            _warned_degenerate_fit = True
            warnings.warn(
                "calibration fit has a non-positive slope (measured "
                "seconds do not grow with bytes); degenerating to "
                "link_bw=inf with alpha=mean(seconds)",
                RuntimeWarning,
                stacklevel=2,
            )
        link_bw = float("inf")
        alpha = float(y.mean())
    else:
        link_bw = 1.0 / float(slope)
        alpha = max(float(intercept), 0.0)
    pred = alpha + x / link_bw
    return Calibration(
        alpha=alpha,
        link_bw=link_bw,
        n_samples=int(x.size),
        max_abs_err_s=float(np.abs(pred - y).max()),
    )


def calibrate_from_trace(trace) -> Calibration:
    """Fit from a store-enabled :class:`repro_torch.trace.schema.Trace`.

    Uses the per-step totals: ``bytes_measured`` summed across PEs and
    ``fetch_time_measured`` (the batched gather's wall clock, recorded
    broadcast across PEs) averaged per step.
    """
    arrays = trace.arrays
    if "bytes_measured" not in arrays or "fetch_time_measured" not in arrays:
        raise ValueError(
            "trace has no measured store streams "
            "(record with feature_store=True)"
        )
    nbytes = np.asarray(arrays["bytes_measured"]).sum(axis=1)
    seconds = np.asarray(arrays["fetch_time_measured"]).mean(axis=1)
    return fit_alpha_bw(nbytes, seconds)


def calibrate_from_session(session) -> Calibration:
    """Fit from a telemetry session's ``store.gather`` spans."""
    pairs = [
        (sp.nbytes, sp.duration)
        for sp in session.tracer.spans
        if sp.name == "store.gather" and sp.nbytes > 0
    ]
    if len(pairs) < 2:
        raise ValueError(
            "session has < 2 store.gather spans with recorded bytes"
        )
    nbytes, seconds = zip(*pairs)
    return fit_alpha_bw(np.asarray(nbytes), np.asarray(seconds))
