"""Metrics registry: counters, gauges, histograms with dotted names.

The registry is the numeric half of the telemetry plane (spans are the
temporal half, :mod:`repro_torch.telemetry.spans`). Metrics are dense numpy
accumulators so per-PE instrumentation costs one vectorized add, not a
Python loop: a counter's shape is fixed by its first ``add`` — scalar
``()`` or per-PE ``(P,)`` or per-pair ``(P, P)`` — and every later add
must match (a shape change is an instrumentation bug, so it raises).

Names are hierarchical, dot-separated: the first segment identifies the
plane/subsystem (``fetch.miss_nodes``, ``device.fallback_int64``,
``kernel.gather_rows.calls``) and is what the CLI breakdown groups by.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _coerce(value) -> np.ndarray:
    return np.asarray(value, dtype=np.float64)


class Counter:
    """Monotonic accumulator; shape fixed by the first ``add``."""

    kind = "counter"

    def __init__(self, name: str, shape: tuple[int, ...] | None = None):
        self.name = name
        self._values: np.ndarray | None = (
            np.zeros(shape, dtype=np.float64) if shape is not None else None
        )

    def add(self, value=1) -> None:
        arr = _coerce(value)
        if self._values is None:
            self._values = np.zeros(arr.shape, dtype=np.float64)
        elif arr.shape != self._values.shape:
            raise ValueError(
                f"counter {self.name!r} has shape {self._values.shape}, "
                f"got add of shape {arr.shape}"
            )
        self._values += arr

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            return np.zeros((), dtype=np.float64)
        return self._values

    @property
    def total(self) -> float:
        return float(self.values.sum())

    def summary(self) -> dict:
        out: dict = {"total": self.total}
        if self.values.ndim:
            out["values"] = self.values.tolist()
        return out


class Gauge:
    """Last-write-wins value (scalar or array)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._value: np.ndarray = np.zeros((), dtype=np.float64)

    def set(self, value) -> None:
        self._value = _coerce(value)

    @property
    def values(self) -> np.ndarray:
        return self._value

    @property
    def total(self) -> float:
        return float(self._value.sum())

    def summary(self) -> dict:
        out: dict = {"value": self.total}
        if self._value.ndim:
            out["values"] = self._value.tolist()
        return out


class Histogram:
    """Streaming distribution: count/sum/min/max plus a bounded sample.

    Observations beyond ``cap`` keep updating the moments but stop
    growing the sample, so memory stays bounded on long runs while
    percentiles remain available from the (deterministic) prefix.
    """

    kind = "histogram"

    def __init__(self, name: str, cap: int = 65536):
        self.name = name
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.min = np.inf
        self.max = -np.inf
        self._sample: list[float] = []

    def observe(self, value) -> None:
        arr = np.atleast_1d(_coerce(value))
        if not arr.size:
            return
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        room = self.cap - len(self._sample)
        if room > 0:
            self._sample.extend(arr.ravel()[:room].tolist())

    def percentile(self, q: float) -> float:
        if not self._sample:
            return float("nan")
        return float(np.percentile(np.asarray(self._sample), q))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else float("nan"),
            "max": self.max if self.count else float("nan"),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create store of named metrics.

    Re-requesting a name returns the existing metric; requesting it as
    a different kind raises (one name, one meaning).
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kwargs):
        metric = self._metrics.get(name)
        if metric is None:
            metric = cls(name, **kwargs)
            self._metrics[name] = metric
        elif not isinstance(metric, cls):
            raise ValueError(
                f"metric {name!r} is a {metric.kind}, requested {cls.kind}"
            )
        return metric

    def counter(self, name: str, shape: tuple[int, ...] | None = None) -> Counter:
        metric = self._get(name, Counter)
        if shape is not None and metric._values is None:
            metric._values = np.zeros(shape, dtype=np.float64)
        return metric

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __len__(self) -> int:
        return len(self._metrics)

    def summary(self) -> dict:
        """Nested ``{kind: {name: summary}}`` dict, JSON-serializable."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in self.names():
            metric = self._metrics[name]
            out[metric.kind + "s"][name] = metric.summary()
        return out
