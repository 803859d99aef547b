"""Span tracer: nested wall-clock intervals on per-PE tracks.

A span is a named interval (``perf_counter`` seconds relative to the
tracer's origin) on a *track* — ``pe=-1`` is the host/driver track,
``pe >= 0`` a trainer PE. Tracks carry independent nesting stacks, so
``step > sample > kernel.gather_rows`` nests naturally and the
exporter can emit Chrome-trace complete events per track.

Each finished span records its *inclusive* duration and the summed
duration of its direct children (``child_s``); the difference is its
*exclusive* (self) time, which is what per-plane breakdowns sum so
that a plane's seconds are never double-counted against its callees'.
"""

from __future__ import annotations

import time

__all__ = ["Span", "SpanTracer"]


class Span:
    """One timed interval; use as a context manager via ``tracer.span``."""

    __slots__ = (
        "name",
        "plane",
        "pe",
        "t0",
        "t1",
        "depth",
        "nbytes",
        "child_s",
        "_tracer",
    )

    def __init__(self, tracer: "SpanTracer", name: str, pe: int, plane: str, nbytes: int):
        self._tracer = tracer
        self.name = name
        self.plane = plane
        self.pe = pe
        self.nbytes = nbytes
        self.t0 = 0.0
        self.t1 = 0.0
        self.depth = 0
        self.child_s = 0.0

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    @property
    def self_s(self) -> float:
        """Exclusive time: inclusive duration minus direct children."""
        return max(self.duration - self.child_s, 0.0)

    def __enter__(self) -> "Span":
        self._tracer._enter(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._exit(self)
        return False

    def as_row(self) -> dict:
        return {
            "name": self.name,
            "plane": self.plane,
            "pe": self.pe,
            "t0": self.t0,
            "t1": self.t1,
            "depth": self.depth,
            "nbytes": int(self.nbytes),
        }


class SpanTracer:
    """Collects finished spans; per-track stacks give nesting depth."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stacks: dict[int, list[Span]] = {}
        self.origin = time.perf_counter()

    def span(self, name: str, pe: int = -1, plane: str = "", nbytes: int = 0) -> Span:
        return Span(self, name, pe, plane or name.split(".", 1)[0], nbytes)

    # -- context-manager protocol driven by Span ----------------------- #
    def _enter(self, span: Span) -> None:
        stack = self._stacks.setdefault(span.pe, [])
        span.depth = len(stack)
        stack.append(span)
        span.t0 = time.perf_counter() - self.origin

    def _exit(self, span: Span) -> None:
        span.t1 = time.perf_counter() - self.origin
        stack = self._stacks.get(span.pe)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:
            # Mis-nested begin/end (an exception unwound past an open
            # begin token): drop everything above it rather than corrupt
            # the depth accounting for the rest of the run.
            while stack[-1] is not span:
                stack.pop()
            stack.pop()
        if stack:
            stack[-1].child_s += span.duration
        self.spans.append(span)

    # -- explicit begin/end (for loop bodies where `with` would force a
    #    large re-indent); telemetry-off callers get None tokens ------- #
    def begin(self, name: str, pe: int = -1, plane: str = "", nbytes: int = 0) -> Span:
        span = self.span(name, pe=pe, plane=plane, nbytes=nbytes)
        span.__enter__()
        return span

    def end(self, span: Span | None) -> None:
        if span is not None:
            span.__exit__(None, None, None)

    # -- aggregation --------------------------------------------------- #
    def by_name(self) -> dict:
        """``{name: {count, total_s}}`` over inclusive durations."""
        out: dict[str, dict] = {}
        for sp in self.spans:
            row = out.setdefault(sp.name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += sp.duration
        return out

    def by_plane(self) -> dict:
        """``{plane: self_seconds}`` — exclusive time, sums to <= wall."""
        out: dict[str, float] = {}
        for sp in self.spans:
            out[sp.plane] = out.get(sp.plane, 0.0) + sp.self_s
        return out

    def total_s(self) -> float:
        """Wall seconds covered by top-level spans."""
        return sum(sp.duration for sp in self.spans if sp.depth == 0)

    def summary(self) -> dict:
        names = self.by_name()
        return {
            "span_count": len(self.spans),
            "total_s": self.total_s(),
            "by_plane": dict(sorted(self.by_plane().items())),
            "by_name": {k: names[k] for k in sorted(names)},
        }
