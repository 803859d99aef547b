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

Each span also records ``id`` (the tracer's sequence number, in the
order spans open), ``parent`` (the ``id`` of the span enclosing it on
its track, -1 at a track's top) and ``step`` (the index of the training
step open when it opened, -1 outside steps; a loop opens its ``step``
span through :meth:`SpanTracer.begin_step`).

While ``torch.profiler`` records, every span also runs inside
``torch.profiler.record_function("repro.<name>")``, so the program's
phases sit on the profiler's clock beside the kernels and copies they
launch; with the profiler off no range is entered.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "SpanTracer", "profiling"]


def profiling() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) records."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(name: str):
    """The entered ``record_function("repro.<name>")`` range."""
    import torch

    rf = torch.profiler.record_function("repro." + name)
    rf.__enter__()
    return rf


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
        "id",
        "parent",
        "step",
        "_tracer",
        "_range",
        "_prev_step",
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
        self.id = -1
        self.parent = -1
        self.step = -1
        self._range = None
        # The tracer's step before this span opened one (None: it opens none).
        self._prev_step = None

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
            "id": self.id,
            "parent": self.parent,
            "step": self.step,
        }


class SpanTracer:
    """Collects finished spans; per-track stacks give nesting depth."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stacks: dict[int, list[Span]] = {}
        self._next_id = 0
        self._step = -1  # the open step's index, -1 outside steps
        self.origin = time.perf_counter()

    def span(self, name: str, pe: int = -1, plane: str = "", nbytes: int = 0) -> Span:
        return Span(self, name, pe, plane or name.split(".", 1)[0], nbytes)

    # -- context-manager protocol driven by Span ----------------------- #
    def _enter(self, span: Span) -> None:
        stack = self._stacks.setdefault(span.pe, [])
        span.depth = len(stack)
        span.parent = stack[-1].id if stack else -1
        span.id = self._next_id
        self._next_id += 1
        if span._prev_step is None:
            span.step = self._step
        else:
            span._prev_step, self._step = self._step, span.step
        stack.append(span)
        if profiling():
            span._range = _open_range(span.name)
        span.t0 = time.perf_counter() - self.origin

    @staticmethod
    def _close_range(span: Span) -> None:
        if span._range is not None:
            rf, span._range = span._range, None
            rf.__exit__(None, None, None)

    def _drop(self, span: Span) -> None:
        """Closes what a span left open that the recovery pops unexited:
        its profiler range and, if it opened a step, the step."""
        self._close_range(span)
        if span._prev_step is not None:
            self._step, span._prev_step = span._prev_step, None

    def _exit(self, span: Span) -> None:
        span.t1 = time.perf_counter() - self.origin
        stack = self._stacks.get(span.pe)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:
            # Mis-nested begin/end (an exception unwound past an open
            # begin token): drop everything above it rather than corrupt
            # the depth accounting for the rest of the run; their
            # profiler ranges close first, innermost first.
            while stack[-1] is not span:
                self._drop(stack.pop())
            stack.pop()
        self._drop(span)
        if stack:
            stack[-1].child_s += span.duration
        self.spans.append(span)

    # -- explicit begin/end (for loop bodies where `with` would force a
    #    large re-indent); telemetry-off callers get None tokens ------- #
    def begin(self, name: str, pe: int = -1, plane: str = "", nbytes: int = 0) -> Span:
        span = self.span(name, pe=pe, plane=plane, nbytes=nbytes)
        span.__enter__()
        return span

    def begin_step(self, name: str, step: int, pe: int = -1, plane: str = "") -> Span:
        """:meth:`begin` a span that opens training step ``step``: it and
        every span opened before it ends carry ``step``."""
        span = self.span(name, pe=pe, plane=plane)
        span.step = int(step)
        span._prev_step = -1
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
