"""TelemetrySession: one run's registry + tracer + kernel profiler.

A session owns a :class:`MetricsRegistry` and a :class:`SpanTracer`
and is installed as the process-wide active session for the duration
of one ``DistributedTrainer.run()`` (see :func:`repro_torch.telemetry.active`).
Instrumentation sites never hold a session reference — they ask the
module-level helpers, which are no-ops when nothing is active. That
indirection is the zero-overhead-off contract: with no session, every
hook is one global load and a ``None`` check.

Kernel profiling (``profile_call``, ``profile_kernels=True``) never
synchronises. A call whose inputs lie on a CUDA device runs between two
``torch.cuda.Event(enable_timing=True)`` records on the current stream;
the pairs are kept and resolved by ``elapsed_time`` only when the session
is summarised or exported (:meth:`TelemetrySession.resolve`), after the
run's own end. ``kernel.<name>.seconds`` then holds device seconds: an
event pair spans the dispatcher's work on the stream, including any gaps
between its kernels (and the launch itself when the stream runs dry). A
call on the CPU, which is synchronous there, records its host time.
"""

from __future__ import annotations

import time

from .registry import MetricsRegistry
from .spans import SpanTracer

__all__ = ["TelemetrySession"]


def _on_cuda(out) -> bool:
    """True if ``out`` (a tensor, or a tuple / list nesting them) holds a
    tensor on a CUDA device."""
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    device = getattr(out, "device", None)
    return getattr(device, "type", None) == "cuda"


class TelemetrySession:
    def __init__(self, label: str = "run", profile_kernels: bool = True):
        self.label = label
        self.profile_kernels = profile_kernels
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer()
        self.meta: dict = {}
        # (dispatcher, start event, end event) not yet resolved.
        self._pending: list = []

    # -- kernel profiling ---------------------------------------------- #
    def profile_call(self, name: str, fn, *args, **kwargs):
        """Call ``fn`` under ``name``: device time by a CUDA event pair
        when its inputs lie on a card, else host time; never a sync."""
        self.registry.counter(f"kernel.{name}.calls").add(1)
        if _on_cuda(args) or _on_cuda(list(kwargs.values())):
            import torch

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self._pending.append((name, start, end))
            return out
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.registry.histogram(f"kernel.{name}.seconds").observe(time.perf_counter() - t0)
        return out

    def resolve(self) -> None:
        """Fold the kept event pairs into ``kernel.<name>.seconds``
        (waits for the last of them)."""
        pending, self._pending = self._pending, []
        for name, start, end in pending:
            end.synchronize()
            self.registry.histogram(f"kernel.{name}.seconds").observe(
                start.elapsed_time(end) * 1e-3
            )

    # -- aggregation --------------------------------------------------- #
    def summary(self) -> dict:
        """Flat JSON-safe summary merged into RunResult / sweep rows."""
        self.resolve()
        return {
            "label": self.label,
            "spans": self.tracer.summary(),
            "metrics": self.registry.summary(),
            "meta": dict(self.meta),
        }

    def brief(self) -> dict:
        """Compact per-cell summary for sweep rows: seconds by plane
        plus counter totals (no per-element arrays, no histograms)."""
        counters = {
            name: self.registry[name].total
            for name in self.registry.names()
            if self.registry[name].kind == "counter"
        }
        return {
            "wall_s": self.tracer.total_s(),
            "span_count": len(self.tracer.spans),
            "by_plane": dict(sorted(self.tracer.by_plane().items())),
            "counters": counters,
        }

    # -- export (delegates; see export.py) ----------------------------- #
    def write_jsonl(self, path) -> None:
        from .export import write_jsonl

        write_jsonl(self, path)

    def write_chrome_trace(self, path) -> None:
        from .export import write_chrome_trace

        write_chrome_trace(self, path)
