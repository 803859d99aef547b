"""TelemetrySession: one run's registry + tracer + kernel profiler.

A session owns a :class:`MetricsRegistry` and a :class:`SpanTracer`
and is installed as the process-wide active session for the duration
of one ``DistributedTrainer.run()`` (see :func:`repro_torch.telemetry.active`).
Instrumentation sites never hold a session reference — they ask the
module-level helpers, which are no-ops when nothing is active. That
indirection is the zero-overhead-off contract: with no session, every
hook is one global load and a ``None`` check.

Kernel profiling (``profile_call``) times a dispatcher call and, when any
tensor it returns lies on a CUDA device, waits with
``torch.cuda.synchronize()`` before the clock stops: the wait is what
makes the number mean "kernel finished", not "launch returned" (the
reference blocks on its outputs for the same reason). With
``annotate=True`` the call also runs under
``torch.profiler.record_function("repro.<name>")``, so it shows up in a
``torch.profiler`` trace when one is being captured.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

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
    def __init__(
        self,
        label: str = "run",
        profile_kernels: bool = True,
        annotate: bool = False,
    ):
        self.label = label
        self.profile_kernels = profile_kernels
        self.annotate = annotate
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer()
        self.meta: dict = {}

    # -- kernel profiling ---------------------------------------------- #
    def profile_call(self, name: str, fn, *args, **kwargs):
        """Call ``fn`` timed to its outputs' completion under ``name``."""
        if self.annotate:
            import torch

            annotation = torch.profiler.record_function(f"repro.{name}")
        else:
            annotation = nullcontext()
        t0 = time.perf_counter()
        with annotation:
            out = fn(*args, **kwargs)
            if _on_cuda(out):
                import torch

                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.registry.counter(f"kernel.{name}.calls").add(1)
        self.registry.histogram(f"kernel.{name}.seconds").observe(dt)
        return out

    # -- aggregation --------------------------------------------------- #
    def summary(self) -> dict:
        """Flat JSON-safe summary merged into RunResult / sweep rows."""
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
