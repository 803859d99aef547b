"""Telemetry plane of the port: metrics registry, span tracing, kernel
profiling.

The reference's telemetry plane on the port's trainer. One
:class:`TelemetrySession` (registry + tracer) is installed process-wide
for the duration of a run; instrumentation sites across the other planes
call the module-level helpers below, which are no-ops while no session
is active.

The load-bearing contract (mirrors the trace plane's):

* **Off is free.** Telemetry defaults to off; every hook is then one
  global load + ``None`` check and *no* telemetry object is ever
  constructed — runs reproduce the committed golden traces
  bit-identically.
* **On never perturbs exact streams.** Spans and counters observe;
  they never feed back into sampling, scoring, decisions, or byte
  accounting — telemetry-on runs keep the same
  ``Trace.exact_digest()``. Only wall-clock (already excluded from
  exact digests) can move: ``@profiled`` dispatchers are timed by CUDA
  event pairs, resolved after the run (never a sync on the hot path),
  and the fetch stage's readback waits on an event before it copies
  (the ``device.wait`` span).
* **One clock with the device trace.** While ``torch.profiler``
  records, every span and every ``@profiled`` dispatcher call also runs
  inside ``record_function("repro.<name>")``.

Copies between host and device are counted by site
(:func:`copied`: ``device.<way>_bytes`` and
``device.<way>_bytes.<site>``). Every span carries its ``step``, ``id``
and ``parent``; ``python -m repro_torch.telemetry steps run.jsonl``
lists the longest steps by phase.

Usage::

    trainer = DistributedTrainer(parts, telemetry=True)
    result = trainer.run()
    result.telemetry["spans"]["by_plane"]      # seconds per plane
    trainer.last_telemetry.write_jsonl("run.jsonl")
    # python -m repro_torch.telemetry summary run.jsonl

Artifacts are the reference's format: each package's ``load_jsonl`` and
CLI read the other's JSONL.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

from .calibrate import (
    Calibration,
    calibrate_from_session,
    calibrate_from_trace,
    fit_alpha_bw,
)
from .provenance import provenance
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .session import TelemetrySession
from .spans import Span, SpanTracer, profiling

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanTracer",
    "TelemetrySession",
    "Calibration",
    "fit_alpha_bw",
    "calibrate_from_trace",
    "calibrate_from_session",
    "provenance",
    "current",
    "enabled",
    "activate",
    "deactivate",
    "active",
    "span",
    "begin",
    "end",
    "count",
    "copied",
    "mark",
    "wait",
    "gauge",
    "observe",
    "spanned",
    "profiled",
]

_SESSION: TelemetrySession | None = None


class _NullSpan:
    """Shared do-nothing span for telemetry-off code paths.

    Deliberately *not* ``__slots__``-restricted: instrumented code sets
    attributes on the span it holds (``sp.nbytes = ...``) and must not
    care whether telemetry is live.
    """

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def current() -> TelemetrySession | None:
    return _SESSION


def enabled() -> bool:
    return _SESSION is not None


def activate(session: TelemetrySession) -> TelemetrySession:
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("a telemetry session is already active")
    _SESSION = session
    return session


def deactivate() -> None:
    global _SESSION
    _SESSION = None


@contextmanager
def active(session: TelemetrySession):
    """Install ``session`` as the process-wide session for the block."""
    activate(session)
    try:
        yield session
    finally:
        deactivate()


# -- cheap instrumentation helpers (the only API call sites use) ------- #
def span(name: str, pe: int = -1, plane: str = "", nbytes: int = 0):
    s = _SESSION
    if s is None:
        return _NULL_SPAN
    return s.tracer.span(name, pe=pe, plane=plane, nbytes=nbytes)


def begin(name: str, pe: int = -1, plane: str = "", step: int | None = None):
    """Open a span without a ``with`` block; pair with :func:`end`.

    Returns ``None`` when telemetry is off — ``end(None)`` is a no-op,
    so loop bodies stay un-indented at zero cost. ``step`` marks the span
    as the one that opens training step ``step`` (the loops' ``step``
    span); a session whose tracer has no ``begin_step`` gets a plain
    span.
    """
    s = _SESSION
    if s is None:
        return None
    if step is not None:
        begin_step = getattr(s.tracer, "begin_step", None)
        if begin_step is not None:
            return begin_step(name, step, pe=pe, plane=plane)
    return s.tracer.begin(name, pe=pe, plane=plane)


def end(token) -> None:
    if token is not None:
        token.__exit__(None, None, None)


def copied(site: str, way: str, nbytes) -> None:
    """Count a copy of ``nbytes`` between host and device (``way``
    ``"h2d"`` or ``"d2h"``) made at ``site``: into ``device.<way>_bytes``
    and ``device.<way>_bytes.<site>``."""
    s = _SESSION
    if s is None:
        return
    n = int(nbytes)
    s.registry.counter(f"device.{way}_bytes").add(n)
    s.registry.counter(f"device.{way}_bytes.{site}").add(n)


def mark(device):
    """A CUDA event recorded now on ``device``'s current stream, for
    :func:`wait`; None when telemetry is off or ``device`` is not a card."""
    s = _SESSION
    if s is None or getattr(device, "type", None) != "cuda":
        return None
    import torch

    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def wait(event) -> None:
    """The ``device.wait`` span: the host blocked until ``event`` (a
    :func:`mark`), and so everything queued before it, has finished."""
    s = _SESSION
    if s is None:
        return
    with s.tracer.span("device.wait", plane="device"):
        if event is not None:
            event.synchronize()


def count(name: str, value=1, shape=None) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.counter(name, shape=shape).add(value)


def gauge(name: str, value) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.gauge(name).set(value)


def observe(name: str, value) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.histogram(name).observe(value)


def spanned(name: str, plane: str = ""):
    """Method/function decorator: run the call under a span when on.

    Off-path cost is one global load + ``None`` check per call — no
    span object, no context manager, no tracer touch.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = _SESSION
            if s is None:
                return fn(*args, **kwargs)
            with s.tracer.span(name, plane=plane):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def profiled(name: str):
    """Kernel-dispatcher decorator.

    With no active session the wrapper is a direct call. With one, the
    call runs inside ``record_function("repro.<name>")`` while
    ``torch.profiler`` records, and through the session's
    ``profile_call`` (timing without a sync) when ``profile_kernels`` is
    on; the device pipeline's async launch overlap is untouched.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = _SESSION
            if s is None:
                return fn(*args, **kwargs)

            def call():
                if s.profile_kernels:
                    return s.profile_call(name, fn, *args, **kwargs)
                return fn(*args, **kwargs)

            if not profiling():
                return call()
            import torch

            with torch.profiler.record_function(f"repro.{name}"):
                return call()

        return wrapper

    return deco
