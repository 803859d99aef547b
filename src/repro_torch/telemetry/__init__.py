"""Telemetry hooks of the port: the off-path API only.

Instrumentation sites across the other planes call the module-level
helpers below. They are no-ops while no session is active, and in this
package no session ever is: the session object (metrics registry, span
tracer, kernel profiling) is not ported yet, so ``DistributedTrainer``
refuses ``telemetry=...``. The helpers keep the reference's names and
signatures so that the copied planes keep their call sites unchanged.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

__all__ = [
    "current",
    "enabled",
    "activate",
    "deactivate",
    "active",
    "span",
    "begin",
    "end",
    "count",
    "spanned",
    "profiled",
]

_SESSION = None


class _NullSpan:
    """Shared do-nothing span for telemetry-off code paths."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def current():
    return _SESSION


def enabled() -> bool:
    return _SESSION is not None


def activate(session):
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("a telemetry session is already active")
    _SESSION = session
    return session


def deactivate() -> None:
    global _SESSION
    _SESSION = None


@contextmanager
def active(session):
    """Install ``session`` as the process-wide session for the block."""
    activate(session)
    try:
        yield session
    finally:
        deactivate()


def span(name: str, pe: int = -1, plane: str = "", nbytes: int = 0):
    s = _SESSION
    if s is None:
        return _NULL_SPAN
    return s.tracer.span(name, pe=pe, plane=plane, nbytes=nbytes)


def begin(name: str, pe: int = -1, plane: str = ""):
    """Open a span without a ``with`` block; pair with :func:`end`.
    Returns ``None`` when telemetry is off."""
    s = _SESSION
    if s is None:
        return None
    return s.tracer.begin(name, pe=pe, plane=plane)


def end(token) -> None:
    if token is not None:
        token.__exit__(None, None, None)


def count(name: str, value=1, shape=None) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.counter(name, shape=shape).add(value)


def spanned(name: str, plane: str = ""):
    """Method/function decorator: run the call under a span when on."""

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
    """Kernel-dispatcher decorator: timed through the session when on,
    a direct call otherwise."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = _SESSION
            if s is None or not s.profile_kernels:
                return fn(*args, **kwargs)
            return s.profile_call(name, fn, *args, **kwargs)

        return wrapper

    return deco
