"""Per-step readings of the program's spans, for the per-layer metrics.

``run["spans"]`` holds the traced window's spans as ``(name, t0, t1)``
host seconds; ``run["steps"]`` the window's steps. A tree whose program
does not record a span gives ``None`` for it, so a metric that reads a
span a later program adds falls silent on an older one.
"""

from __future__ import annotations


def per_step_ms(run, names) -> float | None:
    """Milliseconds a step of the spans named in ``names``, summed; None
    when none of them appears or the window has no step."""
    names = set(names)
    found = [t1 - t0 for name, t0, t1 in run["spans"] if name in names]
    if not run["steps"] or not found:
        return None
    return 1e3 * sum(found) / run["steps"]
