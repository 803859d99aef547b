"""Trace plane — deterministic capture/replay of the exact run streams.

Port of the reference's ``trace`` package, which is numpy only: these
modules are copies with their imports re-pointed, so the schema is
byte-compatible and each package's :func:`load_trace` reads the other's
files (the committed goldens under ``tests/golden/`` included).

* :class:`TraceRecorder` (:mod:`.capture`) — fed by the device loop
  behind ``DistributedTrainer(trace=...)``;
* :class:`Trace` / schema (:mod:`.schema`) — dtype-normalized arrays +
  JSON manifest with a payload digest and :meth:`Trace.exact_digest`;
* :func:`save_trace` / :func:`load_trace` (:mod:`.store`);
* :func:`diff_traces` (:mod:`.diff`) — structured first-divergence report;
* replay adapters (:mod:`.replay`);
* ``python -m repro_torch.trace`` (:mod:`.cli`) — ``record`` / ``replay``
  / ``diff`` / ``verify``, the port's trainer on ``--device`` (``cuda``
  by default).
"""

from .capture import TraceRecorder, controller_validity
from .diff import DiffReport, Divergence, diff_traces, write_report_json
from .replay import (
    metrics_at,
    replay_decisions,
    replay_decisions_report,
    replay_time_engine,
    replay_time_engine_report,
)
from .schema import ID_DTYPE, SCHEMA_VERSION, Trace, normalize_ids
from .store import load_trace, save_trace, trace_paths

__all__ = [
    "SCHEMA_VERSION",
    "ID_DTYPE",
    "Trace",
    "normalize_ids",
    "TraceRecorder",
    "controller_validity",
    "save_trace",
    "load_trace",
    "trace_paths",
    "diff_traces",
    "DiffReport",
    "Divergence",
    "write_report_json",
    "metrics_at",
    "replay_decisions",
    "replay_decisions_report",
    "replay_time_engine",
    "replay_time_engine_report",
]
