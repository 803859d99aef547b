"""One-process scenario sweeps over the port's runtime.

Port of the reference's ``runtime/sweep.py``: a grid of ``(graph,
num_parts, batch_size, fanout, controller, policy, topology,
time_engine, stragglers, congestion)`` configurations run in a single
process, each cell a :func:`repro_torch.trace.cli.build_trainer` trainer
on ``device`` (the card by default, ``"cpu"``, or ``False`` for the
staged host loop). The rows equal the reference's: every metric they
carry is built from exact streams (steady %-Hits, communication per
minibatch, modeled epoch time), except a store cell's measured fetch
seconds.

Partitioned graphs are cached per ``(dataset, num_parts, scale, seed)``
within a sweep, so widening the grid along batch size / fanout /
controller / policy axes reuses the expensive partitioning work.

Sweep output is deterministic under a fixed seed: cells run and emit in
sorted cell-config order (a total key over every config field — labels
alone can collide when grids vary axes the label omits), every
stochastic input is derived from the cell's own seed, and
:func:`write_sweep_json` renders the row set with sorted keys, so the
artifact is diffable across runs.
"""

from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class SweepConfig:
    """One cell of the sweep grid."""

    dataset: str = "products"
    variant: str = "fixed"
    num_parts: int = 4
    batch_size: int = 16
    fanouts: tuple[int, ...] = (10, 25)
    mode: str = "async"
    interval: int = 32
    buffer_frac: float = 0.25
    epochs: int = 5
    backend: str = "gemma3-4b"
    policy: str = "rudder"
    topology: str = "none"  # per-pair comm pricing; "none" = flat model
    time_engine: str = "closed_form"  # wall-clock model (repro_torch.sim)
    stragglers: str = "none"   # straggler preset (event engine only)
    congestion: str = "none"   # congestion preset (event engine only)
    feature_store: bool = False  # serve real features (measured data plane)
    seed: int = 0

    def label(self) -> str:
        fan = "x".join(str(f) for f in self.fanouts)
        label = (
            f"{self.dataset}/p{self.num_parts}/b{self.batch_size}"
            f"/f{fan}/{self.variant}/{self.policy}"
        )
        if self.topology != "none":
            label += f"/t-{self.topology}"
        if self.time_engine != "closed_form":
            label += f"/e-{self.time_engine}"
        if self.stragglers != "none":
            label += f"/s-{self.stragglers}"
        if self.congestion != "none":
            label += f"/c-{self.congestion}"
        if self.feature_store:
            label += "/store"
        return label


#: Config fields that identify a cell (label is a display summary only —
#: grids may legitimately vary axes the label omits, e.g. interval/mode).
CONFIG_KEYS = (
    "dataset",
    "variant",
    "num_parts",
    "batch_size",
    "fanouts",
    "mode",
    "interval",
    "buffer_frac",
    "epochs",
    "backend",
    "policy",
    "topology",
    "time_engine",
    "stragglers",
    "congestion",
    "feature_store",
    "seed",
)


def _cell_key(row: dict) -> tuple:
    """Total, deterministic ordering/identity key for one cell."""
    return tuple(
        tuple(v) if isinstance(v, (list, tuple)) else v
        for v in (row.get(k) for k in CONFIG_KEYS)
    )


def default_grid(
    datasets: tuple[str, ...] = ("products",),
    num_parts: tuple[int, ...] = (2, 4),
    batch_sizes: tuple[int, ...] = (16, 32),
    fanouts: tuple[tuple[int, ...], ...] = ((5, 10), (10, 25)),
    variants: tuple[str, ...] = ("fixed", "massivegnn"),
    policies: tuple[str, ...] = ("rudder",),
    topologies: tuple[str, ...] = ("none",),
    time_engines: tuple[str, ...] = ("closed_form",),
    stragglers: tuple[str, ...] = ("none",),
    congestions: tuple[str, ...] = ("none",),
    epochs: int = 5,
    feature_store: bool = False,
) -> list[SweepConfig]:
    """The stock grid: 16 cells (2 parts x 2 batch x 2 fanout x 2
    controller) by default; the ``policies`` axis multiplies it by the
    scoring/eviction policies of :mod:`repro_torch.core.scoring`, the
    ``datasets`` axis by the graph-scenario families of
    :mod:`repro_torch.graph.generate`, the ``topologies`` axis by the
    cluster cost models and the ``time_engines`` / ``stragglers`` /
    ``congestions`` axes by the simulation plane of
    :mod:`repro_torch.sim`. Straggler/congestion scenarios only exist under the event engine — the closed form cannot express
    them — so closed-form cells are generated for the baseline
    ``("none", "none")`` scenario only.
    """
    return [
        SweepConfig(
            dataset=d,
            variant=v,
            num_parts=p,
            batch_size=b,
            fanouts=f,
            policy=pol,
            topology=t,
            time_engine=te,
            stragglers=s,
            congestion=c,
            feature_store=feature_store,
            epochs=epochs,
        )
        for d in datasets
        for p in num_parts
        for b in batch_sizes
        for f in fanouts
        for v in variants
        for pol in policies
        for t in topologies
        for te in time_engines
        for s in stragglers
        for c in congestions
        if te == "event" or (s == "none" and c == "none")
    ]


def run_sweep(
    configs: list[SweepConfig],
    scale: float = 0.12,
    verbose: bool = False,
    trace_dir: str | None = None,
    telemetry: bool = False,
    device="cuda",
) -> list[dict]:
    """Run every configuration in-process on ``device``; returns one
    result row per cell.

    Rows carry the config fields plus the headline metrics every paper
    figure is built from: steady-state %-Hits, communication per
    minibatch, and modeled mean epoch time. Cells run (and rows return)
    in sorted cell-config order regardless of the order ``configs`` was
    built in, so repeated sweeps over the same grid produce identical
    output.

    With ``trace_dir``, every cell additionally records its full run
    trace (:mod:`repro_torch.trace`) with a replayable manifest config and saves it
    under ``trace_dir/<label>.npz``; rows gain a ``trace`` field naming
    the artifact, so any sweep cell can be replayed or diffed in
    isolation later.

    With ``telemetry=True`` each cell runs under its own
    :class:`repro_torch.telemetry.TelemetrySession` and the row gains a
    ``telemetry`` field (:meth:`TelemetrySession.brief`: wall seconds,
    span count, per-plane exclusive seconds, counter totals). Exact
    metrics are unchanged — telemetry observes, never perturbs.
    """
    # Deferred: repro_torch.gnn.train imports this package at module load.
    from ..graph import generate, partition_graph

    # Single source of cell construction — a replayable trace manifest
    # must rebuild exactly the trainer that recorded it, so the sweep
    # and `python -m repro_torch.trace` share one constructor.
    from ..trace.cli import build_trainer

    parts_cache: dict[tuple, object] = {}
    rows: list[dict] = []
    for cfg in sorted(configs, key=lambda c: _cell_key(asdict(c))):
        key = (cfg.dataset, cfg.num_parts, float(scale), cfg.seed)
        if key not in parts_cache:
            g = generate(cfg.dataset, seed=cfg.seed, scale=scale)
            parts_cache[key] = partition_graph(g, cfg.num_parts)
        cell_config = {
            **asdict(cfg),
            "fanouts": list(cfg.fanouts),
            "scale": float(scale),
            "runtime": "vectorized",
        }
        trainer = build_trainer(cell_config, parts=parts_cache[key], device=device)
        if trace_dir is not None:
            from ..trace import TraceRecorder

            trainer.trace = TraceRecorder.for_trainer(trainer, config=cell_config)
        if telemetry:
            from ..telemetry import TelemetrySession

            trainer.telemetry = TelemetrySession(label=cfg.label())
        result = trainer.run()
        row = asdict(cfg)
        if telemetry:
            row["telemetry"] = trainer.last_telemetry.brief()
        if trace_dir is not None:
            import hashlib

            from ..trace import save_trace

            os.makedirs(trace_dir, exist_ok=True)
            # Labels are display summaries and omit axes (mode, interval,
            # seed, ...); suffix the full cell key so no two cells of any
            # grid can overwrite each other's artifact.
            cell = hashlib.sha1(repr(_cell_key(row)).encode()).hexdigest()[:8]
            name = f"{cfg.label()}-{cfg.mode}-s{cfg.seed}-{cell}".replace("/", "-")
            save_trace(trainer.last_trace, os.path.join(trace_dir, name))
            row["trace"] = f"{name}.npz"
        if cfg.feature_store:
            row.update(
                bytes_measured=int(result.total_bytes_measured),
                bytes_modeled=int(result.total_bytes_modeled),
                fetch_seconds_measured=round(result.total_fetch_seconds, 6),
            )
        row.update(
            label=cfg.label(),
            mean_pct_hits=round(result.mean_pct_hits, 2),
            steady_pct_hits=round(result.steady_pct_hits, 2),
            comm_per_minibatch=round(result.comm_per_minibatch, 1),
            total_comm=result.total_comm,
            mean_epoch_time=round(result.mean_epoch_time, 4),
        )
        rows.append(row)
        if verbose:
            # stderr: stdout stays machine-readable (the --sweep CSV).
            print(
                f"[sweep] {cfg.label():48s} hits={row['steady_pct_hits']:6.2f} "
                f"comm/mb={row['comm_per_minibatch']:8.1f} "
                f"epoch={row['mean_epoch_time']:.3f}s",
                file=sys.stderr,
            )
    return rows


#: Metric fields every sweep row must carry, finite, for the gate.
GATED_METRICS = (
    "mean_pct_hits",
    "steady_pct_hits",
    "comm_per_minibatch",
    "total_comm",
    "mean_epoch_time",
)


def validate_rows(rows: list[dict]) -> list[str]:
    """Perf-trajectory gate: reject NaN, non-finite and empty cells.

    Returns a list of human-readable problems (empty = artifact is
    sound): a sweep that silently produced garbage must fail, not
    become a poisoned baseline.
    """
    problems: list[str] = []
    if not rows:
        return ["sweep produced 0 rows (empty grid?)"]
    seen: set[tuple] = set()
    for i, row in enumerate(rows):
        label = row.get("label") or f"<row {i}>"
        key = _cell_key(row)
        if not row.get("label"):
            problems.append(f"{label}: missing label")
        elif key in seen:
            problems.append(f"{label}: duplicate cell")
        seen.add(key)
        for name in GATED_METRICS:
            value = row.get(name)
            if value is None:
                problems.append(f"{label}: missing metric {name}")
            elif not math.isfinite(float(value)):
                problems.append(f"{label}: {name} is not finite ({value})")
        epoch_time = row.get("mean_epoch_time")
        if epoch_time is not None and float(epoch_time) <= 0:
            problems.append(f"{label}: mean_epoch_time <= 0")
    return problems


def sweep_artifact(rows: list[dict]) -> dict:
    """The sweep artifact's payload: sorted rows + grid summary.

    Carries the port's provenance header (schema, git sha, platform,
    library versions, the device — :func:`repro_torch.telemetry.provenance`)
    so every baseline records what produced it. No wall-clock timestamp:
    reruns of the same tree must stay byte-identical.
    """
    from ..telemetry import provenance

    rows = sorted(rows, key=_cell_key)
    return {
        "schema": 1,
        "provenance": provenance(),
        "grid": {
            "cells": len(rows),
            "datasets": sorted({r["dataset"] for r in rows}),
            "variants": sorted({r["variant"] for r in rows}),
            "policies": sorted({r["policy"] for r in rows}),
            "topologies": sorted({r.get("topology", "none") for r in rows}),
            "time_engines": sorted(
                {r.get("time_engine", "closed_form") for r in rows}
            ),
            "stragglers": sorted({r.get("stragglers", "none") for r in rows}),
            "congestions": sorted({r.get("congestion", "none") for r in rows}),
        },
        "rows": rows,
    }


def write_sweep_json(rows: list[dict], path: str) -> dict:
    """Write the deterministic sweep artifact; returns the payload."""
    payload = sweep_artifact(rows)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return payload
