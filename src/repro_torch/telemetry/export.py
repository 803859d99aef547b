"""Telemetry exporters: per-run JSONL, Chrome-trace JSON, text tables.

JSONL is the run artifact (one ``meta`` line, then one line per span
and per metric) — ``python -m repro_torch.telemetry summary/chrome`` consume
it. The Chrome-trace exporter emits the ``trace_events`` JSON the
Perfetto UI (https://ui.perfetto.dev) and ``chrome://tracing`` load:
spans become complete events (``ph: "X"``, microsecond ``ts``/``dur``)
on one thread track per PE, with ``tid 0`` the host/driver track.
"""

from __future__ import annotations

import json
from pathlib import Path

from .provenance import provenance

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "jsonl_rows",
    "write_jsonl",
    "load_jsonl",
    "breakdown_rows",
    "render_table",
]

JSONL_SCHEMA = 1


def _track_of(pe: int) -> int:
    # Host/driver spans record pe=-1; map onto tid 0 and shift PEs up.
    return pe + 1


def _span_rows(source) -> list[dict]:
    """Accept a live session or a loaded-artifact dict."""
    if hasattr(source, "tracer"):
        return [sp.as_row() for sp in source.tracer.spans]
    return list(source.get("spans", []))


def chrome_trace(source, label: str = "repro") -> dict:
    """Build the ``trace_events`` document from a session or artifact."""
    spans = _span_rows(source)
    pes = sorted({int(sp["pe"]) for sp in spans})
    events: list[dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": 0,
            "tid": 0,
            "args": {"name": label},
        }
    ]
    for pe in pes:
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": _track_of(pe),
                "args": {"name": "host" if pe < 0 else f"PE {pe}"},
            }
        )
    for sp in spans:
        events.append(
            {
                "name": sp["name"],
                "cat": sp["plane"],
                "ph": "X",
                "ts": sp["t0"] * 1e6,
                "dur": (sp["t1"] - sp["t0"]) * 1e6,
                "pid": 0,
                "tid": _track_of(int(sp["pe"])),
                "args": {"depth": sp["depth"], "nbytes": sp.get("nbytes", 0)},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(source, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(source)))
    return path


# ---------------------------------------------------------------------- #
def jsonl_rows(session) -> list[dict]:
    rows: list[dict] = [
        {
            "kind": "meta",
            "jsonl_schema": JSONL_SCHEMA,
            "label": session.label,
            "provenance": provenance(),
            "meta": dict(session.meta),
        }
    ]
    for sp in session.tracer.spans:
        rows.append({"kind": "span", **sp.as_row()})
    reg = session.registry
    for name in reg.names():
        metric = reg[name]
        rows.append({"kind": metric.kind, "name": name, **metric.summary()})
    return rows


def write_jsonl(session, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for row in jsonl_rows(session):
            fh.write(json.dumps(row) + "\n")
    return path


def load_jsonl(path) -> dict:
    """Parse a run artifact back into ``{meta, spans, metrics}``."""
    path = Path(path)
    meta: dict = {}
    spans: list[dict] = []
    metrics: list[dict] = []
    with path.open() as fh:
        for line_no, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(
                    f"{path}:{line_no}: not a telemetry JSONL artifact ({exc})"
                ) from exc
            kind = row.get("kind")
            if kind == "meta":
                meta = row
            elif kind == "span":
                spans.append(row)
            elif kind in ("counter", "gauge", "histogram"):
                metrics.append(row)
    if not meta and not spans and not metrics:
        raise ValueError(f"{path}: no telemetry rows found")
    return {"meta": meta, "spans": spans, "metrics": metrics}


# ---------------------------------------------------------------------- #
def breakdown_rows(artifact: dict) -> list[dict]:
    """Per-plane time/bytes breakdown from a loaded artifact.

    Time is *exclusive* span seconds grouped by plane; bytes come from
    counters whose name contains ``bytes`` grouped by their first
    name segment (the plane convention).
    """
    plane_s: dict[str, float] = {}
    plane_spans: dict[str, int] = {}
    for sp in artifact["spans"]:
        plane = sp["plane"]
        # exclusive time: subtract direct children, recomputed from rows
        plane_s.setdefault(plane, 0.0)
        plane_spans[plane] = plane_spans.get(plane, 0) + 1
    # Recompute child time per span from nesting (same track, enclosing
    # interval, depth+1) so loaded artifacts don't need child_s stored.
    by_track: dict[int, list[dict]] = {}
    for sp in artifact["spans"]:
        by_track.setdefault(int(sp["pe"]), []).append(sp)
    for track_spans in by_track.values():
        track_spans.sort(key=lambda s: (s["t0"], -s["t1"]))
        for sp in track_spans:
            child = sum(
                c["t1"] - c["t0"]
                for c in track_spans
                if c is not sp
                and c["depth"] == sp["depth"] + 1
                and c["t0"] >= sp["t0"]
                and c["t1"] <= sp["t1"]
            )
            plane_s[sp["plane"]] += max((sp["t1"] - sp["t0"]) - child, 0.0)

    plane_bytes: dict[str, float] = {}
    for metric in artifact["metrics"]:
        if metric["kind"] == "counter" and "bytes" in metric["name"]:
            plane = metric["name"].split(".", 1)[0]
            plane_bytes[plane] = plane_bytes.get(plane, 0.0) + metric["total"]

    planes = sorted(set(plane_s) | set(plane_bytes))
    return [
        {
            "plane": plane,
            "spans": plane_spans.get(plane, 0),
            "self_s": plane_s.get(plane, 0.0),
            "bytes": plane_bytes.get(plane, 0.0),
        }
        for plane in planes
    ]


def render_table(rows: list[dict]) -> str:
    """Fixed-width per-plane breakdown table."""
    header = f"{'plane':<12} {'spans':>8} {'self_s':>12} {'bytes':>14}"
    lines = [header, "-" * len(header)]
    for row in rows:
        lines.append(
            f"{row['plane']:<12} {row['spans']:>8d} "
            f"{row['self_s']:>12.6f} {row['bytes']:>14.0f}"
        )
    total_s = sum(r["self_s"] for r in rows)
    total_b = sum(r["bytes"] for r in rows)
    total_n = sum(r["spans"] for r in rows)
    lines.append("-" * len(header))
    lines.append(f"{'total':<12} {total_n:>8d} {total_s:>12.6f} {total_b:>14.0f}")
    return "\n".join(lines)
