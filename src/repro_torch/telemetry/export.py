"""Telemetry exporters: per-run JSONL, Chrome-trace JSON, text tables.

JSONL is the run artifact (one ``meta`` line, then one line per span
and per metric) — ``python -m repro_torch.telemetry summary/chrome/steps``
consume it. The Chrome-trace exporter emits the ``trace_events`` JSON the
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
    "step_rows",
    "render_steps",
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
                "args": {
                    "depth": sp["depth"],
                    "nbytes": sp.get("nbytes", 0),
                    "id": sp.get("id", -1),
                    "parent": sp.get("parent", -1),
                    "step": sp.get("step", -1),
                },
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
    session.resolve()
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
    byte_counters = {
        m["name"] for m in artifact["metrics"]
        if m["kind"] == "counter" and "bytes" in m["name"]
    }
    for metric in artifact["metrics"]:
        name = metric["name"]
        # A counter that extends another one's name is a part of it (the
        # copies by site, ``device.h2d_bytes.<site>``): counted once.
        if name not in byte_counters or any(
            name.startswith(other + ".") for other in byte_counters
        ):
            continue
        plane = name.split(".", 1)[0]
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


# ---------------------------------------------------------------------- #
def step_rows(artifact: dict, top: int = 5) -> list[dict]:
    """The ``top`` longest ``step`` spans of a loaded artifact, longest
    first: each step's index, milliseconds, its own self time and, per
    direct child's name, the children's total and self milliseconds
    (children by the spans' ``parent`` ids)."""
    spans = artifact["spans"]
    if spans and "id" not in spans[0]:
        raise ValueError("artifact's spans carry no ids (an older schema)")
    children: dict[int, list[dict]] = {}
    for sp in spans:
        children.setdefault(int(sp["parent"]), []).append(sp)

    def ms(sp) -> float:
        return 1e3 * (sp["t1"] - sp["t0"])

    def self_ms(sp) -> float:
        return max(ms(sp) - sum(ms(c) for c in children.get(int(sp["id"]), ())), 0.0)

    steps = sorted((sp for sp in spans if sp["name"] == "step"), key=ms, reverse=True)
    rows = []
    for sp in steps[:top]:
        phases: dict[str, list[float]] = {}
        for c in children.get(int(sp["id"]), ()):
            row = phases.setdefault(c["name"], [0.0, 0.0])
            row[0] += ms(c)
            row[1] += self_ms(c)
        rows.append({
            "step": int(sp["step"]),
            "ms": ms(sp),
            "self_ms": self_ms(sp),
            "phases": {k: {"ms": v[0], "self_ms": v[1]}
                       for k, v in sorted(phases.items(), key=lambda kv: -kv[1][0])},
        })
    return rows


def render_steps(rows: list[dict]) -> str:
    """The longest steps, each with its direct children's time."""
    lines = []
    for row in rows:
        lines.append(
            f"step {row['step']:>6d} {row['ms']:>10.3f} ms "
            f"(self {row['self_ms']:.3f} ms)"
        )
        for name, ph in row["phases"].items():
            lines.append(f"  {name:<20} {ph['ms']:>10.3f} ms  self {ph['self_ms']:>10.3f} ms")
    return "\n".join(lines)
