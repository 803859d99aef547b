"""``python -m repro_torch.telemetry`` — inspect run artifacts.

Subcommands:

* ``summary ARTIFACT.jsonl`` — per-plane time/bytes breakdown table
  from a run artifact written by ``TelemetrySession.write_jsonl``.
* ``chrome ARTIFACT.jsonl --out trace.json`` — convert the artifact to
  Chrome-trace/Perfetto ``trace_events`` JSON (load it at
  https://ui.perfetto.dev or chrome://tracing).
* ``steps ARTIFACT.jsonl [--top N]`` — the N longest ``step`` spans,
  each with its direct children's total and self time: which phase made
  a tail step slow.
* ``calibrate TRACE`` — fit TimeModel alpha/link_bw from a recorded
  store-enabled trace's measured byte + wall-clock streams.

All error paths print to stderr and return exit code 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from .calibrate import calibrate_from_trace
from .export import (
    breakdown_rows,
    load_jsonl,
    render_steps,
    render_table,
    step_rows,
    write_chrome_trace,
)

__all__ = ["main", "make_parser"]


def cmd_summary(args) -> int:
    artifact = load_jsonl(args.artifact)
    meta = artifact["meta"]
    if meta:
        label = meta.get("label", "?")
        sha = meta.get("provenance", {}).get("git_sha", "?")
        print(f"# run: {label}  (git {sha[:12]})")
    rows = breakdown_rows(artifact)
    if not rows:
        print("no spans or byte counters recorded")
        return 0
    print(render_table(rows))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"rows": rows}, fh, indent=2)
        print(f"wrote {args.json}")
    return 0


def cmd_chrome(args) -> int:
    artifact = load_jsonl(args.artifact)
    path = write_chrome_trace(artifact, args.out)
    n = len(artifact["spans"])
    print(f"wrote {path} ({n} spans) — load at https://ui.perfetto.dev")
    return 0


def cmd_steps(args) -> int:
    rows = step_rows(load_jsonl(args.artifact), top=args.top)
    if not rows:
        print("no step spans recorded")
        return 0
    print(render_steps(rows))
    return 0


def cmd_calibrate(args) -> int:
    from ..trace.store import load_trace

    trace = load_trace(args.trace)
    cal = calibrate_from_trace(trace)
    print(
        f"alpha={cal.alpha:.6g} s  link_bw={cal.link_bw:.6g} B/s  "
        f"(n={cal.n_samples}, max_abs_err={cal.max_abs_err_s:.3g} s)"
    )
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(cal.summary(), fh, indent=2)
        print(f"wrote {args.json}")
    return 0


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Inspect telemetry run artifacts.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("summary", help="per-plane time/bytes breakdown")
    p.add_argument("artifact", help="JSONL artifact from write_jsonl()")
    p.add_argument("--json", default=None, help="also write rows as JSON")
    p.set_defaults(func=cmd_summary)

    p = sub.add_parser("chrome", help="export Chrome-trace/Perfetto JSON")
    p.add_argument("artifact", help="JSONL artifact from write_jsonl()")
    p.add_argument("--out", default="trace.json", help="output path")
    p.set_defaults(func=cmd_chrome)

    p = sub.add_parser("steps", help="the longest steps, by phase")
    p.add_argument("artifact", help="JSONL artifact from write_jsonl()")
    p.add_argument("--top", type=int, default=5, help="steps to list")
    p.set_defaults(func=cmd_steps)

    p = sub.add_parser(
        "calibrate", help="fit TimeModel alpha/link_bw from a trace"
    )
    p.add_argument("trace", help="trace base path (store-enabled recording)")
    p.add_argument("--json", default=None, help="write fit as JSON")
    p.set_defaults(func=cmd_calibrate)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    try:
        return args.func(args)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
