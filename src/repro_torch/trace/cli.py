"""``python -m repro_torch.trace`` — record / replay / diff / verify.

The reference's trace CLI on the port's trainer. Every subcommand that
runs a trainer takes ``--device`` (``cuda`` by default, or ``cpu``): a
trace config's ``"device"`` key names the reference's path (``False`` is
its staged loop) and is not read: the CLI runs a ``"vectorized"`` config
on the port's device-resident loop, whose streams the reference holds
bit-identical to the staged ones, and a ``"legacy"`` one (or
``replay --runtime legacy``) on the port's legacy loop, its model and
store on the device; from Python, :func:`record_trace` and
:func:`build_trainer` also take ``device=False``, the port's staged
loop. So
``python -m repro_torch.trace verify tests/golden --device cuda``
re-records the committed goldens on the card.

Subcommands::

    record  --out PATH [axis flags]     run one configuration, save trace
    replay  PATH [--plane ...]          rebuild from the manifest config,
                                        replay, diff vs recorded
    diff    A B                         structured first-divergence report
    verify  DIR [--json PATH]           re-record every golden in DIR and
                                        diff (the CI drift gate)

``record`` writes a *replayable* manifest: the full cell config (same
axes as the sweep grid) is stored under ``manifest["config"]``, so
``replay`` can rebuild the trainer exactly. ``replay --plane`` selects
what is re-run: ``full`` re-records the whole run (both runtimes via
``--runtime``), ``decision`` re-runs only the decision plane against the
recorded metric stream, ``time`` re-prices the recorded communication
streams through a fresh time engine. Exit status 1 on any divergence —
every subcommand is CI-gate shaped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .capture import TraceRecorder
from .diff import DiffReport, diff_traces, write_report_json
from .replay import replay_decisions_report, replay_time_engine_report
from .schema import RAGGED_FIELDS, Trace
from .store import load_trace, save_trace, trace_paths

#: The replayable cell config: same axes as ``runtime.sweep.SweepConfig``
#: plus ``scale`` and ``runtime`` (which the sweep fixes globally).
CONFIG_DEFAULTS: dict = {
    "dataset": "products",
    "scale": 0.12,
    "variant": "fixed",
    "num_parts": 4,
    "batch_size": 16,
    "fanouts": [10, 25],
    "mode": "async",
    "interval": 32,
    "buffer_frac": 0.25,
    "epochs": 3,
    "backend": "gemma3-4b",
    "policy": "rudder",
    "topology": "none",
    "time_engine": "closed_form",
    "stragglers": "none",
    "congestion": "none",
    "seed": 0,
    "runtime": "vectorized",
    "feature_store": False,
    "device": False,
}


def _parse_bool(s: str) -> bool:
    """argparse-safe bool: ``type=bool`` would make ``--x false`` True."""
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def build_trainer(
    config: dict, runtime: str | None = None, parts=None, device="cuda"
):
    """Construct the port's :class:`DistributedTrainer` a trace config
    names, on ``device``.

    The trace CLI constructs every trainer here, so a replayable
    manifest always rebuilds exactly the trainer that recorded it.
    ``parts`` supplies a pre-partitioned graph; otherwise the graph is
    generated from ``(dataset, scale, seed)`` and partitioned
    ``num_parts``-way. Experiment cells never train the model
    (``train_model=False``). The config's ``"device"`` key is the
    reference's and is not read: ``device`` is the port's (``"cuda"``,
    ``"cpu"``, or ``False`` for the staged loop). ``runtime`` (or the
    config's ``"runtime"``) picks the loop: ``"vectorized"``, or
    ``"legacy"``, the per-PE host loop, with the store on ``device``.
    """
    from ..core import LLMAgent, make_backend
    from ..gnn import DistributedTrainer

    cfg = {**CONFIG_DEFAULTS, **config}
    if parts is None:
        from ..graph import generate, partition_graph

        g = generate(
            cfg["dataset"], seed=int(cfg["seed"]), scale=float(cfg["scale"])
        )
        parts = partition_graph(g, int(cfg["num_parts"]))
    deciders = None
    if cfg["variant"] == "rudder":
        deciders = [
            LLMAgent(make_backend(cfg["backend"]), None)
            for _ in range(int(cfg["num_parts"]))
        ]
    return DistributedTrainer(
        parts,
        variant=cfg["variant"],
        deciders=deciders,
        buffer_frac=float(cfg["buffer_frac"]),
        batch_size=int(cfg["batch_size"]),
        fanouts=tuple(int(f) for f in cfg["fanouts"]),
        epochs=int(cfg["epochs"]),
        mode=cfg["mode"],
        interval=int(cfg["interval"]),
        policy=cfg["policy"],
        topology=None if cfg["topology"] == "none" else cfg["topology"],
        time_engine=cfg["time_engine"],
        stragglers=cfg["stragglers"],
        congestion=cfg["congestion"],
        train_model=False,
        seed=int(cfg["seed"]),
        runtime=runtime or cfg.get("runtime", "vectorized"),
        feature_store=bool(cfg["feature_store"]),
        device=device,
    )


def record_trace(
    config: dict, runtime: str | None = None, device="cuda"
) -> Trace:
    """Run one configuration with capture on, on ``device``; returns the
    finished trace."""
    cfg = {**CONFIG_DEFAULTS, **config}
    if runtime:
        cfg["runtime"] = runtime
    trainer = build_trainer(cfg, device=device)
    trainer.trace = TraceRecorder.for_trainer(trainer, config=cfg)
    trainer.run()
    return trainer.last_trace


# ---------------------------------------------------------------------- #
def _emit(report: DiffReport, json_path: str | None, extra: dict | None = None) -> int:
    print(report.render())
    if json_path:
        write_report_json(report, json_path, extra)
        print(f"# report written to {json_path}", file=sys.stderr)
    return 0 if report.identical else 1


def cmd_record(args) -> int:
    config = {
        key: getattr(args, key)
        for key in CONFIG_DEFAULTS
        if getattr(args, key, None) is not None
    }
    trace = record_trace(config, device=args.device)
    npz_path, json_path = save_trace(trace, args.out)
    print(
        f"recorded {trace.num_steps} steps x {trace.num_pes} PEs "
        f"-> {npz_path} + {json_path} (digest {trace.digest()[:12]})"
    )
    return 0


def cmd_replay(args) -> int:
    trace = load_trace(args.trace)
    config = trace.config
    if not config.get("replayable", True):
        print(
            f"{args.trace}: manifest config is not replayable — the trace "
            "was recorded from a live trainer (DistributedTrainer("
            "trace=True)), whose graph scale/seed and deciders are not "
            "recoverable. Record via `python -m repro_torch.trace record` or a "
            "sweep --trace=DIR for a rebuildable manifest, or use the "
            "in-process replay adapters (repro_torch.trace.replay).",
            file=sys.stderr,
        )
        return 2
    if args.plane == "full":
        fresh = record_trace(config, runtime=args.runtime, device=args.device)
        fields = None
        if "fetch_time_measured" in trace.arrays:
            # Store-enabled trace: the wall-clock measurement is
            # nondeterministic by design (the one field excluded from
            # Trace.exact_digest()), so a full replay compares every
            # stream except it — otherwise replay could never come back
            # identical.
            ragged_keys = {
                f"{n}_{s}"
                for n in RAGGED_FIELDS
                for s in ("flat", "offsets")
            }
            fields = sorted(
                ((set(trace.arrays) | set(fresh.arrays)) - ragged_keys
                 - {"fetch_time_measured"}) | set(RAGGED_FIELDS)
            )
            print(
                "# note: fetch_time_measured (wall clock) excluded "
                "from the replay diff",
                file=sys.stderr,
            )
        report = diff_traces(trace, fresh, fields=fields)
    elif args.plane == "decision":
        trainer = build_trainer(config, runtime=args.runtime, device=args.device)
        report = replay_decisions_report(trace, trainer.controllers)
    elif args.plane == "time":
        trainer = build_trainer(config, runtime=args.runtime, device=args.device)
        report = replay_time_engine_report(trace, trainer.make_time_engine())
    else:  # pragma: no cover — argparse choices guard this
        raise ValueError(args.plane)
    return _emit(report, args.json, {"trace": args.trace, "plane": args.plane})


def cmd_diff(args) -> int:
    report = diff_traces(load_trace(args.a), load_trace(args.b))
    for note in report.config_mismatches:
        print(f"# note: {note}", file=sys.stderr)
    return _emit(report, args.json, {"a": args.a, "b": args.b})


def cmd_verify(args) -> int:
    """Re-record every golden under DIR and diff — the CI drift gate."""
    # Every trace manifest (any JSON with a schema_version) is in scope;
    # an orphan manifest whose npz payload is missing must FAIL the
    # gate, not silently shrink the conformance set.
    manifests: list[str] = []
    for fname in sorted(os.listdir(args.dir)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(args.dir, fname)) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(manifest, dict) and "schema_version" in manifest:
            manifests.append(fname)
    if not manifests:
        print(f"no traces found under {args.dir}", file=sys.stderr)
        return 2
    results: dict[str, dict] = {}
    failed = 0
    for name in manifests:
        base = os.path.join(args.dir, name)
        npz_path, _ = trace_paths(base)
        if not os.path.exists(npz_path):
            report = DiffReport(
                problems=[
                    f"{name}: payload {os.path.basename(npz_path)} missing"
                ]
            )
        else:
            # Any per-golden failure (digest/schema ValueError, a
            # truncated npz's BadZipFile, a re-record crash) must land
            # in the report and fail the gate — never take down the
            # whole verify run with the JSON artifact unwritten.
            try:
                golden = load_trace(base)
            except Exception as exc:
                report = DiffReport(
                    problems=[f"{name}: {type(exc).__name__}: {exc}"]
                )
            else:
                if not golden.config.get("replayable", True):
                    report = DiffReport(
                        problems=[f"{name}: manifest config is not replayable"]
                    )
                else:
                    try:
                        fresh = record_trace(golden.config, device=args.device)
                    except Exception as exc:
                        report = DiffReport(problems=[
                            f"{name}: re-record failed: "
                            f"{type(exc).__name__}: {exc}"
                        ])
                    else:
                        report = diff_traces(golden, fresh)
        results[name] = report.to_json()
        status = "ok" if report.identical else "DRIFT"
        print(f"[trace verify] {name:40s} {status}")
        if not report.identical:
            print(report.render())
            failed += 1
    if args.json:
        import torch

        payload = {
            "identical": failed == 0,
            "provenance": {"torch": torch.__version__, "device": args.device},
            "traces": results,
            "golden_dir": args.dir,
        }
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"# report written to {args.json}", file=sys.stderr)
    print(
        f"# verify: {len(manifests) - failed}/{len(manifests)} traces conform",
        file=sys.stderr,
    )
    return 1 if failed else 0


# ---------------------------------------------------------------------- #
def _device_flag(sub) -> None:
    sub.add_argument(
        "--device", default="cuda",
        help="where the port's trainer runs: cuda (default) or cpu",
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    rec = sub.add_parser("record", help="run one configuration and save a trace")
    rec.add_argument("--out", required=True, help="output path (base or .npz)")
    for key, default in CONFIG_DEFAULTS.items():
        if key == "device":  # the reference's path; see _device_flag
            continue
        if key == "fanouts":
            rec.add_argument(
                "--fanouts",
                type=lambda s: [int(x) for x in s.split(",")],
                default=None, help="e.g. 10,25",
            )
        else:
            rec.add_argument(
                f"--{key.replace('_', '-')}", dest=key,
                type=_parse_bool if isinstance(default, bool) else type(default),
                default=None, help=f"default {default!r}",
            )
    _device_flag(rec)
    rec.set_defaults(func=cmd_record)

    rep = sub.add_parser(
        "replay", help="rebuild from the manifest config, replay, diff"
    )
    rep.add_argument("trace", help="trace path (base, .npz or .json)")
    rep.add_argument(
        "--plane", choices=("full", "decision", "time"), default="full",
        help="what to re-run against the recorded upstream streams",
    )
    rep.add_argument(
        "--runtime", choices=("vectorized", "legacy"), default=None,
        help="override the recorded runtime (full replay)",
    )
    rep.add_argument("--json", default=None, help="write the JSON report here")
    _device_flag(rep)
    rep.set_defaults(func=cmd_replay)

    dif = sub.add_parser("diff", help="first-divergence report of two traces")
    dif.add_argument("a")
    dif.add_argument("b")
    dif.add_argument("--json", default=None, help="write the JSON report here")
    dif.set_defaults(func=cmd_diff)

    ver = sub.add_parser(
        "verify", help="re-record every trace under DIR and diff (CI gate)"
    )
    ver.add_argument("dir", help="directory of golden traces")
    ver.add_argument("--json", default=None, help="write the JSON report here")
    _device_flag(ver)
    ver.set_defaults(func=cmd_verify)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    try:
        return args.func(args)
    except (OSError, ValueError, RuntimeError, json.JSONDecodeError) as exc:
        # Missing artifacts, digest/schema mismatches, corrupt manifests:
        # operator errors, not crashes — report and exit like a CLI.
        print(f"error: {exc}", file=sys.stderr)
        return 2
