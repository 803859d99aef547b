"""One benchmark cell's training calls under the program's own telemetry.

Builds the cell's trainer as the benchmark does (``bench/``: the graph
drawn on the card from ``--seed``, the program's set-up), runs a warm-up
``run()`` call, then ``--calls`` calls under one
``TelemetrySession(profile_kernels=False)`` and writes its JSONL artifact.
It prints the calls' seeds per second, the self time of the ``step`` spans
as a share of all step time and of the ``run`` spans as a share of all run
time (how much of a step and of a call no named phase covers), and the
longest steps by phase (``python -m repro_torch.telemetry steps``).

With ``--kernels`` it then times the named dispatchers two ways: one call
under ``TelemetrySession(profile_kernels=True)`` alone (CUDA event pairs),
and one more with ``torch.profiler`` over it too, where each dispatcher's
``kernel.<name>.seconds`` is set beside the profiler's device time of the
operations launched inside its ``repro.<name>`` ranges.

With ``--ops-in SPAN`` it runs one more call under ``torch.profiler`` and
lists the device operations launched inside the program's
``repro.<SPAN>`` ranges (e.g. ``train.features``), by name, with their
launches and device seconds. ``--src PATH`` runs the program of another
tree (e.g. a ``git archive`` of a parent under ``_checkout/``) with this
tree's benchmark.

    python3 scripts/trace_cell.py --workload products-rudder --seed N \\
        [--calls 3] [--kernels] [--ops-in SPAN] [--src PATH] [--out DIR]

Needs a card; prints the card's name and power limit first and, last,
one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

DISPATCHERS = ("fused_frontier_step_batch", "gather_mean", "segment_sum_equal")


def self_shares(spans) -> dict:
    """Per span name in (``step``, ``run``): its spans' self time (minus
    their direct children, by ``parent`` id) over their total time."""
    child_s: dict = {}
    for sp in spans:
        if sp.parent >= 0:
            child_s[sp.parent] = child_s.get(sp.parent, 0.0) + sp.duration
    out = {}
    for name in ("step", "run"):
        mine = [sp for sp in spans if sp.name == name]
        total = sum(sp.duration for sp in mine)
        own = sum(max(sp.duration - child_s.get(sp.id, 0.0), 0.0) for sp in mine)
        out[name] = {"total_s": total, "self_s": own, "self_share": own / total if total else None}
    return out


def kernel_seconds(trainer, torch, profiled: bool) -> dict:
    """One call with ``profile_kernels=True``: each dispatcher's event-pair
    seconds, and with ``profiled`` the profiler's device seconds."""
    from benchlib.profile import WINDOW, analyse, read_events
    from repro_torch.telemetry import TelemetrySession

    session = TelemetrySession(label="kernels", profile_kernels=True)
    trainer.telemetry = session
    if profiled:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                trainer.run()
                torch.cuda.synchronize()
        device_s = analyse(read_events(prof), [f"repro.{n}" for n in DISPATCHERS],
                           set()).dispatcher_s
    else:
        trainer.run()
        device_s = {}
    trainer.telemetry = False
    hists = session.summary()["metrics"]["histograms"]
    rows = {}
    for name in DISPATCHERS:
        h = hists.get(f"kernel.{name}.seconds") or {}
        rows[name] = {"calls": h.get("count", 0), "events_s": h.get("sum"),
                      "profiler_s": device_s.get(f"repro.{name}")}
    return rows


def ops_inside(trainer, torch, span: str) -> dict:
    """One call under ``torch.profiler`` with the program's spans on: the
    device operations launched inside its ``repro.<span>`` ranges, by
    name, as ``[launches, device seconds]``."""
    from benchlib.profile import DEVICE_CATS, LAUNCH_CATS, read_events
    from repro_torch.telemetry import TelemetrySession

    trainer.telemetry = TelemetrySession(label="ops", profile_kernels=False)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.run()
        torch.cuda.synchronize()
    trainer.telemetry = False
    events = read_events(prof)
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
              for e in events
              if e.get("cat") == "user_annotation" and e["name"] == f"repro.{span}"]
    launched = {
        (e.get("args") or {}).get("correlation")
        for e in events
        if e.get("cat") in LAUNCH_CATS
        and any(t == e.get("tid") and a <= float(e["ts"]) <= b for a, b, t in ranges)
    }
    ops: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and (e.get("args") or {}).get("correlation") in launched:
            row = ops.setdefault(e["name"], [0, 0.0])
            row[0] += 1
            row[1] += float(e["dur"]) * 1e-6
    return {"ranges": len(ranges), "ops": ops}


def trace(cell, seed: int, calls: int, kernels: bool, out: Path, device,
          ops_in: str | None = None) -> dict:
    """The numbers of one cell (see the module note); ``device`` is the
    card, or the CPU for a rehearsal at a tiny size (no ``kernels``)."""
    import torch

    from benchlib import generate
    from benchlib.runner import build
    from repro_torch.telemetry import TelemetrySession
    from repro_torch.telemetry.export import load_jsonl, render_steps, step_rows

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cell.config
    graph = generate.generate(cfg, seed, device)
    init = generate.init_weights(int(cfg["feature_dim"]), int(cfg["model"]["hidden_dim"]),
                                 int(cfg["num_classes"]), seed, device)
    trainer = build(cell, graph, init, seed, device)
    del init
    trainer.run()  # warm-up: kernel builds, caches
    sync()

    session = TelemetrySession(label=cell.name, profile_kernels=False)
    trainer.telemetry = session
    steps, t0 = 0, time.perf_counter()
    for _ in range(calls):
        steps += len(trainer.run().losses)
    sync()
    wall = time.perf_counter() - t0
    trainer.telemetry = False
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{cell.name}_{seed}.jsonl"
    session.write_jsonl(path)
    shares = self_shares(session.tracer.spans)
    seeds_per_s = steps * trainer.parts.num_parts * trainer.batch_size / wall
    print(f"{calls} calls, {steps} steps in {wall:.3f} s: {seeds_per_s:.1f} seeds/s")
    for name, row in shares.items():
        print(f"{name}: self {row['self_s']:.4f} s of {row['total_s']:.4f} s "
              f"({100 * row['self_share']:.2f}%)")
    print(render_steps(step_rows(load_jsonl(path), top=3)))
    line = {"workload": cell.name, "seed": seed, "calls": calls, "steps": steps,
            "seeds_per_s": seeds_per_s, "self": shares}
    if kernels:
        line["kernels_events_only"] = kernel_seconds(trainer, torch, profiled=False)
        line["kernels_profiled"] = kernel_seconds(trainer, torch, profiled=True)
        for name in DISPATCHERS:
            alone = line["kernels_events_only"][name]
            prof = line["kernels_profiled"][name]
            ratio = (prof["events_s"] / prof["profiler_s"]
                     if prof["events_s"] and prof["profiler_s"] else None)
            print(f"{name}: {prof['calls']} calls; events {prof['events_s']!r} s "
                  f"(without the profiler {alone['events_s']!r} s), profiler "
                  f"{prof['profiler_s']!r} s, ratio {ratio!r}")
    if ops_in:
        line["ops_in"] = {ops_in: ops_inside(trainer, torch, ops_in)}
        found = line["ops_in"][ops_in]
        print(f"device operations inside {found['ranges']} repro.{ops_in} ranges:")
        for name, (n, sec) in sorted(found["ops"].items(), key=lambda kv: -kv[1][1]):
            print(f"  {n} x {sec * 1e3:.3f} ms  {name[:120]}")
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="products-rudder")
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--ops-in", default=None, metavar="SPAN")
    ap.add_argument("--src", default=None, metavar="PATH")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from benchlib import cells

    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    line = trace(cells.find_cell(args.workload), args.seed, args.calls, args.kernels,
                 Path(args.out), "cuda", args.ops_in)
    print(json.dumps({"card": card, **line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
