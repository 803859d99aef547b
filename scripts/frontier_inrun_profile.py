"""Where the prefetch step's time goes inside a training run, on the card.

``chip_smoke.py`` phase 3 times each launch of the raw loop's frontier step
by CUDA events around the dispatcher call: in the run that reads several
times what the same launch takes when timed alone. This script repeats
phase 3's run (``products`` at ``scale=10``, 4 PEs, ``chip_smoke.RUN``)
and, with ``--wide``, phase 6's (the graph rebased past 2^31), and puts a
``torch.profiler`` window around two launches of the run (``--launches``,
by default the 3rd and 4th of the trainer's 10). For each launch in the
window it prints, as one JSON line (and first one line with the
CUDA-event and host times of every launch of the run but the first and
the last, and their medians):

* ``events_ms``: the CUDA-event time, as phase 3 records it;
* ``host_ms``: the host time of the dispatcher call;
* ``device_ops``: the device operations the call issued (kernels,
  memsets, copies; matched to the call by the correlation ids of the
  runtime calls made inside it), each with its device time;
* ``busy_ms`` (their sum), ``span_ms`` (first start to last end) and
  ``idle_ms`` (the span's gaps), and ``queued_ms``: how long the first
  operation waited on the stream after the host issued it (the device
  still busy with the step's earlier work).

Then the window's middle launch again, alone (the captured inputs, CUDA
events after an L2 flush, mean of 20; its device operations by the same
matching), so that the two read side by side. The rows (with every
operation's name and time) and the chrome trace of each window go to
``--out`` (by default ``_profiles/`` in the checkout).

With ``--ragged`` the same for the ragged loop's fused step: phase 3b's
run (``papers`` at ``scale=10`` with a kernel-backed feature store,
``chip_smoke.RAGGED``; with ``--wide`` phase 6b's), the engine's
``fused_step_readback_batch`` launches, and alone its wrapper
``fused_step_readback_cuda``.

Usage (from the repository root, on a machine with a card)::

    python3 scripts/frontier_inrun_profile.py [--src PATH] [--wide] [--ragged]
        [--tag NAME] [--capture-aggregation] [--out DIR]

``--src`` points at the ``src`` directory of the package to profile (by
default this checkout's), so that two trees can be compared in one call.
``--capture-aggregation`` also captures the aggregation kernels' inputs
(a copy of each before its launch), as ``chip_smoke.py`` phase 3 does
and phase 6 does not.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def device_ops_in(trace_path: Path, label_prefix: str) -> dict:
    """``{label: [(name, start_us, dur_us, issued_us), ...]}``: the device
    operations of each ``record_function`` range whose name starts with
    ``label_prefix`` in a chrome trace, matched through the correlation
    ids of the runtime calls made inside the range."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    ranges = [
        e for e in events
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(label_prefix)
        and e.get("cat") in ("user_annotation", "cpu_op")
    ]
    issued = {}  # correlation id -> (label, host ts of the runtime call)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        for r in ranges:
            if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                issued[corr] = (r["name"], e["ts"])
    out = {r["name"]: [] for r in ranges}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr in issued:
            label, ts_issued = issued[corr]
            out[label].append((e["name"], e["ts"], e["dur"], ts_issued))
    return out


def summarise(ops) -> dict:
    if not ops:
        return {"device_ops": 0}
    ops = sorted(ops, key=lambda o: o[1])
    busy = sum(o[2] for o in ops)
    span = max(o[1] + o[2] for o in ops) - ops[0][1]
    return {
        "device_ops": len(ops),
        "busy_ms": busy / 1e3,
        "span_ms": span / 1e3,
        "idle_ms": (span - busy) / 1e3,
        "queued_ms": (ops[0][1] - ops[0][3]) / 1e3,
        "ops": [[o[0][:70], round(o[2] / 1e3, 4)] for o in ops],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--wide", action="store_true", help="phase 6's (6b's) rebased run")
    ap.add_argument("--ragged", action="store_true",
                    help="phase 3b's ragged run and its fused step")
    ap.add_argument("--launches", type=int, nargs=2, default=(2, 3),
                    help="0-based indices of the first and last launch in the window")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=str(ROOT / "_profiles"),
                    help="directory for the rows and the chrome traces")
    ap.add_argument("--capture-aggregation", action="store_true",
                    help="also capture (clone) and time every gather_mean and "
                    "segment_sum_equal launch, as chip_smoke.py phase 3 does")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("frontier_inrun_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import telemetry
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import native
    from repro_torch.store import FeatureStore

    dev = torch.device("cuda")
    native.build_all()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from repro_torch.kernels import ops

    # A tree from before the engine's readback form launches the reference
    # form from the engine (``--src`` of an older tree).
    readback = hasattr(ops, "fused_step_readback_batch")
    if args.ragged:
        name = ("fused_step_readback_batch" if readback
                else "fused_step_wide_batch" if args.wide else "fused_step_batch")
        label = "step launch "
    else:
        name = "fused_frontier_step_wide_batch" if args.wide else "fused_frontier_step_batch"
        label = "frontier launch "
    first, last = args.launches

    class WindowClock(cs.StageClock):
        """StageClock that opens a profiler window before launch ``first``
        and closes it after launch ``last``, each launch a named range."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = 0
            self.prof = None
            self.host = {}

        def profile_call(self, fname, fn, *a, **kw):
            if fname != name:
                return super().profile_call(fname, fn, *a, **kw)
            i = self.calls
            self.calls += 1
            if not first <= i <= last:
                t0 = time.perf_counter()
                out = super().profile_call(fname, fn, *a, **kw)
                self.host[i] = (time.perf_counter() - t0) * 1e3
                return out
            if i == first:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA,
                ])
                self.prof.__enter__()
                # The window's first device operation, which the profiler
                # can miss, so that it is not a launch's.
                torch.zeros(1, device=dev)
                torch.cuda.synchronize()
            # Capture the inputs as StageClock does, outside the range.
            self.launches[fname].append((
                [x.clone() if isinstance(x, torch.Tensor) and x.numel() <= 2**25
                 and id(x) not in self.by_ref else x for x in a],
                dict(kw),
            ))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"{label}{i}"):
                start.record()
                out = fn(*a, **kw)
                end.record()
            self.host[i] = (time.perf_counter() - t0) * 1e3
            self.events[fname].append((start, end))
            if i == last:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
            return out

    g = generate("papers" if args.ragged else "products", seed=0,
                 scale=cs.RAGGED_SCALE if args.ragged else cs.MAIN_SCALE)
    if args.wide:
        g = g.rebase(cs.WIDE_BASE)
    parts = partition_graph(g, 4)
    if args.ragged:
        store = FeatureStore.for_partitions(parts, device="cuda", use_kernel=True)
        trainer = DistributedTrainer(parts, device="cuda", feature_store=store, **cs.RAGGED)
    else:
        trainer = DistributedTrainer(parts, device="cuda", **cs.RUN)
    captured = [name, *cs.AGGREGATION_KERNELS] if args.capture_aggregation else [name]
    clock = WindowClock(captured, by_ref=[trainer.features])
    torch.cuda.synchronize()
    with telemetry.active(clock):
        trainer.run()
    torch.cuda.synchronize()
    events_ms = clock.device_ms(name)
    tag = f"{args.tag}_{'wide' if args.wide else 'narrow'}"
    kind = "step" if args.ragged else "frontier"
    trace = out_dir / f"{kind}_inrun_{tag}.json"
    clock.prof.export_chrome_trace(str(trace))
    found = device_ops_in(trace, label)
    card = cs.card_line()
    # Every launch but the prime one (0) and the drained one (the last, Mt = 1).
    steady = range(1, len(events_ms) - 1)
    rows = [{
        "tree": args.tag, "wide": args.wide, "ragged": args.ragged,
        "where": "in run, every launch",
        "capture_aggregation": args.capture_aggregation,
        "launches": len(events_ms),
        "events_ms": [round(events_ms[i], 4) for i in steady],
        "host_ms": [round(clock.host[i], 4) for i in steady],
        "events_ms_median": float(np.median([events_ms[i] for i in steady])),
        "host_ms_median": float(np.median([clock.host[i] for i in steady])),
    }]
    for i in range(first, last + 1):
        row = {"tree": args.tag, "wide": args.wide, "launch": i, "where": "in run",
               "events_ms": events_ms[i], "host_ms": clock.host[i]}
        row.update(summarise(found.get(f"{label}{i}", [])))
        rows.append(row)

    # The middle launch of the window, alone.
    (a, kw) = clock.launches[name][first]
    if args.ragged:
        wrapper = (fs.fused_step_readback_cuda if readback
                   else fs.fused_step_wide_cuda if args.wide else fs.fused_step_cuda)
    else:
        wrapper = fs.fused_frontier_step_wide_cuda if args.wide else fs.fused_frontier_step_cuda
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    call = lambda: wrapper(*a, **kw)  # noqa: E731
    call()
    alone_ms = cs.timed_ms(call, 20, flush)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        torch.zeros(1, device=dev)  # the operation the profiler can miss
        torch.cuda.synchronize()
        with torch.profiler.record_function(f"{label}{first} alone"):
            call()
        torch.cuda.synchronize()
    alone_trace = out_dir / f"{kind}_alone_{tag}.json"
    prof.export_chrome_trace(str(alone_trace))
    alone = device_ops_in(alone_trace, label)
    row = {"tree": args.tag, "wide": args.wide, "launch": first, "where": "alone",
           "events_ms": alone_ms}
    row.update(summarise(alone.get(f"{label}{first} alone", [])))
    rows.append(row)
    with open(out_dir / f"{kind}_inrun_{tag}.jsonl", "w") as f:
        for row in rows:
            row["card"] = card
            f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps({k: v for k, v in row.items() if k != "ops"}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
