"""Reading a ``torch.profiler`` trace of one traced call.

The profiler's chrome trace holds, on one clock: the device's operations
(``kernel``, ``gpu_memcpy``, ``gpu_memset``), the host's runtime calls
that launched them (``cuda_runtime`` / ``cuda_driver``, tied to them by
``correlation``), and the harness's ``record_function`` ranges
(``user_annotation``), all named ``bench.*``. From it:

* the busy time: the union of the device intervals inside the window;
* each dispatcher's device time: the device operations launched by
  runtime calls that lie inside that dispatcher's ranges;
* the ten device operations that took most time;
* the idle time by what the host was doing: each gap between device
  intervals, labelled by the innermost harness stage range open at its
  middle, summed per label.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclass
class Profile:
    window_s: float
    busy_s: float
    dispatcher_s: dict = field(default_factory=dict)  # name -> device seconds
    top_ops: list = field(default_factory=list)        # [[name, seconds]]
    idle_by_host: list = field(default_factory=list)   # [[label, seconds]]


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle stretches of ``[lo, hi]`` between the merged intervals."""
    out, t = [], lo
    for s, e in merged(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def read_events(prof) -> list:
    """The complete (``"ph": "X"``) events of a finished profiler."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def analyse(events, dispatchers, stages) -> Profile:
    """``events`` in microseconds; ``dispatchers`` and ``stages`` the
    ``bench.*`` range names to time and to label idle gaps with."""
    win = [e for e in events if e.get("name") == WINDOW]
    if not win:
        raise ValueError("no bench.window range in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    inside = [
        (max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
        for e in dev
    ]
    inside = [(s, e) for s, e in inside if e > s]
    busy = union_length(inside)

    by_corr: dict = {}
    totals: dict = {}
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        by_corr.setdefault(corr, []).append(float(e["dur"]))
        totals[e["name"]] = totals.get(e["name"], 0.0) + float(e["dur"])
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS]
    annotations = [e for e in events if e.get("cat") == "user_annotation"]

    dispatcher_s = {}
    for name in dispatchers:
        ranges = [e for e in annotations if e["name"] == name]
        if not ranges:
            continue
        seconds = 0.0
        for r in ranges:
            r0, r1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            for call in launches:
                if call.get("tid") != r.get("tid") or not r0 <= float(call["ts"]) <= r1:
                    continue
                corr = (call.get("args") or {}).get("correlation")
                seconds += sum(by_corr.get(corr, ()))
        dispatcher_s[name] = seconds * 1e-6

    stage_ranges = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in annotations
        if e["name"] in stages
    ]
    idle: dict = {}
    for g0, g1 in gaps(inside, w0, w1):
        mid = 0.5 * (g0 + g1)
        open_ = [r for r in stage_ranges if r[0] <= mid <= r[1]]
        label = min(open_, key=lambda r: r[1] - r[0])[2] if open_ else "host.other"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6

    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return Profile(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy * 1e-6,
        dispatcher_s=dispatcher_s,
        top_ops=[[k, v * 1e-6] for k, v in top],
        idle_by_host=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    )
