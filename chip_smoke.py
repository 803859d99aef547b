#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

0. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
1. build every hand-written kernel from ``src/repro_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, bit for bit,
   on the seeded scenario set of the CPU tests;
3. the main path: ``DistributedTrainer(device="cuda")`` on the products
   preset at ``scale=10`` (240k nodes), 4 trainers, batch 2000, fanouts
   (10, 25), 25% buffers, rudder variant, 3 epochs of GraphSAGE training;
   the kernel counts are zeroed just before the run and read just after;
   then the kernel against its plain version on the captured inputs of the
   run's own launches (full shape), and both timed;
4. the same configuration at ``scale=1``, batch 256, on the card and on the
   CPU: every integer and bool stream identical, losses allclose;
5. a ``kernels`` JSON line, and as the last line the device JSON line.

Every phase raises on failure, so any failure exits non-zero. Without a
CUDA card, or outside a checkout of the repository, the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
#: outside the tensor cores, used as the roof for the kernel's integer and
#: compare work too.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: The main path's configuration (phase 3) and the card-vs-CPU one (phase 4).
RUN = dict(
    variant="rudder",
    deciders=["gemma3-4b"],
    mode="async",
    batch_size=2000,
    fanouts=(10, 25),
    hidden_dim=64,
    buffer_frac=0.25,
    train_model=True,
    epochs=3,
)
SMALL = dict(RUN, batch_size=256, epochs=2)
MAIN_SCALE, SMALL_SCALE = 10, 1
DEVICE = "cuda"

#: Loss tolerance of the card-vs-CPU run: the same float32 math, summed in
#: another order by the card's matmul and reduction kernels, over a few SGD
#: steps.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5

STREAMS = (
    "pct_hits", "comm_volume", "comm_missed", "unique_remote", "replaced",
    "decisions", "occupancy", "step_time",
)
STATS = (
    "lookups", "hits", "misses", "replaced_total", "replacement_rounds",
    "skipped_rounds",
)
OUT_NAMES = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "cand_next",
    "packed", "counters",
)


# --------------------------------------------------------------------------- #
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare_outputs(got, want, what: str) -> float:
    """Raise unless two output tuples are bit-identical (floats compared as
    their int32 bit patterns); returns the max abs difference (0.0)."""
    import torch

    err = 0.0
    for name, a, b in zip(OUT_NAMES, got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: {name} is None on one side only")
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(
                f"{what}: {name} {tuple(a.shape)} {a.dtype} vs "
                f"{tuple(b.shape)} {b.dtype}"
            )
        if a.dtype == torch.float32:
            diff = (a - b).abs().max().item() if a.numel() else 0.0
            err = max(err, diff)
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")
    return err


def to_device(arrays: dict, device):
    import numpy as np
    import torch

    return [
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in arrays.values()
    ]


class StageClock:
    """A telemetry session for the port's off-path hooks: host time per span,
    the dispatcher's device time by CUDA events, and the inputs of every
    launch of the frontier step (kept on the card for phase 3's check)."""

    profile_kernels = True

    def __init__(self):
        self.tracer = self
        self.registry = self
        self.host_s = defaultdict(list)  # span name -> seconds of each call
        self.events = []
        self.launches = []

    # tracer
    def span(self, name, pe=-1, plane="", nbytes=0):
        return _Span(self, name)

    def begin(self, name, pe=-1, plane=""):
        return _Span(self, name).__enter__()

    # registry
    def counter(self, name, shape=None):
        return self

    def add(self, value):
        pass

    def profile_call(self, name, fn, *args, **kwargs):
        import torch

        self.launches.append(
            (
                [a.clone() if a is not None else None for a in args],
                dict(kwargs),
            )
        )
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def device_ms(self, events) -> list[float]:
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]


class _Span:
    def __init__(self, clock, name):
        self.clock, self.name = clock, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.clock.host_s[self.name].append(time.perf_counter() - self.t0)
        return False


def timed_ms(fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, each timed alone by
    CUDA events after an L2 flush (the step's inputs arrive cold)."""
    import torch

    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_us(event) -> float:
    """Device time of a profiler row (the attribute's name varies across
    torch versions)."""
    for name in ("device_time_total", "cuda_time_total"):
        value = getattr(event, name, None)
        if value:
            return float(value)
    return 0.0


def step_bytes(args, outs) -> int:
    """Bytes the frontier step must move: each input read once, each output
    written once."""
    return sum(t.numel() * t.element_size() for t in (*args, *outs) if t is not None)


def step_ops(args) -> int:
    """Operations the frontier step does on these inputs: the row sort
    (Mt log2 Mt compares per PE) and some ten integer operations per
    frontier position and per slot and candidate (masks, ranks, probe)."""
    ids, touched_aug, cand = args[0], args[6], args[8]
    P, C = ids.shape
    Mt = touched_aug.shape[1] - 1
    K = cand.shape[1]
    return int(P * (Mt * (math.log2(max(Mt, 2)) + 10) + 10 * (C + K)))


# --------------------------------------------------------------------------- #
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch import telemetry
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph
    from repro_torch.kernels import native, ref, scenarios
    from repro_torch.kernels.fused_step import fused_frontier_step_cuda

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 0. the card ------------------------------------------------------ #
    print(card_line())
    print(
        f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}"
    )

    # -- 1. build --------------------------------------------------------- #
    t0 = time.perf_counter()
    reports = native.build_all(verbose=True)
    print(f"phase 1: built {sorted(native.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernel vs plain on the scenario set --------------------------- #
    max_err = 0.0
    cases = scenarios.frontier_scenarios()
    for sc in cases:
        args = to_device(sc.arrays(), dev)
        kw = dict(cand_cap=sc.cand_cap, **sc.constants)
        got = fused_frontier_step_cuda(*args, **kw)
        want = ref.fused_frontier_step(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_outputs(got, want, f"scenario {sc.name}"))
    print(f"phase 2: kernel == plain, bit-exact, on {len(cases)} scenarios "
          f"({', '.join(sc.name for sc in cases)})")

    # -- 3. the main path on the card ------------------------------------- #
    t0 = time.perf_counter()
    g = generate("products", seed=0, scale=MAIN_SCALE)
    parts = partition_graph(g, 4)
    trainer = DistributedTrainer(parts, device=DEVICE, **RUN)
    steps = trainer.epochs * trainer.mb_per_epoch
    print(
        f"phase 3: products scale={MAIN_SCALE} ({g.num_nodes} nodes, {g.num_edges} edges, "
        f"{g.features.shape[1]}-dim features), P=4, capacity "
        f"{trainer.engine.capacity.tolist()}, {steps} steps; set-up "
        f"{time.perf_counter() - t0:.1f} s"
    )
    clock = StageClock()
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.active(clock):
        result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)

    if launches["fused_frontier_step"] != steps + 1:
        raise AssertionError(f"launches {launches} != steps + 1 = {steps + 1}")
    transfers = trainer.last_device_engine.transfers
    if transfers["h2d"] != steps + 1 or transfers["d2h"] != steps + 1:
        raise AssertionError(f"transfers {transfers} != one each per launch")
    losses = np.asarray(result.losses)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not all(len(log.pct_hits) == steps for log in result.logs):
        raise AssertionError("a PE logged the wrong number of steps")
    hits = int(trainer.engine.stats.hits.sum())
    if hits <= 0:
        raise AssertionError("the buffers never hit: the prefetch path did nothing")
    Mt = clock.launches[1][0][6].shape[1] - 1
    print(
        f"phase 3: {steps} steps, {launches['fused_frontier_step']} launches "
        f"(steps + 1), transfers {transfers}, Mt = {Mt} per PE, "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f} (finite), buffer hits {hits}, "
        f"accuracy {result.accuracy:.4f}, wall {wall:.2f} s"
    )
    stage_ms = {
        "step": [1e3 * s for s in clock.host_s["step"]],
        "sample_host": [1e3 * s for s in clock.host_s["sample"]],
        "decide_host": [1e3 * s for s in clock.host_s["decision"]],
        # The last launch is the drained one (Mt = 1): leave it out.
        "launch_device_cuda_events": clock.device_ms(clock.events[:-1]),
        "launch_host": [1e3 * s for s in clock.host_s["device.launch"][:-1]],
        "readback": [1e3 * s for s in clock.host_s["device.readback"][:-1]],
        "train": [1e3 * s for s in clock.host_s["train"]],
    }
    # The mean carries the first step's one-off costs (library and
    # allocator warm-up); the median is the steady step.
    for stat, fn in (("mean", np.mean), ("median", np.median)):
        print(f"phase 3: ms per step by stage, {stat} over the run: " + json.dumps(
            {k: round(float(fn(v)), 3) for k, v in stage_ms.items()}))
    print(f"phase 3: wall {1e3 * wall / steps:.3f} ms per step; first step "
          + json.dumps({k: round(v[0], 3) for k, v in stage_ms.items()}))

    # Kernel vs plain on the run's own launches, at full shape.
    for i, (args, kw) in enumerate(clock.launches):
        got = fused_frontier_step_cuda(*args, **kw)
        want = ref.fused_frontier_step(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_outputs(got, want, f"launch {i}"))
    print(f"phase 3: kernel == plain, bit-exact, on all {len(clock.launches)} "
          f"launches of the run (Mt = {Mt})")

    # Time one steady launch: plain, kernel, kernel, plain.
    args, kw = clock.launches[len(clock.launches) // 2]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    run_kernel = lambda: fused_frontier_step_cuda(*args, **kw)  # noqa: E731
    run_plain = lambda: ref.fused_frontier_step(*args, **kw)  # noqa: E731
    for fn in (run_kernel, run_plain):
        fn()
    reps = 20
    p1 = timed_ms(run_plain, reps, flush)
    k1 = timed_ms(run_kernel, reps, flush)
    k2 = timed_ms(run_kernel, reps, flush)
    p2 = timed_ms(run_plain, reps, flush)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    outs = run_kernel()
    nbytes = step_bytes(args, outs)
    nops = step_ops(args)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(
        f"phase 3: fused_frontier_step at P={args[0].shape[0]}, Mt={Mt}, "
        f"C={args[0].shape[1]}, K={args[8].shape[1]}: kernel {k1:.4f}/{k2:.4f} ms, "
        f"plain {p1:.4f}/{p2:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms, "
        f"{nops} ops -> {t_ops:.4f} ms; bound {bound_ms:.4f} ms"
    )
    with torch.profiler.profile(
        activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
    ) as prof:
        for _ in range(3):
            run_kernel()
        torch.cuda.synchronize()
    rows = sorted(
        prof.key_averages(),
        key=device_us,
        reverse=True,
    )
    dev_rows = [
        f"{e.key[:60]}={device_us(e) / 3 / 1e3:.4f}ms"
        for e in rows[:8]
        if device_us(e) > 0
    ]
    print("phase 3: device time per launch by kernel (torch.profiler): "
          + ("; ".join(dev_rows) if dev_rows else "not measured"))

    # -- 4. card vs CPU, end to end --------------------------------------- #
    g1 = generate("products", seed=0, scale=SMALL_SCALE)
    p1g = partition_graph(g1, 4)
    runs = {}
    for where in ("card", "cpu"):
        tr = DistributedTrainer(
            p1g, device=DEVICE if where == "card" else "cpu", **SMALL
        )
        runs[where] = (tr, tr.run())
    (tc, rc), (th, rh) = runs["card"], runs["cpu"]
    for p, (a, b) in enumerate(zip(rc.logs, rh.logs)):
        for f in STREAMS:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"card vs CPU: PE {p} stream {f} differs")
    for f in STATS:
        if not np.array_equal(getattr(tc.engine.stats, f), getattr(th.engine.stats, f)):
            raise AssertionError(f"card vs CPU: engine.stats.{f} differs")
    for f in ("ids", "scores", "valid", "accessed", "weights"):
        if not np.array_equal(getattr(tc.engine, f), getattr(th.engine, f)):
            raise AssertionError(f"card vs CPU: engine.{f} differs")
    np.testing.assert_allclose(rc.losses, rh.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    n_small = len(rc.losses)
    print(
        f"phase 4: products scale={SMALL_SCALE}, batch {SMALL['batch_size']}, {n_small} steps: card == CPU on "
        f"every stream ({', '.join(STREAMS)}), engine.stats and buffer state; "
        f"losses allclose (rtol={LOSS_RTOL}, atol={LOSS_ATOL}), max |diff| "
        f"{float(np.max(np.abs(np.subtract(rc.losses, rh.losses)))):.3g}"
    )

    # -- 5. results ------------------------------------------------------- #
    kernels = [
        {
            "name": "fused_frontier_step",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_frontier_step.cu",
            "replaces": "src/repro/kernels/fused_step.py:698",
            "launches": launches["fused_frontier_step"],
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
    ]
    print("kernels: " + ", ".join(f"{k['name']} launches={k['launches']}" for k in kernels))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
