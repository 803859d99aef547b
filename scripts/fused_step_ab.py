"""A/B of the fused step kernel's design choices at the ragged loop's
shape, on one NVIDIA card, and ablations that show where its time goes.

Builds ``src/repro_torch/kernels/csrc/fused_step.cu`` as it stands (the
base: a cluster of 16 blocks per PE, 4 elements a thread a tile) and
variants made from it and from ``prefetch_state.cuh`` by text patches
(one ``nvcc`` each, all started together, each in its own directory under
``kernels/_build/``):

- design variants, each checked against the plain version: ``b8i8``, a
  cluster of 8 blocks (the portable size; 32 SMs at P = 4) and 8
  elements a thread; ``b16i8``; ``b16i2``; ``b8i1``, 8 blocks and 1
  element a thread a tile: a block scan per 512 slots or candidates, the
  state round's walk before this design; ``t1024i2``, blocks of 1,024
  threads with 2 elements each;
- ablations, timing only (their outputs are wrong by design, and each
  call starts from fresh maps): ``noprobe`` (no query probed),
  ``norestore`` (the maps left dirty), ``round`` (neither: the state
  round alone), ``nofence`` (no ``__threadfence`` before the cluster
  barriers).

Every variant is timed in turns, base first and last: the engine's
wrapper (``fused_step_readback_cuda``) by CUDA events after an L2 flush,
mean of 20 calls (design variants only), and ``fused_step_kernel`` alone
by torch.profiler. Then the base wrapper's host time: the mean of 500
calls and cProfile's functions with the most time of their own. Inputs: one launch at phase 3b's largest shape (P 4,
C 23,398, M 21,946, K 22,447, ids below 550,000; the rudder policy,
every gate on), from a numpy seed: 97% of the slots valid at scores in
[0.5, 2), 30% accessed, queries 40% resident, candidates 10% resident
and with repeats; narrow, and wide (the ids moved up by 2^31 + 1000).

With ``--parent PATH`` (the ``src`` directory of another tree, e.g. a
``git archive`` of the parent commit under ``_checkout/``), the
reference form's wrapper (``fused_step_cuda`` / ``fused_step_wide_cuda``,
the one both trees have) is also timed in subprocesses on the same
inputs, in the order parent, change, change, parent, with its device
operations a call and their device time.

Prints the card's ``nvidia-smi`` name and power limit first and one JSON
line of the times last. Compare variants only within one call.

    PYTHONPATH=src python3 scripts/fused_step_ab.py [--parent PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(P=4, C=23398, M=21946, K=22447, N=550000)
WIDE_BASE = 2**31 + 1000

#: variant -> [(file, text in it, replacement)], each text found exactly once.
STEP, ROUND = "fused_step.cu", "prefetch_state.cuh"
BLOCKS = "constexpr int kStepBlocks = 16;"
ITEMS = "constexpr int kStepItems = 4;"
DESIGN = {
    "b8i8": [(STEP, BLOCKS, "constexpr int kStepBlocks = 8;"),
             (STEP, ITEMS, "constexpr int kStepItems = 8;")],
    "b16i8": [(STEP, ITEMS, "constexpr int kStepItems = 8;")],
    "b16i2": [(STEP, ITEMS, "constexpr int kStepItems = 2;")],
    "b8i1": [(STEP, BLOCKS, "constexpr int kStepBlocks = 8;"),
             (STEP, ITEMS, "constexpr int kStepItems = 1;")],
    "t1024i2": [(ROUND, "constexpr int kStateThreads = 512;", "constexpr int kStateThreads = 1024;"),
                (STEP, ITEMS, "constexpr int kStepItems = 2;")],
}
NO_PROBE = (STEP, "  for (int base = 0; base < M; base += kStepBlocks * T * kStepItems) {",
            "  for (int base = 0; base < 0; base += kStepBlocks * T * kStepItems) {")
NO_RESTORE = (STEP, "  if constexpr (!kSorted) {\n    // -- (3) restore",
              "  if constexpr (false) {\n    // -- (3) restore")
ABLATION = {
    "noprobe": [NO_PROBE],
    "norestore": [NO_RESTORE],
    "round": [NO_PROBE, NO_RESTORE],
    "nofence": [(STEP, "__threadfence();", ""), (ROUND, "__threadfence();", "")],
}
DESIGN_ORDER = ("base", "b8i8", "b16i8", "b16i2", "b8i1", "t1024i2",
                "t1024i2", "b8i1", "b16i2", "b16i8", "b8i8", "base")
ABLATION_ORDER = ("base", "noprobe", "norestore", "round", "nofence",
                  "nofence", "round", "norestore", "noprobe", "base")


def launch_inputs(wide: bool, seed: int = 0):
    """One launch's inputs on the card: ``(args, gate words, id range
    keywords, constants)``."""
    from repro_torch.core import scoring

    P, C, M, K, N = (SHAPE[k] for k in ("P", "C", "M", "K", "N"))
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(N, C, replace=False) for _ in range(P)])
    valid = rng.random((P, C)) < 0.97
    ids = np.where(valid, ids, -1)
    scores = rng.uniform(0.5, 2.0, (P, C)).astype(np.float32)
    accessed = rng.random((P, C)) < 0.3
    in_cap = np.ones((P, C), dtype=bool)
    queries = np.full((P, M), -1, dtype=np.int64)
    cand = np.empty((P, K), dtype=np.int64)
    for p in range(P):
        live = ids[p][valid[p]]
        q = np.unique(np.concatenate([rng.choice(live, int(0.4 * M)), rng.choice(N, M)]))
        q = rng.permutation(q)[:M]
        queries[p, : len(q)] = q
        cand[p] = np.concatenate([rng.choice(live, K // 10), rng.choice(N, K - K // 10)])
    base = WIDE_BASE if wide else 0
    idt = np.int64 if wide else np.int32

    def shift(a):
        return np.where(a >= 0, a + base, a).astype(idt)

    dev = torch.device("cuda")
    host = (shift(ids), scores, valid, accessed, in_cap, None, shift(queries), shift(cand), None)
    args = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in host]
    words = torch.full((P,), 7, dtype=torch.int32, device=dev)
    span = dict(id_lo=base, num_ids=N) if wide else dict(num_ids=N)
    return args, words, span, scoring.make_policy("rudder").kernel_constants()


def timed_ms(fn, flush, reps: int = 20) -> float:
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


def device_ops(fn, reps: int = 3, match: str | None = None) -> tuple[int, float]:
    """``(device operations a call, their device ms a call)`` by
    torch.profiler, after a warm-up call; with ``match``, only the
    operations whose name contains it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and (match is None or match in e.name)]
    us = sum(e.time_range.elapsed_us() for e in ops)
    return len(ops) // reps, us / reps / 1e3


def build_variants() -> dict[str, Path]:
    """``{variant: library}``, the base as it stands and each patch (all
    of ``DESIGN`` and ``ABLATION``), each built from its own directory
    holding its copies of both sources."""
    from repro_torch.kernels import native

    native.build_all(["fused_step"])
    libs = {"base": native._target("fused_step")}
    texts = {f: (native.CSRC / f).read_text() for f in (STEP, ROUND)}
    procs = {}
    for name, patches in {**DESIGN, **ABLATION}.items():
        files = dict(texts)
        for f, old, new in patches:
            n = files[f].count(old)
            if n == 0 or (n > 1 and old != "__threadfence();"):  # fences: every one
                raise RuntimeError(f"patch {name}: {old!r} found {n} times in {f}")
            files[f] = files[f].replace(old, new)
        where = native.BUILD_DIR / f"fused_step_ab_{name}"
        where.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (where / f).write_text(text)
        out = where / "libfused_step.so"
        procs[name] = (subprocess.Popen(native.nvcc_command(where / STEP, out),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = out
    return libs


def tree_times() -> dict:
    """The reference form's wrapper of the tree on ``sys.path`` (the mode
    the ``--parent`` subprocesses run): CUDA-event ms, device operations a
    call and their device ms, narrow and wide."""
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import native

    native.build_all(["fused_step"])
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    out = {}
    for wide in (False, True):
        args, words, span, consts = launch_inputs(wide)
        bits = [(words & bit) != 0 for bit in (1, 2, 4)]
        wrapper = fs.fused_step_wide_cuda if wide else fs.fused_step_cuda

        def call():
            return wrapper(*args, *bits, **span, **consts)

        call()
        n_ops, dev_ms = device_ops(call)
        out["wide" if wide else "narrow"] = {
            "ms": timed_ms(call, flush), "device_ops": n_ops, "device_ms": dev_ms,
        }
    return out


def host_profile(call, n: int = 500) -> dict:
    """Where the host time of ``call`` goes: the mean µs a call (the card
    synchronised every 50 calls) and cProfile's top functions by their
    own time, µs a call."""
    import cProfile
    import pstats
    import time

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        call()
        if i % 50 == 49:
            torch.cuda.synchronize()
    mean_us = (time.perf_counter() - t0) / n * 1e6
    prof = cProfile.Profile()
    prof.enable()
    for i in range(n):
        call()
        if i % 50 == 49:
            torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    return {
        "mean_us": mean_us,
        "top_own_us": [
            (f"{Path(f).name}:{line}:{fn}", round(st[2] / n * 1e6, 2), st[1] // n)
            for (f, line, fn), st in top
        ],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="src directory of the tree to compare with")
    parser.add_argument("--tree-only", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("fused_step_ab: no CUDA device", file=sys.stderr)
        return 2
    if opts.tree_only:
        print(json.dumps(tree_times()))
        return 0

    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import native, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    result = {"card": card, "shape": SHAPE}
    for wide in (False, True):
        tag = "wide" if wide else "narrow"
        args, words, span, consts = launch_inputs(wide)
        bits = [(words & bit) != 0 for bit in (1, 2, 4)]
        plain = ref.fused_step(*args, *bits, **consts)
        want = (*plain[:5], ref.pack_readback(*plain[5:9], plain[10]))

        def call():
            return fs.fused_step_readback_cuda(*args, words, **span, **consts)

        loaded = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
        failed = {}
        for name, lib in loaded.items():  # check the design variants, warm up
            native._LIBS["fused_step"] = lib
            fs._MAPS.clear()
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as exc:  # a variant the card refuses to launch
                failed[name] = str(exc)
                continue
            if name in ABLATION:
                continue
            for a, b in zip(got, want):
                if a is None or b is None:
                    continue
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise AssertionError(f"variant {name} ({tag}) differs from the plain version")
        fs._MAPS.clear()

        def fresh():
            fs._MAPS.clear()
            return call()

        times, alone, ablated = {}, {}, {}
        for name in (n for n in DESIGN_ORDER if n not in failed):
            native._LIBS["fused_step"] = loaded[name]
            times.setdefault(name, []).append(timed_ms(call, flush))
            alone.setdefault(name, []).append(device_ops(call, match="fused_step_kernel")[1])
        for name in (n for n in ABLATION_ORDER if n not in failed):
            native._LIBS["fused_step"] = loaded[name]
            ablated.setdefault(name, []).append(device_ops(fresh, match="fused_step_kernel")[1])
        fs._MAPS.clear()
        native._LIBS["fused_step"] = loaded["base"]
        result[tag] = {"wrapper_ms": times, "kernel_alone_ms": alone,
                       "ablation_kernel_ms": ablated, "failed": failed,
                       "host": host_profile(call)}
        print(f"{tag}: " + json.dumps(result[tag]))

    if opts.parent:
        runs = {}
        for which in ("parent", "change", "change", "parent"):
            src = opts.parent if which == "parent" else str(ROOT / "src")
            env = dict(os.environ, PYTHONPATH=src)
            done = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--tree-only"],
                capture_output=True, text=True, env=env, timeout=600,
            )
            if done.returncode != 0:
                raise RuntimeError(f"{which} run failed:\n{done.stdout}\n{done.stderr}")
            runs.setdefault(which, []).append(json.loads(done.stdout.strip().splitlines()[-1]))
        result["trees"] = runs
        print("trees (reference form): " + json.dumps(runs))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
