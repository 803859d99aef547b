"""A/B of the staged fall-back's two kernels and their hooks on one NVIDIA
card, this tree against another (the parent's).

The staged fall-back (a device run whose ids pass ``WIDE_ID_MAX``) runs the
sampler's dedup hook (``SamplerPlane.sample_all`` with ``use_kernels``) and
the engine's scoring round (``PrefetchEngine.end_round`` with
``use_kernels``) once a step. Each tree runs in its own subprocess, in the
order parent, change, change, parent, on the same inputs made from a seed:
``generate("products", seed=0, scale=10)`` in 4 partitions, 2,000 train
nodes of each PE as its seeds, fanouts (10, 25) (phase 8's block, ``(4,
522,000)`` int32), and buffers of a quarter of each PE's halo (phase 8's
``C``). Every tree reports:

- the hooks end to end, host ms (median of ``--reps`` calls): the kernel
  route on the card and the numpy route (``sample_all``), the scoring
  round on the card and in numpy (``end_round``); the two sampler routes'
  outputs are checked equal first;
- the sampler hook's split, its steps timed one at a time on the tree's
  own code (a sync between steps; CUDA events for the device steps). This
  tree: expansion (into the kept upload buffer), upload, sort, kernel
  (device ms each, and their enqueue's host ms), readback (counts, then
  the used ids), host split. The parent: expansion, ``np.sort``, the
  ``part_of`` gather over the block, the two pageable uploads, kernel,
  the two mask downloads, the two mask extractions;
- each kernel alone by torch.profiler (mean of 10 launches), warm (one
  after another) and cold (after a read of a 256 MB buffer): the
  reference's mask form of ``frontier_unique_batch`` at phase 8's shape
  (flags from ``part_of``), the sampler's compact form (this tree only),
  and ``score_policy_update_batch`` at ``(4, C)``; with each, its device
  operations a call (``chip_smoke.device_ops_a_call``), the wrapper's host
  ms (``chip_smoke.host_ms``), its CUDA-event ms after an L2 flush (the
  whole wrapper, ``chip_smoke.timed_ms``) and its bound from these inputs.

The design choices, in the main process (this tree's wrappers' C entries
and scratch, the sources built as they stand, ``base``, and as variants
made by text patches, one ``nvcc`` each, all started together, each in
its own directory under ``kernels/_build/staged_ab/``), every variant
first checked bit for bit against the plain version, then timed alone,
warm and cold, in turns (base first and last):

- ``score_c8``: the scoring round's cluster of 8 blocks a row (the base:
  16); ``score_t256g2``: blocks of 256 threads taking 2 groups of 4 slots
  a pass (the base: 512 x 4); ``score_c8t256g2``: both (the first
  cluster design); ``score_t1024``: blocks of 1,024 threads. The scoring
  variants are timed at the staged shape ``(4, C)`` and on a row of
  300,001 slots (``(2, 300,001)``, the fixed-policy entries' phase-2
  shape).

And ablations of the compact form, timed only (their outputs are wrong):
``no_lookback`` (each tile takes 0 as its predecessors' sums),
``no_gathers`` (no ``part_of`` load: the key's low bits as its home),
``no_stores`` (the ids are staged in shared memory but not stored).

Prints the card's ``nvidia-smi`` name and power limit first and one JSON
line of the results last (also written to ``--out``). Compare trees only
within one call. ``chip_smoke.py`` phase 8 imports :func:`hook_split` and
:func:`kernel_alone`.

    PYTHONPATH=src python3 scripts/staged_hooks_ab.py [--parent PATH] [--out FILE]
        [--no-variants] [--scale S] [--reps N]

``--parent`` is the ``src`` directory of the other tree (e.g. a ``git
archive`` of the parent commit unpacked under ``_checkout/``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the card helpers: host_ms, timed_ms, ...)

FANOUTS = (10, 25)
BATCH = 2000
PES = 4


def median(xs) -> float:
    return float(np.median(xs))


class Clock:
    """Host ms of a block (the card synchronised at both ends) or device ms
    between CUDA events."""

    def __init__(self):
        self.host = {}
        self.device = {}

    def run(self, name, fn, sync=True):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        self.host.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
        return out

    def events(self, names):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        return evs, names

    def record_device(self, evs, names):
        torch.cuda.synchronize()
        for name, a, b in zip(names, evs, evs[1:]):
            self.device.setdefault(name, []).append(a.elapsed_time(b))

    def medians(self):
        return ({k: median(v) for k, v in self.host.items()},
                {k: median(v) for k, v in self.device.items()})


# -- inputs ------------------------------------------------------------------ #
def setup(scale: float):
    """The graph, its 4-way partition, the PEs' seed blocks and buffer
    capacities (a quarter of each PE's halo, as the trainer sizes them)."""
    from repro_torch.graph import generate, partition_graph

    g = generate("products", seed=0, scale=scale)
    parts = partition_graph(g, PES)
    blocks = [parts.local_train_nodes(p)[:BATCH] for p in range(PES)]
    n = min(len(b) for b in blocks)
    blocks = [np.asarray(b[:n], dtype=np.int64) for b in blocks]
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    caps = []
    for p in range(PES):
        nbrs = np.unique(g.indices[parts.part_of[src] == p])
        caps.append(max(int(len(nbrs[parts.part_of[nbrs] != p]) * 0.25), 1))
    return g, parts, blocks, caps


def dedup_inputs(plane, blocks, part_of):
    """Phase 8's dedup input: the row-sorted int32 block of one step and the
    flags ``part_of[key] != row``."""
    _, _, touched = plane._expand_blocks(blocks, np.random.default_rng(0))
    keys = np.sort(touched.astype(np.int32), axis=1)
    flags = part_of[keys] != np.arange(keys.shape[0])[:, None]
    return keys, flags


def score_inputs(caps, seed=21):
    from repro_torch.kernels import scenarios

    sc = scenarios.make_score_scenario("staged", seed, "rudder", False, P=PES, N=max(caps))
    return sc


# -- the sampler hook's split ------------------------------------------------ #
def hook_split(plane, blocks, part_of, reps: int = 5) -> dict:
    """This tree's sampler hook (``SamplerPlane._dedup_on_device``), its
    steps one at a time on ``plane`` (kernel route on a card): host ms of
    the expansion, of the enqueue of upload + sort + kernel, of the
    readback and of the split, and device ms (CUDA events) of the upload,
    the sort and the kernel; medians over ``reps`` calls. The result is
    checked against ``plane.sample_all`` on the same draws."""
    from repro_torch.kernels import ops

    clock = Clock()
    P = len(blocks)
    Mt = plane._layer_sizes(len(blocks[0]))
    Mt = sum(n * f for n, f in Mt) + len(blocks[0])
    pdev = plane._part_of_on_device(part_of)
    for rep in range(reps):
        rng = np.random.default_rng(100 + rep)
        stage = plane._host_buffer("touched", P * Mt, torch.int32).view(P, Mt)
        clock.run("expansion", lambda: plane._expand_blocks(blocks, rng, out=stage.numpy()))
        evs, names = clock.events(["upload", "sort", "kernel"])

        def enqueue():
            evs[0].record()
            keys = stage.to(plane.device, non_blocking=True)
            evs[1].record()
            srt = torch.sort(keys, dim=1, stable=True).values
            evs[2].record()
            out = ops.frontier_unique_batch(srt, part_of=pdev, compact=True)
            evs[3].record()
            return out

        out = clock.run("enqueue_upload_sort_kernel", enqueue, sync=False)
        clock.record_device(evs, names)
        pulled = clock.run("readback", lambda: plane._pull_ids(*out))
        uniq, remote = clock.run("host_split", lambda: plane._split_ids(*pulled))
        if rep == 0:
            mbs, want = plane.sample_all(blocks, np.random.default_rng(100), part_of=part_of)
            for a, b in zip(want, remote):
                np.testing.assert_array_equal(a, b)
            for mb, u in zip(mbs, uniq):
                np.testing.assert_array_equal(mb.unique_nodes, u)
    host, device = clock.medians()
    return {"host_ms": host, "device_ms": device,
            "hook_host_ms_outside_expansion": sum(v for k, v in host.items()
                                                  if k != "expansion")}


def parent_hook_split(plane, blocks, part_of, reps: int = 5) -> dict:
    """The parent tree's sampler hook, its steps one at a time as its
    ``sample_all`` runs them on the kernel route: expansion (and the int32
    cast), ``np.sort``, the ``part_of`` gather over the block, the two
    pageable uploads, the kernel (device ms by CUDA events), the two mask
    downloads, the two mask extractions and splits."""
    from repro_torch.kernels import ops

    clock = Clock()
    dev = plane.device
    P = len(blocks)
    for rep in range(reps):
        rng = np.random.default_rng(100 + rep)
        touched = clock.run("expansion", lambda: plane._expand_blocks(blocks, rng)[2]
                            .astype(np.int32))
        keys = clock.run("np_sort", lambda: np.sort(touched, axis=1))
        flags = clock.run("part_of_gather",
                          lambda: part_of[keys] != np.arange(P, dtype=part_of.dtype)[:, None])
        up = clock.run("uploads", lambda: (
            torch.from_numpy(np.ascontiguousarray(keys)).to(dev),
            torch.from_numpy(np.ascontiguousarray(flags)).to(dev)))
        evs, names = clock.events(["kernel"])

        def launch():
            evs[0].record()
            out = ops.frontier_unique_batch(*up)
            evs[1].record()
            return out

        first, remote, _, _ = clock.run("kernel_enqueue", launch, sync=False)
        clock.record_device(evs, names)
        first, remote = clock.run("downloads", lambda: (first.cpu().numpy(),
                                                          remote.cpu().numpy()))

        def extract():
            counts = first.sum(axis=1)
            uniq = np.split(keys.ravel()[first.ravel()].astype(np.int64),
                            np.cumsum(counts)[:-1])
            rem = np.split(keys.ravel()[remote.ravel()].astype(np.int64),
                           np.cumsum(remote.sum(axis=1))[:-1])
            return uniq, rem

        clock.run("extractions", extract)
    host, device = clock.medians()
    return {"host_ms": host, "device_ms": device,
            "hook_host_ms_outside_expansion": sum(v for k, v in host.items()
                                                  if k != "expansion")}


# -- the kernels alone -------------------------------------------------------- #
def kernel_alone(fn, kernel: str, reps: int = 10, flush=None):
    """Mean device ms of the kernels whose names contain ``kernel`` over
    ``reps`` calls of ``fn`` in one torch.profiler window (after a warm-up
    call); with ``flush``, each call after a read of it (L2 cold). None
    when the trace shows no such kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and chip_smoke.device_us(e) > 0]
    n = sum(e.count for e in hits)
    return sum(chip_smoke.device_us(e) for e in hits) / n / 1e3 if n else None


def kernel_rows(keys_np, flags_np, part_of_np, sc) -> dict:
    """Each staged kernel of the tree on ``sys.path`` at phase 8's shapes:
    kernel alone warm and cold, device operations a call, wrapper host
    ms, CUDA-event ms after an L2 flush, bound."""
    from repro_torch.kernels import frontier_unique as fu
    from repro_torch.kernels import score_update as su

    dev = torch.device("cuda")
    keys = torch.from_numpy(keys_np).to(dev)
    flags = torch.from_numpy(flags_np).to(dev)
    part_of = torch.from_numpy(part_of_np.astype(np.int32)).to(dev)
    s, a = torch.from_numpy(sc.scores).to(dev), torch.from_numpy(sc.accessed).to(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    P, M = keys.shape
    calls = {
        "frontier_unique_batch (mask form)": (
            lambda: fu.frontier_unique_batch_cuda(keys, flags), "frontier_unique_kernel",
            P * M * (4 + 1 + 2) + 8 * P),
        "score_policy_update_batch": (
            lambda: su.score_policy_update_batch_cuda(s, a, None, **sc.constants),
            "score_update_kernel", s.numel() * (4 + 1 + 4) + 4 * P),
    }
    if hasattr(fu, "frontier_unique_compact_cuda"):
        out = fu.frontier_unique_compact_cuda(keys, part_of)
        used = int(out[2].sum()) + int(out[3].sum())
        calls["frontier_unique_batch (compact form)"] = (
            lambda: fu.frontier_unique_compact_cuda(keys, part_of), "frontier_unique_kernel",
            P * M * 4 + part_of.numel() * 4 + 4 * used + 8 * P)
    rows = {}
    for name, (fn, kernel, nbytes) in calls.items():
        rows[name] = {
            "kernel_alone_warm_ms": kernel_alone(fn, kernel),
            "kernel_alone_cold_ms": kernel_alone(fn, kernel, flush=flush),
            "device_ops_a_call": chip_smoke.device_ops_a_call(fn),
            "host_ms": chip_smoke.host_ms(fn, reps=200),
            "event_ms_after_flush": chip_smoke.timed_ms(fn, 20, flush),
            "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes,
        }
    return rows


# -- design variants (this tree) --------------------------------------------- #
FRONTIER, SCORE = "frontier_unique.cu", "score_update.cu"
S_CLUSTER = "constexpr int kCluster = 16;  // blocks a row (a non-portable cluster size)"
S_THREADS = "constexpr int kThreads = 512;"
S_GROUPS = "constexpr int kGroups = 4;    // 4-slot groups a thread takes a pass"

#: variant -> (source, [(text in it, replacement)]).
VARIANTS = {
    "score_c8": (SCORE, [(S_CLUSTER, "constexpr int kCluster = 8;")]),
    "score_t256g2": (SCORE, [(S_THREADS, "constexpr int kThreads = 256;"),
                             (S_GROUPS, "constexpr int kGroups = 2;")]),
    "score_c8t256g2": (SCORE, [(S_CLUSTER, "constexpr int kCluster = 8;"),
                               (S_THREADS, "constexpr int kThreads = 256;"),
                               (S_GROUPS, "constexpr int kGroups = 2;")]),
    "score_t1024": (SCORE, [(S_THREADS, "constexpr int kThreads = 1024;")]),
}
#: Ablations of the compact form: timed, not checked.
ABLATIONS = {
    "no_lookback": (FRONTIER, [(
        "for (int j = tile - 1; j >= 0; j -= 32) {", "for (int j = -1; j >= 0; j -= 32) {")]),
    "no_gathers": (FRONTIER, [("part_of[key] != row;", "(key & 3) != row;")]),
    "no_stores": (FRONTIER, [
        ("for (int i = t; i < tot_f; i += kThreads) dst[i] = s_ids[i];", ""),
        ("for (int i = t; i < tot_r; i += kThreads) dst[i] = s_ids[i];", "")]),
}


def build_variants() -> dict:
    """``{variant: (source, library path)}``, ``base`` for both sources;
    one nvcc a library, all started together."""
    from repro_torch.kernels import native

    out_dir = native.BUILD_DIR / "staged_ab"
    jobs = {"base_frontier": (FRONTIER, []), "base_score": (SCORE, []), **VARIANTS,
            **ABLATIONS}
    procs = {}
    for name, (source, patches) in jobs.items():
        text = (native.CSRC / source).read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {source}")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        lib = d / "lib.so"
        procs[name] = (source, lib, subprocess.Popen(
            native.nvcc_command(d / source, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (source, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = (source, lib)
    return libs


def variant_callers(libs, keys, part_of, s, a, constants) -> dict:
    """``{variant: call}``: each library's compact dedup (frontier sources)
    or scoring round (score sources) on these inputs, through the C entry
    and the kept scratch the wrappers use; a call returns its outputs."""
    import ctypes

    from repro_torch.kernels import frontier_unique as fu
    from repro_torch.kernels import score_update as su

    dev = keys.device
    P, M = keys.shape
    calls = {}
    for name, (source, lib) in libs.items():
        cdll = ctypes.CDLL(str(lib))
        if source == FRONTIER:
            fn = cdll.rudder_frontier_unique_compact
            fn.argtypes, fn.restype = fu._COMPACT_ARGS, ctypes.c_int

            def call(fn=fn):
                uniq = torch.empty((P * M,), dtype=keys.dtype, device=dev)
                rem = torch.empty((P * M,), dtype=keys.dtype, device=dev)
                counts = torch.empty((2, P), dtype=torch.int32, device=dev)
                _, ctl, tiles = fu._scratch(dev, P, -(-(P * M) // fu.TILE))
                err = fn(P, M, keys.data_ptr(), part_of.data_ptr(), part_of.numel(),
                         uniq.data_ptr(), rem.data_ptr(), counts.data_ptr(),
                         ctl.data_ptr(), tiles.data_ptr(), 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"compact dedup: cudaError_t {err}")
                return uniq, rem, counts[0], counts[1]
        else:
            fn = cdll.rudder_score_update
            fn.argtypes, fn.restype = su._ARGS, ctypes.c_int

            def call(fn=fn):
                out = torch.empty_like(s)
                stale = torch.empty((s.shape[0],), dtype=torch.int32, device=dev)
                c = constants
                err = fn(s.shape[0], s.shape[1], s.data_ptr(), a.data_ptr(), None,
                         out.data_ptr(), stale.data_ptr(), c["increment"],
                         c["decay"], c["threshold"], c["score_cap"],
                         su._MODES[c["mode"]], 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"score round: cudaError_t {err}")
                return out, stale
        calls[name] = (source, call)
    return calls


def variant_rows(keys_np, part_of_np, sc) -> dict:
    """Every variant bit for bit against the plain version, then its
    kernel alone warm and cold, in turns (base first and last)."""
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    keys = torch.from_numpy(keys_np).to(dev)
    part_of = torch.from_numpy(part_of_np.astype(np.int32)).to(dev)
    from repro_torch.kernels import scenarios

    libs = build_variants()
    long_row = scenarios.make_score_scenario("long", 22, "rudder", False, P=2, N=300_001)
    cases = {}  # case -> ({variant: (source, call)}, kernel name, plain outputs)
    for case, score in (("staged", sc), ("long_row", long_row)):
        s = torch.from_numpy(score.scores).to(dev)
        a = torch.from_numpy(score.accessed).to(dev)
        calls = variant_callers(libs, keys, part_of, s, a, score.constants)
        want = ref.score_policy_update_batch(s, a, None, **score.constants)
        cases[f"score_{case}"] = (
            {n: c for n, c in calls.items() if c[0] == SCORE}, "score_update_kernel",
            (want[0].view(torch.int32), want[1]))
    want = ref.frontier_unique_compact(keys, part_of)
    cases["frontier_compact"] = (
        {n: c for n, c in calls.items() if c[0] == FRONTIER}, "frontier_unique_kernel", want)
    for case, (calls, _, want) in cases.items():
        for name, (source, call) in calls.items():
            if name in ABLATIONS:
                continue
            got = call()
            torch.cuda.synchronize()
            if source == FRONTIER:
                got = (got[0][: want[0].numel()], got[1][: want[1].numel()], *got[2:])
            else:
                got = (got[0].view(torch.int32), got[1])
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"variant {name} differs from the plain version ({case})")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rows = {}
    for case, (calls, kernel, _) in cases.items():
        names = list(calls)
        names = names + names[:1]  # base first and last
        for name in names:
            call = calls[name][1]
            row = rows.setdefault(case, {}).setdefault(name, {"warm_ms": [], "cold_ms": []})
            row["warm_ms"].append(kernel_alone(call, kernel))
            row["cold_ms"].append(kernel_alone(call, kernel, flush=flush))
    return rows


# -- one tree ----------------------------------------------------------------- #
def tree_run(scale: float, reps: int) -> dict:
    """Everything measured on the tree whose ``src`` is on ``sys.path``."""
    from repro_torch.graph import SamplerPlane
    from repro_torch.kernels import native
    from repro_torch.runtime import PrefetchEngine

    native.build_all(["frontier_unique", "score_update"])
    g, parts, blocks, caps = setup(scale)
    part_of = parts.part_of
    card = SamplerPlane(g, FANOUTS, use_kernels=True, device="cuda")
    host = SamplerPlane(g, FANOUTS)
    out = {"caps": caps, "block": [PES, None]}
    # The hooks end to end (checked equal first).
    a = card.sample_all(blocks, np.random.default_rng(1), part_of=part_of)
    b = host.sample_all(blocks, np.random.default_rng(1), part_of=part_of)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    for name, plane in (("sample_all_card", card), ("sample_all_numpy", host)):
        times = []
        for rep in range(reps):
            rng = np.random.default_rng(rep)
            t0 = time.perf_counter()
            plane.sample_all(blocks, rng, part_of=part_of)
            times.append(1e3 * (time.perf_counter() - t0))
        out[name + "_ms"] = median(times)
    split = hook_split if hasattr(card, "_dedup_on_device") else parent_hook_split
    out["sampler_hook_split"] = split(card, blocks, part_of, reps)
    # The scoring round end to end.
    rng = np.random.default_rng(3)
    engines = {"end_round_card": PrefetchEngine(caps, use_kernels=True, device="cuda"),
               "end_round_numpy": PrefetchEngine(caps)}
    for p, c in enumerate(caps):
        ids = rng.choice(g.num_nodes, size=c, replace=False)
        for eng in engines.values():
            eng.insert(p, ids)
    active = np.ones(PES, dtype=bool)
    for name, eng in engines.items():
        times = []
        for rep in range(reps):
            eng.accessed[:] = np.random.default_rng(rep).random(eng.accessed.shape) < 0.3
            t0 = time.perf_counter()
            eng.end_round(active)
            times.append(1e3 * (time.perf_counter() - t0))
        out[name + "_ms"] = median(times)
    np.testing.assert_array_equal(engines["end_round_card"].scores.view(np.int32),
                                  engines["end_round_numpy"].scores.view(np.int32))
    keys, flags = dedup_inputs(host, blocks, part_of)
    out["block"] = list(keys.shape)
    out["kernels"] = kernel_rows(keys, flags, part_of, score_inputs(caps))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="src directory of the tree to compare with")
    parser.add_argument("--out", help="also write the JSON line here")
    parser.add_argument("--scale", type=float, default=10.0, help="products preset scale")
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--no-variants", action="store_true",
                        help="leave out the design variants")
    parser.add_argument("--tree-only", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("staged_hooks_ab: no CUDA device", file=sys.stderr)
        return 2
    if opts.tree_only:
        print(json.dumps(tree_run(opts.scale, opts.reps)))
        return 0
    card = chip_smoke.card_line()
    print(card)
    result = {"card": card, "scale": opts.scale, "trees": {}}
    if not opts.no_variants:
        from repro_torch.graph import SamplerPlane

        g, parts, blocks, caps = setup(opts.scale)
        keys, _ = dedup_inputs(SamplerPlane(g, FANOUTS), blocks, parts.part_of)
        result["variants"] = variant_rows(keys, parts.part_of, score_inputs(caps))
        print("variants: " + json.dumps(result["variants"]))
    for which in ("parent", "change", "change", "parent"):
        if which == "parent" and not opts.parent:
            continue
        src = opts.parent if which == "parent" else str(ROOT / "src")
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree-only",
             "--scale", str(opts.scale), "--reps", str(opts.reps)],
            capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=src),
            timeout=900,
        )
        if done.returncode != 0:
            raise RuntimeError(f"{which} run failed:\n{done.stdout}\n{done.stderr}")
        run = json.loads(done.stdout.strip().splitlines()[-1])
        run["wall_s"] = time.perf_counter() - t0
        result["trees"].setdefault(which, []).append(run)
        print(f"{which}: " + json.dumps(run))
    line = json.dumps(result)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
