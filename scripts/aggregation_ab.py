"""A/B of the GraphSAGE aggregation kernels' design choices on one NVIDIA
card, against the parent tree's kernels, with the L2 floor of the gather.

Builds ``src/repro_torch/kernels/csrc/gather_mean.cu`` and
``segment_sum.cu`` as they stand (the base) and variants made from them by
text patches, one ``nvcc`` per source and variant (with ``-Xptxas -v``),
all started together, each variant in its own directory under
``kernels/_build/``:

- ``g_unroll4`` / ``8`` / ``16``: the gather's neighbour loop unrolled that
  deep, so a lane puts that many row loads in flight before its adds (the
  base leaves the depth to the compiler); ``g_warp``: 32 lanes a
  destination whatever the row's width (the first kernel's warp per row);
  ``g_nocap``: one group per destination, no fixed grid;
- ``s_unroll8`` / ``16``: the segment sum's row loop unrolled that deep
  (the base: 8); ``s_t128``: blocks of 128 threads;
- ``parent`` (with ``--parent PATH``, the ``src`` directory of another
  tree, e.g. a ``git archive`` of the parent commit under ``_checkout/``):
  that tree's two kernel sources, called through their own C entries.

Inputs: phase 3's launch from a numpy seed: ``generate("products",
seed=0, scale=10)`` (240,000 x 100 float32 features), 2,000 of PE 0's
train nodes (of 4 partitions, as the trainer's seeds) sampled at fanouts
(10, 25) by the port's ``NeighborSampler`` (82,046 distinct rows, as the
run's 82,105; a destination repeats a third of its rows, a seed's ten
sibling destinations more than half): the gather at ``(20,000, 25)``
int64 indices and at their first 10 columns (``K = 10``), and on a
seeded (240,000, 128) bfloat16 table (its 16-byte path); ``x_n1 (20,000,
100)`` summed at k = 10; phase 3b's ``x_n2 (350,250, 128)`` from a seed
at k = 25, in float32 and bfloat16. Every variant is first checked bit
for bit against the plain version on every input, then timed in turns
(parent and base first and last): the kernel alone by torch.profiler,
the mean of 10 calls warm (one call after another, as chip_smoke's
kernel-alone rows) and cold (after a read of a 256 MB buffer).

The L2 floor of the gather: the distinct rows' bytes read once from DRAM
(a contiguous read of a buffer that size after an L2 flush) plus the
remaining ``B * K * F * 4 - distinct`` bytes at the rate of a contiguous
read of an L2-resident buffer of the distinct rows' size (``__ldcg``, a
small probe kernel built here). Beside it the DRAM bound chip_smoke
computes (distinct rows, output and index at 3.35 TB/s). ``chip_smoke.py``
imports :func:`l2_floor` for its phase 3.

The wrappers' host time, parent against change: in subprocesses on the
same inputs, parent, change, change, parent, each reporting the mean host
ms of 200 calls (the card synchronised before each) of ``gather_mean_cuda``,
``segment_sum_equal_cuda`` on ``x_n1`` and ``fanout_mean`` on it, their
device operations a call and their CUDA-event ms after an L2 flush; then
cProfile's functions with the most time of their own in the change's.

Prints the card's ``nvidia-smi`` name and power limit first and one JSON
line of the results last (also written to ``--out``). Compare variants
only within one call.

    PYTHONPATH=src python3 scripts/aggregation_ab.py [--parent PATH] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12

GATHER, SEGSUM = "gather_mean.cu", "segment_sum.cu"
G_LOOP = "      for (int j = 1; j < K; ++j) {"
S_LOOP = "  for (int j = 1; j < k; ++j) {"


def unrolled(loop: str, n: int) -> tuple[str, str]:
    return loop, f"#pragma unroll {n}\n{loop}"


#: variant -> (source, [(text in it, replacement)]); the other source is
#: the base's. The unroll factors put that many row loads of a lane in
#: flight before its adds (the batches of the first redesign); the base
#: leaves the factor to the compiler, as the first kernels did.
VARIANTS = {
    "g_unroll4": (GATHER, [unrolled(G_LOOP, 4)]),
    "g_unroll8": (GATHER, [unrolled(G_LOOP, 8)]),
    "g_unroll16": (GATHER, [unrolled(G_LOOP, 16)]),
    "g_warp": (GATHER, [("  while ((1 << g) < W && g < 5) ++g;", "  g = 5;")]),
    "g_nocap": (GATHER, [("constexpr int kMaxBlocks = 132 * 16;",
                          "constexpr int kMaxBlocks = 1 << 30;")]),
    "s_unroll8": (SEGSUM, [unrolled(S_LOOP, 8)]),
    "s_unroll16": (SEGSUM, [unrolled(S_LOOP, 16)]),
    "s_t128": (SEGSUM, [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
}

_GM = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_SS = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# The parent's entries: separate bf16 / idx64 ints, no scale.
_GM_PARENT = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p]
_SS_PARENT = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// Reads n 16-byte words `passes` times through L2 (__ldcg: not kept in L1).
__global__ void read_kernel(const uint4* __restrict__ p, int64_t n, int passes,
                            unsigned* sink) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  uint32_t x = 0;
  for (int pass = 0; pass < passes; ++pass) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    for (; i + 3 * stride < n; i += 4 * stride) {
      const uint4 a = __ldcg(p + i), b = __ldcg(p + i + stride);
      const uint4 c = __ldcg(p + i + 2 * stride), d = __ldcg(p + i + 3 * stride);
      x ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
      x ^= c.x ^ c.y ^ c.z ^ c.w ^ d.x ^ d.y ^ d.z ^ d.w;
    }
    for (; i < n; i += stride) {
      const uint4 a = __ldcg(p + i);
      x ^= a.x ^ a.y ^ a.z ^ a.w;
    }
  }
  if (x == 0x9e3779b9u) *sink = x;  // keeps every load
}

extern "C" int rudder_read_probe(const void* p, int64_t n, int passes, void* sink,
                                 int blocks, void* stream) {
  read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), n, passes, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def kernel_ms(fn, match: str, flush=None, reps: int = 10) -> float:
    """Mean device ms a call of the kernels whose name holds ``match``, by
    torch.profiler over ``reps`` calls; with ``flush``, each after a read
    of that 256 MB buffer (``flush.sum()``: it evicts L2 and, unlike
    chip_smoke's ``zero_``, leaves no dirty lines for the call to write
    back; not counted)."""
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
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    # Each call runs one such kernel; the profiler can miss some of them.
    return sum(us) / len(us) / 1e3 if us else float("nan")


# -- the L2 floor ------------------------------------------------------------- #
def probe_lib() -> ctypes.CDLL:
    """The read probe, built once per process into ``kernels/_build/``."""
    from repro_torch.kernels import native

    where = native.BUILD_DIR / "aggregation_ab_probe"
    lib = where / "libprobe.so"
    if not lib.exists():
        where.mkdir(parents=True, exist_ok=True)
        (where / "probe.cu").write_text(PROBE)
        done = subprocess.run(native.nvcc_command(where / "probe.cu", lib),
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for the read probe:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    so.rudder_read_probe.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    so.rudder_read_probe.restype = ctypes.c_int
    return so


def l2_floor(table: torch.Tensor, idx: torch.Tensor, flush, passes: int = 8) -> dict:
    """The gather's L2 floor on these inputs (see the module docstring),
    with the DRAM bound beside it; ms."""
    so = probe_lib()
    B, K = idx.shape
    row = table.shape[1] * table.element_size()
    distinct = torch.unique(idx).numel()
    distinct_bytes = distinct * row
    reread_bytes = B * K * row - distinct_bytes
    n16 = distinct_bytes // 16
    buf = torch.ones(n16 * 4, dtype=torch.int32, device=table.device)
    sink = torch.zeros(1, dtype=torch.int32, device=table.device)
    blocks = torch.cuda.get_device_properties(table.device).multi_processor_count * 8

    def read(p):
        err = so.rudder_read_probe(buf.data_ptr(), n16, p, sink.data_ptr(), blocks, stream())
        if err:
            raise RuntimeError(f"read probe: cudaError_t {err}")

    dram_ms = kernel_ms(lambda: read(1), "read_kernel", flush=flush)
    l2_ms = kernel_ms(lambda: read(passes), "read_kernel")
    l2_rate = passes * n16 * 16 / (l2_ms / 1e3)
    nbytes = distinct_bytes + B * row + idx.numel() * idx.element_size()
    return {
        "distinct_rows": distinct,
        "distinct_bytes": distinct_bytes,
        "reread_bytes": reread_bytes,
        "dram_read_ms": dram_ms,
        "dram_read_rate": distinct_bytes / (dram_ms / 1e3),
        "l2_read_rate": l2_rate,
        "l2_floor_ms": dram_ms + reread_bytes / l2_rate * 1e3,
        "dram_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }


# -- inputs --------------------------------------------------------------------- #
def make_inputs(dev) -> dict:
    """Phase 3's gather and ``x_n1``, phase 3b's ``x_n2``, from seeds."""
    from repro_torch.graph import generate, partition_graph
    from repro_torch.graph.sampler import NeighborSampler

    g = generate("products", seed=0, scale=10)
    rng = np.random.default_rng(0)
    seeds = rng.permutation(partition_graph(g, 4).local_train_nodes(0))[:2000]
    mb = NeighborSampler(g, (10, 25)).sample(seeds, rng)
    n1, n2 = mb.layer_nbrs
    table = torch.from_numpy(g.features).to(dev)
    x_n2 = np.random.default_rng(1).standard_normal((350250, 128), dtype=np.float32)
    wide = np.random.default_rng(2).standard_normal((g.num_nodes, 128), dtype=np.float32)
    return {
        "table": table,
        "table128": torch.from_numpy(wide).to(dev),
        "idx": torch.from_numpy(np.ascontiguousarray(n2)).to(dev),
        "x_n1": table[torch.from_numpy(n1.ravel()).to(dev)],
        "x_n2": torch.from_numpy(x_n2).to(dev),
    }


def cases(inp) -> dict:
    """name -> (kind, args): ``("gather", (table, idx))`` or ``("sum",
    (data, k))``."""
    bf = torch.bfloat16
    return {
        "gather_k25": ("gather", (inp["table"], inp["idx"])),
        "gather_k10": ("gather", (inp["table"], inp["idx"][:, :10].contiguous())),
        "gather_k25_bf16_f128": ("gather", (inp["table128"].to(bf), inp["idx"])),
        "sum_x_n1": ("sum", (inp["x_n1"], 10)),
        "sum_x_n2": ("sum", (inp["x_n2"], 25)),
        "sum_x_n2_bf16": ("sum", (inp["x_n2"].to(bf), 25)),
    }


# -- builds --------------------------------------------------------------------- #
def build_variants(parent: str | None) -> tuple[dict, dict]:
    """``({variant: {source: library}}, {variant: ptxas report})``: the
    base as it stands, each patch, and the parent's sources, one ``nvcc``
    per source and variant (with ``-Xptxas -v``), all started together."""
    from repro_torch.kernels import native

    here = {f: (native.CSRC / f).read_text() for f in (GATHER, SEGSUM, "float_io.cuh")}
    trees = {"base": here}
    for name, (source, patches) in VARIANTS.items():
        files = dict(here)
        for old, new in patches:
            if files[source].count(old) != 1:
                raise RuntimeError(f"patch {name}: {old!r} not found once in {source}")
            files[source] = files[source].replace(old, new)
        trees[name] = files
    if parent:
        csrc = Path(parent) / "repro_torch" / "kernels" / "csrc"
        trees["parent"] = {f: (csrc / f).read_text() for f in (GATHER, SEGSUM, "float_io.cuh")}
    libs, procs = {}, []
    for name, files in trees.items():
        where = native.BUILD_DIR / f"aggregation_ab_{name}"
        where.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (where / f).write_text(text)
        libs[name] = {}
        for f in (GATHER, SEGSUM):
            out = where / f"lib{Path(f).stem}.so"
            cmd = native.nvcc_command(where / f, out, verbose=True)
            cmd[cmd.index(str(native.CSRC))] = str(where)  # this variant's header
            procs.append((name, f, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs[name][f] = out
    reports = {}
    for name, f, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name} ({f}):\n{log}")
        reports.setdefault(name, []).extend(
            line.split("info    : ")[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill" in line)
    return libs, reports


def callers(libs: dict[str, Path], parent: bool) -> dict:
    """``{"gather": fn(table, idx), "sum": fn(data, k)}`` on one variant's
    libraries, each allocating its output and launching on the current
    stream."""
    gm = ctypes.CDLL(str(libs[GATHER])).rudder_gather_mean
    ss = ctypes.CDLL(str(libs[SEGSUM])).rudder_segment_sum
    gm.argtypes, ss.argtypes = (_GM_PARENT, _SS_PARENT) if parent else (_GM, _SS)
    gm.restype = ss.restype = ctypes.c_int

    def gather(table, idx):
        B, K = idx.shape
        out = torch.empty((B, table.shape[1]), dtype=table.dtype, device=table.device)
        bf16, idx64 = int(table.dtype == torch.bfloat16), int(idx.dtype == torch.int64)
        flags = (bf16, idx64) if parent else (bf16 | idx64 << 1,)
        err = gm(B, K, table.shape[1], 1.0 / K, *flags, table.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), stream())
        if err:
            raise RuntimeError(f"gather_mean: cudaError_t {err}")
        return out

    def seg_sum(data, k):
        S = data.shape[0] // k
        out = torch.empty((S, data.shape[1]), dtype=data.dtype, device=data.device)
        bf16 = int(data.dtype == torch.bfloat16)
        head = (bf16,) if parent else (0.0, bf16)
        err = ss(S, k, data.shape[1], *head, data.data_ptr(), out.data_ptr(), stream())
        if err:
            raise RuntimeError(f"segment_sum: cudaError_t {err}")
        return out

    return {"gather": gather, "sum": seg_sum}


# -- the wrappers, per tree ------------------------------------------------------ #
def host_ms(fn, n: int = 200) -> float:
    """Mean host ms of one call (the card synchronised before each call and
    not inside it), as chip_smoke's ``host_ms``."""
    for _ in range(20):
        fn()
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / n * 1e3


def event_ms(fn, flush, reps: int = 20) -> float:
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


def device_ops(fn, reps: int = 5) -> float:
    """Device operations a call, by torch.profiler (the event list)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()) / reps


def wrapper_calls(inp) -> dict:
    from repro_torch.gnn.sage import fanout_mean
    from repro_torch.kernels import gather_mean as gm
    from repro_torch.kernels import segment_sum as ss

    table, idx, x_n1 = inp["table"], inp["idx"], inp["x_n1"]
    return {
        "gather_mean_cuda": lambda: gm.gather_mean_cuda(table, idx),
        "segment_sum_equal_cuda": lambda: ss.segment_sum_equal_cuda(x_n1, 10),
        "fanout_mean": lambda: fanout_mean(x_n1.view(2000, 10, x_n1.shape[1])),
    }


def tree_times(path: str) -> dict:
    """The wrappers of the tree on ``sys.path`` on the inputs saved at
    ``path``: host ms, CUDA-event ms after a flush, device operations."""
    from repro_torch.kernels import native

    native.build_all(["gather_mean", "segment_sum"])
    inp = {k: v.cuda() for k, v in torch.load(path).items()}
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    return {
        name: {"host_ms": host_ms(fn), "event_ms": event_ms(fn, flush),
               "device_ops": device_ops(fn)}
        for name, fn in wrapper_calls(inp).items()
    }


def host_profile(fn, n: int = 200) -> list:
    """cProfile's 12 functions with the most own time, µs a call (the card
    synchronised before each call, outside the profile)."""
    import cProfile
    import pstats

    for _ in range(20):
        fn()
    prof = cProfile.Profile()
    for _ in range(n):
        torch.cuda.synchronize()
        prof.enable()
        fn()
        prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    return [(f"{Path(f).name}:{line}:{fn_}", round(st[2] / n * 1e6, 2))
            for (f, line, fn_), st in top]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="src directory of the tree to compare with")
    parser.add_argument("--out", help="also write the JSON line here")
    parser.add_argument("--tree-only", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("aggregation_ab: no CUDA device", file=sys.stderr)
        return 2
    if opts.tree_only:
        print(json.dumps(tree_times(opts.tree_only)))
        return 0

    from repro_torch.kernels import native, ref

    card = card_line()
    print(card)
    dev = torch.device("cuda")
    libs, reports = build_variants(opts.parent)
    inp = make_inputs(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    result = {"card": card, "distinct_rows_k25": torch.unique(inp["idx"]).numel(),
              "ptxas": reports}
    result["l2_floor_k25"] = l2_floor(inp["table"], inp["idx"], flush)
    result["l2_floor_k10"] = l2_floor(inp["table"], inp["idx"][:, :10].contiguous(), flush)
    print("L2 floor: " + json.dumps({k: result[k] for k in ("l2_floor_k25", "l2_floor_k10")}))

    calls = {name: callers(paths, name == "parent") for name, paths in libs.items()}
    plain = {"gather": ref.gather_mean, "sum": ref.segment_sum_equal}
    runs = cases(inp)
    for case, (kind, args) in runs.items():  # every variant bit-exact first
        want = plain[kind](*args)
        for name, c in calls.items():
            got = c[kind](*args)
            torch.cuda.synchronize()
            bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
            if not torch.equal(got.view(bits), want.view(bits)):
                raise AssertionError(f"variant {name} differs from the plain version on {case}")
    for case, (kind, args) in runs.items():
        match, source = ("gather_mean", GATHER) if kind == "gather" else ("segment_sum", SEGSUM)
        names = [n for n in ("parent", "base") if n in calls]
        names += [n for n, (f, _) in VARIANTS.items() if f == source]
        warm, cold = {}, {}
        for name in names + names[::-1]:  # in turns: base and parent first and last
            fn = lambda c=calls[name][kind]: c(*args)  # noqa: E731
            warm.setdefault(name, []).append(kernel_ms(fn, match))
            cold.setdefault(name, []).append(kernel_ms(fn, match, flush=flush))
        result[case] = {"alone_warm_ms": warm, "alone_cold_ms": cold}
        print(f"{case}: " + json.dumps(result[case]))

    inputs = native.BUILD_DIR / "aggregation_ab_inputs.pt"
    torch.save({k: inp[k].cpu() for k in ("table", "idx", "x_n1")}, inputs)
    trees = {}
    for which in ("parent", "change", "change", "parent"):
        if which == "parent" and not opts.parent:
            continue
        src = opts.parent if which == "parent" else str(ROOT / "src")
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree-only", str(inputs)],
            capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=src), timeout=600,
        )
        if done.returncode != 0:
            raise RuntimeError(f"{which} run failed:\n{done.stdout}\n{done.stderr}")
        trees.setdefault(which, []).append(json.loads(done.stdout.strip().splitlines()[-1]))
    result["wrappers"] = trees
    print("wrappers: " + json.dumps(trees))
    result["host_profile"] = {name: host_profile(fn) for name, fn in wrapper_calls(inp).items()}
    print("host profile: " + json.dumps(result["host_profile"]))
    line = json.dumps(result)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
