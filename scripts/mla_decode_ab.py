"""A/B of the bf16 MLA decode kernel's design choices, and ablations that
show where its time goes, at ``decode_32k`` on one NVIDIA card.

Builds ``src/repro_torch/kernels/csrc/mla_decode.cu`` as it stands and
variants made from it by text patches (one ``nvcc`` each, all started
together, into ``kernels/_build/``):

- design variants, each checked against the plain version:
  ``far``: the head block is the slowest grid dimension instead of the
  fastest, so a request's two 64-head blocks no longer run side by side;
  ``late``: each ring stage is released after the next tile's scores
  instead of right after its own context product;
  ``one_stage``: a ring of one row tile instead of two;
- ablations, timing only (their outputs are wrong by design):
  ``noscores``: no score products (the softmax of zeros);
  ``noctx``: no context products;
  ``nosync``: the two barriers per tile where the consumer warpgroups meet
  (row maxima, then the P tile) left out.

Inputs: B 128, S 32,768, H 128, r 512, rr 64, bf16, pos S - 1, N(0, 0.3²)
from a seed on the card, the queries scaled so the scores spread by
``scenarios.PEAKED``. Each timing is the mean of 10 calls of the C entry
after an L2 flush (CUDA events), every variant called once before any
timing; the variants are timed in turns, design and ablations each
against the base. Prints the card's ``nvidia-smi`` name
and power limit first and one JSON line of the times last. Compare
variants only within one call.

    PYTHONPATH=src python3 scripts/mla_decode_ab.py
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from repro_torch.kernels import mla_decode as md
from repro_torch.kernels import native, ref, scenarios

#: variant -> [(text in mla_decode.cu, replacement)], each found exactly once.
PATCHES = {
    "far": [
        ("  const int h0 = blockIdx.x * kTcHeads;", "  const int h0 = blockIdx.z * kTcHeads;"),
        ("  const int b = blockIdx.z;\n  const int row_begin = split * chunk;\n"
         "  const int row_end = min(row_begin + chunk, n_valid);\n  const int n_tiles",
         "  const int b = blockIdx.x;\n  const int row_begin = split * chunk;\n"
         "  const int row_end = min(row_begin + chunk, n_valid);\n  const int n_tiles"),
        ("const dim3 grid((H + kTcHeads - 1) / kTcHeads, n_split, B);",
         "const dim3 grid(B, n_split, (H + kTcHeads - 1) / kTcHeads);"),
    ],
    "late": [
        ("      wgmma_commit();\n      wgmma_wait_all();\n    } else {",
         "      wgmma_commit();\n      wgmma_wait_all();\n"
         "      if (t > 0 && lane == 0) mbar_arrive(bars + 8 * (stages + (t - 1) % stages));\n"
         "    } else {"),
        ("    wgmma_wait_all();\n    if (lane == 0) mbar_arrive(bars + 8 * (stages + st));\n  }\n",
         "  }\n  wgmma_wait_all();\n"
         "  if (n_tiles > 0 && lane == 0) mbar_arrive(bars + 8 * (stages + (n_tiles - 1) % stages));\n"),
    ],
    "one_stage": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 1;")],
    "noscores": [
        ("      for (int g = 0; g < R / 16; ++g) {", "      for (int g = 0; g < 0; ++g) {"),
        ("      for (int g = 0; g < rope_steps; ++g) {", "      for (int g = 0; g < 0; ++g) {"),
    ],
    "noctx": [("    for (int k = 0; k < 4; ++k)\n      wgmma_context(",
               "    for (int k = 0; k < 0; ++k)\n      wgmma_context(")],
    "nosync": [
        ("    consumers_sync(2);\n    float alpha[2], safe_m[2];", "    float alpha[2], safe_m[2];"),
        ("    consumers_sync(3);  // both halves of P are in place\n", ""),
    ],
}
DESIGN = ("base", "far", "late", "one_stage", "one_stage", "late", "far", "base")
ABLATION = ("base", "noscores", "noctx", "nosync", "nosync", "noctx", "noscores", "base")


def variants() -> dict[str, str]:
    """``{name: source}``: the kernel as it stands and each patched copy."""
    base = (native.CSRC / native.SOURCES["mla_decode"]).read_text()
    out = {"base": base}
    for name, edits in PATCHES.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: patch text found {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict[str, str]) -> dict:
    """Compile every variant (one ``nvcc`` each, in parallel) and bind its
    bf16 entry."""
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = native.BUILD_DIR / f"mla_ab_{name}.cu"
        src.write_text(text)
        out = native.BUILD_DIR / f"libmla_ab_{name}.so"
        procs[name] = (subprocess.Popen(native.nvcc_command(src, out), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out)).rudder_mla_flash_decode_bf16
        fn.argtypes = md._ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mla_decode_ab: needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = build(variants())
    dev = torch.device("cuda")
    B, S, H, R, RR = 128, 32768, 128, 512, 64
    pos, scale = S - 1, 1.0 / math.sqrt(128 + RR)
    gen = torch.Generator(device=dev).manual_seed(3)
    gains = (*scenarios.mla_query_gains(R, RR, scale, scenarios.PEAKED), 1.0, 1.0)
    args = [(torch.randn(sh, generator=gen, device=dev) * (0.3 * g)).to(torch.bfloat16)
            for sh, g in zip(((B, H, R), (B, H, RR), (B, S, R), (B, S, RR)), gains)]
    n_split, chunk = md.split_plan(B, H, S, md.sm_count(dev))
    out = torch.empty((B, H, R), dtype=torch.bfloat16, device=dev)
    part_acc = torch.empty((B, H, n_split, R), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)

    def call(name):
        err = fns[name](B, H, S, R, RR, S, n_split, chunk, scale,
                        *(a.data_ptr() for a in args), part_acc.data_ptr(), part_ml.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        native.check(err, f"mla_decode_ab {name}")

    want = ref.mla_latent_attention(*args, pos, scale).float()
    for name in dict.fromkeys(DESIGN):
        call(name)
        err = (out.float() - want).abs().max().item()
        if not (torch.allclose(out.float(), want, rtol=3e-2, atol=3e-2)
                and err <= 1e-2 * want.abs().max().item()):
            raise AssertionError(f"{name}: kernel != plain (max |diff| {err:.3g})")
        print(f"{name}: allclose 3e-2 to the plain version, max |diff| {err:.3g} "
              f"(max |plain| {want.abs().max().item():.3g})")
    del want
    for name in fns:  # load every library's module before any timing
        call(name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def timed(name, reps=10):
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            call(name)
            e1.record()
            torch.cuda.synchronize()
            total += e0.elapsed_time(e1)
        return total / reps

    result = {}
    for label, order in (("design_ms", DESIGN), ("ablation_ms", ABLATION)):
        times = {name: [] for name in dict.fromkeys(order)}
        for name in order:
            times[name].append(timed(name))
        print(f"decode_32k ms per call, in turns ({label}): " + json.dumps(times))
        result[label] = times
    print(json.dumps({**result, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
