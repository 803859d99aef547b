#!/usr/bin/env python3
"""A/B of the MoE layer's grouped products on the card.

``repro_torch.models.moe.moe_forward`` runs the three expert products as
``torch._grouped_mm`` over the rows sorted by expert, with the group
offsets computed on the card (no host read). The alternative timed here
(:func:`loop_forward`) reads the expert counts to the host and runs one
``torch.matmul`` per expert that received rows. This script times both
on one DeepSeek-V3 MoE layer at full width (256 routed experts top-8,
d_model 7168, d_ff_expert 2048, one shared expert, bf16, random weights
from a seed) at decode (4 tokens) and at prefill (4 x 256 tokens): CUDA
events, L2 flushed, the mean of ``--reps`` calls after a warm call, in
the order loop, grouped, grouped, loop. It also checks the two against
each other (bf16, 3e-2) and says whether ``torch._grouped_mm`` takes
float32 on this card.

    PYTHONPATH=src python3 scripts/moe_grouped_ab.py [--reps 5] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.mlp import mlp_forward


def loop_forward(cfg, params, x):
    """``moe.moe_forward`` with the counts read to the host and one
    ``torch.matmul`` per expert that received rows (swiglu)."""
    m = cfg.moe
    b, s, d = x.shape
    n, k = b * s, m.experts_per_token
    tokens = x.reshape(n, d)
    gates, idx, aux = moe._route(cfg, params["router"], tokens)
    flat_expert = idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = tokens[order // k]
    counts = torch.bincount(flat_expert, minlength=m.num_experts).tolist()
    out = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if c:
            rows = xs[start : start + c]
            h = F.silu(rows @ params["w_gate"][e]) * (rows @ params["w_up"][e])
            out[start : start + c] = h @ params["w_down"][e]
            start += c
    out = out * gates.reshape(-1)[order][:, None].to(out.dtype)
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(n * k, device=x.device)
    copies = out[torch.sort(sorted_pos.view(n, k), dim=1).values]
    y = copies[:, 0]
    for j in range(1, k):
        y = y + copies[:, j]
    y = y.reshape(b, s, d).to(x.dtype)
    if m.num_shared_experts:
        y = y + mlp_forward(cfg, params["shared"], x)
    return y, aux


def timed_ms(fn, reps, flush):
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    cfg = get_config("deepseek-v3-671b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = moe.init_moe(cfg, gen)
    torch.cuda.synchronize()
    print(f"one MoE layer at full width drawn in {time.perf_counter() - t0:.2f} s")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    rows = {"card": card}
    for what, shape in (("decode", (4, 1)), ("prefill", (4, 256))):
        x = (torch.randn((*shape, cfg.d_model), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        with torch.no_grad():
            loop = lambda: loop_forward(cfg, params, x)  # noqa: E731
            grouped = lambda: moe.moe_forward(cfg, params, x)  # noqa: E731
            a, b = loop()[0], grouped()[0]
            err = (a.float() - b.float()).abs().max().item()
            l1 = timed_ms(loop, args.reps, flush)
            g1 = timed_ms(grouped, args.reps, flush)
            g2 = timed_ms(grouped, args.reps, flush)
            l2 = timed_ms(loop, args.reps, flush)
        rows[what] = {"tokens": shape[0] * shape[1], "loop_ms": [l1, l2], "grouped_ms": [g1, g2],
                      "max_abs_diff": err, "allclose_3e-2": bool(torch.allclose(
                          a.float(), b.float(), rtol=3e-2, atol=3e-2))}
        print(f"{what} ({shape[0] * shape[1]} tokens): loop {l1:.4f} / {l2:.4f} ms, grouped "
              f"{g1:.4f} / {g2:.4f} ms; max |diff| {err:.4g}")
    a = torch.randn((8, 64), device=dev)
    bw = torch.randn((4, 64, 32), device=dev)
    offs = torch.tensor([2, 4, 6, 8], dtype=torch.int32, device=dev)
    try:
        torch._grouped_mm(a, bw, offs=offs)
        rows["float32"] = "accepted"
    except RuntimeError as exc:  # what this card's build refuses is the finding
        rows["float32"] = f"refused: {str(exc).splitlines()[0]}"
    print(f"torch._grouped_mm on float32: {rows['float32']}")
    print(json.dumps(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
