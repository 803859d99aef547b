#!/usr/bin/env python3
"""The training path's backward choices, measured on the card.

Three questions the port's training path (``repro_torch.models.model.
lm_loss``) answers by a design choice, each checked here at full width
on bf16 inputs drawn from a seed:

1. **Embedding backward** (DeepSeek-V3's table, 129,280 x 7168, and
   Gemma2-2B's, 256,000 x 2304; the tokens of ``TokenPipeline(seed=0)``,
   so that ids repeat as they do in training). The gradient of
   ``embedding[tokens]`` (an ``index_put_`` with accumulate), of
   ``F.embedding`` and of a sum in float32 over the distinct ids
   (``index_put_`` into float32 rows) are each held against the float64
   sum rounded once to bf16: the elements that differ, the largest
   difference, whether two runs are bit-identical, and the time.
2. **``torch._grouped_mm`` backward** (one Phi-3.5-MoE layer at full
   width: 16 experts top-2, d_model 4096, d_ff 6400, 1024 tokens, bf16;
   and the smoke widths in float32): ``moe_forward``'s gradients against
   a per-expert ``torch.matmul`` loop's, an expert with no rows included.
3. **The unembedding's saved blocks** (DeepSeek-V3: x (2, 512, 7168),
   the 129,280-row table): peak memory and time of a forward and
   backward through ``common.unembed`` (which widens each block again in
   backward) against the plain autograd form (which keeps every widened
   block).

    PYTHONPATH=src python3 scripts/train_backward_probe.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.models import common, moe


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def embedding_backward(arch: str, batch: int, seq: int, dev) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
    tokens = torch.from_numpy(TokenPipeline(cfg, batch, seq, seed=0).next_batch()["tokens"]
                              ).to(dev).long()
    up = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)

    def by_index():
        e = table.detach().requires_grad_()
        return torch.autograd.grad(e[tokens], e, up)[0]

    def by_embedding():
        e = table.detach().requires_grad_()
        return torch.autograd.grad(F.embedding(tokens, e), e, up)[0]

    def by_distinct_rows():
        flat = tokens.reshape(-1)
        uniq, inv = torch.unique(flat, return_inverse=True)
        acc = torch.zeros((uniq.numel(), cfg.d_model), dtype=torch.float32, device=dev)
        acc.index_put_((inv,), up.reshape(-1, cfg.d_model).float(), accumulate=True)
        out = torch.zeros_like(table)
        out[uniq] = acc.to(torch.bfloat16)
        return out

    flat = tokens.reshape(-1)
    uniq = torch.unique(flat)
    exact = torch.zeros((uniq.numel(), cfg.d_model), dtype=torch.float64, device=dev)
    exact.index_add_(0, torch.searchsorted(uniq, flat), up.reshape(-1, cfg.d_model).double())
    exact = exact.to(torch.bfloat16)
    row = {"tokens": flat.numel(), "distinct": uniq.numel(),
           "repeats_of_the_most_frequent": int(torch.bincount(flat).max())}
    for name, fn in (("index", by_index), ("F.embedding", by_embedding),
                     ("float32 distinct rows", by_distinct_rows)):
        a, b = fn(), fn()
        got = a[uniq]
        diff = (got.float() - exact.float()).abs()
        row[name] = {
            "elements_differing_from_the_float64_sum": int((got != exact).sum()),
            "max_abs_diff": diff.max().item(),
            "two_runs_bit_identical": bool(torch.equal(a.view(torch.int16), b.view(torch.int16))),
            "ms": timed(fn),
        }
        del a, b, got, diff
    del table, up, exact
    torch.cuda.empty_cache()
    return row


def loop_moe(cfg, params, x):
    """``moe.moe_forward`` with one ``torch.matmul`` per expert (swiglu)."""
    m = cfg.moe
    b, s, d = x.shape
    n, k = b * s, m.experts_per_token
    tokens = x.reshape(n, d)
    gates, idx, _ = moe._route(cfg, params["router"], tokens)
    flat_expert = idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = tokens[order // k]
    counts = torch.bincount(flat_expert, minlength=m.num_experts).tolist()
    pieces, start = [], 0
    for e, c in enumerate(counts):
        rows = xs[start : start + c]
        h = F.silu(rows @ params["w_gate"][e]) * (rows @ params["w_up"][e])
        pieces.append(h @ params["w_down"][e])
        start += c
    out = torch.cat(pieces) * gates.reshape(-1)[order][:, None].to(xs.dtype)
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(n * k, device=x.device)
    copies = out[torch.sort(sorted_pos.view(n, k), dim=1).values]
    y = copies[:, 0]
    for j in range(1, k):
        y = y + copies[:, j]
    return y.reshape(b, s, d).to(x.dtype)


def grouped_backward(cfg, tokens: int, dev, empty_expert: bool) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    params = moe.init_moe(cfg, gen)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    if empty_expert:  # positive inputs and a negative router column: no row for the last expert
        x = x.abs()
        params["router"][:, -1] = -1.0
    x = x.to(params["w_up"].dtype)
    up = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
    names = ("router", "w_gate", "w_up", "w_down")

    def grads(fn):
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        xi = x.detach().requires_grad_()
        y = fn(cfg, {**params, **leaves}, xi)
        if isinstance(y, tuple):
            y = y[0]
        return dict(zip(("x", *names), torch.autograd.grad(y, (xi, *leaves.values()), up)))

    got, want = grads(moe.moe_forward), grads(loop_moe)
    row = {"dtype": str(x.dtype), "tokens": tokens, "experts": cfg.moe.num_experts,
           "empty_expert": empty_expert}
    for k in got:
        scale = max(want[k].float().abs().max().item(), 1e-30)
        row[k] = (got[k].float() - want[k].float()).abs().max().item() / scale
    if empty_expert:
        row["w_up_grad_of_the_empty_expert_zero"] = bool((got["w_up"][-1] == 0).all())
    try:
        xi = x.detach().requires_grad_()
        moe.moe_forward(cfg, params, xi)[0].sum().backward()
        row["stride_0_upstream"] = "ran"
    except RuntimeError as err:
        row["stride_0_upstream"] = f"raises: {str(err).splitlines()[0][:120]}"
    return row


def unembed_memory(dev) -> dict:
    cfg = get_config("deepseek-v3-671b")
    gen = torch.Generator(device=dev).manual_seed(2)
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)

    def plain(xx, e):
        xf = xx.to(torch.float32)
        out = torch.empty((*xx.shape[:-1], e.shape[0]), dtype=torch.float32, device=dev)
        for v0 in range(0, e.shape[0], common.UNEMBED_CHUNK):
            block = e[v0 : v0 + common.UNEMBED_CHUNK].to(torch.float32)
            out[..., v0 : v0 + block.shape[0]] = xf @ block.T
        return out

    row = {}
    results = {}
    for name, fn in (("plain autograd", plain),
                     ("common.unembed", lambda xx, e: common.unembed(cfg, e, xx))):
        def run():
            xi, e = x.detach().requires_grad_(), table.detach().requires_grad_()
            logits = fn(xi, e)
            loss = torch.logsumexp(logits, -1).mean()
            return torch.autograd.grad(loss, (xi, e))

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[name] = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        row[name] = {"peak_bytes_above_inputs": peak, "ms": timed(run, reps=2)}
    gx0, ge0 = results["plain autograd"]
    gx1, ge1 = results["common.unembed"]
    row["grad_x_max_rel_diff"] = ((gx0.float() - gx1.float()).abs().max()
                                  / gx0.float().abs().max()).item()
    row["grad_table_bit_identical"] = bool(torch.equal(ge0.view(torch.int16), ge1.view(torch.int16)))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(out), flush=True)
    out["embedding"] = {
        "deepseek-v3 (2 x 512)": embedding_backward("deepseek-v3-671b", 2, 512, dev),
        "gemma2-2b (2 x 1024)": embedding_backward("gemma2-2b", 2, 1024, dev),
        "gemma2-2b (8 x 1024)": embedding_backward("gemma2-2b", 8, 1024, dev),
    }
    print(json.dumps(out["embedding"]), flush=True)
    phi = get_config("phi3.5-moe-42b-a6.6b")
    small = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(dtype="float32")
    out["grouped_mm"] = [
        grouped_backward(phi, 1024, dev, False),
        grouped_backward(phi, 1024, dev, True),
        grouped_backward(small, 30, dev, True),
    ]
    print(json.dumps(out["grouped_mm"]), flush=True)
    out["unembed"] = unembed_memory(dev)
    print(json.dumps(out["unembed"]), flush=True)
    out["seconds"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
