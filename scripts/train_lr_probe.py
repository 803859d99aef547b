#!/usr/bin/env python3
"""The learning rates at which chip_smoke's full-width training runs learn.

Trains each of ``chip_smoke.TRAIN_RUNS``' models (DeepSeek-V3's three
dense layers with its MTP head at 2 x 512, Gemma2-2B whole at 2 x 1024,
Phi-3.5-MoE's first two layers at 2 x 512; random weights from seed 0,
``TokenPipeline(seed=0)`` batches) for 8 steps of ``launch.train.train``
at each of lr 3e-4, 1e-4, 3e-5 and 1e-5, and prints every step's loss,
``ce`` and host ms. With ``--ssm`` it trains phase 15c's models instead
(``chip_smoke.SSM_ARCHES``, xLSTM-350M and Zamba2-1.2B whole at
``chip_smoke.SSM_TRAIN``'s 2 x 256) for ``chip_smoke.TRAIN_STEPS`` steps
at each of lr 3e-4, 1e-4 and 3e-5; with ``--media`` phase 16c's
(``chip_smoke.MEDIA_TRAIN``: Whisper-large-v3 whole at 2 x 256 tokens
with 1500 frames, Phi-3-vision-4.2B whole at 1 x 256 tokens with 576
patches) for ``chip_smoke.TRAIN_STEPS`` steps at the same three.
``--arch`` keeps one model, ``--lrs`` and ``--batch`` replace the learning
rates and the batch; each run also prints its peak memory. AdamW runs un-warmed, as the reference's driver runs
it: at DeepSeek-V3's d_model of 7168 its first steps move every logit by
about ``lr x d_model`` and the loss can climb before it falls.

    PYTHONPATH=src python3 scripts/train_lr_probe.py [--ssm | --media] [--arch ID] \
        [--lrs 1e-4,3e-5] [--batch N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

LRS = (3e-4, 1e-4, 3e-5, 1e-5)
STEPS = 8
SSM_LRS = (3e-4, 1e-4, 3e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--ssm", action="store_true", help="phase 15c's models")
    which.add_argument("--media", action="store_true", help="phase 16c's models")
    ap.add_argument("--arch", default=None, help="only this model of the set")
    ap.add_argument("--lrs", default=None, help="comma-separated learning rates")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    out = {}
    runs = cs.TRAIN_RUNS
    lrs, steps = LRS, STEPS
    if args.ssm:
        runs = [(a, None, cs.SSM_TRAIN["batch"], cs.SSM_TRAIN["seq"], None)
                for a in cs.SSM_ARCHES]
    if args.media:
        runs = cs.MEDIA_TRAIN
    if args.ssm or args.media:
        lrs, steps = SSM_LRS, cs.TRAIN_STEPS
    if args.lrs:
        lrs = [float(x) for x in args.lrs.split(",")]
    for arch, layers, batch, seq, _ in runs:
        if args.arch and arch != args.arch:
            continue
        batch = args.batch or batch
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_overrides(num_layers=layers)
        for lr in lrs:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = train(arch, cfg=cfg, steps=steps, batch=batch, seq=seq, lr=lr, seed=0,
                        log_every=100, device="cuda")
            out[f"{arch} {lr} {batch}"] = {"losses": [round(x, 4) for x in res["losses"]],
                                   "ce": [round(m["ce"], 4) for m in res["metrics"]],
                                   "step_ms": [round(1e3 * t, 1) for t in res["step_s"]],
                                   "batch": batch, "seq": seq,
                                   "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
            print(arch, lr, json.dumps(out[f"{arch} {lr} {batch}"]), flush=True)
            del res
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
