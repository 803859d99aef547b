#!/usr/bin/env python3
"""The learning rates at which chip_smoke's full-width training runs learn.

Trains each of ``chip_smoke.TRAIN_RUNS``' models (DeepSeek-V3's three
dense layers with its MTP head at 2 x 512, Gemma2-2B whole at 2 x 1024,
Phi-3.5-MoE's first two layers at 2 x 512; random weights from seed 0,
``TokenPipeline(seed=0)`` batches) for 8 steps of ``launch.train.train``
at each of lr 3e-4, 1e-4, 3e-5 and 1e-5, and prints every step's loss,
``ce`` and host ms. AdamW runs un-warmed, as the reference's driver runs
it: at DeepSeek-V3's d_model of 7168 its first steps move every logit by
about ``lr x d_model`` and the loss can climb before it falls.

    PYTHONPATH=src python3 scripts/train_lr_probe.py [--out FILE]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    out = {}
    for arch, layers, batch, seq, _ in cs.TRAIN_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_overrides(num_layers=layers)
        for lr in LRS:
            torch.cuda.empty_cache()
            res = train(arch, cfg=cfg, steps=STEPS, batch=batch, seq=seq, lr=lr, seed=0,
                        log_every=100, device="cuda")
            out[f"{arch} {lr}"] = {"losses": [round(x, 4) for x in res["losses"]],
                                   "ce": [round(m["ce"], 4) for m in res["metrics"]],
                                   "step_ms": [round(1e3 * t, 1) for t in res["step_s"]]}
            print(arch, lr, json.dumps(out[f"{arch} {lr}"]), flush=True)
            del res
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
