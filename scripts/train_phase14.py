#!/usr/bin/env python3
"""chip_smoke.py's training phases alone: phase 14 (DeepSeek-V3's three
dense layers with its MTP head, Gemma2-2B whole and Phi-3.5-MoE's first
two layers trained at full width, ``chip_smoke.TRAIN_RUNS``) and phase
14c (the six smoke configs, card against CPU, a checkpoint moved across),
with chip_smoke's own checks and lines, and every row as JSON in
``--out``. No kernel is built: training launches none.

    PYTHONPATH=src python3 scripts/train_phase14.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rows = {}
    for arch, layers, batch, seq, lr in cs.TRAIN_RUNS:
        rows[arch] = cs.train_full_width(arch, layers, batch, seq, lr, dev)
        cs.print_train_row(arch, rows[arch])
        sys.stdout.flush()
    for arch in cs.ZOO:
        rows[f"{arch} (14c)"] = cs.zoo_train_card_vs_cpu(arch, dev)
        print(f"phase 14c: {arch} " + json.dumps(rows[f"{arch} (14c)"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
