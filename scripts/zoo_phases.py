#!/usr/bin/env python3
"""chip_smoke's phases for the SSM, hybrid, encoder-decoder and vision
models, alone.

Runs the phases of ``chip_smoke.py`` named on the command line (all by
default) with the same functions and checks: ``9c`` and ``14c`` (the
smoke configs of xLSTM-350M, Zamba2-1.2B, Whisper-large-v3 and
Phi-3-vision-4.2B card vs CPU), ``15`` (the SSM and hybrid models served
whole), ``15b`` (``long_500k``), ``15c`` (trained whole at 2 x 256),
``16`` (Whisper served whole), ``16b`` (Phi-3-vision's prefill step
whole) and ``16c`` (both trained whole at ``chip_smoke.MEDIA_TRAIN``),
and prints each phase's wall seconds. Needs a CUDA card; nothing is
built (no kernel runs on these paths).

    python3 scripts/zoo_phases.py [9c] [14c] [15] [15b] [15c] [16] [16b] [16c]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402

PHASES = ("9c", "14c", "15", "15b", "15c", "16", "16b", "16c")
SMOKE = (*cs.SSM_ARCHES, cs.AUDIO_ARCH, cs.VISION_ARCH)


def main(argv=None) -> int:
    which = list(argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    wall = {}
    for phase in which:
        t0 = time.perf_counter()
        if phase == "9c":
            for arch in SMOKE:
                print(f"phase 9c ({arch}): {cs.zoo_card_vs_cpu(arch, dev)}", flush=True)
        elif phase == "14c":
            for arch in SMOKE:
                print(f"phase 14c ({arch}): {cs.zoo_train_card_vs_cpu(arch, dev)}", flush=True)
        elif phase == "15":
            for arch in cs.SSM_ARCHES:
                cs.ssm_serve(arch, dev)
        elif phase == "15b":
            for arch in cs.SSM_ARCHES:
                cs.long_context(arch, dev)
        elif phase == "15c":
            t = cs.SSM_TRAIN
            for arch in cs.SSM_ARCHES:
                row = cs.train_full_width(arch, None, t["batch"], t["seq"], t["lr"], dev,
                                          tag="phase 15c", remat_steps=1, split=False)
                cs.print_train_row(arch, row, tag="phase 15c")
        elif phase == "16":
            cs.audio_serve(dev)
        elif phase == "16b":
            cs.vision_prefill(dev)
        else:
            for arch, layers, batch, seq, lr in cs.MEDIA_TRAIN:
                row = cs.train_full_width(arch, layers, batch, seq, lr, dev, tag="phase 16c")
                cs.print_train_row(arch, row, tag="phase 16c")
        wall[phase] = round(time.perf_counter() - t0, 1)
        print("wall s " + json.dumps(wall), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
