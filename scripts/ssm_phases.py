#!/usr/bin/env python3
"""chip_smoke's phases for the SSM and hybrid models, alone.

Runs, for xLSTM-350M and Zamba2-1.2B (``chip_smoke.SSM_ARCHES``), the
phases of ``chip_smoke.py`` named on the command line (all by default):
``9c`` and ``14c`` (the smoke configs card vs CPU), ``15`` (served whole),
``15b`` (``long_500k``) and ``15c`` (trained whole at 2 x 256), with the
same functions and checks, and prints each phase's wall seconds. Needs a
CUDA card; nothing is built (no kernel runs on these paths).

    python3 scripts/ssm_phases.py [9c] [14c] [15] [15b] [15c]
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

PHASES = ("9c", "14c", "15", "15b", "15c")


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
    for arch in cs.SSM_ARCHES:
        for phase in which:
            t0 = time.perf_counter()
            if phase == "9c":
                print(f"phase 9c ({arch}): {cs.zoo_card_vs_cpu(arch, dev)}", flush=True)
            elif phase == "14c":
                print(f"phase 14c ({arch}): {cs.zoo_train_card_vs_cpu(arch, dev)}", flush=True)
            elif phase == "15":
                cs.ssm_serve(arch, dev)
            elif phase == "15b":
                cs.long_context(arch, dev)
            else:
                t = cs.SSM_TRAIN
                row = cs.train_full_width(arch, None, t["batch"], t["seq"], t["lr"], dev,
                                          tag="phase 15c", remat_steps=1, split=False)
                cs.print_train_row(arch, row, tag="phase 15c")
            wall[f"{phase} {arch}"] = round(time.perf_counter() - t0, 1)
            print("wall s " + json.dumps(wall), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
