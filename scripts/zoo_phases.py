#!/usr/bin/env python3
"""chip_smoke's phases for the SSM, hybrid, encoder-decoder and vision
models and for expert parallelism, alone.

Runs the phases of ``chip_smoke.py`` named on the command line (all by
default) with the same functions and checks: ``9c`` and ``14c`` (the
smoke configs of xLSTM-350M, Zamba2-1.2B, Whisper-large-v3 and
Phi-3-vision-4.2B card vs CPU), ``15`` (the SSM and hybrid models served
whole), ``15b`` (``long_500k``), ``15c`` (trained whole at 2 x 256),
``16`` (Whisper served whole), ``16b`` (Phi-3-vision's prefill step
whole), ``16c`` (both trained whole at ``chip_smoke.MEDIA_TRAIN``) and
``17`` (phases 17-17c: expert parallelism on a mesh of one, after phase
9's DeepSeek-V3 cut is served once without it for the greedy tokens 17c
compares with), and prints each phase's wall seconds. ``17t`` repeats
phase 17's card-vs-CPU comparison with TF32 off and then on and prints
the gaps of each, with no bar. Needs a CUDA card; only ``17`` runs a
kernel (the MLA decode, built at its first launch).

    python3 scripts/zoo_phases.py [9c] [14c] [15] [15b] [15c] [16] [16b] [16c] [17] [17t]
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

PHASES = ("9c", "14c", "15", "15b", "15c", "16", "16b", "16c", "17", "17t")
SMOKE = (*cs.SSM_ARCHES, cs.AUDIO_ARCH, cs.VISION_ARCH)


def served_tokens(dev):
    """Phase 9's greedy tokens: its DeepSeek-V3 cut served from its seed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model as M

    cfg = get_config(cs.ARCH).with_overrides(num_layers=cs.SERVE_LAYERS)
    params = M.init_params(cfg, cs.SERVE["seed"], device=dev)
    tokens = serve_batch(cs.ARCH, cfg=cfg, params=params, device=cs.DEVICE, **cs.SERVE)["tokens"]
    del params
    torch.cuda.empty_cache()
    return tokens


def ep_tf32(dev) -> dict:
    """Phase 17's inputs and cases on the mesh of one, card against CPU,
    with TF32 off and then on: the largest gaps in ``y`` (and max |y|),
    ``aux`` and the gradients (of a leaf's largest). Leaves TF32 off."""
    rows = {}
    with cs.ep_world_of_one():
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for arch in cs.EP_ARCHES:
                base, params, x, ct = cs.ep_small_inputs(arch)
                for combine, cf in cs.EP_CASES:
                    cfg = base.with_overrides(ep_capacity_factor=cf, ep_combine=combine)
                    cpu, card = (cs.ep_grads(cfg, params, x, ct, w) for w in ("cpu", dev))
                    rows[f"tf32 {'on' if tf32 else 'off'}, {arch} {combine} cf {cf}"] = {
                        "y_diff": (card["y"] - cpu["y"]).abs().max().item(),
                        "y_max": cpu["y"].abs().max().item(),
                        "aux_diff": abs(card["aux"].item() - cpu["aux"].item()),
                        "grad_rel_diff": max(
                            (card[k] - cpu[k]).abs().max().item() / cpu[k].abs().max().item()
                            for k in cpu if k.startswith("g"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    return rows


def main(argv=None) -> int:
    which = list(argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; at start allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
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
        elif phase == "17":
            cs.ep_phases(dev, torch.empty(64 * 2**20, dtype=torch.int32, device=dev),
                         served_tokens(dev))
        elif phase == "17t":
            print("phase 17t: card vs CPU, TF32 off then on " + json.dumps(ep_tf32(dev)), flush=True)
        elif phase == "16c":
            for arch, layers, batch, seq, lr in cs.MEDIA_TRAIN:
                row = cs.train_full_width(arch, layers, batch, seq, lr, dev, tag="phase 16c")
                cs.print_train_row(arch, row, tag="phase 16c")
        wall[phase] = round(time.perf_counter() - t0, 1)
        print("wall s " + json.dumps(wall), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
