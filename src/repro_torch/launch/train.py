"""Training driver.

Counterpart of the reference's ``repro.launch.train``: real AdamW steps
on :func:`repro_torch.models.model.lm_loss` over batches of the
synthetic token pipeline, on the card unless the caller asks for the
CPU. Weights are random (made from ``seed``) unless ``params`` is given;
nothing is downloaded. Examples:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --steps 50 --batch 8 --seq 64 [--full] [--device cpu]

The CLI trains the reference's smoke config of ``--arch`` (2 layers), or
with ``--full`` the whole published config. A state (parameters,
gradients and AdamW's two moments) larger than the device stops with
``MemoryError`` naming its bytes before anything is drawn: there is no
fall-back to a smaller config or to the CPU. Gemma2-2B whole fits one
card (31.4 GB of state), Whisper-large-v3 (18.4 GB) and
Phi-3-vision-4.2B (45.9 GB) too, their batches carrying the pipeline's
frames and patches; DeepSeek-V3 at full width fits only cut in depth
(``cfg=CONFIG.with_overrides(num_layers=3)``, 34.3 GB).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import all_arch_ids, get_config, get_smoke_config
from ..data.pipeline import TokenPipeline
from ..models import model as M
from ..optim.adamw import adamw_init
from ..runtime.engine import resolve_device
from ..tree import flatten
from .steps import make_train_step


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    ckpt_path: str | None = None,
    log_every: int = 10,
    params=None,
    cfg=None,
    device="cuda",
) -> dict:
    """``steps`` AdamW steps (``remat=False``) on ``TokenPipeline(cfg,
    batch, seq, seed)``'s batches (with Whisper's frames and Phi-3-vision's
    patches, uploaded with the tokens). ``cfg`` overrides the config (a
    depth-cut one, say); ``params`` is a parameter tree of the port on
    ``device`` (for the reference's, ``models.model.params_from_jax``),
    which the steps update in place. Returns the reference's dict (the
    first and last loss, every step's loss, the parameters and the
    config) with every step's metrics and its host seconds (from the
    step's call to its loss on the host); ``ckpt_path`` saves the
    parameters there (the reference's format).
    ``device="cuda"`` without a card raises ``RuntimeError``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    need = M.train_state_bytes(cfg)
    if params is not None:  # already resident
        need -= sum(p.nbytes for p in flatten(params)[0] if p.device == dev)
    M.check_room(cfg, need, "training state (parameters, gradients and two "
                 f"{cfg.opt_dtype} AdamW moments)", dev)
    pipe = TokenPipeline(cfg, batch, seq, seed=seed)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    opt_state = adamw_init(params, moment_dtype=cfg.opt_dtype)
    step_fn = make_train_step(cfg, lr=lr, remat=False)

    losses, history, step_s = [], [], []
    t0 = time.time()
    for step in range(steps):
        batch_t = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        loss = float(metrics["loss"])  # waits for the step
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        history.append({k: float(v) for k, v in metrics.items()})
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({time.time()-t0:.1f}s)")
    if ckpt_path:
        from ..ckpt import save_checkpoint

        save_checkpoint(ckpt_path, params)
        print(f"saved checkpoint to {ckpt_path}")
    return {
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "losses": losses,
        "metrics": history,
        "step_s": step_s,
        "params": params,
        "config": cfg,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = train(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        ckpt_path=args.ckpt,
        device=args.device,
    )
    print(f"loss {res['first_loss']:.3f} -> {res['last_loss']:.3f}")


if __name__ == "__main__":
    main()
