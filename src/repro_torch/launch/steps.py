"""Step functions of the serving path, and the input shapes of the
reference's assignment.

Counterpart of the reference's ``repro.launch.steps``: ``SHAPES`` is
copied as data, :func:`make_prefill_step` returns the last position's
logits of a full forward, and :func:`make_decode_step` is the greedy
one-token decode step. PyTorch runs eagerly, so there is nothing to jit;
the train step (ROADMAP Queue A item 5a) and the abstract input specs
(``dryrun.py``'s, item 5f) are not ported.

INPUT SHAPES (assignment):
    train_4k     seq 4096,    global batch 256   (training)
    prefill_32k  seq 32768,   global batch 32    (inference prefill)
    decode_32k   cache 32768, global batch 128   (one-token decode)
    long_500k    cache 524288, batch 1           (sub-quadratic only)
"""

from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits (B, vocab)``: float32
    logits of the last position of :func:`repro_torch.models.model.forward`
    over ``batch["tokens"]`` (``patches`` / ``frames`` are passed on, and
    refused there)."""

    def prefill_step(params, batch: dict):
        logits, _ = M.forward(
            cfg,
            params,
            batch["tokens"],
            patches=batch.get("patches"),
            frames=batch.get("frames"),
        )
        # Serving prefill returns only the last-position logits.
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig, long_mode: bool = False):
    """``decode_step(params, cache, token (B, 1), pos) -> (next_token
    (B, 1) int32, cache)``: one token through the stack and a greedy
    ``argmax`` over the last position's logits. The cache is updated in
    place."""
    force_local = long_mode and cfg.local_global

    def decode_step(params, cache, token, pos):
        logits, cache = M.decode_step(
            cfg, params, cache, token, pos, force_local=force_local
        )
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], cache

    return decode_step
