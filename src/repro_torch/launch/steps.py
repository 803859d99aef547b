"""Step functions of the serving path, and the input shapes of the
reference's assignment.

Counterpart of the reference's ``repro.launch.steps``: ``SHAPES`` is
copied as data, and :func:`make_decode_step` is the greedy one-token
decode step. PyTorch runs eagerly, so there is nothing to jit; the train
and prefill steps and the abstract input specs wait for ROADMAP Queue A
item 5.

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
