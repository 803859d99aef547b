"""Step functions of the training and serving paths, and the abstract
inputs of every (architecture x input shape).

Counterpart of the reference's ``repro.launch.steps``: ``SHAPES`` is
copied as data, :func:`shape_supported` is the reference's rule for
``long_500k``, :func:`make_train_step` is one AdamW step on
:func:`repro_torch.models.model.lm_loss`, :func:`make_prefill_step`
returns the last position's logits of a full forward, and
:func:`make_decode_step` is the greedy one-token decode step. PyTorch
runs eagerly, so there is nothing to jit. The abstract inputs
(:func:`abstract_params`, :func:`abstract_opt_state`,
:func:`abstract_cache`, :func:`input_specs`) are ``meta`` tensors: the
shapes and dtypes the reference's ``ShapeDtypeStruct`` trees hold, with
no memory.

INPUT SHAPES (assignment):
    train_4k     seq 4096,    global batch 256   (training)
    prefill_32k  seq 32768,   global batch 32    (inference prefill)
    decode_32k   cache 32768, global batch 128   (one-token decode)
    long_500k    cache 524288, batch 1           (sub-quadratic only)
"""

from __future__ import annotations

import torch

from ..data.pipeline import make_batch_specs
from ..models import model as M
from ..models.common import SHAPES_ONLY
from ..models.config import ModelConfig
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..tree import flatten, unflatten

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}


def shape_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic decode (DESIGN.md §skips)."""
    if shape_name != "long_500k":
        return True, ""
    if cfg.supports_long_context:
        return True, ""
    return False, (
        f"{cfg.name} is pure full-attention; 524k-token decode is "
        "quadratic-cost — skipped per DESIGN.md"
    )


def loss_and_grads(cfg: ModelConfig, params, batch: dict, remat: bool = True):
    """``(loss, metrics, grads)``: :func:`~repro_torch.models.model.lm_loss`
    and its gradient with respect to every leaf of ``params`` (a tree of
    the parameters' structure, by ``torch.autograd.grad``; zeros for a
    leaf the loss does not reach). The loss and metrics are detached 0-d
    tensors, still on the device."""
    leaves, spec = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = M.lm_loss(cfg, unflatten(spec, live), batch, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(spec, grads)


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``lm_loss`` (:func:`loss_and_grads`) and
    one :func:`~repro_torch.optim.adamw.adamw_update` at ``lr``, which
    writes the new parameters and moments into the given tensors and
    returns them. ``metrics`` holds ``loss`` and ``lm_loss``'s metrics as
    0-d tensors on the device: the caller decides when to read them."""

    def train_step(params, opt_state: AdamWState, batch: dict):
        loss, metrics, grads = loss_and_grads(cfg, params, batch, remat=remat)
        params, opt_state = adamw_update(params, grads, opt_state, lr)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits (B, vocab)``: float32
    logits of the last position of :func:`repro_torch.models.model.forward`
    over ``batch["tokens"]`` (``patches`` / ``frames`` are passed on: a
    vision config's logits cover the patch prefix too, the last position
    is the text's)."""

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


# --------------------------------------------------------------------- #
# abstract inputs
# --------------------------------------------------------------------- #
def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``init_params`` as ``meta`` tensors."""
    return M._draw_params(cfg, SHAPES_ONLY)


def abstract_opt_state(cfg: ModelConfig) -> AdamWState:
    """AdamW's state for :func:`abstract_params`, as ``meta`` tensors."""
    return adamw_init_like(cfg, abstract_params(cfg))


def adamw_init_like(cfg: ModelConfig, params) -> AdamWState:
    return adamw_init(params, moment_dtype=cfg.opt_dtype)


def abstract_cache(cfg: ModelConfig, batch: int, seq: int, long_mode: bool) -> list:
    """The decode cache of ``init_cache`` as ``meta`` tensors."""
    return M.init_cache(cfg, batch, seq, long_mode=long_mode, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str, seq: int | None = None) -> dict:
    """``meta`` stand-ins for every model input of this shape (``seq``
    replaces its sequence length: the dry-run's probes).

    Audio/VLM frontends are stubs: frames/patches arrive as precomputed
    embeddings of the documented shape (DESIGN.md carve-out). Whisper's
    prefill is the start of a transcription: the whole audio and at most
    448 text tokens, its decoder's length.
    """
    info = SHAPES[shape_name]
    b, s = info["batch"], seq or info["seq"]
    if info["kind"] in ("train", "prefill"):
        batch = make_batch_specs(cfg, b, s)
        if cfg.encoder_layers and info["kind"] == "prefill":
            batch["tokens"] = torch.empty((b, min(s, 448)), dtype=torch.int32, device="meta")
        return {"batch": batch}
    long_mode = bool(info.get("long"))
    return {
        "cache": abstract_cache(cfg, b, s, long_mode),
        "token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
