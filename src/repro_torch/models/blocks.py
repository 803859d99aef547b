"""Per-layer block dispatch: init / cache / decode step.

Counterpart of the reference's ``repro.models.blocks`` for the one kind
the port runs so far:

  dense  — MLA attention + dense MLP (DeepSeek's first-k layers)

Every other kind (``attn``, ``moe``, the SSM and encoder-decoder kinds)
raises ``NotImplementedError``: they wait for ROADMAP Queue A item 5.
"""

from __future__ import annotations

import torch

from . import attention as attn
from .common import apply_norm, dtype_of, make_norm_params
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward


def _uses_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.attn_type == "mla" and kind in ("dense", "moe", "attn")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind != "dense" or not _uses_mla(cfg, kind):
        raise NotImplementedError(
            f"block kind {kind!r} ({cfg.attn_type} attention) is not ported yet: "
            "the port runs MLA + dense-MLP layers only (ROADMAP Queue A item 5)"
        )


def _residual(cfg: ModelConfig, p: dict, x, sub_out, post_key: str):
    if cfg.post_norm and post_key in p:
        sub_out = apply_norm(cfg, p[post_key], sub_out)
    return x + sub_out


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def init_block(cfg: ModelConfig, kind: str, gen: torch.Generator) -> dict:
    _check_kind(cfg, kind)
    dev = gen.device
    p: dict = {"norm1": make_norm_params(cfg, dev)}
    if cfg.post_norm:
        p["post_norm1"] = make_norm_params(cfg, dev)
    p["mixer"] = attn.init_mla(cfg, gen)
    p["norm2"] = make_norm_params(cfg, dev)
    if cfg.post_norm:
        p["post_norm2"] = make_norm_params(cfg, dev)
    p["ffn"] = init_mlp(cfg, gen, d_ff=cfg.moe.d_ff_dense)
    return p


# --------------------------------------------------------------------- #
# decode step (single token, cache-carrying)
# --------------------------------------------------------------------- #
def init_layer_cache(
    cfg: ModelConfig, kind: str, batch: int, seq: int, long_mode: bool = False,
    device=None,
) -> dict:
    _check_kind(cfg, kind)
    dt = dtype_of(cfg)
    m = cfg.mla
    return {
        "c": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dt, device=device),
        "kr": torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dt, device=device),
    }


def block_decode(
    cfg: ModelConfig,
    kind: str,
    p: dict,
    x: torch.Tensor,             # (B, 1, D)
    cache: dict,
    pos: int,
) -> tuple[torch.Tensor, dict]:
    """One token through one layer; the layer's cache is updated in place
    (see :func:`repro_torch.models.attention.mla_decode`) and returned."""
    _check_kind(cfg, kind)
    h = apply_norm(cfg, p["norm1"], x)
    a, c, kr = attn.mla_decode(cfg, p["mixer"], h, cache["c"], cache["kr"], pos)
    cache = dict(cache, c=c, kr=kr)
    x = _residual(cfg, p, x, a, "post_norm1")
    h = apply_norm(cfg, p["norm2"], x)
    f = mlp_forward(cfg, p["ffn"], h)
    return _residual(cfg, p, x, f, "post_norm2"), cache
