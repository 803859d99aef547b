"""Attention: MLA (DeepSeek-V3), its parameters and the absorbed decode.

Counterpart of the MLA half of the reference's ``repro.models.attention``.
GQA, cross attention and the full-sequence ``mla_forward`` wait for
ROADMAP Queue A item 5.

Conventions:
  x            (B, S, D)
  MLA cache    latent (B, S, r_kv) + shared rope key (B, S, r_rope)
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from .common import apply_rope, dtype_of, init_dense, normal, rms_norm
from .config import ModelConfig


def init_mla(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "w_dq": init_dense(gen, d, m.q_lora_rank, dt),
        "q_norm": torch.zeros((m.q_lora_rank,), dtype=torch.float32, device=dev),
        "w_uq": init_dense(gen, m.q_lora_rank, (h, qk_head), dt),
        "w_dkv": init_dense(gen, d, m.kv_lora_rank, dt),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=torch.float32, device=dev),
        "w_kr": init_dense(gen, d, m.qk_rope_head_dim, dt),
        "w_uk": init_dense(gen, m.kv_lora_rank, (h, m.qk_nope_head_dim), dt),
        "w_uv": init_dense(gen, m.kv_lora_rank, (h, m.v_head_dim), dt),
        "wo": normal(gen, (h, m.v_head_dim, d), (1.0 / (h * m.v_head_dim)) ** 0.5, dt),
    }


def _mla_q(cfg: ModelConfig, params: dict, x, positions):
    m = cfg.mla
    ql = rms_norm(x @ params["w_dq"], params["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", ql, params["w_uq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim :], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg: ModelConfig, params: dict, x, positions):
    c = rms_norm(x @ params["w_dkv"], params["kv_norm"])
    k_rope = (x @ params["w_kr"])[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return c, k_rope


def mla_decode(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,            # (B, 1, D)
    cache_c: torch.Tensor,      # (B, S, r_kv) — compressed latent
    cache_kr: torch.Tensor,     # (B, S, r_rope)
    pos: int,
):
    """Absorbed-matrices decode: attention runs in the latent space, so
    the per-token cache is r_kv + r_rope values — MLA's whole point.

    ``pos`` is the host int of the new token's position. The new latent
    and rope key are written into ``cache_c`` / ``cache_kr`` *in place* at
    ``pos`` (the reference returns updated copies); the same tensors are
    returned. The latent context goes through
    :func:`repro_torch.kernels.ops.mla_flash_decode` (the Hopper kernel on
    the card), whose softmax weights stay float32 where the reference
    rounds them to the cache dtype first: in bfloat16 the two differ by
    that rounding."""
    m = cfg.mla
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(cfg, params, x, positions)
    c_new, kr_new = _mla_latent(cfg, params, x, positions)
    cache_c[:, pos] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[:, pos] = kr_new[:, 0].to(cache_kr.dtype)
    # Absorb W_uk into q: query expressed in latent coordinates.
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["w_uk"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ctx_lat = ops.mla_flash_decode(q_lat, q_rope[:, 0], cache_c, cache_kr, pos, scale=scale)
    out = torch.einsum("bhr,rhk->bhk", ctx_lat, params["w_uv"])
    return torch.einsum("bhk,hkd->bd", out, params["wo"])[:, None], cache_c, cache_kr
