"""Attention variants: GQA (with qk-norm, softcap, sliding window), MLA
(DeepSeek-V3), and encoder / cross attention (Whisper), with their
KV-cache decode paths.

Counterpart of the reference's ``repro.models.attention``.

Conventions:
  x            (B, S, D)
  q            (B, S, H, hd)
  k, v         (B, S, Hkv, hd)
  caches       (B, S_cache, Hkv, hd) — keys after RoPE
  MLA cache    latent (B, S, r_kv) + shared rope key (B, S, r_rope)

The decode paths take the new token's position as a host int and write
the caches in place (:func:`_write_row`). None of these layers reaches a
Pallas kernel in the reference but the MLA decode's latent context, which runs
:func:`repro_torch.kernels.ops.mla_flash_decode` here; the rest is plain
PyTorch with the reference's float32 scores and masking constant.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from .common import _as_dtensor, apply_rope, dtype_of, init_dense, normal, rms_norm, softcap
from .config import ModelConfig

NEG_INF = -2.3819763e38  # same constant XLA uses for -inf masking


def _write_row(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``cache[:, slot] = value`` in the cache's dtype, in place. A DTensor
    cache sharded along its sequence (the dry-run's flash-decode layout)
    is written by the rank whose block holds ``slot``, in its block:
    DTensor's own rule would gather the whole cache to write one row."""
    if not isinstance(cache, DTensor) or not any(p.is_shard(1) for p in cache.placements):
        cache[:, slot] = value.to(cache.dtype)
        return
    mesh, coord = cache.device_mesh, cache.device_mesh.get_coordinate()
    local = cache.to_local()
    index, row_pl = 0, []
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):
            index = index * mesh.size(i) + coord[i]
            p = Replicate()
        elif p.is_shard() and p.dim > 1:
            p = Shard(p.dim - 1)
        row_pl.append(p)
    at = slot - index * local.shape[1]
    if 0 <= at < local.shape[1]:
        local[:, at] = value.redistribute(mesh, row_pl).to_local().to(cache.dtype)


# --------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------- #
def init_gqa(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    h, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    params = {
        "wq": init_dense(gen, d, (h, hd), dt),
        "wk": init_dense(gen, d, (hkv, hd), dt),
        "wv": init_dense(gen, d, (hkv, hd), dt),
        "wo": normal(gen, (h, hd, d), (1.0 / (h * hd)) ** 0.5, dt),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
        params["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
    return params


def _project_qkv(cfg: ModelConfig, params: dict, xq, xkv, positions_q, positions_kv):
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions_q, cfg.rope_theta)
    k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """Grouped scaled-dot-product attention, scores in float32.

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); mask: (B|1, Sq, Skv) bool.
    The scores are products in the inputs' dtype widened to float32, as
    the reference's; the softmax weights are rounded to v's dtype before
    the context product, as the reference's."""
    if isinstance(q, DTensor):
        # The dry-run's DTensors. Keys and values sharded along the
        # sequence (a decode's cache) keep that layout: the queries are
        # replicated there and the softmax runs over the sharded scores.
        seq = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
        if not seq:
            return _sdpa_heads(cfg, q, k, v, mask)
        q = q.redistribute(q.device_mesh, [Replicate() if i in seq else p
                                           for i, p in enumerate(q.placements)])
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgk,bshk->bhgqs", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_heads(cfg: ModelConfig, q, k, v, mask):
    """:func:`_sdpa` over DTensors (the dry-run's), each rank attending
    with its own query heads through ``local_map`` and the key and value
    heads they read: a mesh dim of 16 cannot split 32 heads into 8 groups
    of 4 as DTensor would need to reshape them, and XLA splits it."""
    mesh = q.device_mesh
    g = q.shape[2] // k.shape[2]

    def kept(p, dims):
        return p if p.is_shard() and p.dim in dims else Replicate()

    q_pl = [kept(p, (0, 2)) for p in q.placements]
    heads = [i for i, p in enumerate(q_pl) if p.is_shard(2)]
    kv_pl = [kept(p, (0, 2)) if p.is_shard(0) or i in heads else Replicate()
             for i, p in enumerate(k.placements)]
    kv_grad = [Partial() if i in heads and not p.is_shard(2) else p for i, p in enumerate(kv_pl)]
    m_pl = [Shard(0) if p.is_shard(0) and mask.shape[0] == q.shape[0] else Replicate()
            for p in q_pl]

    def local(ql, kl, vl, ml):
        index = 0
        for i in heads:
            index = index * mesh.size(i) + mesh.get_coordinate()[i]
        held = index * kl.shape[2] if heads and kv_pl[heads[0]].is_shard(2) else 0
        kv0 = index * ql.shape[2] // g - held
        kv1 = kv0 + max(1, ql.shape[2] // g)
        return _sdpa(cfg, ql, kl[:, :, kv0:kv1], vl[:, :, kv0:kv1], ml)

    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl, m_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, m_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, _as_dtensor(mask, mesh))


def _causal_mask(sq: int, skv: int, window: int = 0, device=None) -> torch.Tensor:
    """(1, Sq, Skv) causal (optionally banded) mask; q positions are the
    trailing sq positions of the kv range."""
    qpos = torch.arange(sq, device=device) + (skv - sq)
    kpos = torch.arange(skv, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m[None]


def gqa_forward(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    window: int = 0,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill): causal, or with
    ``causal=False`` over every position (Whisper's encoder; an all-true
    mask, as the reference's). RoPE applies either way, as in the
    reference."""
    q, k, v = _project_qkv(cfg, params, x, x, positions, positions)
    s = x.shape[1]
    if causal:
        mask = _causal_mask(s, s, window, x.device)
    else:
        mask = torch.ones((1, s, s), dtype=torch.bool, device=x.device)
    out = _sdpa(cfg, q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def gqa_decode(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,            # (B, 1, D)
    cache_k: torch.Tensor,      # (B, S, Hkv, hd)
    cache_v: torch.Tensor,
    pos: int,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode at host position ``pos``. ``window > 0`` treats
    the cache as a ring buffer of that size (slot ``pos % window``,
    clipped to the cache; every slot valid once ``pos`` reaches the
    cache's length). The new key and value are written into ``cache_k`` /
    ``cache_v`` in place (the reference returns updated copies); the same
    tensors are returned."""
    s_cache = cache_k.shape[1]
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x, x, positions, positions)
    slot = pos % max(window, 1) if window > 0 else pos
    slot = min(slot, s_cache - 1)
    _write_row(cache_k, slot, k_new[:, 0])
    _write_row(cache_v, slot, v_new[:, 0])
    kpos = torch.arange(s_cache, device=x.device)
    if window > 0 and pos >= s_cache:
        valid = torch.ones((s_cache,), dtype=torch.bool, device=x.device)
    else:
        valid = kpos <= pos
    out = _sdpa(cfg, q, cache_k, cache_v, valid[None, None, :])
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache_k, cache_v


# --------------------------------------------------------------------- #
# Cross attention (Whisper decoder over encoder memory)
# --------------------------------------------------------------------- #
def cross_forward(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,            # (B, Sq, D)
    memory_k: torch.Tensor,     # (B, Senc, Hkv, hd) — precomputed
    memory_v: torch.Tensor,
) -> torch.Tensor:
    """The decoder's queries (``wq`` only: no RoPE, no qk-norm) over the
    encoder's keys and values, every position visible."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    mask = torch.ones((1, x.shape[1], memory_k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(cfg, q, memory_k, memory_v, mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def cross_memory(cfg: ModelConfig, params: dict, memory: torch.Tensor):
    """Encoder keys and values, computed once per request (no RoPE:
    Whisper's positions are the sinusoid added at embedding time)."""
    k = torch.einsum("bsd,dhk->bshk", memory, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, params["wv"])
    return k, v


# --------------------------------------------------------------------- #
# MLA — Multi-head Latent Attention (DeepSeek-V3)
# --------------------------------------------------------------------- #
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


def mla_forward(
    cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Full-sequence MLA (prefill) with materialised keys and values."""
    m = cfg.mla
    s = x.shape[1]
    q_nope, q_rope = _mla_q(cfg, params, x, positions)
    c, k_rope = _mla_latent(cfg, params, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c, params["w_uv"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (
        torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
        + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)
    ).to(torch.float32) * scale
    mask = _causal_mask(s, s, device=x.device)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", probs, v)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


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
    _write_row(cache_c, pos, c_new[:, 0])
    _write_row(cache_kr, pos, kr_new[:, 0])
    # Absorb W_uk into q: query expressed in latent coordinates.
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["w_uk"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ctx_lat = ops.mla_flash_decode(q_lat, q_rope[:, 0], cache_c, cache_kr, pos, scale=scale)
    out = torch.einsum("bhr,rhk->bhk", ctx_lat, params["w_uv"])
    return torch.einsum("bhk,hkd->bd", out, params["wo"])[:, None], cache_c, cache_kr
