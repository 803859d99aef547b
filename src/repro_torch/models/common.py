"""Shared layers: norms, RoPE, embeddings, softcap.

Counterpart of the reference's ``repro.models.common``, on torch tensors.
Random initialisers draw from a ``torch.Generator``; the tensors land on
the generator's device. A stand-in whose ``device`` is ``meta``
(:data:`SHAPES_ONLY`) makes them return meta tensors: the shapes and
dtypes of a tree, with no memory and no draw.
"""

from __future__ import annotations

import math

import torch

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Vocabulary rows per float32 block of :func:`unembed`.
UNEMBED_CHUNK = 16384
#: Elements per float32 draw of :func:`normal` (1 GiB).
NORMAL_CHUNK = 1 << 28


class _ShapesOnly:
    """Stands in for a ``torch.Generator``: the initialisers given it
    return meta tensors."""

    device = torch.device("meta")


SHAPES_ONLY = _ShapesOnly()


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale``, back in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def make_norm_params(cfg: ModelConfig, device=None) -> dict:
    if cfg.norm_type == "layernorm":
        return {
            "scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        }
    return {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    return rms_norm(x, params["scale"])


# --------------------------------------------------------------------- #
# rotary position embedding
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of head_dim (split, not interleaved), as the reference."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# misc
# --------------------------------------------------------------------- #
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 soft capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens.long()]


def unembed(cfg: ModelConfig, embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 logits ``x · embeddingᵀ``, as the reference's float32 einsum.

    The product runs over blocks of :data:`UNEMBED_CHUNK` vocabulary rows,
    each widened to float32 just before its product: a bf16 embedding is
    never copied whole to float32 (129,280 × 7168 would be a 3.7 GB
    temporary per decode step). The price is one float32 block of
    ``UNEMBED_CHUNK × d_model`` (470 MB at d_model 7168) and the widening
    pass over the table each step; a float32 table needs no copy."""
    xf = x.to(torch.float32)
    vocab = embedding.shape[0]
    logits = torch.empty((*x.shape[:-1], vocab), dtype=torch.float32, device=x.device)
    for v0 in range(0, vocab, UNEMBED_CHUNK):
        block = embedding[v0 : v0 + UNEMBED_CHUNK].to(torch.float32)
        logits[..., v0 : v0 + block.shape[0]] = xf @ block.T
    return softcap(logits, cfg.logit_softcap)


def init_dense(gen: torch.Generator, in_dim: int, out_dims, dtype) -> torch.Tensor:
    """Fan-in scaled normal init; out_dims may be a tuple (fused heads).
    Drawn in float32 from ``gen`` on its device, then cast."""
    if isinstance(out_dims, int):
        out_dims = (out_dims,)
    return normal(gen, (in_dim, *out_dims), (1.0 / in_dim) ** 0.5, dtype)


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """``std`` × a standard normal draw of ``shape`` in float32 from ``gen``
    (on the generator's device), cast to ``dtype``.

    A tensor of more than :data:`NORMAL_CHUNK` elements is allocated once
    in ``dtype`` and drawn into in float32 pieces of that many elements,
    so that a bf16 expert stack (256 × 7168 × 2048) never exists whole in
    float32."""
    dev = gen.device
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    n = math.prod(shape)
    if n <= NORMAL_CHUNK:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for i in range(0, n, NORMAL_CHUNK):
        piece = torch.randn(min(NORMAL_CHUNK, n - i), generator=gen, dtype=torch.float32,
                            device=dev)
        flat[i : i + piece.numel()] = piece.mul_(std)
    return out
