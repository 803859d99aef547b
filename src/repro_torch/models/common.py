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


class _Embed(torch.autograd.Function):
    """``embedding[tokens]``, whose backward sums each row's gradient in
    float32 over the distinct ids (one ``index_put_`` with accumulate into
    float32 rows, sorted and so the same from run to run) and rounds once
    to the table's dtype. Autograd's own backward of the gather, and
    ``F.embedding``'s below 3072 tokens, add in the table's dtype: on an
    NVIDIA H100 their bf16 rows differed from the float64 sum by up to
    0.25 and 0.19 (DeepSeek-V3's table, 1024 tokens) and 0.75 and 0.5
    (Gemma2-2B's, 2048 tokens), this one by 0
    (``scripts/train_backward_probe.py``)."""

    @staticmethod
    def forward(ctx, embedding, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (embedding.shape, embedding.dtype)
        return embedding[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        shape, dtype = ctx.table
        uniq, inv = torch.unique(tokens.reshape(-1), return_inverse=True)
        rows = torch.zeros((uniq.numel(), shape[1]), dtype=torch.float32, device=grad.device)
        rows.index_put_((inv,), grad.reshape(-1, shape[1]).to(torch.float32), accumulate=True)
        out = torch.zeros(shape, dtype=dtype, device=grad.device)
        out[uniq] = rows.to(dtype)
        return out, None


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return _Embed.apply(embedding, tokens.long())


class _Unembed(torch.autograd.Function):
    """``x · embeddingᵀ`` in float32 over vocabulary blocks, whose backward
    widens each block again instead of keeping it: autograd would save
    every widened block, a float32 copy of the whole table (3.7 GB for
    DeepSeek-V3's: a forward and backward at 2 x 512 tokens held 7.88 GB
    above its inputs that way on an NVIDIA H100, 4.15 GB this way;
    ``scripts/train_backward_probe.py``). The gradients are the float32
    einsum's, cast back to each input's dtype, as the reference's
    ``astype`` does."""

    @staticmethod
    def forward(ctx, x, embedding):
        ctx.save_for_backward(x, embedding)
        xf = x.to(torch.float32)
        vocab = embedding.shape[0]
        logits = torch.empty((*x.shape[:-1], vocab), dtype=torch.float32, device=x.device)
        for v0 in range(0, vocab, UNEMBED_CHUNK):
            block = embedding[v0 : v0 + UNEMBED_CHUNK].to(torch.float32)
            logits[..., v0 : v0 + block.shape[0]] = xf @ block.T
        return logits

    @staticmethod
    def backward(ctx, grad):
        x, embedding = ctx.saved_tensors
        vocab, d = embedding.shape
        g = grad.reshape(-1, vocab)
        xf = x.to(torch.float32).reshape(-1, d)
        gx = torch.zeros_like(xf) if ctx.needs_input_grad[0] else None
        ge = torch.empty_like(embedding) if ctx.needs_input_grad[1] else None
        for v0 in range(0, vocab, UNEMBED_CHUNK):
            block = embedding[v0 : v0 + UNEMBED_CHUNK].to(torch.float32)
            gb = g[:, v0 : v0 + block.shape[0]]
            if gx is not None:
                gx.addmm_(gb, block)
            if ge is not None:
                ge[v0 : v0 + block.shape[0]] = (gb.T @ xf).to(embedding.dtype)
        if gx is not None:
            gx = gx.reshape(x.shape).to(x.dtype)
        return gx, ge


def unembed(cfg: ModelConfig, embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 logits ``x · embeddingᵀ``, as the reference's float32 einsum.

    The product runs over blocks of :data:`UNEMBED_CHUNK` vocabulary rows,
    each widened to float32 just before its product: a bf16 embedding is
    never copied whole to float32 (129,280 × 7168 would be a 3.7 GB
    temporary per decode step). The price is one float32 block of
    ``UNEMBED_CHUNK × d_model`` (470 MB at d_model 7168) and the widening
    pass over the table each step; a float32 table needs no copy. Under
    autograd the backward widens the blocks again (:class:`_Unembed`)."""
    return softcap(_Unembed.apply(x, embedding), cfg.logit_softcap)


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
