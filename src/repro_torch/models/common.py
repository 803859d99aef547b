"""Shared layers: norms, RoPE, embeddings, softcap.

Counterpart of the reference's ``repro.models.common``, on torch tensors.
Random initialisers draw from a ``torch.Generator``; the tensors land on
the generator's device. A stand-in whose ``device`` is ``meta``
(:data:`SHAPES_ONLY`) makes them return meta tensors: the shapes and
dtypes of a tree, with no memory and no draw.

The embedding and the unembedding also take DTensors (the dry-run's
sharded ``meta`` trees, ``repro_torch.launch.dryrun``): a table sharded
by vocabulary runs vocabulary-parallel, each rank on its own rows through
``local_map``, as the reference's partitioned einsum and gather do.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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


def _summed(t: DTensor) -> DTensor:
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate() if p.is_partial() else p for p in t.placements])


class _SumPartials(torch.autograd.Function):
    """A DTensor's partial sums summed, forward and backward: the
    all-reduces of the partitioned program (Megatron's pair) before a
    norm. DTensor would otherwise carry the partial sums into the next
    product, forward or backward, and gather that product's sharded
    weights instead."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


def make_norm_params(cfg: ModelConfig, device=None) -> dict:
    if cfg.norm_type == "layernorm":
        return {
            "scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        }
    return {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The config's norm of ``x``. A DTensor residual stream that holds a
    sub-layer's partial sums (the projection out of sharded heads or
    hidden units) is summed first, and so is its gradient
    (:class:`_SumPartials`)."""
    if isinstance(x, DTensor):
        x = _SumPartials.apply(x)
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
    (``scripts/train_backward_probe.py``).

    On ``meta`` tensors, which hold no ids, the backward takes the worst
    case, every token distinct: ``min(tokens, vocabulary rows)`` rows."""

    @staticmethod
    def forward(ctx, embedding, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (embedding.shape, embedding.dtype)
        return embedding[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        shape, dtype = ctx.table
        flat = tokens.reshape(-1)
        if flat.device.type == "meta":
            uniq = flat.new_empty((min(flat.numel(), shape[0]),))
            inv = torch.empty_like(flat)
        else:
            uniq, inv = torch.unique(flat, return_inverse=True)
        rows = torch.zeros((uniq.numel(), shape[1]), dtype=torch.float32, device=grad.device)
        rows.index_put_((inv,), grad.reshape(-1, shape[1]).to(torch.float32), accumulate=True)
        out = torch.zeros(shape, dtype=dtype, device=grad.device)
        out[uniq] = rows.to(dtype)
        return out, None


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(embedding, DTensor):
        return _embed_sharded(embedding, tokens)
    return _Embed.apply(embedding, tokens.long())


def _vocab_dim(table: DTensor):
    """The mesh dim that shards ``table`` (V, D) by vocabulary, or None."""
    dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if len(dims) > 1:
        raise ValueError(f"a table sharded by vocabulary over {len(dims)} mesh dims")
    return dims[0] if dims else None


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _batch_placements(t: DTensor, vocab: int | None) -> list:
    """``t``'s placements with everything but a shard of a leading dim
    replicated, and the vocabulary dim's replicated."""
    return [
        p if i != vocab and p.is_shard() and p.dim < t.ndim - 1 else Replicate()
        for i, p in enumerate(t.placements)
    ]


def _embed_sharded(embedding: DTensor, tokens: torch.Tensor) -> DTensor:
    """``embedding[tokens]`` over a mesh. On the vocabulary's mesh dim each
    rank gathers the ids of its own rows (zeros elsewhere) and the rows
    are summed over that dim (one all-reduce); the table's gradient is
    summed over the mesh dims that shard the batch."""
    mesh = embedding.device_mesh
    vocab = _vocab_dim(embedding)
    tokens = _as_dtensor(tokens, mesh)
    tok_pl = _batch_placements(tokens, vocab)
    tab_pl = [Shard(0) if i == vocab else Replicate() for i in range(mesh.ndim)]
    out_pl = [Partial() if i == vocab else tok_pl[i] for i in range(mesh.ndim)]
    grad_pl = [Partial() if tok_pl[i].is_shard() else tab_pl[i] for i in range(mesh.ndim)]

    def local(table, ids):
        ids = ids.long()
        if vocab is None:
            return _Embed.apply(table, ids)
        rows = table.shape[0]
        ids = ids - mesh.get_local_rank(vocab) * rows
        mine = (ids >= 0) & (ids < rows)
        out = _Embed.apply(table, torch.where(mine, ids, 0))
        return torch.where(mine[..., None], out, out.new_zeros(()))

    rows = local_map(local, out_placements=out_pl, in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(embedding, tokens)
    return rows.redistribute(mesh, tok_pl)


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
    autograd the backward widens the blocks again (:class:`_Unembed`).

    A DTensor table sharded by vocabulary gives logits sharded by
    vocabulary on that mesh dim, ``x`` replicated there: each rank runs
    the blocks of its own rows, ``x``'s gradient is summed over the
    vocabulary's mesh dim and the table's over the batch's."""
    if isinstance(embedding, DTensor):
        mesh = embedding.device_mesh
        vocab = _vocab_dim(embedding)
        x = _as_dtensor(x, mesh)
        x_pl = _batch_placements(x, vocab)
        tab_pl = [Shard(0) if i == vocab else Replicate() for i in range(mesh.ndim)]
        out_pl = [Shard(x.ndim - 1) if i == vocab else x_pl[i] for i in range(mesh.ndim)]
        gx_pl = [Partial() if i == vocab else x_pl[i] for i in range(mesh.ndim)]
        gt_pl = [Partial() if x_pl[i].is_shard() else tab_pl[i] for i in range(mesh.ndim)]
        logits = local_map(_Unembed.apply, out_placements=out_pl, in_placements=(x_pl, tab_pl),
                           in_grad_placements=(gx_pl, gt_pl), device_mesh=mesh,
                           redistribute_inputs=True)(x, embedding)
    else:
        logits = _Unembed.apply(x, embedding)
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
