"""Mixture-of-Experts layer.

Counterpart of the single-device half of the reference's
``repro.models.moe``: DeepSeek-V3 (1 shared + 256 routed experts, top-8,
gates normalised over the selected experts) and Phi-3.5-MoE (16 routed,
top-2). The router runs in float32 and returns the Switch-style
load-balance auxiliary loss.

``moe_forward`` is the dropless dispatch. The token copies are sorted by
expert (stably, as ``jnp.argsort``) and the three expert products run as
``torch._grouped_mm`` over the sorted rows, with the group offsets
(cumulated counts, :func:`_counts`) computed on the device: nothing is
read back to the host, and an expert with no rows is never read. (The reference's
grouped products are ``jax.lax.ragged_dot``, a library product outside
any Pallas kernel.) On an NVIDIA H100 80GB HBM3 (700.00 W) this form took
1.56–1.64 ms per DeepSeek-V3 layer at decode (4 tokens) against 2.63–3.18
ms for one ``torch.matmul`` per non-empty expert after a host read of the
counts, and 9.35–9.37 against 17.48–18.93 ms at prefill (1024 tokens;
``scripts/moe_grouped_ab.py``). At decode a DeepSeek-V3 batch of 4
touches at most 32 of the 256 experts. The combine gathers each token's
copies back and sums them in a fixed order (ascending expert, the order
of the reference's scatter-add), in the output's dtype, so that a run on
the card is bit-identical with itself: no atomics.

Expert parallelism (``moe_forward_ep`` with ``_moe_local_body`` or
``_moe_local_body_a2a``, the reference's ``shard_map`` bodies) runs on a
``torch.distributed`` mesh registered with :func:`set_ep_mesh`: the
experts are split over ``cfg.ep_axis`` (one mesh axis, or a tuple of
them), each rank computes the token copies of its own experts in
fixed-capacity blocks (``cfg.ep_capacity_factor``; copies past an
expert's capacity are dropped, as the reference drops them) and the
partial outputs are summed over the ep ranks (``ep_combine="psum"``), or
each rank routes one sequence chunk and two all-to-alls move the copies
to their experts and back (``"a2a"``). The torch form is local in, local
out: ``x`` is the rank's batch block, the expert stacks its
``E / ep_size`` experts. The collectives are autograd functions that
transpose as ``shard_map`` does, so that a leaf's gradient summed over
the batch axes is the gradient of the whole batch's loss; the combines
sum each token's copies in a fixed order, as ``moe_forward`` does.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import telemetry
from .common import dtype_of, normal
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    params = {
        "router": normal(gen, (d, e), 0.02, torch.float32),
        "w_gate": normal(gen, (e, d, f), (1.0 / d) ** 0.5, dt),
        "w_up": normal(gen, (e, d, f), (1.0 / d) ** 0.5, dt),
        "w_down": normal(gen, (e, f, d), (1.0 / f) ** 0.5, dt),
    }
    if m.num_shared_experts:
        params["shared"] = init_mlp(cfg, gen, d_ff=f * m.num_shared_experts)
    return params


def _route(cfg: ModelConfig, router: torch.Tensor, tokens: torch.Tensor):
    """Top-k gates in float32, renormalised over the selected experts.

    ``torch.topk(sorted=True)`` orders the selected experts by descending
    probability, as ``jax.lax.top_k``. Returns ``(gates (n, k), idx (n, k),
    aux)``."""
    m = cfg.moe
    logits = tokens.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.experts_per_token, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    e = m.num_experts
    density = torch.mean(F.one_hot(idx[:, 0], e).to(torch.float32), dim=0)
    mean_probs = torch.mean(probs, dim=0)
    aux = e * torch.sum(density * mean_probs)
    return gates, idx, aux


def _counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(keys, minlength=n)`` for keys in ``[0, n)``: int64
    counts of static size ``n``, which ``meta`` tensors (the dry-run's)
    can also give."""
    return torch.zeros(n, dtype=torch.int64, device=keys.device).scatter_add_(
        0, keys, torch.ones_like(keys, dtype=torch.int64))


def _expert_ffn(cfg: ModelConfig, params: dict, xs, offs):
    """The experts' FFN over rows sorted by expert; ``offs`` (int32) ends
    each expert's rows."""
    up = torch._grouped_mm(xs, params["w_up"], offs=offs)
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch._grouped_mm(xs, params["w_gate"], offs=offs)) * up
    elif cfg.mlp_type == "geglu":
        h = F.gelu(torch._grouped_mm(xs, params["w_gate"], offs=offs), approximate="tanh") * up
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return torch._grouped_mm(h, params["w_down"], offs=offs)


@telemetry.profiled("moe_forward")
def moe_forward(
    cfg: ModelConfig, params: dict, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    k = m.experts_per_token
    tokens = x.reshape(n, d)

    gates, idx, aux = _route(cfg, params["router"], tokens)

    # Sort token copies by expert id → grouped products over contiguous
    # rows.
    flat_expert = idx.reshape(-1)                           # (n*k,)
    order = torch.argsort(flat_expert, stable=True)
    xs = tokens[order // k]                                 # (n*k, d)
    offs = torch.cumsum(_counts(flat_expert, m.num_experts), 0)
    out = _expert_ffn(cfg, params, xs, offs.to(torch.int32))
    out = out * gates.reshape(-1)[order][:, None].to(out.dtype)

    # Each token's copies, in ascending sorted position (= ascending
    # expert), summed one after another in the output's dtype.
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(n * k, device=x.device)
    sorted_pos = torch.sort(sorted_pos.view(n, k), dim=1).values
    copies = out[sorted_pos]                                # (n, k, d)
    y = copies[:, 0]
    for j in range(1, k):
        y = y + copies[:, j]
    y = y.reshape(b, s, d).to(x.dtype)

    if m.num_shared_experts:
        y = y + mlp_forward(cfg, params["shared"], x)
    return y, aux.to(torch.float32)




# --------------------------------------------------------------------- #
# Expert-parallel path
# --------------------------------------------------------------------- #
def _expert_ffn_blocked(cfg: ModelConfig, w_gate, w_up, w_down, xb):
    """The experts' FFN over fixed-capacity blocks ``xb`` (E_local, cap,
    D): batched products, exactly cap x D x F per matrix and expert."""
    up = torch.bmm(xb, w_up)
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(xb, w_gate)) * up
    elif cfg.mlp_type == "geglu":
        h = F.gelu(torch.bmm(xb, w_gate), approximate="tanh") * up
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, w_down)


_EP = None
#: Groups over a set of axes of a mesh (a composite ``ep_axis``, every axis
#: for the auxiliary loss), kept for as long as the world they belong to:
#: ``(world, {(mesh shape, mesh ranks, dims): group})``.
_FLAT: tuple = (None, {})


def set_ep_mesh(mesh) -> None:
    """Register the :class:`~torch.distributed.device_mesh.DeviceMesh` that
    ``moe_forward_ep`` runs on (``None`` clears it). A single ep axis runs
    on the mesh's own group for that dim; a set of axes gets one group over
    the flattened dims, the whole mesh's built here and a composite
    ``ep_axis``'s at its first use. Each is kept while the world lives, so
    registering a mesh again builds nothing. Every rank of the world must
    register the mesh, and make the first call on a composite ``ep_axis``,
    together, as ``new_group`` requires."""
    global _EP
    _EP = mesh
    if mesh is not None:
        _group(mesh, tuple(mesh.mesh_dim_names))


def _ep_axes(cfg: ModelConfig) -> tuple[str, ...]:
    return (cfg.ep_axis,) if isinstance(cfg.ep_axis, str) else tuple(cfg.ep_axis)


def _group(mesh, axes: tuple[str, ...]):
    """The process group over ``axes`` of ``mesh`` (named in mesh order),
    its ranks in the row-major order of those axes."""
    global _FLAT
    names = tuple(mesh.mesh_dim_names)
    if len(set(axes)) != len(axes) or list(axes) != [a for a in names if a in axes]:
        raise ValueError(f"ep_axis {axes} must name axes of the mesh {names} in its order")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if _FLAT[0] is not dist.group.WORLD:
        _FLAT = (dist.group.WORLD, {})
    ranks = mesh.mesh
    dims = tuple(names.index(a) for a in axes)
    key = (tuple(ranks.shape), tuple(ranks.reshape(-1).tolist()), dims)
    if key not in _FLAT[1]:
        rest = [i for i in range(ranks.ndim) if i not in dims]
        lists = ranks.permute(*rest, *dims).reshape(
            -1, math.prod(ranks.shape[i] for i in dims)).tolist()
        _FLAT[1][key] = dist.new_subgroups_by_enumeration(lists)[0]
    return _FLAT[1][key]


def _axis_index_flat(group) -> int:
    """This rank's linear index along the ep axes (row-major over them):
    its rank in their group."""
    return dist.get_rank(group)


class _Enter(torch.autograd.Function):
    """An input replicated over the ep axes: identity forward, the
    cotangent summed over the ep ranks backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOver(torch.autograd.Function):
    """The psum combine: the partial outputs summed over the ep ranks
    forward; the output is replicated there, so its cotangent passes
    through unchanged backward."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_to_all(t, group):
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over dim 0 in equal pieces; its transpose is itself."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """The a2a form's output: each rank's sequence chunk gathered over the
    ep ranks along dim 1. The whole block is replicated there, so each
    rank's cotangent of its own chunk is its slice of the block's."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.index, ctx.width = dist.get_rank(group), t.shape[1]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.index * ctx.width, ctx.width), None


class _MeanAll(torch.autograd.Function):
    """The auxiliary loss's ``pmean`` over every mesh axis: the mean over
    the ranks forward, the cotangent divided by their number backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.size = dist.get_world_size(group)
        out = t.reshape(1).clone()
        dist.all_reduce(out, group=group)
        return (out / ctx.size).reshape(t.shape)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def _capacity(rows: int, groups: int, cf: float, floor: bool) -> int:
    """Rows of each capacity block, as the reference computes them: the
    mean share scaled by ``cf`` and rounded up, at most ``rows``; with
    ``floor`` at least ``min(8, rows)`` (a real product at decode)."""
    cap = min(int(math.ceil(rows / groups * cf)), rows)
    return max(cap, min(8, rows)) if floor else cap


def _blocks(keys, buckets: int, cap: int, fill: int):
    """Fixed-capacity blocks over ``keys`` (values in ``[0, buckets]``, the
    last one outside every block): the stable order, each block's row ids
    (``(buckets * cap,)``, clamped as the reference clamps them), which
    rows are valid, and each key's flat slot ``key * cap + rank`` or
    ``buckets * cap`` where it is outside or past its block's capacity."""
    nk = keys.numel()
    order = torch.argsort(keys, stable=True)
    counts = _counts(keys, buckets + 1)[:buckets]
    offsets = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cap, device=keys.device)[None, :]
    valid = slot < counts[:, None]                           # (buckets, cap)
    pos = torch.clamp(offsets[:, None] + slot, max=nk - 1)
    take = order[pos.reshape(-1)]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nk, device=keys.device)
    within = rank - offsets[keys.clamp(max=buckets - 1)]
    kept = (keys < buckets) & (within < cap)
    flat = torch.where(kept, keys * cap + within, fill)
    return take, valid, flat


def _combine(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Row ``t`` the sum of ``rows[slots[t]]`` (a slot of ``len(rows)`` is
    a zero row) in ascending slot order, added one after another: the
    order of the reference's scatter-add, with no atomics."""
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    copies = padded[torch.sort(slots, dim=1).values]
    y = copies[:, 0]
    for j in range(1, slots.shape[1]):
        y = y + copies[:, j]
    return y


def _moe_local_body(cfg: ModelConfig, mesh, router, w_gate, w_up, w_down, x_blk):
    """The psum body. ``x_blk`` (B_local, S, D) is replicated over the ep
    axes, ``w_*`` (E_local, ...) are this rank's experts. Every ep rank
    routes all the tokens; each computes the copies routed to its experts
    in ``(E_local, cap_e, D)`` blocks, and the partial outputs are summed
    over the ep ranks. Returns ``(y, aux)``, aux the mean over the mesh."""
    group = _group(mesh, _ep_axes(cfg))
    m = cfg.moe
    bl, s, d = x_blk.shape
    n = bl * s
    k = m.experts_per_token
    e_local = w_up.shape[0]
    tokens = _Enter.apply(x_blk, group).reshape(n, d)
    router = _Enter.apply(router, group)
    gates, idx, aux = _route(cfg, router, tokens)
    lo = _axis_index_flat(group) * e_local

    local_e = idx.reshape(-1) - lo                           # (n*k,)
    mine = (local_e >= 0) & (local_e < e_local)
    # My copies first, grouped by local expert; foreign copies sink into
    # a trailing bucket beyond every expert's capacity window.
    sort_key = torch.where(mine, local_e, e_local)
    cap_e = _capacity(n * k, m.num_experts, cfg.ep_capacity_factor, floor=True)
    take, valid, slots = _blocks(sort_key, e_local, cap_e, e_local * cap_e)

    xb = tokens[take // k].reshape(e_local, cap_e, d)
    xb = torch.where(valid[..., None], xb, torch.zeros((), dtype=xb.dtype, device=xb.device))
    out = _expert_ffn_blocked(cfg, w_gate, w_up, w_down, xb)

    gate_of = torch.where(valid.reshape(-1), gates.reshape(-1)[take], 0.0)
    out = out.reshape(-1, d) * gate_of[:, None].to(out.dtype)
    y = _SumOver.apply(_combine(out, slots.view(n, k)), group)
    aux_g = _MeanAll.apply(aux, _group(mesh, tuple(mesh.mesh_dim_names)))
    return y.reshape(bl, s, d).to(x_blk.dtype), aux_g


def _moe_local_body_a2a(cfg: ModelConfig, mesh, router, w_gate, w_up, w_down, x_blk):
    """The all-to-all body (``ep_combine="a2a"``). ``x_blk`` (B_local, S,
    D) is replicated over the ep axes; this rank routes its sequence chunk
    (S / ep_size positions, by its ep index), packs the copies into
    per-destination capacity slots, sends them to the owning ranks, runs
    its experts on what it receives in capacity blocks, sends the outputs
    back and combines its chunk; the chunks are then gathered over the ep
    ranks. Returns ``(y (B_local, S, D), aux)``."""
    group = _group(mesh, _ep_axes(cfg))
    m = cfg.moe
    bl, s, d = x_blk.shape
    k = m.experts_per_token
    e_local = w_up.shape[0]
    cols = m.num_experts // e_local
    s_loc = s // cols
    x_loc = _Enter.apply(x_blk, group).narrow(1, _axis_index_flat(group) * s_loc, s_loc)
    n = bl * s_loc
    tokens = x_loc.reshape(n, d)
    router = _Enter.apply(router, group)

    gates, idx, aux = _route(cfg, router, tokens)
    flat_e = idx.reshape(-1)                       # (n*k,) global expert id
    dest = flat_e // e_local                       # owning column

    # ---- outbound: pack copies into per-destination capacity slots ----
    cap_s = _capacity(n * k, cols, cfg.ep_capacity_factor, floor=False)
    take, valid_s, slots = _blocks(dest, cols, cap_s, cols * cap_s)
    valid_s = valid_s.reshape(-1)
    zero = torch.zeros((), dtype=tokens.dtype, device=tokens.device)
    send_x = torch.where(valid_s[:, None], tokens[take // k], zero).reshape(cols, cap_s, d)
    send_le = torch.where(valid_s, flat_e[take] % e_local, e_local).to(torch.int32)
    send_gate = torch.where(valid_s, gates.reshape(-1)[take], 0.0)

    recv_x = _AllToAll.apply(send_x, group)        # (cols, cap_s, d) for my experts
    recv_le = _all_to_all(send_le.reshape(cols, cap_s), group)

    # ---- local expert compute over fixed-capacity blocks --------------
    r = cols * cap_s
    rle = recv_le.reshape(r).to(torch.int64)       # e_local = invalid marker
    cap_e = _capacity(r, e_local, cfg.ep_capacity_factor, floor=True)
    take2, valid_e, slots2 = _blocks(rle, e_local, cap_e, e_local * cap_e)
    xb = recv_x.reshape(r, d)[take2].reshape(e_local, cap_e, d)
    xb = torch.where(valid_e[..., None], xb, zero)
    out_b = _expert_ffn_blocked(cfg, w_gate, w_up, w_down, xb)
    # Each received row's output (zero where it found no slot).
    out_recv = torch.cat([out_b.reshape(-1, d), out_b.new_zeros(1, d)])[slots2]

    # ---- return trip + combine ----------------------------------------
    back = _AllToAll.apply(out_recv.reshape(cols, cap_s, d), group)
    back = back.reshape(-1, d) * send_gate[:, None].to(back.dtype)
    y = _combine(back, slots.view(n, k)).reshape(bl, s_loc, d).to(x_blk.dtype)
    aux_g = _MeanAll.apply(aux, _group(mesh, tuple(mesh.mesh_dim_names)))
    return _GatherSeq.apply(y, group), aux_g


@telemetry.profiled("moe_forward_ep")
def moe_forward_ep(
    cfg: ModelConfig, params: dict, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the registered mesh (:func:`set_ep_mesh`):
    ``x`` is this rank's batch block (replicated over ``cfg.ep_axis``),
    ``params``' expert stacks its ``E / ep_size`` experts (a ``ValueError``
    otherwise). Returns ``(y, aux)``: ``y`` of ``x``'s shape, ``aux`` the load-balance loss averaged
    over every rank of the mesh. DTensor inputs (the dry-run's) run the
    same body on each rank's blocks (:func:`_ep_routed_sharded`)."""
    if isinstance(x, DTensor):
        y, aux = _ep_routed_sharded(cfg, params, x)
    else:
        y, aux = _ep_routed(cfg, params["router"], params["w_gate"], params["w_up"],
                            params["w_down"], x)
    if cfg.moe.num_shared_experts:
        y = y + mlp_forward(cfg, params["shared"], x)
    return y, aux.to(torch.float32)


def _ep_mesh():
    if _EP is None:
        raise RuntimeError(
            "cfg.ep_axis set but no EP mesh registered; call "
            "repro_torch.models.moe.set_ep_mesh(mesh) first"
        )
    return _EP


def _ep_routed(cfg: ModelConfig, router, w_gate, w_up, w_down, x):
    """The routed experts' ``(y, aux)`` on this rank's blocks: the psum or
    the all-to-all body."""
    mesh = _ep_mesh()
    ep_size = dist.get_world_size(_group(mesh, _ep_axes(cfg)))
    e_local, e = w_up.shape[0], cfg.moe.num_experts
    if e_local * ep_size != e:
        raise ValueError(
            f"the expert stacks hold {e_local} experts, and this rank's block of {e} "
            f"experts over {ep_size} ep ranks is {e / ep_size:g}: pass the rank's block, "
            "the .to_local() of models.sharding.place(params, shard_params(...))"
        )
    use_a2a = cfg.ep_combine == "a2a" and x.shape[1] % ep_size == 0
    body = _moe_local_body_a2a if use_a2a else _moe_local_body
    return body(cfg, mesh, router, w_gate, w_up, w_down, x)


def _ep_routed_sharded(cfg: ModelConfig, params: dict, x: DTensor):
    """:func:`_ep_routed` over DTensors through ``local_map``, the
    counterpart of the reference's ``shard_map`` with ``moe_forward_ep``'s
    specs: ``x`` sharded by batch over the batch axes outside the ep axes
    and replicated over the rest, the expert stacks sharded over the ep
    axes, the router replicated. The reference's replicated in_specs
    transpose to a sum over the batch axes, while the body's autograd
    functions sum only over the ep axes: so the router's and the expert
    stacks' gradients are declared ``Partial`` over the batch axes."""
    names = tuple(_ep_mesh().mesh_dim_names)
    ep = _ep_axes(cfg)
    batch = [n for n in ("pod", "data") if n in names and n not in ep]
    x_pl = [Shard(0) if n in batch else Replicate() for n in names]
    w_pl = [Shard(0) if n in ep else Replicate() for n in names]
    r_pl = [Replicate()] * len(names)

    def summed(pl):
        return [Partial() if n in batch else p for n, p in zip(names, pl)]

    return local_map(
        functools.partial(_ep_routed, cfg),
        out_placements=(x_pl, r_pl),
        in_placements=(r_pl, w_pl, w_pl, w_pl, x_pl),
        in_grad_placements=(summed(r_pl), summed(w_pl), summed(w_pl), summed(w_pl), x_pl),
        device_mesh=x.device_mesh,
        redistribute_inputs=True,
    )(params["router"], params["w_gate"], params["w_up"], params["w_down"], x)


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Dispatch: expert-parallel with ``cfg.ep_axis`` set, the dropless
    single-device form otherwise."""
    if cfg.ep_axis:
        return moe_forward_ep(cfg, params, x)
    return moe_forward(cfg, params, x)
