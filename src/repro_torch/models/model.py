"""Model assembly: stacked layer groups, embeddings, forward, LM loss,
decode.

Counterpart of the reference's ``repro.models.model`` for every
architecture of the zoo: decoder-only attention, SSM (xLSTM), hybrid
(Zamba2), encoder-decoder (Whisper) and vision-prefixed (Phi-3-vision).
Layers are grouped into *scan groups* exactly as the reference groups
them (maximal runs of a repeating unit, e.g. DeepSeek = 3 dense + 58 moe,
Gemma2 = 13 x (local, global), Zamba2 = 6 x (5 mamba2 + shared_attn) + 2
mamba2), and each group's parameters and caches are stacked with a
leading count axis, so that the two packages' trees match leaf for leaf.
PyTorch runs eagerly: where the reference scans a group, the port splits
each stacked leaf once (``torch.unbind``, whose backward is one stack)
and loops over the layers in Python; ``remat`` recomputes each unit in
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does.

Ported: :func:`layer_kinds`, :func:`scan_groups`, :func:`init_params`,
:func:`init_cache`, :func:`encode`, :func:`forward` (Whisper's ``frames``,
Phi-3-vision's ``patches``), :func:`lm_loss` (DeepSeek-V3's MTP head
included), :func:`decode_step`, :func:`prefill_cross_cache`, and
:func:`params_from_jax`, which carries the reference's parameters across;
Zamba2's shared block lives once, at ``params["shared_block"]``, and every
``shared_attn`` slot reads it.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import blocks
from .common import (
    _DTYPES, SHAPES_ONLY, _as_dtensor, apply_norm, dtype_of, embed_tokens, make_norm_params,
    normal, unembed,
)
from .config import ModelConfig

VISION_EMBED_DIM = 1024  # CLIP ViT-L/14 output width (projector input)


# --------------------------------------------------------------------- #
# scan-group structure
# --------------------------------------------------------------------- #
def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.encoder_layers:
        return ["dec"] * cfg.num_layers
    return [cfg.block_kind(l) for l in range(cfg.num_layers)]


def scan_groups(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Partition the layer-kind sequence into (unit, count) groups."""
    groups = _scan_groups_raw(cfg)
    if cfg.scan_counts_override is not None:
        ov = cfg.scan_counts_override
        assert len(ov) == len(groups), (ov, groups)
        groups = [(unit, int(c)) for (unit, _), c in zip(groups, ov)]
    return groups


def _scan_groups_raw(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    kinds = layer_kinds(cfg)
    groups: list[tuple[tuple[str, ...], int]] = []
    i = 0
    L = len(kinds)
    while i < L:
        best_unit, best_count = (kinds[i],), 1
        for period in range(1, min(8, L - i) + 1):
            unit = tuple(kinds[i : i + period])
            count = 1
            while (
                tuple(kinds[i + count * period : i + (count + 1) * period]) == unit
            ):
                count += 1
            if count * period > len(best_unit) * best_count:
                best_unit, best_count = unit, count
        groups.append((best_unit, best_count))
        i += len(best_unit) * best_count
    return groups


def _map(fn, *trees):
    """``fn`` over the leaves of equal-structure dict trees."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _init_group(cfg: ModelConfig, unit, count: int, gen) -> dict:
    """A group's stacked parameters, drawn layer by layer.

    A group of one layer unit is that unit's tree with a leading axis of
    1 (views, no copy: a DeepSeek-V3 unit of 3 dense + 2 MoE layers is
    54.6 GB in bf16). A longer group allocates each stacked leaf once in
    its final dtype and copies each layer's draw into it, so that the
    memory above the stacked tree is one layer's leaves."""
    stacked = None
    for layer in range(count):
        tree = {f"b{i}": blocks.init_block(cfg, k, gen) for i, k in enumerate(unit)}
        if count == 1:
            return _map(lambda t: t[None], tree)
        if stacked is None:
            stacked = _map(lambda t: t.new_empty((count, *t.shape)), tree)
        _map(lambda s, t: s[layer].copy_(t), stacked, tree)
        del tree
    return stacked


def _layers(tree, count: int) -> list:
    """The ``count`` layers of a stacked tree: every leaf split once along
    its leading axis (views, no copy). Under autograd the split's backward
    is one ``stack`` per leaf; indexing each layer instead would fill a
    zeroed stack per layer and sum ``count`` of them."""
    if isinstance(tree, dict):
        split = {k: _layers(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in split.items()} for i in range(count)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def _draw_params(cfg: ModelConfig, gen) -> dict:
    dt = dtype_of(cfg)
    dev = gen.device
    params: dict = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "final_norm": make_norm_params(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    params["groups"] = [
        _init_group(cfg, unit, count, gen) for unit, count in scan_groups(cfg)
    ]
    if cfg.shared_attn_every:
        params["shared_block"] = blocks.init_shared_block(cfg, gen)
    if cfg.encoder_layers:
        params["enc_groups"] = [_init_group(cfg, ("enc",), cfg.encoder_layers, gen)]
        params["enc_final_norm"] = make_norm_params(cfg, dev)
    if cfg.frontend == "vision":
        params["vision_proj"] = normal(
            gen, (VISION_EMBED_DIM, cfg.d_model), (1.0 / VISION_EMBED_DIM) ** 0.5, dt
        )
    if cfg.mtp:
        params["mtp_proj"] = normal(
            gen, (2 * cfg.d_model, cfg.d_model), (0.5 / cfg.d_model) ** 0.5, dt
        )
        params["mtp_block"] = blocks.init_block(
            cfg, "dense" if cfg.moe.num_experts else "attn", gen
        )
        params["mtp_norm"] = make_norm_params(cfg, dev)
    return params


def param_bytes(cfg: ModelConfig) -> int:
    """Bytes of :func:`init_params`' tree (shapes only; nothing drawn)."""
    return sum(t.nbytes for t in _leaves(_draw_params(cfg, SHAPES_ONLY)))


def train_state_bytes(cfg: ModelConfig) -> int:
    """Bytes of a training step's state: the parameters, their gradients
    (the parameters' dtypes) and AdamW's two moments (``cfg.opt_dtype``)."""
    moment = _DTYPES[cfg.opt_dtype].itemsize
    leaves = list(_leaves(_draw_params(cfg, SHAPES_ONLY)))
    return sum(2 * t.nbytes + 2 * t.numel() * moment for t in leaves)


def check_room(cfg: ModelConfig, need: int, what: str, dev: torch.device) -> None:
    """Refuse, naming the bytes, ``need`` bytes of ``what`` beyond the
    device's free memory (the card's) or the host's physical memory (the
    CPU's)."""
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        where = f"{free} bytes free on {torch.cuda.get_device_name(dev)}"
    else:
        free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = f"{free} bytes of host memory"
    if need > free:
        raise MemoryError(
            f"{cfg.name} at {cfg.num_layers} layers needs {need} bytes of {what}; "
            f"there are {where}"
        )


def init_params(cfg: ModelConfig, seed: int, *, device="cuda") -> dict:
    """The reference's parameter tree (same leaves, shapes and dtypes,
    MTP head included), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``. The numbers differ from the reference's
    ``jax.random`` draws: to start from the reference's parameters, use
    :func:`params_from_jax`. A tree larger than the device's memory
    raises ``MemoryError`` naming the bytes before anything is drawn."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    check_room(cfg, param_bytes(cfg), f"{cfg.dtype} parameters", gen.device)
    return _draw_params(cfg, gen)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tensor_of(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device) -> dict:
    """The port's parameter tree holding the reference's parameters.

    ``tree`` is the reference's ``init_params`` tree with numpy leaves
    (for instance ``jax.tree_util.tree_map(np.asarray, params)``): dicts
    and the ``groups`` list map one to one, each leaf becomes a tensor of
    the same shape and dtype on ``device`` (bfloat16 bits carried
    exactly)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _tensor_of(tree, device)


# --------------------------------------------------------------------- #
# positions
# --------------------------------------------------------------------- #
@functools.cache
def _sin_divisors(d: int, device: torch.device) -> torch.Tensor:
    """``10000 ** (dim / d)`` for ``dim = 0, 2, ..., d - 2`` as the
    reference's float32 power gives them: the exponent a float32 quotient,
    the power taken in float64 and rounded to float32 (``torch.pow`` in
    float32 differs in 11 of Whisper's 640 divisors). Kept per device."""
    expo = np.arange(0, d, 2, dtype=np.float32) / np.float32(d)
    div = np.power(10_000.0, expo.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(div).to(device)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The reference's sinusoid at ``positions`` (S,): ``(S, d)`` float32,
    the sines then the cosines of the float32 angles ``pos / divisor``."""
    angles = positions.to(torch.float32)[:, None] / _sin_divisors(d, positions.device)[None]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _sinusoidal(seq: int, d: int, device=None) -> torch.Tensor:
    """``(1, seq, d)``: the sinusoid at positions ``0 .. seq - 1``."""
    return _sinusoid(torch.arange(seq, device=device), d)[None]


# --------------------------------------------------------------------- #
# forward (training / prefill)
# --------------------------------------------------------------------- #
def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """The tokens' embeddings at positions ``start, start + 1, ...``: with
    the sinusoid added for Whisper, scaled by sqrt(d) for Gemma2 (its
    tied embedding), as they are."""
    x = embed_tokens(params["embed"], tokens)
    if cfg.arch_type == "audio" or cfg.encoder_layers:
        positions = torch.arange(start, start + tokens.shape[1], device=x.device)
        return x + _sinusoid(positions, cfg.d_model)[None].to(x.dtype)
    if cfg.logit_softcap:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype)
    return x


def _run_groups(
    cfg: ModelConfig,
    params: dict,
    group_list: list,
    group_structure: list,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    memory: torch.Tensor | None = None,
    force_local: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer of every group in order; returns ``(x, aux)``, the MoE
    layers' auxiliary losses summed. A ``dec`` layer computes its cross
    keys and values from the encoder's output ``memory`` inside its unit.
    With ``remat`` each unit of a group keeps only its inputs for backward
    and runs again there (the cross keys and values included, as the
    reference's ``jax.checkpoint`` recomputes them)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_block")
    for (unit, count), gparams in zip(group_structure, group_list):

        def unit_fwd(h, aux, up, unit=unit):
            for i, kind in enumerate(unit):
                mem_kv = None
                if kind == "dec":
                    mem_kv = attn.cross_memory(cfg, up[f"b{i}"]["cross"], memory)
                h, a = blocks.block_forward(
                    cfg, kind, up[f"b{i}"], h, positions, shared=shared,
                    memory_kv=mem_kv, force_local=force_local,
                )
                aux = aux + a
            return h, aux

        for up in _layers(gparams, count):
            if remat:
                x, aux_total = checkpoint(unit_fwd, x, aux_total, up, use_reentrant=False)
            else:
                x, aux_total = unit_fwd(x, aux_total, up)
    return x, aux_total


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the (stubbed) post-conv frame embeddings
    ``(B, encoder_seq, d_model)``: cast to the model's dtype, the sinusoid
    added, the ``enc`` layers (never rematerialised, as in the reference)
    and ``enc_final_norm``."""
    frames = frames.to(dtype_of(cfg))
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)[None]
    x, _ = _run_groups(cfg, params, params["enc_groups"], [(("enc",), cfg.encoder_layers)],
                       x, positions)
    return apply_norm(cfg, params["enc_final_norm"], x)


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    patches: torch.Tensor | None = None,
    frames: torch.Tensor | None = None,
    force_local: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns ``(logits, moe_aux_loss)``: float32
    logits ``(B, P + S, vocab)``. An encoder-decoder config needs
    ``frames`` ``(B, encoder_seq, d_model)`` (``ValueError`` without);
    ``patches`` ``(B, P, VISION_EMBED_DIM)`` go through ``vision_proj`` in
    the promoted dtype of the two (float32 patches and a bf16 projector
    multiply in float32, as the reference's einsum promotes them), are cast
    to the model's dtype and come before the text."""
    if cfg.encoder_layers and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: forward needs frames")
    x = _embed(cfg, params, tokens, 0)
    memory = encode(cfg, params, frames) if cfg.encoder_layers else None
    if patches is not None:
        proj = params["vision_proj"]
        dt = torch.promote_types(patches.dtype, proj.dtype)
        pe = torch.einsum("bpv,vd->bpd", patches.to(dt), proj.to(dt)).to(x.dtype)
        if isinstance(pe, DTensor):
            # The projector shards d_model; gathered here, the prefix joins
            # the text's layout, where the concatenation would shard the
            # whole residual stream by d_model instead.
            pe = pe.redistribute(pe.device_mesh, x.placements)
        x = torch.cat([pe, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, aux = _run_groups(
        cfg, params, params["groups"], scan_groups(cfg), x, positions, memory=memory,
        force_local=force_local, remat=remat,
    )
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params.get("unembed", params["embed"]), x)
    return logits, aux


# --------------------------------------------------------------------- #
# LM loss (next-token CE) + optional MTP
# --------------------------------------------------------------------- #
def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy: float32 ``log_softmax`` and the
    targets' entries, as the reference's. DTensor logits sharded by
    vocabulary (the dry-run's) pick each target on the rank that holds it
    (:func:`_picked_sharded`)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if isinstance(logp, DTensor):
        return -torch.mean(_picked_sharded(logp, targets))
    return -torch.mean(torch.gather(logp, -1, targets.long()[..., None]))


def _picked_sharded(logp: DTensor, targets: torch.Tensor) -> DTensor:
    """``gather(logp, -1, targets[..., None])`` over a mesh: on the mesh
    dim that shards the vocabulary each rank picks the targets in its
    block (zeros elsewhere) and the picks are summed over that dim.
    DTensor's rule for the gather's backward fills a zero tensor of the
    whole logits' global shape on every rank."""
    mesh, last = logp.device_mesh, logp.ndim - 1
    vocab = [i for i, p in enumerate(logp.placements) if p.is_shard(last)]
    targets = _as_dtensor(targets, mesh)
    lp = [p if p.is_shard() else Replicate() for p in logp.placements]
    tp = [Replicate() if p.is_shard(last) else p for p in lp]
    out = [Partial() if p.is_shard(last) else p for p in lp]

    def local(lg, tg):
        tg = tg.long()[..., None]
        if not vocab:
            return torch.gather(lg, -1, tg)
        tg = tg - mesh.get_coordinate()[vocab[0]] * lg.shape[-1]
        mine = (tg >= 0) & (tg < lg.shape[-1])
        picked = torch.gather(lg, -1, torch.where(mine, tg, 0))
        return torch.where(mine, picked, torch.zeros((), dtype=lg.dtype, device=lg.device))

    return local_map(local, out_placements=out, in_placements=(lp, tp),
                     in_grad_placements=(lp, tp), device_mesh=mesh,
                     redistribute_inputs=True)(logp, targets)


def lm_loss(
    cfg: ModelConfig,
    params: dict,
    batch: dict,
    remat: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy plus the MoE load-balance loss (weighted
    by ``cfg.moe.router_aux_weight``), and with ``cfg.mtp`` the
    reference's multi-token-prediction term. Returns ``(total, metrics)``
    with 0-d float32 tensors ``ce``, ``aux`` and (MTP) ``mtp_ce``.

    The MTP head is the reference's proxy, ported as written: it predicts
    token t+2 from ``[embed(t) ; embed(t+1)]`` (the tokens embedded again,
    not the trunk's hidden state) through ``mtp_proj``, one block (a
    ``dense`` block for a MoE model) and ``mtp_norm``, sharing the trunk's
    unembedding. ``batch["patches"]`` and ``batch["frames"]`` go to
    :func:`forward`; the loss reads the text positions only, after the
    patch prefix."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    logits, aux = forward(cfg, params, tokens, patches=patches, frames=batch.get("frames"),
                          remat=remat)
    n_prefix = 0 if patches is None else patches.shape[1]
    ce = _ce(logits[:, n_prefix : n_prefix + tokens.shape[1] - 1], tokens[:, 1:])
    total = ce + cfg.moe.router_aux_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        h = embed_tokens(params["embed"], tokens)
        h2 = torch.cat([h[:, :-1], embed_tokens(params["embed"], tokens[:, 1:])], dim=-1)
        h2 = torch.einsum("bsk,kd->bsd", h2, params["mtp_proj"])
        positions = torch.arange(h2.shape[1], device=h2.device)[None]
        h2, _ = blocks.block_forward(
            cfg, "dense" if cfg.moe.num_experts else "attn", params["mtp_block"], h2, positions
        )
        h2 = apply_norm(cfg, params["mtp_norm"], h2)
        mtp_logits = unembed(cfg, params.get("unembed", params["embed"]), h2[:, :-1])
        mtp_ce = _ce(mtp_logits, tokens[:, 2:])
        total = total + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics


# --------------------------------------------------------------------- #
# decode (serving)
# --------------------------------------------------------------------- #
def init_cache(
    cfg: ModelConfig, batch: int, seq: int, long_mode: bool = False, *, device="cuda"
) -> list:
    """Stacked per-group caches holding each layer's initial cache, as the
    reference's: zeros, but the xLSTM stabiliser ``m`` at -1e30. Under
    ``long_mode`` the global layers of a local/global model keep only
    the window. Whisper's ``dec`` layers also hold the encoder's keys and
    values (``ck`` / ``cv``, zeros until :func:`prefill_cross_cache`)."""
    caches = []
    for unit, count in scan_groups(cfg):
        caches.append({
            f"b{i}": {
                name: t[None].repeat(count, *([1] * t.dim()))
                for name, t in blocks.init_layer_cache(
                    cfg, kind, batch, seq, long_mode, device=device
                ).items()
            }
            for i, kind in enumerate(unit)
        })
    return caches


def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: list,
    token: torch.Tensor,         # (B, 1) int
    pos: int,                    # current sequence length (host int)
    *,
    force_local: bool = False,
) -> tuple[torch.Tensor, list]:
    """One-token decode over the full stack. Returns ``(logits, cache)``:
    float32 logits ``(B, 1, vocab)`` and the cache, updated in place.
    ``force_local`` runs the global layers of a local/global model
    windowed (the reference's long-context decode). Whisper adds the
    sinusoid at ``pos`` to the token's embedding and attends to the cross
    cache that :func:`prefill_cross_cache` filled."""
    pos = int(pos)
    x = _embed(cfg, params, token, pos)
    shared = params.get("shared_block")
    for (unit, count), gparams, gcache in zip(scan_groups(cfg), params["groups"], cache):
        for up, uc in zip(_layers(gparams, count), _layers(gcache, count)):
            for i, kind in enumerate(unit):
                x, _ = blocks.block_decode(cfg, kind, up[f"b{i}"], x, uc[f"b{i}"], pos,
                                           shared=shared, force_local=force_local)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params.get("unembed", params["embed"]), x)
    return logits, cache


@torch.no_grad()
def prefill_cross_cache(
    cfg: ModelConfig, params: dict, cache: list, frames: torch.Tensor
) -> list:
    """Whisper: run the encoder once over ``frames`` and write every
    ``dec`` layer's cross keys and values into the cache's ``ck`` / ``cv``
    in place (the reference returns an updated copy); the same cache is
    returned."""
    memory = encode(cfg, params, frames)
    (_, count), gparams = scan_groups(cfg)[0], params["groups"][0]
    c = cache[0]["b0"]
    for i, up in enumerate(_layers(gparams, count)):
        k, v = attn.cross_memory(cfg, up["b0"]["cross"], memory)
        c["ck"][i].copy_(k)
        c["cv"][i].copy_(v)
    return cache
