"""Model assembly: stacked layer groups, embeddings, forward, decode.

Counterpart of the reference's ``repro.models.model`` for serving the
decoder-only attention architectures. Layers are grouped into *scan
groups* exactly as the reference groups them (maximal runs of a
repeating unit, e.g. DeepSeek = 3 dense + 58 moe, Gemma2 = 13 x (local,
global)), and each group's parameters and caches are stacked with a
leading count axis, so that the two packages' trees match leaf for leaf.
PyTorch runs eagerly: where the reference scans a group, the port loops
over the count axis in Python.

Ported: :func:`layer_kinds`, :func:`scan_groups`, :func:`init_params`,
:func:`init_cache`, :func:`forward`, :func:`decode_step`, and
:func:`params_from_jax`, which carries the reference's parameters across.
Waiting (ROADMAP Queue A item 5): ``lm_loss`` and training (5a), the SSM
and hybrid kinds (5b), the encoder-decoder stack and
``prefill_cross_cache`` (5c), the vision projector (5d).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import blocks
from .common import (
    SHAPES_ONLY, apply_norm, dtype_of, embed_tokens, make_norm_params, normal, unembed,
)
from .config import ModelConfig


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A item {item})")


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


def _index(tree, i: int):
    """Leaf ``[i]`` of every tensor in a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.shared_attn_every:
        raise _not_ported("the shared attention block (Zamba2)", "5b")
    if cfg.encoder_layers or cfg.arch_type == "audio":
        raise _not_ported("the encoder-decoder stack (Whisper)", "5c")
    if cfg.frontend == "vision":
        raise _not_ported("the vision projector (Phi-3-vision)", "5d")
    for kind in dict.fromkeys(layer_kinds(cfg)):
        blocks._check_kind(cfg, kind)


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
    _check_ported(cfg)
    return sum(t.nbytes for t in _leaves(_draw_params(cfg, SHAPES_ONLY)))


def _check_room(cfg: ModelConfig, dev: torch.device) -> None:
    """Refuse, naming the bytes, a tree larger than the device's free
    memory (the card's) or the host's physical memory (the CPU's)."""
    need = param_bytes(cfg)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        where = f"{free} bytes free on {torch.cuda.get_device_name(dev)}"
    else:
        free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = f"{free} bytes of host memory"
    if need > free:
        raise MemoryError(
            f"{cfg.name} at {cfg.num_layers} layers needs {need} bytes of "
            f"{cfg.dtype} parameters; there are {where}"
        )


def init_params(cfg: ModelConfig, seed: int, *, device="cuda") -> dict:
    """The reference's parameter tree (same leaves, shapes and dtypes,
    MTP head included), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``. The numbers differ from the reference's
    ``jax.random`` draws: to start from the reference's parameters, use
    :func:`params_from_jax`. A tree larger than the device's memory
    raises ``MemoryError`` naming the bytes before anything is drawn."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    _check_room(cfg, gen.device)
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
# forward (prefill)
# --------------------------------------------------------------------- #
def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = embed_tokens(params["embed"], tokens)
    if cfg.logit_softcap:  # Gemma2 scales its (tied) embedding by sqrt(d)
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
    force_local: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer of every group in order; returns ``(x, aux)``, the MoE
    layers' auxiliary losses summed. ``remat`` is accepted and has no
    effect: the port does not train yet (ROADMAP Queue A item 5a)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (unit, count), gparams in zip(group_structure, group_list):
        for layer in range(count):
            up = _index(gparams, layer)
            for i, kind in enumerate(unit):
                x, a = blocks.block_forward(
                    cfg, kind, up[f"b{i}"], x, positions, force_local=force_local
                )
                aux_total = aux_total + a
    return x, aux_total


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
    logits ``(B, S, vocab)``. ``patches`` (vision) and ``frames`` (audio)
    raise ``NotImplementedError``."""
    if patches is not None:
        raise _not_ported("the vision projector (patches)", "5d")
    if frames is not None:
        raise _not_ported("the audio encoder (frames)", "5c")
    _check_ported(cfg)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, aux = _run_groups(
        cfg, params, params["groups"], scan_groups(cfg), x, positions,
        force_local=force_local, remat=remat,
    )
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params.get("unembed", params["embed"]), x)
    return logits, aux


# --------------------------------------------------------------------- #
# decode (serving)
# --------------------------------------------------------------------- #
def init_cache(
    cfg: ModelConfig, batch: int, seq: int, long_mode: bool = False, *, device="cuda"
) -> list:
    """Stacked per-group caches (zeros), as the reference's. Under
    ``long_mode`` the global layers of a local/global model keep only
    the window."""
    _check_ported(cfg)
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
    windowed (the reference's long-context decode)."""
    _check_ported(cfg)
    pos = int(pos)
    x = _embed(cfg, params, token)
    for (unit, count), gparams, gcache in zip(scan_groups(cfg), params["groups"], cache):
        for layer in range(count):
            up, uc = _index(gparams, layer), _index(gcache, layer)
            for i, kind in enumerate(unit):
                x, _ = blocks.block_decode(cfg, kind, up[f"b{i}"], x, uc[f"b{i}"], pos,
                                           force_local=force_local)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params.get("unembed", params["embed"]), x)
    return logits, cache
