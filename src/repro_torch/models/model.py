"""Model assembly: stacked layer groups, embeddings, decode.

Counterpart of the reference's ``repro.models.model`` for the serving
path. Layers are grouped into *scan groups* exactly as the reference
groups them (maximal runs of a repeating unit, e.g. DeepSeek = 3 dense +
58 moe), and each group's parameters and caches are stacked with a
leading count axis, so that the two packages' trees match leaf for leaf.
PyTorch runs eagerly: where the reference scans a group, the port loops
over the count axis in Python.

Ported: :func:`layer_kinds`, :func:`scan_groups`, :func:`init_params`,
:func:`init_cache`, :func:`decode_step`, and :func:`params_from_jax`,
which carries the reference's parameters across. The block kinds other
than ``dense``, the encoder, the vision projector, ``forward`` and the
losses wait for ROADMAP Queue A item 5.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import blocks
from .common import apply_norm, dtype_of, embed_tokens, make_norm_params, normal, unembed
from .config import ModelConfig


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A item 5)")


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


def _stack(trees: list):
    """Stack a list of equal-structure trees leaf by leaf (new axis 0)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree, i: int):
    """Leaf ``[i]`` of every tensor in a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.shared_attn_every:
        raise _not_ported("the shared attention block (Zamba2)")
    if cfg.encoder_layers or cfg.arch_type == "audio":
        raise _not_ported("the encoder-decoder stack")
    if cfg.frontend == "vision":
        raise _not_ported("the vision projector")
    for kind in dict.fromkeys(layer_kinds(cfg)):
        blocks._check_kind(cfg, kind)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, seed: int, *, device="cuda") -> dict:
    """The reference's parameter tree (same leaves, shapes and dtypes,
    MTP head included), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``. The numbers differ from the reference's
    ``jax.random`` draws: to start from the reference's parameters, use
    :func:`params_from_jax`."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dev = gen.device
    dt = dtype_of(cfg)
    params: dict = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "final_norm": make_norm_params(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    params["groups"] = [
        _stack([
            {f"b{i}": blocks.init_block(cfg, k, gen) for i, k in enumerate(unit)}
            for _ in range(count)
        ])
        for unit, count in scan_groups(cfg)
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
# decode (serving)
# --------------------------------------------------------------------- #
def init_cache(
    cfg: ModelConfig, batch: int, seq: int, long_mode: bool = False, *, device="cuda"
) -> list:
    """Stacked per-group caches (zeros), as the reference's."""
    _check_ported(cfg)
    caches = []
    for unit, count in scan_groups(cfg):
        caches.append({
            f"b{i}": {
                name: torch.stack([t] * count)
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
    float32 logits ``(B, 1, vocab)`` and the cache, updated in place."""
    if force_local:
        raise _not_ported("force_local (local/global attention)")
    _check_ported(cfg)
    pos = int(pos)
    x = embed_tokens(params["embed"], token)
    if cfg.logit_softcap:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype)
    for (unit, count), gparams, gcache in zip(scan_groups(cfg), params["groups"], cache):
        for layer in range(count):
            up, uc = _index(gparams, layer), _index(gcache, layer)
            for i, kind in enumerate(unit):
                x, _ = blocks.block_decode(cfg, kind, up[f"b{i}"], x, uc[f"b{i}"], pos)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params.get("unembed", params["embed"]), x)
    return logits, cache
