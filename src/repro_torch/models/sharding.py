"""Sharding policy: rule-based partition specs, placed with DTensor.

Counterpart of the reference's ``repro.models.sharding``: every parameter,
optimizer moment, batch and cache leaf gets a partition spec on the
production mesh. Rules are name and rank based, with one *divisibility
guard*: a mesh axis is assigned to a tensor dim only when it divides that
dim, otherwise the dim is replicated. That single rule lets the ten
architectures (4-head xLSTM next to 128-head DeepSeek) share the (data=16,
model=16) mesh without per-architecture cases.

Conventions (the reference's):

* parameters under ``groups`` carry one leading scan (layer-count) axis;
* tensor parallelism over ``model``: attention heads, FFN hidden, the MoE
  expert dim (or ``cfg.ep_axis``), vocabulary;
* batch over ``('pod', 'data')``; long-context decode (batch 1) shards the
  KV-cache *sequence* axis over ``('data', 'model')`` instead;
* ZeRO-style optimizer-state sharding adds ``data`` on the largest
  still-replicated divisible dim.

JAX's ``PartitionSpec`` and ``NamedSharding`` become :class:`P` (a tuple of
``None``, axis names and tuples of names) and :class:`NamedSharding`
(a spec on a :class:`~torch.distributed.device_mesh.DeviceMesh`, with the
DTensor placements it means); :func:`place` is ``jax.device_put(tree,
shardings)``. The spec functions read axis sizes from a ``DeviceMesh`` or
from any object whose ``.shape`` maps axis names to sizes.

DTensor shards one tensor dim over several mesh dims in the mesh's order,
so a composite entry such as ``('pod', 'data')`` must name its axes in the
mesh's order (JAX's major-to-minor order then agrees); :class:`NamedSharding`
raises on one that does not.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..optim.adamw import AdamWState
from ..tree import map_with_path, tree_map
from .config import ModelConfig

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    an axis name, or a tuple of names (the dim sharded over their product,
    major to minor). A one-name tuple is stored as the name, as JAX does."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``) or of
    a mesh-like object whose ``.shape`` is that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        return math.prod(_axis_size(mesh, n) for n in name)
    return axis_sizes(mesh).get(name, 0)


def batch_axes(mesh):
    return (POD_AXIS, DATA_AXIS) if POD_AXIS in axis_sizes(mesh) else (DATA_AXIS,)


def guard(mesh, spec: P, shape: tuple[int, ...]) -> P:
    """Drop any axis assignment that does not divide its dim."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        size = _axis_size(mesh, ax)
        if size and shape[i] % size == 0 and shape[i] >= size:
            out.append(ax)
        elif isinstance(ax, (tuple, list)):
            # Try a single sub-axis for composite assignments.
            kept = None
            for sub in ax:
                s = _axis_size(mesh, sub)
                if s and shape[i] % s == 0 and shape[i] >= s:
                    kept = sub
                    break
            out.append(kept)
        else:
            out.append(None)
    # pad to rank
    out += [None] * (len(shape) - len(out))
    return P(*out)


def _path_names(path) -> list[str]:
    """The names along a path: :func:`~repro_torch.tree.map_with_path`'s
    keys and indices, or the reference's key objects (``.key``, ``.idx``,
    ``.name``)."""
    names = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                names.append(str(getattr(p, attr)))
                break
        else:
            names.append(str(p))
    return names


# name -> (which effective dim gets the model axis), by effective rank.
# eff rank counts dims after stripping the scan axis.
_RULES: dict[str, dict[int, int]] = {
    # attention projections (in, H, hd) — shard heads
    "wq": {3: 1},
    "wk": {3: 1},
    "wv": {3: 1},
    "w_uq": {3: 1},
    "w_uk": {3: 1},
    "w_uv": {3: 1},
    "wo": {3: 0},                 # (H, hd, D)
    # dense mlp
    "w_up": {2: 1, 3: 0},         # (D,F) -> F ; experts (E,D,F) -> E
    "w_gate": {2: 1, 3: 0},
    "w_down": {2: 0, 3: 0},       # (F,D) -> F ; experts (E,F,D) -> E
    # embeddings
    "embed": {2: 0},              # (V, D) -> vocab
    "unembed": {2: 0},
    "vision_proj": {2: 1},
    "mtp_proj": {2: 1},
    # mla low-rank projections
    "w_dq": {2: 1},
    "w_dkv": {2: 0},              # keep latent replicated; shard input dim? no - (D, r): r small
    "w_kr": {2: 0},
    # ssm
    "w_in": {2: 1},               # (D, K) -> inner
    "w_out": {2: 0},              # (K, D) -> inner
    "w_if": {2: 1},
    "w_q": {3: 1},
    "w_k": {3: 1},
    "w_v": {3: 1},
    "w_gates": {2: 1},
    "r_gates": {2: 1},
}
# names we always replicate
_REPLICATED = {
    "router", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
    "scale", "bias", "norm_scale", "q_norm", "k_norm", "kv_norm",
}


def param_spec(mesh, cfg: ModelConfig, path, leaf) -> P:
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    scanned = "groups" in names or "enc_groups" in names
    base = 1 if scanned and len(shape) >= 1 else 0
    eff_rank = len(shape) - base
    if name in _REPLICATED or eff_rank <= 1:
        return P(*([None] * len(shape)))
    # xLSTM: q/k/v shard their head dim over 'model' (the mLSTM matrix
    # memory C (B, H, hd, hd) inherits it); everything else replicates,
    # the embeddings keep their vocabulary sharding.
    if cfg.arch_type == "ssm" and name not in ("embed", "unembed"):
        if name in ("w_q", "w_k", "w_v") and eff_rank == 3:
            spec = [None] * len(shape)
            spec[base + 2] = MODEL_AXIS
            return guard(mesh, P(*spec), shape)
        return P(*([None] * len(shape)))
    rule = _RULES.get(name)
    spec = [None] * len(shape)
    if rule and eff_rank in rule:
        axis = MODEL_AXIS
        if (
            eff_rank == 3
            and name in ("w_up", "w_gate", "w_down")
            and cfg.moe.num_experts
            and cfg.ep_axis is not None
        ):
            axis = cfg.ep_axis  # expert dim follows the EP layout
        spec[base + rule[eff_rank]] = axis
    spec = guard(mesh, P(*spec), shape)
    if getattr(cfg, "fsdp", False):
        # FSDP: big leaves also shard over 'data' (weights gathered per
        # layer at use). The 16 MiB threshold keeps norms and biases whole.
        if math.prod(shape) * 2 >= 16 * 2**20:
            spec = zero_spec(mesh, spec, shape)
    return spec


def shard_params(mesh, cfg: ModelConfig, params_tree):
    """Tree of :class:`NamedSharding` matching an (abstract) params tree."""
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(mesh, cfg, path, leaf)),
        params_tree,
    )


def zero_spec(mesh, spec: P, shape: tuple[int, ...]) -> P:
    """ZeRO-1: additionally shard optimizer moments over 'data' on the
    largest still-replicated divisible dim."""
    d = _axis_size(mesh, DATA_AXIS)
    if not d:
        return spec
    flat = [
        a
        for entry in spec
        if entry is not None
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,))
    ]
    if DATA_AXIS in flat:
        return spec
    spec_l = list(spec) + [None] * (len(shape) - len(spec))
    cand = [
        (shape[i], i)
        for i in range(len(shape))
        if spec_l[i] is None and shape[i] % d == 0 and shape[i] >= d
    ]
    if cand:
        _, i = max(cand)
        spec_l[i] = DATA_AXIS
    return P(*spec_l)


def shard_opt_state(mesh, cfg: ModelConfig, params_tree, opt_template=None) -> AdamWState:
    """Shardings for :class:`~repro_torch.optim.adamw.AdamWState` given the
    params' specs: each moment the ZeRO spec of its parameter's."""
    m_sh = map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, zero_spec(mesh, param_spec(mesh, cfg, path, leaf), tuple(leaf.shape))),
        params_tree,
    )
    return AdamWState(
        step=NamedSharding(mesh, P()),
        m=m_sh,
        v=tree_map(lambda s: s, m_sh),
    )


# --------------------------------------------------------------------- #
# activations / inputs / caches
# --------------------------------------------------------------------- #
def batch_spec(mesh, shape: tuple[int, ...]) -> P:
    return guard(mesh, P(batch_axes(mesh)), tuple(shape))


def shard_batch(mesh, batch_tree):
    return tree_map(lambda leaf: NamedSharding(mesh, batch_spec(mesh, leaf.shape)), batch_tree)


def cache_spec(mesh, cfg: ModelConfig, path, leaf, *, seq_shard: bool = False) -> P:
    """KV and state caches: (count, B, S, H, hd) etc.

    Default: batch over ('pod', 'data'), the sequence of K/V and MLA
    latents over 'model' (the flash-decode layout: kv-head counts rarely
    divide the model axis, the sequence always does). ``seq_shard``
    (long_500k, batch 1): the sequence over ('data', 'model') instead.
    """
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    spec = [None] * len(shape)
    if len(shape) >= 2:
        spec[1] = batch_axes(mesh)  # batch dim after scan axis
    if name in ("k", "v", "ck", "cv") and len(shape) == 5:
        if seq_shard:
            spec[1] = None
            spec[2] = (DATA_AXIS, MODEL_AXIS)
        else:
            spec[2] = MODEL_AXIS
    elif name in ("c", "kr") and len(shape) == 4:
        # MLA latent: (count, B, S, r)
        if seq_shard:
            spec[1] = None
            spec[2] = (DATA_AXIS, MODEL_AXIS)
        else:
            spec[2] = MODEL_AXIS
    elif name in ("C",) and len(shape) == 5:
        spec[2] = MODEL_AXIS      # (count, B, H, hd, hd)
    elif name in ("ssm",) and len(shape) == 5:
        spec[2] = MODEL_AXIS      # (count, B, H, hd, N)
    return guard(mesh, P(*spec), shape)


def shard_cache(mesh, cfg: ModelConfig, cache_tree, *, seq_shard=False):
    return map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_spec(mesh, cfg, path, leaf, seq_shard=seq_shard)),
        cache_tree,
    )


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #
class NamedSharding:
    """A :class:`P` on a mesh: ``placements`` are the DTensor placements
    it means, one per mesh dim (``Shard(tensor dim)`` or ``Replicate()``)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({axis_sizes(self.mesh)}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        axes = list(axis_sizes(self.mesh))
        dim_of = {}
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            unknown = [n for n in names if n not in axes]
            if unknown:
                raise ValueError(f"{self.spec!r}: axes {unknown} are not in the mesh {axes}")
            order = [axes.index(n) for n in names]
            if order != sorted(order):
                raise ValueError(
                    f"{self.spec!r}: the composite entry {entry!r} must name its axes in "
                    f"the mesh's order {tuple(axes)}: DTensor shards one tensor dim "
                    "over several mesh dims major to minor in mesh order")
            for n in names:
                if n in dim_of:
                    raise ValueError(f"{self.spec!r}: axis {n!r} shards two dims")
                dim_of[n] = dim
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in axes)


def place(tree, shardings):
    """Each leaf of ``tree`` as a DTensor laid out by the matching
    :class:`NamedSharding` of ``shardings`` (a tree of the same structure,
    or one sharding for every leaf): the counterpart of
    ``jax.device_put(tree, shardings)``. Every rank passes the same whole
    tensors; ``.to_local()`` of a leaf is the rank's block."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: _place(t, shardings), tree)
    return tree_map(_place, tree, shardings)


def _place(t: torch.Tensor, sharding: NamedSharding):
    return distribute_tensor(t, sharding.mesh, sharding.placements)
