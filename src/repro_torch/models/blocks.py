"""Per-layer block dispatch: init / cache / sequence forward / decode step.

Counterpart of the reference's ``repro.models.blocks`` for the kinds of
the decoder-only attention, SSM and hybrid architectures:

  attn / attn_global  — GQA + MLP (pre-norm, optional post-norm)
  attn_local          — GQA with sliding window
  dense               — MLA attention + dense MLP (DeepSeek first-k)
  moe                 — MLA/GQA attention + MoE FFN
  mamba2              — Mamba2 mixer (no separate MLP)
  mlstm / slstm       — xLSTM cells
  shared_attn         — Zamba2 shared transformer block (weights shared
                        across occurrences, at the model's
                        ``shared_block``; each slot holds only its norms)

Whisper's ``enc`` / ``dec`` raise ``NotImplementedError``: they wait for
ROADMAP Queue A item 5c (Phi-3-vision's projector, 5d, is refused by
:mod:`repro_torch.models.model`).
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import ssm
from .common import apply_norm, dtype_of, make_norm_params
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_apply

PORTED_KINDS = ("attn", "attn_global", "attn_local", "dense", "moe", "mamba2", "mlstm",
                "slstm", "shared_attn")
#: The recurrent mixers: (init, sequence form, decode form, state init).
_SSM = {
    "mamba2": (ssm.init_mamba2, ssm.mamba2_forward, ssm.mamba2_decode, ssm.mamba2_init_state),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_forward, ssm.mlstm_decode, ssm.mlstm_init_state),
    "slstm": (ssm.init_slstm, ssm.slstm_forward, ssm.slstm_decode, ssm.slstm_init_state),
}
_WAITING = {
    "enc": "Whisper's encoder (ROADMAP Queue A item 5c)",
    "dec": "Whisper's decoder with cross attention (ROADMAP Queue A item 5c)",
}


def _uses_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.attn_type == "mla" and kind in ("dense", "moe", "attn")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: "
            + _WAITING.get(kind, "no such kind in the reference")
        )


def _window(cfg: ModelConfig, kind: str, force_local: bool) -> int:
    """The reference's window rule for a GQA layer (0: full causal)."""
    if kind == "attn_local" or (force_local and kind == "attn_global"):
        return cfg.sliding_window
    if cfg.sliding_window and not cfg.local_global:
        return cfg.sliding_window
    return 0


def _residual(cfg: ModelConfig, p: dict, x, sub_out, post_key: str):
    if cfg.post_norm and post_key in p:
        sub_out = apply_norm(cfg, p[post_key], sub_out)
    return x + sub_out


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(cfg: ModelConfig, kind: str, p: dict, x):
    if kind == "moe":
        return moe_apply(cfg, p["ffn"], x)
    return mlp_forward(cfg, p["ffn"], x), _zero(x)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def init_block(cfg: ModelConfig, kind: str, gen: torch.Generator) -> dict:
    _check_kind(cfg, kind)
    dev = gen.device
    p: dict = {"norm1": make_norm_params(cfg, dev)}
    if cfg.post_norm:
        p["post_norm1"] = make_norm_params(cfg, dev)
    if kind in _SSM:
        p["mixer"] = _SSM[kind][0](cfg, gen)
        return p
    if kind == "shared_attn":
        # Shared weights live at model level; only the per-slot norm here.
        return p
    if _uses_mla(cfg, kind):
        p["mixer"] = attn.init_mla(cfg, gen)
    else:
        p["mixer"] = attn.init_gqa(cfg, gen)
    p["norm2"] = make_norm_params(cfg, dev)
    if cfg.post_norm:
        p["post_norm2"] = make_norm_params(cfg, dev)
    if kind == "moe":
        p["ffn"] = init_moe(cfg, gen)
    elif kind == "dense":
        p["ffn"] = init_mlp(cfg, gen, d_ff=cfg.moe.d_ff_dense)
    else:
        p["ffn"] = init_mlp(cfg, gen)
    return p


def init_shared_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Zamba2's single shared attention+MLP block."""
    dev = gen.device
    return {
        "norm1": make_norm_params(cfg, dev),
        "mixer": attn.init_gqa(cfg, gen),
        "norm2": make_norm_params(cfg, dev),
        "ffn": init_mlp(cfg, gen),
    }


def _shared(cfg: ModelConfig, sp: dict, x, attend):
    """The shared block on ``x``: ``attend(h)`` is its attention (the
    sequence's or the decode step's), then the MLP, both residual. A
    slot's own ``norm1`` is drawn but never read, as in the reference
    (which computes it and drops it): its gradient is 0."""
    x = x + attend(apply_norm(cfg, sp["norm1"], x))
    return x + mlp_forward(cfg, sp["ffn"], apply_norm(cfg, sp["norm2"], x))


# --------------------------------------------------------------------- #
# sequence forward (training / prefill)
# --------------------------------------------------------------------- #
def block_forward(
    cfg: ModelConfig,
    kind: str,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    shared: dict | None = None,
    force_local: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss). ``shared`` is the model's ``shared_block``
    (read by the ``shared_attn`` kind only)."""
    _check_kind(cfg, kind)
    if kind == "shared_attn":
        x = _shared(cfg, shared, x, lambda h: attn.gqa_forward(cfg, shared["mixer"], h,
                                                               positions))
        return x, _zero(x)
    h = apply_norm(cfg, p["norm1"], x)
    if kind in _SSM:
        return _residual(cfg, p, x, _SSM[kind][1](cfg, p["mixer"], h), "post_norm1"), _zero(x)
    if _uses_mla(cfg, kind):
        a = attn.mla_forward(cfg, p["mixer"], h, positions)
    else:
        a = attn.gqa_forward(cfg, p["mixer"], h, positions,
                             window=_window(cfg, kind, force_local))
    x = _residual(cfg, p, x, a, "post_norm1")
    h = apply_norm(cfg, p["norm2"], x)
    f, aux = _ffn(cfg, kind, p, h)
    return _residual(cfg, p, x, f, "post_norm2"), aux


# --------------------------------------------------------------------- #
# decode step (single token, cache-carrying)
# --------------------------------------------------------------------- #
def init_layer_cache(
    cfg: ModelConfig, kind: str, batch: int, seq: int, long_mode: bool = False,
    device=None,
) -> dict:
    """A layer's initial cache: a recurrent mixer's state (zeros, and the
    xLSTM stabiliser ``m`` at -1e30), or zeros: the MLA latent and rope
    key, or the GQA keys and values of ``seq`` positions (the window's for
    ``attn_local``, for ``attn_global`` under ``long_mode``, and for every
    layer of a windowed model that is not local/global; a ``shared_attn``
    slot's are the full length's)."""
    _check_kind(cfg, kind)
    if kind in _SSM:
        return _SSM[kind][3](cfg, batch, device=device)
    dt = dtype_of(cfg)
    if _uses_mla(cfg, kind):
        m = cfg.mla
        return {
            "c": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dt, device=device),
            "kr": torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dt, device=device),
        }
    s = seq
    if kind == "attn_local" or (long_mode and kind == "attn_global"):
        s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    elif cfg.sliding_window and not cfg.local_global:
        s = min(seq, cfg.sliding_window)
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def block_decode(
    cfg: ModelConfig,
    kind: str,
    p: dict,
    x: torch.Tensor,             # (B, 1, D)
    cache: dict,
    pos: int,
    *,
    shared: dict | None = None,
    force_local: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One token through one layer; the layer's cache is updated in place
    (see :func:`repro_torch.models.attention.mla_decode`,
    :func:`~repro_torch.models.attention.gqa_decode` and the decode forms
    of :mod:`repro_torch.models.ssm`) and returned."""
    _check_kind(cfg, kind)
    if kind == "shared_attn":
        def attend(h):
            a, _, _ = attn.gqa_decode(cfg, shared["mixer"], h, cache["k"], cache["v"], pos)
            return a

        return _shared(cfg, shared, x, attend), cache
    h = apply_norm(cfg, p["norm1"], x)
    if kind in _SSM:
        out, cache = _SSM[kind][2](cfg, p["mixer"], h, cache)
        return _residual(cfg, p, x, out, "post_norm1"), cache
    if _uses_mla(cfg, kind):
        a, c, kr = attn.mla_decode(cfg, p["mixer"], h, cache["c"], cache["kr"], pos)
        cache = dict(cache, c=c, kr=kr)
    else:
        a, ck, cv = attn.gqa_decode(cfg, p["mixer"], h, cache["k"], cache["v"], pos,
                                    window=_window(cfg, kind, force_local))
        cache = dict(cache, k=ck, v=cv)
    x = _residual(cfg, p, x, a, "post_norm1")
    h = apply_norm(cfg, p["norm2"], x)
    f, _ = _ffn(cfg, kind, p, h)
    return _residual(cfg, p, x, f, "post_norm2"), cache
