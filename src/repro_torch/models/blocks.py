"""Per-layer block dispatch: init / cache / sequence forward / decode step.

Counterpart of the reference's ``repro.models.blocks``, every kind:

  attn / attn_global  — GQA + MLP (pre-norm, optional post-norm)
  attn_local          — GQA with sliding window
  dense               — MLA attention + dense MLP (DeepSeek first-k)
  moe                 — MLA/GQA attention + MoE FFN
  mamba2              — Mamba2 mixer (no separate MLP)
  mlstm / slstm       — xLSTM cells
  shared_attn         — Zamba2 shared transformer block (weights shared
                        across occurrences, at the model's
                        ``shared_block``; each slot holds only its norms)
  enc                 — bidirectional attention + MLP (Whisper encoder)
  dec                 — causal self-attn + cross-attn + MLP (Whisper)
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import ssm
from .common import apply_norm, dtype_of, make_norm_params
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_apply

#: The recurrent mixers: (init, sequence form, decode form, state init).
_SSM = {
    "mamba2": (ssm.init_mamba2, ssm.mamba2_forward, ssm.mamba2_decode, ssm.mamba2_init_state),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_forward, ssm.mlstm_decode, ssm.mlstm_init_state),
    "slstm": (ssm.init_slstm, ssm.slstm_forward, ssm.slstm_decode, ssm.slstm_init_state),
}


def _uses_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.attn_type == "mla" and kind in ("dense", "moe", "attn")


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
    if kind == "dec":
        p["norm_cross"] = make_norm_params(cfg, dev)
        p["cross"] = attn.init_gqa(cfg, gen)
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
    memory_kv: tuple | None = None,
    force_local: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss). ``shared`` is the model's ``shared_block``
    (read by the ``shared_attn`` kind only); ``memory_kv`` the encoder's
    keys and values (``cross_memory``) a ``dec`` layer attends to after
    its self attention."""
    if kind == "shared_attn":
        x = _shared(cfg, shared, x, lambda h: attn.gqa_forward(cfg, shared["mixer"], h,
                                                               positions))
        return x, _zero(x)
    h = apply_norm(cfg, p["norm1"], x)
    if kind in _SSM:
        return _residual(cfg, p, x, _SSM[kind][1](cfg, p["mixer"], h), "post_norm1"), _zero(x)
    if _uses_mla(cfg, kind):
        a = attn.mla_forward(cfg, p["mixer"], h, positions)
    elif kind == "enc":
        a = attn.gqa_forward(cfg, p["mixer"], h, positions, causal=False)
    else:
        a = attn.gqa_forward(cfg, p["mixer"], h, positions,
                             window=_window(cfg, kind, force_local))
    x = _residual(cfg, p, x, a, "post_norm1")
    if kind == "dec":
        x = x + attn.cross_forward(cfg, p["cross"], apply_norm(cfg, p["norm_cross"], x),
                                   *memory_kv)
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
    slot's are the full length's); a ``dec`` layer also holds the
    encoder's keys and values ``ck`` / ``cv`` of ``cfg.encoder_seq``
    positions, which :func:`repro_torch.models.model.prefill_cross_cache`
    fills."""
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
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }
    if kind == "dec":
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["ck"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cv"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


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
    if kind == "dec":
        x = x + attn.cross_forward(cfg, p["cross"], apply_norm(cfg, p["norm_cross"], x),
                                   cache["ck"], cache["cv"])
    h = apply_norm(cfg, p["norm2"], x)
    f, _ = _ffn(cfg, kind, p, h)
    return _residual(cfg, p, x, f, "post_norm2"), cache
