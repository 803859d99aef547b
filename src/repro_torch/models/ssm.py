"""Recurrent blocks: Mamba2 (SSD), and xLSTM's mLSTM/sLSTM cells.

Counterpart of the reference's ``repro.models.ssm``, on torch tensors.
All three expose a *sequence* form (a loop over time — training and
prefill) and a *step* form (single-token decode carrying explicit state).
The O(1)-per-token decode state is what qualifies these architectures
for the ``long_500k`` shape (524k context, batch 1).

The reference scans one step function over time (``jax.lax.scan``). The
port's sequence forms loop over time in Python with the decode step's
arithmetic, element for element, but take the parts of a step that do
not read the state (the gates, Mamba2's and mLSTM's outer products,
mLSTM's readout) for all steps at once, so that the loop launches a few
operations a step: eager PyTorch pays host time for each. The decode
forms write the new state into the given state tensors in place
(``copy_``) and return the same dict. No layer here reaches a kernel of
the reference: each recurrence is plain PyTorch, as the reference's is
plain ``jnp``.

Rounding is the reference's, op for op, including where its sequence and
decode forms differ: Mamba2's sequence form sums the causal convolution's
products in the inputs' dtype and rounds the scan's output before the
gate, its decode form accumulates the convolution in float32 and gates
in float32. ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``
is (``torch.nn.functional.softplus`` returns ``x`` past its threshold).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from .common import dtype_of, init_dense, normal, rms_norm
from .config import ModelConfig


_CONSTANTS: dict = {}


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``like``'s device and dtype, made once
    per device and dtype (no fill a step)."""
    key = (value, like.device, like.dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.full((), value, dtype=like.dtype, device=like.device)
    return t


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, _const(0.0, x))


def _at_least_one(x: torch.Tensor) -> torch.Tensor:
    """``maximum(x, 1)`` by ``torch.maximum``, whose gradient splits a tie
    in half as ``jnp.maximum``'s does (sLSTM's normaliser is exactly 1
    after its first step)."""
    return torch.maximum(x, _const(1.0, x))


def _write(state: dict, new: dict) -> dict:
    """Copy each new value into the state's tensor of that name."""
    for k, v in new.items():
        state[k].copy_(v)
    return state


# --------------------------------------------------------------------- #
# Mamba2 (simplified SSD: scalar decay per head, groups = 1)
# --------------------------------------------------------------------- #
def mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // cfg.ssm.head_dim
    return d_inner, heads, cfg.ssm.state_dim


def init_mamba2(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    dev = gen.device
    d = cfg.d_model
    d_inner, heads, n = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused in-projection: [x (d_inner), B (n), C (n), z (d_inner), dt (heads)]
        "w_in": init_dense(gen, d, 2 * d_inner + 2 * n + heads, dt),
        "conv_w": normal(gen, (cfg.ssm.conv_width, conv_dim), 0.2, dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, float(heads), heads, **f32)),
        "dt_bias": torch.zeros((heads,), **f32),
        "d_skip": torch.ones((heads,), **f32),
        "w_out": normal(gen, (d_inner, d), (1.0 / d_inner) ** 0.5, dt),
        "norm_scale": torch.zeros((d_inner,), **f32),
    }


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, heads, n = mamba2_dims(cfg)
    xbc = proj[..., : d_inner + 2 * n]
    z = proj[..., d_inner + 2 * n : 2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n :]
    return xbc, z, dt


def _mamba2_gates(cfg, params, xbc, dt_raw):
    """The parts of an SSD step that do not read the state, elementwise
    over any leading axes: the decay (…, H), ``x * dt`` (…, H, hd), the
    float32 ``B`` and ``C`` (…, N), and the skip term ``d_skip * x``."""
    d_inner, heads, n = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    x = xbc[..., :d_inner]
    b_in = xbc[..., d_inner : d_inner + n].to(torch.float32)
    c_in = xbc[..., d_inner + n :].to(torch.float32)
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])          # (…, H)
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)                   # (…, H)
    xh = x.reshape(*x.shape[:-1], heads, hd).to(torch.float32)
    return decay, xh * dt[..., None], b_in, c_in, params["d_skip"][:, None] * xh


def _ssd_update(state, decay, update, c_in):
    """The state's step: (B, H, hd, N) decayed plus ``update``, read by
    ``C``; returns (state, y (B, H, hd))."""
    b, heads, hd, n = state.shape
    state = state * decay[..., None, None] + update
    # einsum("bhkn,bn->bhk") as one batched product.
    y = torch.bmm(state.view(b, heads * hd, n), c_in[..., None]).view(b, heads, hd)
    return state, y


def _outer(xdt, b_in):
    """einsum("bhk,bn->bhkn") over any leading axes: an outer product,
    one rounding per element."""
    return xdt[..., None] * b_in[..., None, None, :]


def _mamba2_step(cfg, params, state, xbc, z, dt_raw):
    """One SSD step. state: (B, H, hd, N); returns (state, y (B, d_inner))."""
    decay, xdt, b_in, c_in, skip = _mamba2_gates(cfg, params, xbc, dt_raw)
    state, y = _ssd_update(state, decay, _outer(xdt, b_in), c_in)
    y = y + skip
    return state, y.reshape(*y.shape[:-2], -1)


def mamba2_forward(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D); causal depthwise conv + SSD scan.

    The scan runs :func:`_mamba2_step`'s arithmetic: the parts that do not
    read the state for every step at once (:func:`_mamba2_gates` and the
    outer product, elementwise), then the state's step
    (:func:`_ssd_update`) over time; each step's inputs are split off once
    (``unbind``: one stack in backward)."""
    b, s, d = x.shape
    d_inner, heads, n = mamba2_dims(cfg)
    proj = x @ params["w_in"]
    xbc, z, dt = _mamba2_split(cfg, proj)
    # Causal depthwise conv over time: a sum of products in x's dtype,
    # each product and partial sum rounded, as the reference's Python sum.
    w = params["conv_w"]
    pad = cfg.ssm.conv_width - 1
    xbc_pad = F.pad(xbc, (0, 0, pad, 0))
    conv = sum(
        xbc_pad[:, i : i + s, :] * w[i][None, None, :]
        for i in range(cfg.ssm.conv_width)
    ) + params["conv_b"][None, None, :]
    conv = F.silu(conv)

    decay, xdt, b_in, c_in, skip = _mamba2_gates(cfg, params, conv, dt)
    update = _outer(xdt, b_in)                         # (B, S, H, hd, N)
    state = torch.zeros((b, heads, cfg.ssm.head_dim, n), dtype=torch.float32, device=x.device)
    ys = []
    for step in zip(*(t.unbind(1) for t in (decay, update, c_in))):
        state, y = _ssd_update(state, *step)
        ys.append(y)
    y = (torch.stack(ys, dim=1) + skip).reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_scale"])
    return y @ params["w_out"]


def mamba2_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_inner, heads, n = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_dim), dtype=dtype_of(cfg),
                            device=device),
        "ssm": torch.zeros((batch, heads, cfg.ssm.head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, state: dict):
    """x: (B, 1, D); O(1) step. ``state`` is updated in place and returned."""
    proj = (x @ params["w_in"])[:, 0]
    xbc, z, dt = _mamba2_split(cfg, proj)
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    # einsum("bwk,wk->bk") in x's dtype: products summed in float32,
    # rounded once.
    conv = (window.to(torch.float32) * params["conv_w"].to(torch.float32)).sum(1).to(x.dtype)
    conv = F.silu(conv + params["conv_b"])
    new_ssm, y = _mamba2_step(cfg, params, state["ssm"], conv, z, dt)
    y = rms_norm(
        (y * F.silu(z.to(torch.float32))).to(x.dtype),
        params["norm_scale"],
    )
    out = (y @ params["w_out"])[:, None, :]
    # The window's tail comes from the concatenation, not from a view of
    # the state it overwrites.
    return out, _write(state, {"conv": window[:, 1:, :], "ssm": new_ssm})


# --------------------------------------------------------------------- #
# mLSTM (xLSTM): matrix memory with exponential gating
# --------------------------------------------------------------------- #
def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = int(cfg.ssm.proj_factor_mlstm * cfg.d_model)
    heads = cfg.num_heads
    hd = d_inner // heads
    return d_inner, heads, hd


def init_mlstm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    d_inner, heads, hd = mlstm_dims(cfg)
    return {
        "w_up": init_dense(gen, d, 2 * d_inner, dt),   # [x_in, z_gate]
        "w_q": init_dense(gen, d_inner, (heads, hd), dt),
        "w_k": init_dense(gen, d_inner, (heads, hd), dt),
        "w_v": init_dense(gen, d_inner, (heads, hd), dt),
        "w_if": init_dense(gen, d_inner, 2 * heads, dt),  # i, f pre-acts
        "norm_scale": torch.zeros((d_inner,), dtype=torch.float32, device=gen.device),
        "w_down": normal(gen, (d_inner, d), (1.0 / d_inner) ** 0.5, dt),
    }


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    """``-softplus(-f)``, as the reference writes log sigmoid."""
    return -_softplus(-f)


def _mlstm_gates(log_f, i_pre, m):
    """The stabiliser's step: ``a = log_f + m`` and ``m_new = max(a, i)``;
    the gates are then ``exp(i - m_new)`` (input) and ``exp(a - m_new)``
    (forget)."""
    a = log_f + m
    return a, torch.maximum(a, i_pre)


def _mlstm_read(C, n, q, batch_major=False):
    """einsum("bhkq,bhq->bhk", C, q) and einsum("bhq,bhq->bh", n, q) as
    batched products over any leading axes, and h = num / max(|den|, 1).

    A chunk's stacks ``(ck, B, ...)`` as DTensors (the dry-run's) are
    read batch-major: flattening a time axis before the sharded batch
    axis would leave a strided shard that DTensor's product gathers."""
    if isinstance(q, DTensor) and q.ndim == 4 and not batch_major:
        return _mlstm_read(C.transpose(0, 1), n.transpose(0, 1), q.transpose(0, 1),
                           True).transpose(0, 1)
    *lead, hd = q.shape
    qc = q.reshape(-1, hd, 1)
    num = torch.bmm(C.reshape(-1, hd, hd), qc).view(*lead, hd)
    den = torch.bmm(n.reshape(-1, 1, hd), qc).view(*lead)
    return num / _at_least_one(torch.abs(den))[..., None]


def _mlstm_update(carry, q, k, v, i_pre, log_f):
    """The recurrence of :func:`_mlstm_step`, given ``log sigmoid(f)``."""
    C, n, m = carry
    a, m_new = _mlstm_gates(log_f, i_pre, m)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(a - m_new)
    # einsum("bhk,bhq->bhkq", v, k): an outer product.
    C = C * f_g[..., None, None] + (v[..., :, None] * k[..., None, :]) * i_g[..., None, None]
    n = n * f_g[..., None] + k * i_g[..., None]
    return (C, n, m_new), _mlstm_read(C, n, q)


def _mlstm_step(params, carry, q, k, v, i_pre, f_pre):
    """Stabilised exponential gating (xLSTM eq. 15-19).

    carry: C (B,H,hd,hd), n (B,H,hd), m (B,H).
    """
    return _mlstm_update(carry, q, k, v, i_pre, _log_sigmoid(f_pre))


def _mlstm_qkvif(cfg, params, x_in):
    _, heads, hd = mlstm_dims(cfg)
    q = torch.einsum("...k,khd->...hd", x_in, params["w_q"]).to(torch.float32)
    k = torch.einsum("...k,khd->...hd", x_in, params["w_k"]).to(
        torch.float32
    ) / math.sqrt(hd)
    v = torch.einsum("...k,khd->...hd", x_in, params["w_v"]).to(torch.float32)
    gates = torch.einsum("...k,kh->...h", x_in, params["w_if"]).to(torch.float32)
    return q, k, v, gates[..., :heads], gates[..., heads:]


MLSTM_CHUNK = 64  # time chunk for the nested-checkpoint scan


def _mlstm_chunk(C, n, m, q, k, v, i_pre, log_f):
    """The steps of one chunk (time on axis 0 of the inputs): the carry
    after it and the chunk's outputs (B, ck, H, hd).

    :func:`_mlstm_update`'s arithmetic, element for element, in three
    passes: the stabiliser over the chunk (two small operations a step),
    the gates and the products that do not read the memory for every
    step at once, then the memories' steps (two operations each); the
    readout runs once over the chunk.

    DTensor inputs (the dry-run's, the head dim sharded) read the keys
    whole: the memories then keep the values' sharding, where DTensor
    would shard the outer product's time axis and could not step it."""
    if isinstance(k, DTensor):
        k = k.redistribute(k.device_mesh, [p if p.is_shard(1) else Replicate()
                                           for p in k.placements])
    a_s, m_s = [], []
    for lf, ip in zip(log_f.unbind(0), i_pre.unbind(0)):
        a, m = _mlstm_gates(lf, ip, m)
        a_s.append(a)
        m_s.append(m)
    a, m_all = torch.stack(a_s), torch.stack(m_s)
    i_g = torch.exp(i_pre - m_all)
    f_g = torch.exp(a - m_all)
    vk = (v[..., :, None] * k[..., None, :]) * i_g[..., None, None]   # (ck, B, H, hd, hd)
    kn = k * i_g[..., None]
    Cs, ns = [], []
    for f_t, vk_t, kn_t in zip(f_g.unbind(0), vk.unbind(0), kn.unbind(0)):
        C = C * f_t[..., None, None] + vk_t
        n = n * f_t[..., None] + kn_t
        Cs.append(C)
        ns.append(n)
    h = _mlstm_read(torch.stack(Cs), torch.stack(ns), q)             # (ck, B, H, hd)
    return C, n, m, h.transpose(0, 1)


def mlstm_forward(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Chunked scan: the steps run in chunks of :data:`MLSTM_CHUNK` (of 1
    where the sequence is not a multiple of it), as the reference's outer
    scan over its checkpointed inner scans. Whenever autograd records,
    each chunk keeps only its inputs for backward and runs again there
    (``torch.utils.checkpoint``): without it every step's matrix memory C
    (B, H, hd, hd) would be saved; the numbers are the loop's without it.
    The forget gates' log-sigmoid
    is taken for every step at once (elementwise, as in
    :func:`_mlstm_step`)."""
    b, s, d = x.shape
    d_inner, heads, hd = mlstm_dims(cfg)
    up = x @ params["w_up"]
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, params, x_in)
    # Time-major, so that each step's (B, H, ...) slice is contiguous.
    steps = tuple(t.transpose(0, 1).contiguous()
                  for t in (q, k, v, i_pre, _log_sigmoid(f_pre)))

    f32 = dict(dtype=torch.float32, device=x.device)
    C = torch.zeros((b, heads, hd, hd), **f32)
    n = torch.zeros((b, heads, hd), **f32)
    m = torch.full((b, heads), -1e30, **f32)

    ck = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else 1
    remat = torch.is_grad_enabled()
    hs = []
    for t0 in range(0, s, ck):
        inputs = tuple(t[t0 : t0 + ck] for t in steps)
        if remat:
            C, n, m, h = checkpoint(_mlstm_chunk, C, n, m, *inputs,
                                    use_reentrant=False, preserve_rng_state=False)
        else:
            C, n, m, h = _mlstm_chunk(C, n, m, *inputs)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, s, d_inner).to(x.dtype)
    h = rms_norm(h, params["norm_scale"]) * F.silu(z)
    return h @ params["w_down"]


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    _, heads, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, heads, hd, hd), **f32),
        "n": torch.zeros((batch, heads, hd), **f32),
        "m": torch.full((batch, heads), -1e30, **f32),
    }


def mlstm_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, state: dict):
    """x: (B, 1, D); O(1) step. ``state`` is updated in place and returned."""
    b = x.shape[0]
    d_inner, heads, hd = mlstm_dims(cfg)
    up = (x @ params["w_up"])[:, 0]
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, params, x_in)
    carry = (state["C"], state["n"], state["m"])
    carry, h = _mlstm_step(params, carry, q, k, v, i_pre, f_pre)
    h = h.reshape(b, d_inner).to(x.dtype)
    h = rms_norm(h, params["norm_scale"]) * F.silu(z)
    out = (h @ params["w_down"])[:, None, :]
    return out, _write(state, {"C": carry[0], "n": carry[1], "m": carry[2]})


# --------------------------------------------------------------------- #
# sLSTM (xLSTM): scalar memory with recurrent gate connections
# --------------------------------------------------------------------- #
def init_slstm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    f = int(cfg.ssm.proj_factor_slstm * d)
    return {
        "w_gates": init_dense(gen, d, 4 * d, dt),       # i, f, z, o
        "r_gates": normal(gen, (d, 4 * d), (1.0 / d) ** 0.5, dt),
        "norm_scale": torch.zeros((d,), dtype=torch.float32, device=gen.device),
        "w_up": init_dense(gen, d, 2 * f, dt),
        "w_down": normal(gen, (f, d), (1.0 / f) ** 0.5, dt),
    }


def _slstm_step(params, carry, x_t):
    """carry: c, n, h, m — each (B, D)."""
    c, n, h, m = carry
    pre = (
        x_t @ params["w_gates"] + h.to(x_t.dtype) @ params["r_gates"]
    ).to(torch.float32)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    log_f = -_softplus(-f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = c * f_g + i_g * torch.tanh(z_pre)
    n = n * f_g + i_g
    h_new = torch.sigmoid(o_pre) * c / _at_least_one(n)
    return (c, n, h_new, m_new), h_new


def _slstm_ffn(params, h):
    """The block's gated up/down projection (GELU, tanh form)."""
    f = params["w_up"].shape[-1] // 2
    up = h @ params["w_up"]
    return (F.gelu(up[..., :f], approximate="tanh") * up[..., f:]) @ params["w_down"]


def slstm_forward(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (
        torch.zeros((b, d), **f32),
        torch.zeros((b, d), **f32),
        torch.zeros((b, d), **f32),
        torch.full((b, d), -1e30, **f32),
    )
    hs = []
    for x_t in x.unbind(1):
        carry, h = _slstm_step(params, carry, x_t)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_ffn(params, rms_norm(h, params["norm_scale"]))


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d), **f32),
        "n": torch.zeros((batch, d), **f32),
        "h": torch.zeros((batch, d), **f32),
        "m": torch.full((batch, d), -1e30, **f32),
    }


def slstm_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, state: dict):
    """x: (B, 1, D); O(1) step. ``state`` is updated in place and returned."""
    carry = (state["c"], state["n"], state["h"], state["m"])
    carry, h = _slstm_step(params, carry, x[:, 0])
    out = _slstm_ffn(params, rms_norm(h.to(x.dtype), params["norm_scale"]))[:, None, :]
    return out, _write(state, {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]})
