"""Mixture-of-Experts layer.

Counterpart of the single-device half of the reference's
``repro.models.moe``: DeepSeek-V3 (1 shared + 256 routed experts, top-8,
gates normalised over the selected experts) and Phi-3.5-MoE (16 routed,
top-2). The router runs in float32 and returns the Switch-style
load-balance auxiliary loss.

``moe_forward`` is the dropless dispatch. The token copies are sorted by
expert (stably, as ``jnp.argsort``) and the three expert products run as
``torch._grouped_mm`` over the sorted rows, with the group offsets
(cumulated ``bincount``) computed on the device: nothing is read back to
the host, and an expert with no rows is never read. (The reference's
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

The expert-parallel paths (``moe_forward_ep``, ``_moe_local_body``,
``_moe_local_body_a2a``) run over several devices under ``shard_map``
and wait for ROADMAP Queue A item 5e: :func:`moe_apply` with
``cfg.ep_axis`` set raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    offs = torch.cumsum(torch.bincount(flat_expert, minlength=m.num_experts), 0)
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


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """The single-device dispatch; expert parallelism (``cfg.ep_axis``)
    is not ported."""
    if cfg.ep_axis:
        raise NotImplementedError(
            f"expert parallelism over several devices (ep_axis={cfg.ep_axis!r}: "
            "moe_forward_ep, _moe_local_body, _moe_local_body_a2a) is not ported yet "
            "(ROADMAP Queue A item 5e)"
        )
    return moe_forward(cfg, params, x)
