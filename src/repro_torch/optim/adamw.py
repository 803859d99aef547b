"""AdamW with configurable moment dtype.

Counterpart of the reference's ``repro.optim.adamw``, with its
arithmetic: the global gradient norm in float32 over all leaves, each
gradient scaled in float32 and cast back to its dtype, then ``m``, ``v``,
the bias corrections (``b ** step`` as a float32 power), the step and
the decay in float32, cast back to the parameter's and the moments'
dtypes. Moments default to float32; DeepSeek-V3 keeps them in bf16
(``cfg.opt_dtype``).

Unlike the reference's pure function, :func:`adamw_update` writes the
new parameters and moments into the given tensors and returns the same
trees: a second copy of DeepSeek-V3's 4.29 B parameters and moments
would not fit beside them. It also works through large leaves in row
blocks of :data:`CHUNK` elements, so that the float32 temporaries stay a
few hundred MB (one float32 copy of DeepSeek-V3's embedding is 3.7 GB, of
a stack of Phi-3.5-MoE's experts 3.4 GB).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..tree import flatten, tree_map

#: Elements per row block of the update's float32 temporaries.
CHUNK = 1 << 24

class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def adamw_init(params, moment_dtype="float32") -> AdamWState:
    """Zero moments in ``moment_dtype`` (a name, as ``cfg.opt_dtype``, or
    a torch dtype) and step 0 (int32), on the parameters' devices."""
    dt = getattr(torch, moment_dtype) if isinstance(moment_dtype, str) else moment_dtype

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(iter(flatten(params)[0]), torch.empty(0)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _blocks(*tensors):
    """Blocks of at most :data:`CHUNK` elements of tensors of one shape:
    row blocks of their 2-D views (all leading axes flattened; views, so
    that writing a block writes the tensor)."""
    t = tensors[0]
    if t.numel() <= CHUNK:
        yield tensors
        return
    flat = [x.view(-1, x.shape[-1]) for x in tensors]
    rows = max(1, CHUNK // t.shape[-1])
    for r0 in range(0, flat[0].shape[0], rows):
        yield tuple(x[r0 : r0 + rows] for x in flat)


def _same_structure(spec, tree, what: str) -> list:
    leaves, other = flatten(tree)
    if other != spec:
        raise ValueError(f"{what} do not have the parameters' structure")
    return leaves


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float | torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: float = 1.0,
):
    """One AdamW step. Returns ``(params, state)``: the same parameter and
    moment tensors, updated in place, and the next step count."""
    step = state.step + 1
    flat_p, spec = flatten(params)
    flat_g = [g.contiguous() for g in _same_structure(spec, grads, "grads")]
    flat_m = _same_structure(spec, state.m, "moments m")
    flat_v = _same_structure(spec, state.v, "moments v")
    f32 = torch.float32

    scale = None
    if grad_clip > 0:
        sq = [
            sum(torch.sum(torch.square(gb.to(f32))) for (gb,) in _blocks(g))
            for g in flat_g
        ]
        gnorm = torch.sqrt(sum(sq))
        scale = torch.clamp(gnorm.new_tensor(grad_clip) / torch.clamp(gnorm, min=1e-9), max=1.0)

    stepf = step.to(f32)
    bc1 = 1 - torch.pow(stepf.new_tensor(b1), stepf)
    bc2 = 1 - torch.pow(stepf.new_tensor(b2), stepf)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        for pb, gb, mb, vb in _blocks(p, g, m, v):
            # The reference's expressions, each rounded where it rounds
            # them; float32 blocks are updated in place, others through
            # one float32 copy each.
            g32 = gb.to(f32)
            if scale is not None:
                g32 = (g32 * scale).to(gb.dtype).to(f32)
            m32 = mb.to(f32).mul_(b1).add_(g32 * (1 - b1))
            v32 = vb.to(f32).mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            denom = torch.sqrt(v32 / bc2).add_(eps)
            delta = (m32 / bc1).div_(denom)
            p32 = pb.to(f32)
            delta.add_(weight_decay * p32)
            pb.copy_(p32.sub_(delta.mul_(lr)))
            mb.copy_(m32)
            vb.copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """``schedule(step) -> lr``: linear warm-up, then a cosine to 0 at
    ``total_steps`` (float32, as the reference's)."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(progress, 0.0, 1.0)))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return schedule
