"""Feed-forward variants: SwiGLU / GeGLU / GELU / squared-ReLU.

Counterpart of the reference's ``repro.models.mlp``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dtype_of, init_dense, normal
from .config import ModelConfig


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    params = {
        "w_up": init_dense(gen, d, f, dt),
        "w_down": normal(gen, (f, d), (1.0 / f) ** 0.5, dt),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        params["w_gate"] = init_dense(gen, d, f, dt)
    return params


def mlp_forward(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]
