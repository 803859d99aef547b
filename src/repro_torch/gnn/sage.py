"""GraphSAGE (mean aggregator) as a PyTorch module.

The 2-layer model of the reference's ``gnn/sage.py`` over sampled
neighborhood trees (node classification, fanout {10, 25}, batch 2000 at
full scale), with the same parameter layout — per layer ``w_self (F,
H)``, ``w_nbr (F, H)`` and ``bias (H,)`` — so parameters carry across
between the two packages (:func:`params_from_jax`). The forward
consumes the dense padded blocks of the sampler:

    x_seed : (B, F)          seed features
    x_n1   : (B, f1, F)      sampled neighbors of seeds
    x_n2   : (B, f1, f2, F)  sampled neighbors of those neighbors

Aggregation is a mean over the fanout axis; gradients come from
autograd.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

#: Parameter names in the reference's ``SageParams`` leaf order.
PARAM_NAMES = (
    "layer1.w_self",
    "layer1.w_nbr",
    "layer1.bias",
    "layer2.w_self",
    "layer2.w_nbr",
    "layer2.bias",
)


class SageLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w_self = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.w_nbr = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x_self: torch.Tensor, x_nbr_mean: torch.Tensor):
        return x_self @ self.w_self + x_nbr_mean @ self.w_nbr + self.bias


class GraphSAGE(nn.Module):
    """Two mean-aggregator SAGE layers; ``forward`` returns logits."""

    def __init__(self, feature_dim: int, hidden_dim: int, num_classes: int):
        super().__init__()
        self.layer1 = SageLayer(feature_dim, hidden_dim)
        self.layer2 = SageLayer(hidden_dim, num_classes)

    def forward(self, x_seed, x_n1, x_n2) -> torch.Tensor:
        # Layer 1 applied to every node that layer 2 will read.
        h_n1 = F.relu(self.layer1(x_n1, x_n2.mean(dim=2)))      # (B, f1, H)
        h_seed = F.relu(self.layer1(x_seed, x_n1.mean(dim=1)))  # (B, H)
        return self.layer2(h_seed, h_n1.mean(dim=1))            # (B, classes)

    def loss(self, x_seed, x_n1, x_n2, labels) -> torch.Tensor:
        logp = F.log_softmax(self(x_seed, x_n1, x_n2), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()

    def loss_and_grads(self, x_seed, x_n1, x_n2, labels):
        """``(loss, grads)`` with grads in :meth:`parameters` order; the
        module's own ``.grad`` fields are left untouched."""
        loss = self.loss(x_seed, x_n1, x_n2, labels)
        grads = torch.autograd.grad(loss, list(self.parameters()))
        return loss.detach(), list(grads)

    @torch.no_grad()
    def accuracy(self, x_seed, x_n1, x_n2, labels) -> float:
        logits = self(x_seed, x_n1, x_n2)
        return float((logits.argmax(-1) == labels).to(torch.float32).mean())


def init_sage(
    feature_dim: int,
    hidden_dim: int,
    num_classes: int,
    generator: torch.Generator | None = None,
) -> GraphSAGE:
    """Glorot-normal weights and zero biases, as the reference's
    ``init_sage`` — from a torch generator, so the numbers differ from
    the reference's ``jax.random`` draws (use :func:`params_from_jax` to
    start from the reference's parameters)."""
    model = GraphSAGE(feature_dim, hidden_dim, num_classes)
    with torch.no_grad():
        for layer in (model.layer1, model.layer2):
            a, b = layer.w_self.shape
            std = (2.0 / (a + b)) ** 0.5
            for w in (layer.w_self, layer.w_nbr):
                w.copy_(torch.randn(a, b, generator=generator) * std)
    return model


def params_from_jax(tree) -> GraphSAGE:
    """A :class:`GraphSAGE` holding the reference's parameters.

    ``tree`` is the reference's ``SageParams`` with numpy leaves (for
    instance ``jax.tree_util.tree_map(np.asarray, params)``), or any
    nesting ``tree[0|"layer1"][0|"w_self"]`` of arrays in the same
    layout."""

    def leaf(layer, i, name):
        node = getattr(tree, layer, None)
        if node is None:
            node = tree[0 if layer == "layer1" else 1]
        value = getattr(node, name, None)
        return np.array(node[i] if value is None else value, dtype=np.float32)

    w1 = leaf("layer1", 0, "w_self")
    w2 = leaf("layer2", 0, "w_self")
    model = GraphSAGE(w1.shape[0], w1.shape[1], w2.shape[1])
    with torch.no_grad():
        for layer in ("layer1", "layer2"):
            mod = getattr(model, layer)
            for i, name in enumerate(("w_self", "w_nbr", "bias")):
                getattr(mod, name).copy_(torch.from_numpy(leaf(layer, i, name)))
    return model
