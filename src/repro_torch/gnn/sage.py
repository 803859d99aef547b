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

The two feature means over the fanout axes go through the hand-written
``segment_sum_equal`` kernel (``kernels/ops.py``; the plain version on
the CPU) times ``1 / k``, as the plain ``gather_mean`` rounds;
:meth:`GraphSAGE.forward_aggregated` takes the layer-2-neighbour mean
ready-made, which the trainer computes straight from its feature table
with ``gather_mean`` and never builds ``x_n2``. The hidden mean
``h_n1.mean`` needs a gradient and stays a ``Tensor.mean``; gradients
come from autograd.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import ops

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
        return self.forward_aggregated(x_seed, x_n1, fanout_mean(x_n2))

    def forward_aggregated(self, x_seed, x_n1, n2_mean) -> torch.Tensor:
        """Logits from the layer-2 neighbours' mean ``n2_mean (B, f1, F)``
        instead of their rows ``x_n2 (B, f1, f2, F)``."""
        # Layer 1 applied to every node that layer 2 will read.
        h_n1 = F.relu(self.layer1(x_n1, n2_mean))                # (B, f1, H)
        h_seed = F.relu(self.layer1(x_seed, fanout_mean(x_n1)))  # (B, H)
        return self.layer2(h_seed, h_n1.mean(dim=1))             # (B, classes)

    def _logits(self, x_seed, x_n1, x_n2, aggregated: bool):
        forward = self.forward_aggregated if aggregated else self.forward
        return forward(x_seed, x_n1, x_n2)

    # With ``aggregated=True`` the third argument of the three methods
    # below is ``n2_mean`` (see :meth:`forward_aggregated`), not ``x_n2``.
    def loss(self, x_seed, x_n1, x_n2, labels, aggregated: bool = False) -> torch.Tensor:
        logp = F.log_softmax(self._logits(x_seed, x_n1, x_n2, aggregated), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()

    def loss_and_grads(self, x_seed, x_n1, x_n2, labels, aggregated: bool = False):
        """``(loss, grads)`` with grads in :meth:`parameters` order; the
        module's own ``.grad`` fields are left untouched."""
        loss = self.loss(x_seed, x_n1, x_n2, labels, aggregated)
        grads = torch.autograd.grad(loss, list(self.parameters()))
        return loss.detach(), list(grads)

    @torch.no_grad()
    def accuracy(self, x_seed, x_n1, x_n2, labels, aggregated: bool = False) -> float:
        logits = self._logits(x_seed, x_n1, x_n2, aggregated)
        return float((logits.argmax(-1) == labels).to(torch.float32).mean())


def fanout_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x (..., k, F)`` over its fanout axis ``k``:
    ``segment_sum_equal`` of the rows times the float32 ``1 / k``, in one
    launch on the card (the scale rides in the kernel's epilogue, so no
    tensor is built from a Python scalar and the stream never waits). It
    rounds as the plain ``gather_mean`` does (so, for float32 features, a
    mean taken from the rows equals one gathered from the table bit for
    bit)."""
    *lead, k, feat = x.shape
    return ops.segment_sum_equal(x.reshape(-1, feat), k, scale=1.0 / k).reshape(*lead, feat)


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
