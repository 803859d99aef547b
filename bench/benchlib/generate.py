"""The benchmark's graphs, made on the device from ``--seed``.

A frozen copy, rewritten in torch, of the degree-corrected stochastic
block model (DC-SBM) recipe of ``src/repro_torch/graph/generate.py``
(``_dcsbm_edges``, ``_to_csr`` and the label, feature and train-split
draws of ``generate``): communities of about 300 nodes, Zipf-weighted
degrees within each community, intra-community edges with probability
``intra_prob``, a symmetrised and deduplicated CSR without self loops,
labels tied to the communities with a tenth flipped, features around
one centroid per class, and a train split. The draws run on a
``torch.Generator`` on the device in a few large calls, so the same seed
gives the same graph on the same kind of device; they are not numpy's
draws, so the graph is not the program's own ``generate`` output for
that seed.

One departure from the recipe: the original draws ``num_edges`` pairs
and keeps what survives deduplication. Here the draws repeat, for the
shortfall, until ``num_edges`` distinct undirected edges are there, and
that many are kept, so the graph has the configuration's average degree
(``2 * num_edges / num_nodes``) and not a lower one.

Every size is the configuration file's (``bench/configs/``):
``num_nodes``, ``num_edges`` (undirected) and ``train_nodes``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GraphArrays:
    """The generated graph as host arrays, the form the program takes."""

    indptr: np.ndarray       # (N + 1,) int64
    indices: np.ndarray      # (2E,) int64, both directions, sorted per row
    features: np.ndarray     # (N, F) float32
    labels: np.ndarray       # (N,) int32
    train_nodes: np.ndarray  # (T,) int64, sorted
    communities: np.ndarray  # (N,) int32, sorted
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1


def sizes(cfg: dict) -> dict:
    """Node, undirected edge, community and train counts of a
    configuration; communities hold about 300 nodes, as in the recipe."""
    n = int(cfg["num_nodes"])
    return dict(
        n=n,
        num_edges=int(cfg["num_edges"]),
        num_communities=max(16, n // 300),
        n_train=int(cfg["train_nodes"]),
    )


#: Rounds of draws for the edges that deduplication removed.
MAX_ROUNDS = 64


def _draw_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn by inverse transform: the first ``i`` with
    ``cdf[i] > u``."""
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(cdf) - 1)


def communities(n, num_comm, zipf_s, gen, device):
    """``(comm, starts, ends, cdf, cdf0)``: the sorted community of every
    node, each community's stretch, and the cumulative Zipf weights of
    a random rank within it (the recipe of ``_dcsbm_edges``)."""
    comm = torch.randint(0, num_comm, (n,), generator=gen, device=device).sort().values
    starts = torch.searchsorted(comm, torch.arange(num_comm, device=device))
    ends = torch.searchsorted(comm, torch.arange(num_comm, device=device), right=True)
    # A random rank within each community: order by (community, key).
    key = torch.rand(n, generator=gen, device=device)
    order = torch.argsort(key)
    order = order[torch.argsort(comm[order], stable=True)]
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[order] = torch.arange(n, device=device) - starts[comm[order]] + 1
    cdf = torch.cumsum(rank.to(torch.float64) ** (-zipf_s), 0)
    cdf0 = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), cdf])
    return comm, starts, ends, cdf, cdf0


def draw_pairs(m, comm, starts, ends, cdf, cdf0, intra_prob, gen):
    """``m`` DC-SBM pairs ``(src, dst)``: Zipf-weighted endpoints, the
    destination inside the source's community with ``intra_prob``."""
    device = cdf.device
    total = cdf[-1]
    u = torch.rand(3, m, generator=gen, device=device, dtype=torch.float64)
    src = _draw_cdf(cdf, u[0] * total)
    intra = torch.rand(m, generator=gen, device=device) < intra_prob
    dst = _draw_cdf(cdf, u[1] * total)
    # Intra-community destinations: the same Zipf weights restricted to
    # the source's community, by inverse transform over its stretch of
    # the cumulative sum.
    c = comm[src]
    lo, hi = cdf0[starts[c]], cdf0[ends[c]]
    local = _draw_cdf(cdf, lo + u[2] * (hi - lo))
    local = torch.minimum(torch.maximum(local, starts[c]), ends[c] - 1)
    return src, torch.where(intra, local, dst)


def dcsbm_edges(n, num_edges, num_comm, intra_prob, zipf_s, gen, device):
    """``(keys, comm)``: exactly ``num_edges`` distinct undirected edges
    without self loops, each as ``lo * n + hi`` with ``lo < hi``, sorted,
    and the sorted community of every node."""
    comm, starts, ends, cdf, cdf0 = communities(n, num_comm, zipf_s, gen, device)
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    drawn = 0
    for _ in range(MAX_ROUNDS):
        need = num_edges - len(keys)
        if need <= 0:
            break
        # Draw for the shortfall at the rate at which draws have survived.
        m = need if drawn == 0 else int(need * drawn / max(len(keys), 1) * 1.1) + 1024
        src, dst = draw_pairs(m, comm, starts, ends, cdf, cdf0, intra_prob, gen)
        drawn += m
        keep = src != dst
        lo, hi = torch.minimum(src, dst)[keep], torch.maximum(src, dst)[keep]
        keys = torch.unique(torch.cat([keys, lo * n + hi]), sorted=True)
        del src, dst, keep, lo, hi
    if len(keys) < num_edges:
        raise ValueError(f"{len(keys)} distinct edges after {MAX_ROUNDS} rounds, "
                         f"fewer than {num_edges}")
    pick = torch.randperm(len(keys), generator=gen, device=device)[:num_edges]
    return keys[pick].sort().values, comm


def to_csr(n, keys):
    """The symmetric CSR of undirected ``keys`` (``_to_csr``)."""
    lo, hi = keys // n, keys % n
    s = torch.cat([lo, hi])
    d = torch.cat([hi, lo])
    key = (s * n + d).sort().values
    s, d = key // n, key % n
    counts = torch.bincount(s, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr, d


def generate(cfg: dict, seed: int, device) -> GraphArrays:
    """The configuration's graph from ``seed``, drawn on ``device`` and
    returned as host arrays."""
    g = cfg["generator"]
    sz = sizes(cfg)
    n = sz["n"]
    num_classes = int(cfg["num_classes"])
    feature_dim = int(cfg["feature_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        keys, comm = dcsbm_edges(
            n, sz["num_edges"], sz["num_communities"], g["intra_prob"],
            g["zipf_s"], gen, device,
        )
        indptr, indices = to_csr(n, keys)
        del keys
        labels = comm % num_classes
        flip = torch.rand(n, generator=gen, device=device) < 0.1
        redraw = torch.randint(0, num_classes, (n,), generator=gen, device=device)
        labels = torch.where(flip, redraw, labels)
        centroids = torch.randn(num_classes, feature_dim, generator=gen, device=device)
        noise = torch.randn(n, feature_dim, generator=gen, device=device)
        features = centroids[labels].add_(noise.mul_(0.6))
        del noise
        train = torch.randperm(n, generator=gen, device=device)[: sz["n_train"]].sort().values
        out = GraphArrays(
            indptr=indptr.cpu().numpy(),
            indices=indices.cpu().numpy(),
            features=features.cpu().numpy(),
            labels=labels.to(torch.int32).cpu().numpy(),
            train_nodes=train.cpu().numpy(),
            communities=comm.to(torch.int32).cpu().numpy(),
            num_classes=num_classes,
        )
    return out


def init_weights(feature_dim, hidden_dim, num_classes, seed, device):
    """GraphSAGE's initial parameters from ``seed`` on ``device``, in the
    layout ``(layer1.w_self, layer1.w_nbr, layer1.bias, layer2.w_self,
    layer2.w_nbr, layer2.bias)``: Glorot-normal weights and zero biases
    (the rule of ``init_sage`` in ``src/repro_torch/gnn/sage.py``), in
    float32, two calls of the device generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5A6E)
    out = []
    for a, b in ((feature_dim, hidden_dim), (hidden_dim, num_classes)):
        std = (2.0 / (a + b)) ** 0.5
        w = torch.randn(2, a, b, generator=gen, device=device) * std
        out += [w[0].contiguous(), w[1].contiguous(), torch.zeros(b, device=device)]
    return out
