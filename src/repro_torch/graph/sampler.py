"""Neighbor sampling (GraphSAGE-style fanout sampling).

Matches the paper's setup: 2-layer GraphSAGE with fanout {25, 10} —
every seed samples up to 10 neighbors, each of which samples up to 25.
Sampling is with replacement when a node has fewer neighbors than the
fanout (isolated nodes fall back to self-loops), which yields dense
``(batch, fanout)`` index blocks that JAX consumes without masking.

The sampler also reports the **unique sampled nodes** of the minibatch —
the set the prefetcher intersects with the persistent buffer to compute
%-Hits and the remote fetch list (Algorithm 1, lines 10-11/17).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .generate import Graph


@dataclass
class MiniBatch:
    seeds: np.ndarray            # (B,) local CSR indices
    layer_nbrs: list[np.ndarray]  # [(B, f1), (B*f1, f2), ...] local
    #: All distinct node ids touched, as *global* ids
    #: (``graph.id_base`` + local index); None on the device-native raw
    #: path (``SamplerPlane.sample_all_raw``), where dedup happens
    #: in-launch.
    unique_nodes: np.ndarray | None
    labels: np.ndarray           # (B,)


def _gather_neighbors(
    g: Graph, nodes: np.ndarray, deg: np.ndarray, offs: np.ndarray
) -> np.ndarray:
    """Resolve per-node fanout offsets against the CSR (any leading shape).

    ``offs[..., k] < deg`` whenever ``deg > 0`` (the uniform draw is
    scaled by the degree) and :class:`repro_torch.graph.generate.Graph` asserts
    the CSR invariants at construction, so no bounds clamping is applied
    — a corrupt CSR fails there instead of silently redirecting draws to
    the global last edge. Degree-0 nodes read slot 0 and are overwritten
    by the self-loop fallback.
    """
    has_nbrs = deg[..., None] > 0
    if len(g.indices) == 0:  # edgeless graph: everything self-loops
        return np.broadcast_to(nodes[..., None], offs.shape).copy()
    idx = g.indptr[nodes][..., None] + offs
    nbrs = g.indices[np.where(has_nbrs, idx, 0)]
    return np.where(has_nbrs, nbrs, nodes[..., None])


class NeighborSampler:
    def __init__(self, graph: Graph, fanouts: tuple[int, ...] = (10, 25)):
        """``fanouts[0]`` applies to the seeds' hop, ``fanouts[1]`` to the
        next hop (paper: fanout {10, 25})."""
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)

    def _sample_neighbors(
        self, nodes: np.ndarray, fanout: int, rng: np.random.Generator
    ) -> np.ndarray:
        g = self.graph
        deg = g.indptr[nodes + 1] - g.indptr[nodes]
        # Draw fanout offsets per node with replacement; degree-0 nodes
        # self-loop.
        offs = (rng.random((len(nodes), fanout)) * np.maximum(deg, 1)[:, None]).astype(
            np.int64
        )
        return _gather_neighbors(g, nodes, deg, offs)

    def sample(self, seeds: np.ndarray, rng: np.random.Generator) -> MiniBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        frontier = seeds
        layer_nbrs: list[np.ndarray] = []
        touched = [seeds]
        for fanout in self.fanouts:
            nbrs = self._sample_neighbors(frontier, fanout, rng)
            layer_nbrs.append(nbrs)
            frontier = nbrs.reshape(-1)
            touched.append(frontier)
        unique_nodes = np.unique(np.concatenate(touched))
        if self.graph.id_base:
            unique_nodes = unique_nodes + np.int64(self.graph.id_base)
        return MiniBatch(
            seeds=seeds,
            layer_nbrs=layer_nbrs,
            unique_nodes=unique_nodes,
            labels=self.graph.labels[seeds],
        )


def unique_remote(
    minibatch: MiniBatch, part_of: np.ndarray, part: int, id_base: int = 0
) -> np.ndarray:
    """Unique sampled nodes homed on other partitions (the fetch set).

    ``unique_nodes`` carries global ids; ``part_of`` is local-indexed,
    so pass the graph's ``id_base`` when it is nonzero."""
    nodes = minibatch.unique_nodes
    return nodes[part_of[nodes - id_base] != part]


# Re-exported for its long-standing home: the implementation lives in
# repro_torch.kernels.ref so the kernels plane never imports the data
# plane.
from ..kernels.ref import frontier_dedup  # noqa: E402, F401


class SamplerPlane:
    """Batched multi-trainer sampler: every PE's minibatch in one pass.

    The legacy hot path calls :meth:`NeighborSampler.sample` once per
    trainer — P sequential fanout expansions and P ``np.unique`` passes
    per minibatch, the last scalar loop in the vectorized runtime. The
    plane advances all P trainers at once:

    * per-trainer seed blocks stack into a dense ``(P, B)`` array and
      fanout expansion runs on the shared CSR as ``(P, B, f1)`` /
      ``(P, B*f1, f2)`` blocks;
    * the per-trainer ``np.unique`` + remote filter is one fused pass:
      row-sort all P frontiers, then a single first-occurrence +
      remote-membership mask (numpy, or, with ``use_kernels``, the
      fused kernel ``kernels.ops.frontier_unique_batch`` on ``device``:
      the Hopper kernel on a card, its plain version on the CPU).

    Bit-identical to P sequential ``NeighborSampler.sample`` calls on
    the shared RNG: the uniform blocks are pre-drawn PE-major in the
    legacy consumption order (one flat draw per PE covers that PE's
    layer draws exactly), and every arithmetic step reuses the scalar
    sampler's formulas. Ragged seed blocks (trainers with unequal batch
    sizes) fall back to the scalar sampler, which preserves the same
    draw order trivially.
    """

    def __init__(
        self,
        graph: Graph,
        fanouts: tuple[int, ...] = (10, 25),
        use_kernels: bool = False,
        device="cuda",
    ):
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.use_kernels = use_kernels
        # The kernel route's device, resolved only when it is taken:
        # "cuda" without a card raises RuntimeError.
        self.device = None
        if use_kernels:
            from ..runtime.engine import resolve_device

            self.device = resolve_device(device)
        self._scalar = NeighborSampler(graph, self.fanouts)

    def _dedup(
        self, sorted_keys: np.ndarray, is_remote: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray | None]:
        if self.use_kernels:
            from ..kernels import ops

            # The sorted keys and flags go to the device, the two masks
            # come back; ops.frontier_unique_batch owns the int32 / int64
            # routing of the keys.
            rem = (
                np.zeros(sorted_keys.shape, dtype=bool)
                if is_remote is None
                else is_remote
            )
            keys = torch.from_numpy(np.ascontiguousarray(sorted_keys)).to(self.device)
            flags = torch.from_numpy(np.ascontiguousarray(rem)).to(self.device)
            first, remote, _, _ = ops.frontier_unique_batch(keys, flags)
            first = first.cpu().numpy()
            remote = remote.cpu().numpy() if is_remote is not None else None
            return first, remote
        return frontier_dedup(sorted_keys, is_remote)

    # ------------------------------------------------------------------ #
    def _layer_sizes(self, batch: int) -> list[tuple[int, int]]:
        sizes = []
        n = batch
        for f in self.fanouts:
            sizes.append((n, f))
            n *= f
        return sizes

    # ------------------------------------------------------------------ #
    def _expand_blocks(
        self, seeds: list[np.ndarray], rng: np.random.Generator
    ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
        """Batched fanout expansion for P equal-size seed blocks.

        Pre-draws each PE's uniform blocks in the legacy order
        (PE-major, layer-minor: one flat draw per PE consumes the
        generator stream exactly as that PE's sequence of per-layer
        draws would) and expands all P frontiers on the shared CSR.
        Returns ``(seed_mat (P, B), layers, touched (P, Mt))`` where
        ``touched`` is the raw concatenated frontier — seeds plus every
        sampled neighbor, unsorted and with duplicates.
        """
        P = len(seeds)
        B = len(seeds[0])
        g = self.graph
        sizes = self._layer_sizes(B)
        total = sum(n * f for n, f in sizes)
        draws = np.stack([rng.random(total) for _ in range(P)])  # (P, total)
        layer_u, off = [], 0
        for n, f in sizes:
            layer_u.append(draws[:, off : off + n * f].reshape(P, n, f))
            off += n * f

        seed_mat = np.stack(seeds)                               # (P, B)
        frontier = seed_mat
        layers: list[np.ndarray] = []
        for (n, f), u in zip(sizes, layer_u):
            deg = g.indptr[frontier + 1] - g.indptr[frontier]    # (P, n)
            offs = (u * np.maximum(deg, 1)[..., None]).astype(np.int64)
            nbrs = _gather_neighbors(g, frontier, deg, offs)     # (P, n, f)
            layers.append(nbrs)
            frontier = nbrs.reshape(P, -1)
        touched = np.concatenate(
            [seed_mat] + [nb.reshape(P, -1) for nb in layers], axis=1
        )                                                        # (P, Mt)
        return seed_mat, layers, touched

    def sample_all_raw(
        self,
        seed_blocks: list[np.ndarray],
        rng: np.random.Generator,
    ) -> tuple[list[MiniBatch], np.ndarray]:
        """Device-native output path: expansion only, no host dedup.

        Returns ``(minibatches, touched)`` where ``touched`` is the raw
        ``(P, Mt)`` frontier block (int32 when ids fit) destined for
        :meth:`repro_torch.runtime.engine.DeviceEngine.fused_step_raw` — the
        fused launch performs the unique/remote extraction on device, so
        the returned minibatches carry ``unique_nodes=None``. Consumes
        the RNG identically to :meth:`sample_all`, which is what makes
        the raw and staged device paths replay the same trace. Requires
        equal-size seed blocks (the caller gates on this — see
        ``runtime/driver.py``).
        """
        seeds = [np.asarray(s, dtype=np.int64) for s in seed_blocks]
        if len(seeds) == 0 or len({len(s) for s in seeds}) != 1:
            raise ValueError("sample_all_raw requires equal-size seed blocks")
        g = self.graph
        seed_mat, layers, touched = self._expand_blocks(seeds, rng)
        if g.id_base:
            # Global ids: int64 block for the wide-id device path (the
            # narrow int32 megakernel indexes part_of by raw id, so it
            # only ever serves id_base == 0).
            touched = touched + np.int64(g.id_base)
        elif g.num_nodes <= np.iinfo(np.int32).max:
            touched = touched.astype(np.int32)
        minibatches = [
            MiniBatch(
                seeds=seeds[p],
                layer_nbrs=[nb[p] for nb in layers],
                unique_nodes=None,
                labels=g.labels[seeds[p]],
            )
            for p in range(len(seeds))
        ]
        return minibatches, touched

    def sample_all(
        self,
        seed_blocks: list[np.ndarray],
        rng: np.random.Generator,
        part_of: np.ndarray | None = None,
    ) -> tuple[list[MiniBatch], list[np.ndarray] | None]:
        """Sample one minibatch per trainer PE in one batched pass.

        Returns ``(minibatches, remote)``; ``remote[p]`` is PE p's
        unique remote fetch set (sorted), or ``None`` when ``part_of``
        is not given. Identical to calling ``NeighborSampler.sample``
        once per PE in order on the same ``rng`` (and, for ``remote``,
        :func:`unique_remote` per PE).
        """
        P = len(seed_blocks)
        seeds = [np.asarray(s, dtype=np.int64) for s in seed_blocks]
        lengths = {len(s) for s in seeds}
        if P == 0 or len(lengths) != 1:
            return self._sample_ragged(seeds, rng, part_of)
        g = self.graph
        seed_mat, layers, touched = self._expand_blocks(seeds, rng)

        # Fused unique + remote across all P frontiers: one row-sort,
        # one first-occurrence/remote mask, one ragged extraction. The
        # sort runs in int32 when ids fit (half the bandwidth of the
        # int64 ``np.unique`` the scalar path pays per PE).
        if g.num_nodes <= np.iinfo(np.int32).max:
            touched = touched.astype(np.int32)
        sorted_keys = np.sort(touched, axis=1)
        if self.use_kernels and part_of is not None:
            is_remote = (
                part_of[sorted_keys] != np.arange(P, dtype=part_of.dtype)[:, None]
            )
            first, remote_mask = self._dedup(sorted_keys, is_remote)
        else:
            first, _ = self._dedup(sorted_keys, None)
            remote_mask = None
        counts = first.sum(axis=1)
        bounds = np.cumsum(counts)[:-1]
        flat_uniq = sorted_keys.ravel()[first.ravel()].astype(np.int64)
        # ``sorted_keys`` are local CSR indices (part_of lookups below
        # stay local); the emitted unique/remote sets are global ids.
        base = np.int64(g.id_base)
        uniq = np.split(flat_uniq + base if g.id_base else flat_uniq, bounds)
        remote = None
        if part_of is not None:
            if remote_mask is not None:  # kernel route: the masks came fused
                rcounts = remote_mask.sum(axis=1)
                rem_ids = sorted_keys.ravel()[remote_mask.ravel()].astype(np.int64)
                remote = np.split(
                    rem_ids + base if g.id_base else rem_ids,
                    np.cumsum(rcounts)[:-1],
                )
            else:
                # Numpy route: filter remoteness post-dedup — the gather
                # touches only the unique ids, not the full (P, M) block.
                rows = np.repeat(np.arange(P, dtype=part_of.dtype), counts)
                rem_flat = part_of[flat_uniq] != rows
                remote = [u[m] for u, m in zip(uniq, np.split(rem_flat, bounds))]

        minibatches = [
            MiniBatch(
                seeds=seeds[p],
                layer_nbrs=[nb[p] for nb in layers],
                unique_nodes=uniq[p],
                labels=g.labels[seeds[p]],
            )
            for p in range(P)
        ]
        return minibatches, remote

    def _sample_ragged(
        self,
        seeds: list[np.ndarray],
        rng: np.random.Generator,
        part_of: np.ndarray | None,
    ) -> tuple[list[MiniBatch], list[np.ndarray] | None]:
        """Unequal per-PE batch sizes: scalar per-PE path (same draws)."""
        minibatches = [self._scalar.sample(s, rng) for s in seeds]
        remote = None
        if part_of is not None:
            remote = [
                unique_remote(mb, part_of, p, id_base=self.graph.id_base)
                for p, mb in enumerate(minibatches)
            ]
        return minibatches, remote
