"""Synthetic graph generation with dataset presets.

The paper evaluates on OGB (products, reddit, papers100M, arxiv), yelp,
and SNAP (orkut, friendster). Those datasets are not available offline,
so we generate graphs matching each dataset's *shape* — average degree,
degree skew, community structure, feature dimensionality, #classes —
scaled down ~1000x so the full distributed pipeline (partitioning,
sampling, buffering, training) runs end-to-end on CPU.

Generator: **degree-corrected stochastic block model**. Real graphs have
(a) power-law degrees and (b) strong community structure — (b) is what
makes METIS partitions locality-preserving and gives the remote-node
reuse skew that Rudder's frequency scoring exploits (Fig. 1's declining
unique remotes). Pure preferential attachment reproduces (a) but not
(b), so we sample edges from per-community Zipf weights with a tunable
intra-community probability.

EXPERIMENTS.md reports trends against the paper's bands, not absolute
epoch seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def validate_csr(indptr: np.ndarray, indices: np.ndarray) -> None:
    """Assert the CSR invariants every consumer relies on.

    The samplers index ``indices[indptr[u] + k]`` with ``k < degree(u)``
    and no bounds clamping, so a truncated / non-monotone / out-of-range
    CSR must fail loudly at construction, not silently redirect draws to
    the global last edge (the old ``np.minimum`` clamp bias).
    """
    if len(indptr) < 1 or indptr[0] != 0:
        raise ValueError("CSR indptr must start at 0")
    if indptr[-1] != len(indices):
        raise ValueError(
            f"CSR indptr[-1]={indptr[-1]} must equal len(indices)={len(indices)}"
        )
    if np.any(np.diff(indptr) < 0):
        raise ValueError("CSR indptr must be non-decreasing")
    n = len(indptr) - 1
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(
            f"CSR indices must lie in [0, {n}); got "
            f"[{indices.min()}, {indices.max()}]"
        )


@dataclass
class Graph:
    """Undirected graph in CSR form, with node features and labels.

    ``id_base`` offsets the graph's *global* node-id space: local CSR
    index ``i`` names global node ``id_base + i`` (the partition-major
    id layout DistDGL-scale deployments use, where a shard's ids start
    far above zero). The CSR, features, labels and train set stay
    local-indexed; only the prefetch plane (sampled unique/remote sets,
    the raw device frontier) speaks global ids, so a nonzero base — in
    particular one pushing ids past 2^31 — exercises the wide-id device
    path without materializing billions of rows.
    """

    name: str
    indptr: np.ndarray          # (N+1,) int64
    indices: np.ndarray         # (2E,) int64 — both directions
    features: np.ndarray        # (N, F) float32
    labels: np.ndarray          # (N,) int32
    train_nodes: np.ndarray     # (T,) int64
    num_classes: int
    communities: np.ndarray | None = None  # (N,) int32 ground-truth blocks
    id_base: int = 0            # global id of local node 0

    def __post_init__(self):
        validate_csr(self.indptr, self.indices)
        if self.id_base < 0:
            raise ValueError(f"id_base must be >= 0, got {self.id_base}")

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices) // 2

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def rebase(self, id_base: int) -> "Graph":
        """Copy of this graph with its global id space moved to
        ``id_base`` — same topology, features and draws, shifted ids.
        The vehicle for big-id parity tests and the ``--big-ids`` bench
        leg: a rebase at ``2**31`` makes every global id wide without
        changing any local structure."""
        from dataclasses import replace

        return replace(self, id_base=int(id_base))


@dataclass(frozen=True)
class DatasetPreset:
    """Shape parameters for one named dataset (scaled from the paper)."""

    name: str
    num_nodes: int
    avg_degree: float           # target mean degree (undirected)
    feature_dim: int
    num_classes: int
    train_fraction: float
    intra_prob: float           # community locality (higher = easier cut)
    zipf_s: float               # degree skew within a community
    source: str                 # what it stands in for
    family: str = "dcsbm"       # edge generator: dcsbm | rmat | powerlaw


# Paper Table 1(a), scaled ~1000x (papers100M/friendster ~2000x) so a
# full multi-trainer epoch runs in seconds on CPU. intra_prob reflects
# how cleanly METIS separates each graph (social nets are messier than
# co-purchase/citation graphs).
DATASET_PRESETS: dict[str, DatasetPreset] = {
    "products": DatasetPreset("products", 24_000, 25.0, 100, 47, 0.08, 0.92, 0.85,
                              "ogbn-products 2.4M nodes / 61.85M edges"),
    "reddit": DatasetPreset("reddit", 12_000, 99.0, 602, 41, 0.10, 0.82, 0.95,
                            "reddit 0.23M nodes / 114.61M edges"),
    "papers": DatasetPreset("papers", 55_000, 14.0, 128, 172, 0.01, 0.90, 0.80,
                            "ogbn-papers100M 111M nodes / 1.6B edges"),
    "orkut": DatasetPreset("orkut", 30_000, 38.0, 8, 100, 0.05, 0.80, 0.95,
                           "SNAP com-orkut 3.07M nodes / 117.18M edges"),
    "friendster": DatasetPreset("friendster", 33_000, 27.0, 128, 100, 0.003, 0.85, 0.90,
                                "SNAP friendster 65.6M nodes / 1.8B edges"),
    "yelp": DatasetPreset("yelp", 14_000, 19.0, 300, 100, 0.10, 0.88, 0.85,
                          "yelp 716K nodes / 13.9M edges"),
    "arxiv": DatasetPreset("arxiv", 17_000, 6.5, 128, 40, 0.20, 0.90, 0.75,
                           "ogbn-arxiv 169K nodes / 1.1M edges"),
    # Scenario-axis families beyond DC-SBM: R-MAT reproduces the Graph500
    # self-similar adjacency (hubs, no clean communities — the worst case
    # for locality-preserving partitioners), Chung-Lu power-law gives
    # heavy-tailed degrees with fully independent endpoints. Both leave
    # ``communities=None``, so partitioning exercises the BFS grower.
    "rmat": DatasetPreset("rmat", 20_000, 16.0, 64, 16, 0.10, 0.0, 0.0,
                          "Graph500 R-MAT (a,b,c)=(0.57,0.19,0.19)",
                          family="rmat"),
    "powerlaw": DatasetPreset("powerlaw", 20_000, 12.0, 64, 16, 0.10, 0.0, 0.9,
                              "Chung-Lu power-law, Zipf weights",
                              family="powerlaw"),
}


def _to_csr(n: int, edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize, dedupe, drop self loops, build CSR."""
    e = np.concatenate([edges, edges[:, ::-1]], axis=0)
    e = e[e[:, 0] != e[:, 1]]
    key = e[:, 0] * np.int64(n) + e[:, 1]
    order = np.argsort(key, kind="stable")
    e = e[order]
    key = key[order]
    keep = np.ones(len(e), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    e = e[keep]
    counts = np.bincount(e[:, 0], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, e[:, 1].astype(np.int64)


def _dcsbm_edges(
    n: int,
    num_edges: int,
    num_communities: int,
    intra_prob: float,
    zipf_s: float,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Degree-corrected SBM edge list + community assignment."""
    comm = np.sort(rng.integers(0, num_communities, size=n)).astype(np.int32)
    # Zipf weight by rank within the community -> power-law degrees.
    weights = np.zeros(n)
    starts = np.searchsorted(comm, np.arange(num_communities))
    ends = np.searchsorted(comm, np.arange(num_communities), side="right")
    for c in range(num_communities):
        size = ends[c] - starts[c]
        if size == 0:
            continue
        ranks = rng.permutation(size) + 1
        weights[starts[c] : ends[c]] = ranks.astype(np.float64) ** (-zipf_s)
    global_p = weights / weights.sum()

    # Sources: degree-biased global draw.
    src = rng.choice(n, size=num_edges, p=global_p)
    # Destinations: intra-community w.p. intra_prob, else global.
    intra = rng.random(num_edges) < intra_prob
    dst = np.empty(num_edges, dtype=np.int64)
    dst[~intra] = rng.choice(n, size=int((~intra).sum()), p=global_p)
    # Intra draws, community by community (vectorised within each).
    src_comm = comm[src]
    for c in range(num_communities):
        sel = np.nonzero(intra & (src_comm == c))[0]
        if len(sel) == 0:
            continue
        lo, hi = starts[c], ends[c]
        if hi - lo <= 1:
            dst[sel] = src[sel]
            continue
        local_w = weights[lo:hi] / weights[lo:hi].sum()
        dst[sel] = lo + rng.choice(hi - lo, size=len(sel), p=local_w)
    return np.stack([src, dst], axis=1), comm


def _rmat_edges(
    n: int,
    num_edges: int,
    rng: np.random.Generator,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> np.ndarray:
    """Graph500-style R-MAT edge list (vectorised over all edges).

    Each of ``ceil(log2 n)`` bit levels picks the (src, dst) quadrant
    with probabilities (a, b, c, 1-a-b-c). Endpoints landing past ``n``
    (the power-of-two overshoot) are dropped; batches are redrawn until
    the requested edge count is met, so the preset's average degree
    holds for every ``n`` (the drop rate depends on how far ``n`` sits
    below the next power of two).
    """
    bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    d = 1.0 - a - b - c
    p_src1 = c + d                     # P(src bit = 1)
    p_dst1_src0 = b / (a + b)          # P(dst bit = 1 | src bit = 0)
    p_dst1_src1 = d / (c + d)          # P(dst bit = 1 | src bit = 1)
    chunks: list[np.ndarray] = []
    kept = 0
    draw = int(num_edges * 1.4) + 16
    while kept < num_edges:
        src = np.zeros(draw, dtype=np.int64)
        dst = np.zeros(draw, dtype=np.int64)
        for _ in range(bits):
            src_bit = rng.random(draw) < p_src1
            dst_bit = rng.random(draw) < np.where(
                src_bit, p_dst1_src1, p_dst1_src0
            )
            src = (src << 1) | src_bit
            dst = (dst << 1) | dst_bit
        keep = (src < n) & (dst < n)
        chunk = np.stack([src[keep], dst[keep]], axis=1)
        chunks.append(chunk)
        kept += len(chunk)
        draw = max(int((num_edges - kept) * 1.6) + 16, 16)
    return np.concatenate(chunks)[:num_edges]


def _powerlaw_edges(
    n: int, num_edges: int, zipf_s: float, rng: np.random.Generator
) -> np.ndarray:
    """Chung-Lu power-law edges: both endpoints drawn independently from
    Zipf rank weights (ranks shuffled so node id carries no degree
    information). Heavy-tailed degrees, zero community structure."""
    ranks = rng.permutation(n) + 1
    weights = ranks.astype(np.float64) ** (-zipf_s)
    p = weights / weights.sum()
    src = rng.choice(n, size=num_edges, p=p)
    dst = rng.choice(n, size=num_edges, p=p)
    return np.stack([src, dst], axis=1).astype(np.int64)


def generate(name: str, seed: int = 0, scale: float = 1.0) -> Graph:
    """Generate the named dataset preset (``scale`` shrinks node count)."""
    if name not in DATASET_PRESETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASET_PRESETS)}")
    p = DATASET_PRESETS[name]
    rng = np.random.default_rng(seed)
    n = max(int(p.num_nodes * scale), 256)
    num_edges = int(n * p.avg_degree / 2)
    if p.family == "rmat":
        edges, comm = _rmat_edges(n, num_edges, rng), None
    elif p.family == "powerlaw":
        edges, comm = _powerlaw_edges(n, num_edges, p.zipf_s, rng), None
    else:
        num_comm = max(16, n // 300)
        edges, comm = _dcsbm_edges(
            n, num_edges, num_comm, p.intra_prob, p.zipf_s, rng
        )
    indptr, indices = _to_csr(n, edges)

    # Labels correlate with communities (as in real citation/co-purchase
    # graphs) so GraphSAGE actually benefits from neighborhoods. The
    # community-free families (rmat / powerlaw) get uniform labels.
    if comm is not None:
        labels = (comm % p.num_classes).astype(np.int32)
        flip = rng.random(n) < 0.1
        labels[flip] = rng.integers(0, p.num_classes, size=int(flip.sum()))
    else:
        labels = rng.integers(0, p.num_classes, size=n).astype(np.int32)
    centroids = rng.normal(0, 1, size=(p.num_classes, p.feature_dim)).astype(
        np.float32
    )
    features = centroids[labels] + 0.6 * rng.normal(
        0, 1, size=(n, p.feature_dim)
    ).astype(np.float32)

    n_train = max(int(n * p.train_fraction), 32)
    train_nodes = rng.choice(n, size=n_train, replace=False).astype(np.int64)
    return Graph(
        name=p.name,
        indptr=indptr,
        indices=indices,
        features=features,
        labels=labels,
        train_nodes=np.sort(train_nodes),
        num_classes=p.num_classes,
        communities=comm,
    )


# --------------------------------------------------------------------- #
# Cluster topology cost model
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Topology:
    """Per-pair communication cost model for the trainer cluster.

    The flat §4.5.3 model (``TimeModel.t_comm``) prices every fetched
    byte identically; real clusters do not — a trainer pulling features
    from a partition across the rack switch (or across the torus) pays a
    different latency/bandwidth than from its neighbor. ``Topology``
    replaces the flat constants with ``(P, P)`` matrices and prices each
    trainer's per-peer aggregated fetch RPCs separately.

    ``reduce='max'`` models per-peer RPCs issued in parallel (the step
    waits for the slowest peer); ``'sum'`` models a serialized fetch
    loop. ``topology=None`` on the trainer keeps the legacy flat model
    bit-for-bit.
    """

    name: str
    alpha: np.ndarray            # (P, P) per-RPC latency, seconds
    bw: np.ndarray               # (P, P) bandwidth, bytes/s
    reduce: str = "max"

    def __post_init__(self):
        if self.reduce not in ("max", "sum"):
            raise ValueError(f"reduce must be 'max' or 'sum', got {self.reduce!r}")
        if self.alpha.shape != self.bw.shape or self.alpha.ndim != 2:
            raise ValueError("alpha and bw must be matching (P, P) matrices")

    @property
    def num_parts(self) -> int:
        return self.alpha.shape[0]

    def t_comm_row(
        self, p: int, fetched: np.ndarray, feature_dim: int, feature_bytes: int = 4
    ) -> float:
        """Step comm time for trainer ``p``; ``fetched[q]`` = nodes pulled
        from partition q this step (``fetched[p]`` is ignored)."""
        return float(
            self.t_comm_pairs(
                fetched[None, :], feature_dim, feature_bytes, rows=np.array([p])
            )[0]
        )

    def t_comm_pairs(
        self,
        fetched: np.ndarray,
        feature_dim: int,
        feature_bytes: int = 4,
        rows: np.ndarray | None = None,
    ) -> np.ndarray:
        """Vectorized comm time for all trainers: ``fetched`` is
        ``(P, P)`` with ``fetched[p, q]`` = nodes trainer p pulls from
        partition q. Returns ``(P,)`` step comm times."""
        fetched = np.asarray(fetched, dtype=np.float64)
        alpha = self.alpha if rows is None else self.alpha[rows]
        bw = self.bw if rows is None else self.bw[rows]
        cost = np.where(
            fetched > 0,
            alpha + fetched * feature_dim * feature_bytes / bw,
            0.0,
        )
        # A trainer never fetches from its own partition.
        if rows is None:
            np.fill_diagonal(cost, 0.0)
        else:
            cost[np.arange(len(rows)), rows] = 0.0
        return cost.max(axis=1) if self.reduce == "max" else cost.sum(axis=1)


#: Named topology families for the ``--topology`` sweep axis.
TOPOLOGIES = ("flat", "rack", "torus")


# --------------------------------------------------------------------- #
# Dynamic-condition scenario models (event time engine inputs)
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class StragglerModel:
    """Per-PE compute perturbation for the event time engine.

    ``compute_mult[p]`` scales trainer p's per-minibatch compute time
    (T_DDP); ``jitter`` adds a seeded lognormal multiplicative
    perturbation per (PE, step) on top. The closed-form §4.5.3 model has
    no per-PE compute axis at all, so any non-trivial straggler model
    requires ``time_engine="event"`` — the all-reduce barrier then turns
    one slow trainer into cluster-wide skew, which is exactly the regime
    the paper's adaptive control targets.
    """

    name: str
    compute_mult: np.ndarray     # (P,) per-PE base compute multipliers
    jitter: float = 0.0          # lognormal sigma per (PE, step); 0 = none
    seed: int = 0

    def __post_init__(self):
        if np.any(np.asarray(self.compute_mult) <= 0):
            raise ValueError("compute multipliers must be > 0")
        if self.jitter < 0:
            raise ValueError("jitter sigma must be >= 0")

    @property
    def num_parts(self) -> int:
        return len(self.compute_mult)


@dataclass(frozen=True)
class CongestionModel:
    """Home-partition egress contention for the event time engine.

    Each partition serves feature-fetch RPCs through one egress link of
    capacity ``egress_bw[q]`` bytes/s, max–min fairly shared by every
    trainer pulling from it concurrently (the closed-form model prices
    each trainer's fetches independently, as if every home partition had
    infinite egress). ``window`` optionally degrades ``window_parts`` by
    ``window_factor`` during a fraction-of-run interval — a transient
    link brown-out.
    """

    name: str
    egress_bw: np.ndarray                    # (P,) bytes/s per home partition
    window: tuple[float, float] | None = None  # (start_frac, end_frac) of run
    window_factor: float = 1.0               # egress divided by this in window
    window_parts: np.ndarray | None = None   # partitions hit by the window

    def __post_init__(self):
        if np.any(np.asarray(self.egress_bw) <= 0):
            raise ValueError("egress bandwidths must be > 0")
        if self.window is not None:
            lo, hi = self.window
            if not (0.0 <= lo < hi <= 1.0):
                raise ValueError("window must satisfy 0 <= start < end <= 1")
        if self.window_factor < 1.0:
            raise ValueError("window_factor must be >= 1")

    @property
    def num_parts(self) -> int:
        return len(self.egress_bw)

    def egress_at(self, step: int, total_steps: int) -> np.ndarray:
        """Effective per-partition egress capacity at ``step``."""
        bw = np.asarray(self.egress_bw, dtype=np.float64).copy()
        if self.window is not None and total_steps > 0:
            frac = step / total_steps
            lo, hi = self.window
            if lo <= frac < hi:
                parts = (
                    self.window_parts
                    if self.window_parts is not None
                    else np.arange(len(bw))
                )
                bw[parts] = bw[parts] / self.window_factor
        return bw


#: Named scenario presets for the ``--stragglers`` / ``--congestion``
#: sweep axes (``"none"`` on the CLI maps to no model at all).
STRAGGLER_PRESETS = ("one-slow", "two-slow", "jitter")
CONGESTION_PRESETS = ("egress-share", "hot-home", "transient")


def make_stragglers(name: str, num_parts: int, seed: int = 0) -> StragglerModel:
    """Build a named straggler preset.

    * ``one-slow`` — trainer 0 computes 3x slower (a throttled host);
    * ``two-slow`` — trainers 0 and 1 at 2x (a slow rack half);
    * ``jitter``   — all trainers nominal with lognormal sigma=0.25
      per-step compute jitter (OS noise), drawn from ``seed``.
    """
    P = int(num_parts)
    mult = np.ones(P, dtype=np.float64)
    if name == "one-slow":
        mult[0] = 3.0
        return StragglerModel("one-slow", mult, seed=seed)
    if name == "two-slow":
        mult[: min(2, P)] = 2.0
        return StragglerModel("two-slow", mult, seed=seed)
    if name == "jitter":
        return StragglerModel("jitter", mult, jitter=0.25, seed=seed)
    raise KeyError(f"unknown straggler preset {name!r}; options: {STRAGGLER_PRESETS}")


def make_congestion(
    name: str, num_parts: int, link_bw: float = 1e6
) -> CongestionModel:
    """Build a named congestion preset (egress capacities in bytes/s).

    * ``egress-share`` — every home partition serves all pullers through
      one ``link_bw`` egress link (pure max–min sharing, no degradation);
    * ``hot-home``     — egress sharing plus partition 0's link degraded
      4x for the whole run (an oversubscribed home);
    * ``transient``    — egress sharing plus partition 0 degraded 8x
      during the middle third of the run (a link brown-out).
    """
    P = int(num_parts)
    bw = np.full(P, float(link_bw), dtype=np.float64)
    if name == "egress-share":
        return CongestionModel("egress-share", bw)
    if name == "hot-home":
        bw[0] = link_bw / 4.0
        return CongestionModel("hot-home", bw)
    if name == "transient":
        return CongestionModel(
            "transient",
            bw,
            window=(1.0 / 3.0, 2.0 / 3.0),
            window_factor=8.0,
            window_parts=np.array([0]),
        )
    raise KeyError(
        f"unknown congestion preset {name!r}; options: {CONGESTION_PRESETS}"
    )


def make_topology(
    name: str,
    num_parts: int,
    link_bw: float = 1e6,
    alpha: float = 5e-4,
) -> Topology:
    """Build a named ``(P, P)`` topology.

    * ``flat``  — homogeneous full bisection (every pair at ``link_bw``);
    * ``rack``  — two racks (first/second half of the trainers):
      cross-rack pairs pay 4x the latency at 1/4 the bandwidth;
    * ``torus`` — 1-D torus: cost scales with ring hop distance.
    """
    P = int(num_parts)
    ones = np.ones((P, P), dtype=np.float64)
    if name == "flat":
        return Topology("flat", alpha * ones, link_bw * ones)
    if name == "rack":
        rack = (np.arange(P) >= (P + 1) // 2).astype(np.int64)
        cross = rack[:, None] != rack[None, :]
        return Topology(
            "rack",
            np.where(cross, 4.0 * alpha, alpha),
            np.where(cross, link_bw / 4.0, link_bw),
        )
    if name == "torus":
        d = np.abs(np.arange(P)[:, None] - np.arange(P)[None, :])
        hops = np.maximum(np.minimum(d, P - d), 1).astype(np.float64)
        return Topology("torus", alpha * hops, link_bw / hops)
    raise KeyError(f"unknown topology {name!r}; options: {TOPOLOGIES}")
