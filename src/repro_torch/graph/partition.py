"""Edge-cut graph partitioning (METIS stand-in).

DistDGL partitions with METIS (multilevel k-way, minimizing edge cut
under balance constraints). METIS is not available offline; we implement
a greedy multi-seed BFS grower with strict balance caps — the classical
LDG/BFS family — which serves the same role: partitions are *locality
preserving*, so most sampled neighbors are local and the remote ones
(the communication Rudder attacks) follow the same heavy-tailed reuse
pattern as METIS partitions.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .generate import Graph


@dataclass
class Partitioned:
    graph: Graph
    num_parts: int
    part_of: np.ndarray          # (N,) int32 — owning partition per node
    local_nodes: list[np.ndarray]
    edge_cut: int

    def local_train_nodes(self, part: int) -> np.ndarray:
        mask = self.part_of[self.graph.train_nodes] == part
        return self.graph.train_nodes[mask]

    def part_edges(self, part: int) -> int:
        nodes = self.local_nodes[part]
        return int(
            (self.graph.indptr[nodes + 1] - self.graph.indptr[nodes]).sum()
        ) // 2


def partition_graph(
    graph: Graph, num_parts: int, seed: int = 0, method: str = "auto"
) -> Partitioned:
    """Balanced edge-cut partitioning.

    ``method='community'`` packs ground-truth communities into balanced
    parts (what a converged multilevel METIS finds on block-structured
    graphs); ``method='bfs'`` is the greedy BFS grower; ``'auto'`` uses
    communities when the graph carries them.
    """
    n = graph.num_nodes
    if num_parts <= 1:
        part_of = np.zeros(n, dtype=np.int32)
        return Partitioned(graph, 1, part_of, [np.arange(n, dtype=np.int64)], 0)

    if method == "auto":
        method = "community" if graph.communities is not None else "bfs"
    if method == "community":
        return _partition_by_communities(graph, num_parts)

    rng = np.random.default_rng(seed)
    cap = int(np.ceil(n / num_parts))
    part_of = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)

    # Seeds: spread via degree-descending picks far apart (cheap heuristic:
    # highest-degree unassigned node not adjacent to an existing seed).
    degree = graph.degree()
    seeds = []
    order = np.argsort(-degree)
    banned = set()
    for u in order:
        if len(seeds) == num_parts:
            break
        if int(u) in banned:
            continue
        seeds.append(int(u))
        banned.update(int(v) for v in graph.neighbors(int(u)))
        banned.add(int(u))
    # Pathological small graphs: at most one seed per node — when
    # num_parts > num_nodes the surplus partitions stay (validly) empty.
    while len(seeds) < min(num_parts, n):
        u = int(rng.integers(0, n))
        if u not in seeds:
            seeds.append(u)

    queues = [deque([seeds[p]]) if p < len(seeds) else deque()
              for p in range(num_parts)]
    for p, s in enumerate(seeds):
        part_of[s] = p
        sizes[p] = 1

    # Round-robin BFS growth under the balance cap.
    active = set(range(num_parts))
    while active:
        for p in list(active):
            if sizes[p] >= cap or not queues[p]:
                # Refill from any unassigned node if queue dried up early.
                if sizes[p] < cap:
                    un = np.nonzero(part_of == -1)[0]
                    if len(un):
                        queues[p].append(int(un[rng.integers(0, len(un))]))
                    else:
                        active.discard(p)
                        continue
                else:
                    active.discard(p)
                    continue
            grew = False
            while queues[p] and not grew and sizes[p] < cap:
                u = queues[p].popleft()
                for v in graph.neighbors(u):
                    v = int(v)
                    if part_of[v] == -1 and sizes[p] < cap:
                        part_of[v] = p
                        sizes[p] += 1
                        queues[p].append(v)
                        grew = True
        if all(sizes[p] >= cap or not queues[p] for p in active):
            # Assign stragglers to the smallest partitions.
            un = np.nonzero(part_of == -1)[0]
            if len(un) == 0:
                break
            for u in un:
                p = int(np.argmin(sizes))
                part_of[u] = p
                sizes[p] += 1
            break

    un = np.nonzero(part_of == -1)[0]
    for u in un:
        p = int(np.argmin(sizes))
        part_of[u] = p
        sizes[p] += 1

    return _finish(graph, num_parts, part_of)


def _finish(graph: Graph, num_parts: int, part_of: np.ndarray) -> Partitioned:
    n = graph.num_nodes
    src = np.repeat(np.arange(n), np.diff(graph.indptr))
    cut = int((part_of[src] != part_of[graph.indices]).sum()) // 2
    local_nodes = [
        np.nonzero(part_of == p)[0].astype(np.int64) for p in range(num_parts)
    ]
    return Partitioned(graph, num_parts, part_of, local_nodes, cut)


def _partition_by_communities(graph: Graph, num_parts: int) -> Partitioned:
    """Greedy bin-packing of communities into balanced partitions
    (largest-first into the currently smallest part)."""
    comm = graph.communities
    num_comm = int(comm.max()) + 1
    sizes = np.bincount(comm, minlength=num_comm)
    order = np.argsort(-sizes)
    part_sizes = np.zeros(num_parts, dtype=np.int64)
    comm_to_part = np.zeros(num_comm, dtype=np.int32)
    for c in order:
        p = int(np.argmin(part_sizes))
        comm_to_part[c] = p
        part_sizes[p] += sizes[c]
    part_of = comm_to_part[comm]
    return _finish(graph, num_parts, part_of)
