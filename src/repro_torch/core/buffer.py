"""Persistent buffer of remote node features (paper §2.1, §4).

Each trainer PE owns one fixed-capacity buffer holding features of
*remote* nodes (nodes whose home partition is elsewhere). The buffer is
the unit Rudder steers: the scoring policy decides *what* to replace,
the adaptive controller decides *when*.

Membership and scores are host-side numpy (this mirrors the paper's
CPU prefetcher thread); the feature payload is an optional dense array
so the same class serves both the control-plane simulations and the
real JAX training path (features gathered with ``kernels.ops.gather_rows``).

This class is the single-PE semantic reference; the multi-trainer
runtime batches all PEs' buffers into one array state with identical
state transitions (:class:`repro_torch.runtime.PrefetchEngine` — see
``docs/ARCHITECTURE.md`` §3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import scoring


def _unique_preserve_order(ids: np.ndarray) -> np.ndarray:
    _, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)]


@dataclass
class BufferStats:
    """Counters exposed to the METRICS COLLECTOR."""

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    replaced_total: int = 0
    replacement_rounds: int = 0
    skipped_rounds: int = 0

    @property
    def hit_rate(self) -> float:
        # NaN-on-empty, matching the vectorized twin
        # (runtime.engine.EngineStats.hit_rate) and the RunResult
        # aggregates: no lookups means "no data", not "all misses".
        return self.hits / self.lookups if self.lookups else float("nan")


class PersistentBuffer:
    """Fixed-capacity buffer with Rudder's scoring policy.

    Parameters
    ----------
    capacity:
        Maximum number of remote nodes held.
    feature_dim:
        If > 0, a dense feature payload ``(capacity, feature_dim)`` is
        maintained alongside membership.
    policy:
        Scoring/eviction policy (name or :class:`repro_torch.core.scoring.
        ScoringPolicy`); default is the paper's ``rudder`` policy.
    node_weights:
        Optional per-*node* access weights indexed by *local* node index
        (the ``degree`` policy's input); resolved to per-slot weights at
        insertion time.
    id_base:
        The graph's global-id offset: buffer ids are global
        (``id_base`` + local index), and the weight lookup rebases them
        back to local before indexing ``node_weights``.
    """

    def __init__(
        self,
        capacity: int,
        feature_dim: int = 0,
        policy: str | scoring.ScoringPolicy = "rudder",
        node_weights: np.ndarray | None = None,
        id_base: int = 0,
    ):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self.feature_dim = int(feature_dim)
        self.policy = scoring.make_policy(policy)
        self._node_weights = node_weights
        self.id_base = int(id_base)
        self._slot_of: dict[int, int] = {}
        self._id_of = np.full(self.capacity, -1, dtype=np.int64)
        self._scores = np.zeros(self.capacity, dtype=np.float32)
        self._weights = np.ones(self.capacity, dtype=np.float32)
        self._valid = np.zeros(self.capacity, dtype=bool)
        self._accessed_this_round = np.zeros(self.capacity, dtype=bool)
        if feature_dim > 0:
            self.features = np.zeros((self.capacity, feature_dim), dtype=np.float32)
        else:
            self.features = None
        # Nodes admitted by the most recent replace() round (the topology
        # cost model prices their fetch RPCs by home partition).
        self.last_placed = np.array([], dtype=np.int64)
        self.stats = BufferStats()

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def size(self) -> int:
        return len(self._slot_of)

    @property
    def occupancy(self) -> float:
        return self.size / self.capacity if self.capacity else 0.0

    def scores_snapshot(self) -> np.ndarray:
        return self._scores.copy()

    def ids_snapshot(self) -> np.ndarray:
        return self._id_of[self._valid].copy()

    def __contains__(self, node_id: int) -> bool:
        return int(node_id) in self._slot_of

    # ------------------------------------------------------------------ #
    # lookup / access
    # ------------------------------------------------------------------ #
    def lookup(self, node_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split sampled remote ids into (hit_mask, slots).

        ``slots[i]`` is the buffer slot of ``node_ids[i]`` when hit, -1
        otherwise. Marks hits as accessed for the current scoring round
        and updates hit statistics (%-Hits numerator/denominator).
        """
        node_ids = np.asarray(node_ids, dtype=np.int64)
        slots = np.fromiter(
            (self._slot_of.get(int(n), -1) for n in node_ids),
            dtype=np.int64,
            count=len(node_ids),
        )
        hit_mask = slots >= 0
        self.stats.lookups += int(node_ids.size)
        self.stats.hits += int(hit_mask.sum())
        self.stats.misses += int((~hit_mask).sum())
        if hit_mask.any():
            self._accessed_this_round[slots[hit_mask]] = True
        return hit_mask, slots

    def end_round(self) -> None:
        """Close a minibatch-sampling round: apply the scoring policy."""
        if self.capacity == 0:
            return
        weights = self._weights if self.policy.use_weights else None
        self._scores = np.where(
            self._valid,
            self.policy.update(self._scores, self._accessed_this_round, weights),
            self._scores,
        )
        self._accessed_this_round[:] = False

    # ------------------------------------------------------------------ #
    # replacement
    # ------------------------------------------------------------------ #
    def stale_slots(self) -> np.ndarray:
        return np.nonzero(self.policy.stale(self._scores, self._valid))[0]

    def free_slots(self) -> np.ndarray:
        return np.nonzero(~self._valid)[0]

    def insert(
        self, node_ids: np.ndarray, features: np.ndarray | None = None
    ) -> int:
        """Fill free slots with ``node_ids`` (no eviction). Returns #inserted."""
        free = self.free_slots()
        node_ids = _unique_preserve_order(np.asarray(node_ids, dtype=np.int64))
        node_ids = node_ids[~np.isin(node_ids, self._id_of[self._valid])]
        n = min(len(free), len(node_ids))
        if n == 0:
            return 0
        slots, ids = free[:n], node_ids[:n]
        self._place(slots, ids, None if features is None else features[:n])
        return n

    def replace(
        self, node_ids: np.ndarray, features: np.ndarray | None = None
    ) -> int:
        """One replacement round per the paper's policy.

        Evicts stale slots (score < 0.95) and fills them — plus any free
        slots — with ``node_ids`` (recently sampled remote nodes). If no
        slot is stale and none free, replacement is skipped. Returns the
        number of nodes newly placed.
        """
        node_ids = _unique_preserve_order(np.asarray(node_ids, dtype=np.int64))
        node_ids = node_ids[~np.isin(node_ids, self._id_of[self._valid])]
        stale = self.stale_slots()
        free = self.free_slots()
        slots = np.concatenate([free, stale])
        n = min(len(slots), len(node_ids))
        self.last_placed = node_ids[:n]
        if n == 0:
            self.stats.skipped_rounds += 1
            return 0
        evict_slots = slots[:n]
        for s in evict_slots:
            old = int(self._id_of[s])
            if old >= 0:
                del self._slot_of[old]
        self._place(
            evict_slots, node_ids[:n], None if features is None else features[:n]
        )
        self.stats.replaced_total += n
        self.stats.replacement_rounds += 1
        return n

    def fill_rows(self, node_ids: np.ndarray, rows: np.ndarray) -> None:
        """Set the feature payload of already-resident ``node_ids``.

        The feature-store legacy path fills admissions *after* a
        ``replace``/``insert`` round via ``last_placed`` — slot-accurate
        by construction, unlike passing ``features=`` into ``replace``
        (which aligns rows with the pre-dedup candidate list).
        """
        if self.features is None:
            raise ValueError("buffer has no feature payload (feature_dim=0)")
        node_ids = np.asarray(node_ids, dtype=np.int64)
        if len(node_ids) != len(rows):
            raise ValueError(f"{len(node_ids)} ids != {len(rows)} rows")
        for i, node in enumerate(node_ids):
            self.features[self._slot_of[int(node)]] = rows[i]

    def _place(
        self, slots: np.ndarray, ids: np.ndarray, features: np.ndarray | None
    ) -> None:
        for s, i in zip(slots, ids):
            self._slot_of[int(i)] = int(s)
        self._id_of[slots] = ids
        self._scores[slots] = np.float32(self.policy.initial_score)
        if self._node_weights is not None:
            self._weights[slots] = self._node_weights[ids - self.id_base]
        self._valid[slots] = True
        self._accessed_this_round[slots] = False
        if self.features is not None and features is not None:
            self.features[slots] = features
