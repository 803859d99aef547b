"""Vectorized multi-PE persistent-buffer state (the prefetch engine).

One :class:`PrefetchEngine` replaces the list of per-trainer
:class:`repro_torch.core.buffer.PersistentBuffer` objects: membership,
scores, validity and per-round access marks for *all* P trainer PEs live
in dense ``(P, C)`` numpy arrays (C = max buffer capacity across PEs;
slots past a PE's own capacity are permanent padding). It is the numpy
twin the trainer builds and warm-starts; its semantics are those of the
reference package's ``PrefetchEngine``.

:class:`DeviceEngine` is the device-resident twin the port's runtime
drives: the same ``(P, C)`` state held as persistent torch tensors on
one device and advanced one single-launch frontier step per training
step (:func:`repro_torch.kernels.ops.fused_frontier_step_batch` — the
Hopper kernel on a CUDA device, the plain version on the CPU), with one
upload and one packed readback per step. Semantics and streams are
bit-identical to the reference's ``DeviceEngine`` raw path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import telemetry as tel
from ..core import scoring
from ..core.buffer import _unique_preserve_order


@dataclass
class EngineStats:
    """Per-PE counters, mirror of ``core.buffer.BufferStats``."""

    num_pes: int
    lookups: np.ndarray = field(default=None)
    hits: np.ndarray = field(default=None)
    misses: np.ndarray = field(default=None)
    replaced_total: np.ndarray = field(default=None)
    replacement_rounds: np.ndarray = field(default=None)
    skipped_rounds: np.ndarray = field(default=None)

    def __post_init__(self):
        for name in (
            "lookups",
            "hits",
            "misses",
            "replaced_total",
            "replacement_rounds",
            "skipped_rounds",
        ):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(self.num_pes, dtype=np.int64))

    def hit_rate(self) -> np.ndarray:
        # NaN (not 0.0) for PEs that never looked anything up — the
        # NaN-on-empty policy of RunResult's aggregates: a silent zero
        # reads as "all misses", NaN trips the sweep gate.
        return np.where(
            self.lookups > 0, self.hits / np.maximum(self.lookups, 1), np.nan
        )


class PrefetchEngine:
    """All trainer-PE buffers as one batched array state.

    Parameters
    ----------
    capacities:
        Per-PE buffer capacity. Internally padded to ``C = max(capacities)``;
        padding slots are never valid and never free.
    policy:
        Scoring/eviction policy (name or :class:`repro_torch.core.scoring.
        ScoringPolicy`) applied to every PE; default is the paper's
        ``rudder`` policy. Same contract as
        ``PersistentBuffer(policy=...)``.
    node_weights:
        Optional per-node access weights indexed by *local* node index
        (the ``degree`` policy's input); resolved to per-slot weights at
        insertion time. Buffer ids are global (``id_base`` + local), so
        placement subtracts ``id_base`` before the gather.
    id_base:
        Global id of local node 0 (``Graph.id_base``). All ids entering
        the engine (queries, candidates) are global; only per-node
        weight lookups need the local offset.
    feature_dim:
        If > 0, a dense feature payload ``(P, C, feature_dim)`` float32
        rides alongside membership (the feature-store data plane:
        admissions place real rows via :meth:`place_rows`, hits are
        served from the payload). 0 keeps the engine id-only.
    """

    def __init__(
        self,
        capacities: list[int],
        policy: str | scoring.ScoringPolicy = "rudder",
        node_weights: np.ndarray | None = None,
        feature_dim: int = 0,
        id_base: int = 0,
    ):
        self.capacity = np.asarray(capacities, dtype=np.int64)
        if (self.capacity < 0).any():
            raise ValueError("capacities must be >= 0")
        self.num_pes = P = len(capacities)
        self.max_capacity = C = int(self.capacity.max(initial=1)) if P else 1
        self.policy = scoring.make_policy(policy)
        self._node_weights = node_weights
        self.id_base = int(id_base)
        self.ids = np.full((P, C), -1, dtype=np.int64)
        self.scores = np.zeros((P, C), dtype=np.float32)
        self.weights = np.ones((P, C), dtype=np.float32)
        self.valid = np.zeros((P, C), dtype=bool)
        self.accessed = np.zeros((P, C), dtype=bool)
        # Slots at or past a PE's own capacity are permanent padding.
        self.in_capacity = np.arange(C)[None, :] < self.capacity[:, None]
        self.stats = EngineStats(P)
        # Nodes admitted by the most recent replace_round (per PE): the
        # topology cost model prices their fetch RPCs by home partition.
        self.last_placed: list[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(P)
        ]
        # Feature payload (feature-store data plane). last_hit_slots /
        # last_slots let the fetch stage serve hit rows from the payload
        # and fill newly admitted slots with real rows.
        self.feature_dim = int(feature_dim)
        self.payload = (
            np.zeros((P, C, self.feature_dim), dtype=np.float32)
            if self.feature_dim > 0
            else None
        )
        #: Per-PE slots of the most recent lookup's hits, in query order.
        self.last_hit_slots: list[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(P)
        ]
        #: Per-PE slots filled by the most recent placement round
        #: (aligned with ``last_placed`` after ``replace_round``).
        self.last_slots: list[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(P)
        ]

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def size(self) -> np.ndarray:
        return self.valid.sum(axis=1)

    def occupancy(self) -> np.ndarray:
        return np.where(
            self.capacity > 0, self.size() / np.maximum(self.capacity, 1), 0.0
        )

    def ids_snapshot(self, p: int) -> np.ndarray:
        return self.ids[p][self.valid[p]].copy()

    def scores_snapshot(self, p: int) -> np.ndarray:
        return self.scores[p, : int(self.capacity[p])].copy()

    # ------------------------------------------------------------------ #
    # batched membership
    # ------------------------------------------------------------------ #
    def _membership(
        self, queries: np.ndarray, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched multi-PE membership test.

        ``queries[k]`` is a node id asked of PE ``rows[k]``. Returns
        ``(hit_mask, flat_slots)`` where ``flat_slots[k] = p * C + slot``
        for hits and -1 otherwise. One sort + one searchsorted answers
        every PE's lookup at once: keys are disambiguated by a per-PE
        offset larger than any node id, so ids never collide across PEs.
        """
        hit = np.zeros(len(queries), dtype=bool)
        flat_slots = np.full(len(queries), -1, dtype=np.int64)
        if len(queries) == 0 or not self.valid.any():
            return hit, flat_slots
        offset = int(max(self.ids.max(), queries.max(initial=0), 0)) + 2
        # Invalid slots get key `offset - 1` (never a real node id).
        keys = np.where(self.valid, self.ids, offset - 1)
        keys = keys + np.arange(self.num_pes, dtype=np.int64)[:, None] * offset
        order = np.argsort(keys, axis=None, kind="stable")
        flat_keys = keys.ravel()[order]
        q = queries.astype(np.int64) + rows.astype(np.int64) * offset
        pos = np.searchsorted(flat_keys, q)
        pos_c = np.minimum(pos, flat_keys.size - 1)
        hit = flat_keys[pos_c] == q
        flat_slots[hit] = order[pos_c[hit]]
        return hit, flat_slots

    def lookup(
        self, remote: list[np.ndarray], active: np.ndarray
    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Batched lookup of per-PE remote fetch sets.

        ``remote[p]`` is PE p's unique sampled remote ids; ``active[p]``
        gates whether the PE consults its buffer this round (inactive
        PEs — e.g. the no-prefetch baseline — fetch everything). Returns
        ``(hit_masks, missed)`` per PE; hits are marked accessed for the
        scoring round and the per-PE hit statistics are updated, exactly
        as ``PersistentBuffer.lookup`` does one PE at a time.
        """
        P = self.num_pes
        lengths = np.array(
            [len(remote[p]) if active[p] else 0 for p in range(P)], dtype=np.int64
        )
        rows = np.repeat(np.arange(P, dtype=np.int64), lengths)
        queries = (
            np.concatenate([remote[p] for p in range(P) if active[p] and len(remote[p])])
            if lengths.sum()
            else np.array([], dtype=np.int64)
        )
        hit, flat_slots = self._membership(queries, rows)
        self.last_hit_slots = [np.array([], dtype=np.int64) for _ in range(P)]
        if hit.any():
            self.accessed.ravel()[flat_slots[hit]] = True
            hit_rows = rows[hit]
            hit_slots = flat_slots[hit] - hit_rows * self.max_capacity
            for p in np.unique(hit_rows):
                self.last_hit_slots[p] = hit_slots[hit_rows == p]
        self.stats.lookups += lengths
        hits_per_pe = np.bincount(rows[hit], minlength=P) if len(rows) else np.zeros(
            P, dtype=np.int64
        )
        self.stats.hits += hits_per_pe
        self.stats.misses += lengths - hits_per_pe
        bounds = np.cumsum(lengths)[:-1]
        hit_masks = np.split(hit, bounds)
        out_masks, missed = [], []
        for p in range(P):
            if active[p]:
                out_masks.append(hit_masks[p])
                missed.append(remote[p][~hit_masks[p]])
            else:
                out_masks.append(np.zeros(len(remote[p]), dtype=bool))
                missed.append(remote[p])
        return out_masks, missed

    # ------------------------------------------------------------------ #
    # scoring round
    # ------------------------------------------------------------------ #
    def end_round(self, active: np.ndarray) -> None:
        """Close the sampling round for ``active`` PEs: one batched
        scoring pass (+1 on access, x0.95 idle) and reset access marks."""
        if not active.any():
            return
        weights = self.weights if self.policy.use_weights else None
        new = self.policy.update(self.scores, self.accessed, weights)
        mask = active[:, None] & self.valid
        self.scores = np.where(mask, new, self.scores).astype(np.float32)
        self.accessed[active] = False

    # ------------------------------------------------------------------ #
    # insertion / replacement
    # ------------------------------------------------------------------ #
    def insert(self, p: int, node_ids: np.ndarray) -> int:
        """Fill PE p's free slots (no eviction) — warm-start path."""
        node_ids = _unique_preserve_order(np.asarray(node_ids, dtype=np.int64))
        node_ids = node_ids[~np.isin(node_ids, self.ids[p][self.valid[p]])]
        free = np.nonzero(~self.valid[p] & self.in_capacity[p])[0]
        n = min(len(free), len(node_ids))
        if n == 0:
            return 0
        self._place(p, free[:n], node_ids[:n])
        return n

    def replace_round(
        self, candidates: list[np.ndarray], do_replace: np.ndarray
    ) -> np.ndarray:
        """One replacement round across all PEs.

        ``candidates[p]`` is the admission set (the previous minibatch's
        miss set — Algorithm 1 queues the next minibatch before the
        decision lands); ``do_replace[p]`` is the controller's decision.
        Free slots are filled first, then stale slots (score < 0.95), in
        ascending slot order — the exact ``PersistentBuffer.replace``
        semantics. Returns the number of nodes newly placed per PE.

        Membership filtering of every PE's candidate set happens in one
        batched query; the slot-mask computation (free / stale) is one
        array pass over ``(P, C)``; only the final ragged scatter is a
        short per-PE loop.
        """
        P = self.num_pes
        replaced = np.zeros(P, dtype=np.int64)
        self.last_placed = [np.array([], dtype=np.int64) for _ in range(P)]
        self.last_slots = [np.array([], dtype=np.int64) for _ in range(P)]
        todo = [p for p in range(P) if do_replace[p]]
        if not todo:
            return replaced
        cands = {p: _unique_preserve_order(np.asarray(candidates[p], dtype=np.int64))
                 for p in todo}
        lengths = np.array([len(cands[p]) for p in todo], dtype=np.int64)
        rows = np.repeat(np.asarray(todo, dtype=np.int64), lengths)
        queries = (
            np.concatenate([cands[p] for p in todo])
            if lengths.sum()
            else np.array([], dtype=np.int64)
        )
        member, _ = self._membership(queries, rows)
        fresh = np.split(~member, np.cumsum(lengths)[:-1])
        free_mask = ~self.valid & self.in_capacity
        stale_m = self.valid & self.policy.stale(self.scores)
        for k, p in enumerate(todo):
            cand = cands[p][fresh[k]]
            free = np.nonzero(free_mask[p])[0]
            stale = np.nonzero(stale_m[p])[0]
            slots = np.concatenate([free, stale])
            n = min(len(slots), len(cand))
            if n == 0:
                self.stats.skipped_rounds[p] += 1
                continue
            self._place(p, slots[:n], cand[:n])
            self.last_placed[p] = cand[:n]
            self.stats.replaced_total[p] += n
            self.stats.replacement_rounds[p] += 1
            replaced[p] = n
        return replaced

    def _place(self, p: int, slots: np.ndarray, ids: np.ndarray) -> None:
        self.ids[p, slots] = ids
        self.scores[p, slots] = np.float32(self.policy.initial_score)
        if self._node_weights is not None:
            self.weights[p, slots] = self._node_weights[ids - self.id_base]
        self.valid[p, slots] = True
        self.accessed[p, slots] = False
        self.last_slots[p] = np.asarray(slots, dtype=np.int64)

    def place_rows(self, p: int, slots: np.ndarray, rows: np.ndarray) -> None:
        """Fill PE p's payload slots with real feature rows (the
        feature-store admission path: ids land via ``insert`` /
        ``replace_round``, rows via the store gather that follows)."""
        if self.payload is None:
            raise ValueError("engine has no payload (feature_dim=0)")
        if len(slots) != len(rows):
            raise ValueError(f"{len(slots)} slots != {len(rows)} rows")
        if len(slots):
            self.payload[p, np.asarray(slots, dtype=np.int64)] = rows

    def hit_rows(self, p: int) -> np.ndarray:
        """Payload rows of the most recent lookup's hits for PE p, in
        query order (empty ``(0, F)`` when the PE had no hits)."""
        if self.payload is None:
            raise ValueError("engine has no payload (feature_dim=0)")
        return self.payload[p, self.last_hit_slots[p]]


@dataclass
class FrontierStepOut:
    """Host-visible outputs of one single-launch frontier step
    (:meth:`DeviceEngine.fused_step_raw`), which derives the deduped
    remote query sets on device — the host never sees the raw frontier
    again after the upload."""

    hit_masks: list[np.ndarray]    # per PE, aligned with its query list
    missed: list[np.ndarray]       # per PE, int64 miss ids (query order)
    hits: np.ndarray               # (P,) int64
    hit_slots: list[np.ndarray]    # per PE, slots of the hits (query order)
    replaced: np.ndarray           # (P,) int64 — nodes newly placed
    placed: list[np.ndarray]       # per PE, int64 placed ids (cand order)
    placed_slots: list[np.ndarray] # per PE, slots filled (aligned w/ placed)
    n_valid: np.ndarray            # (P,) int64 post-round occupancy counts
    remote: list[np.ndarray]       # per PE, int64 unique remote ids (sorted)
    n_remote: np.ndarray           # (P,) int64 remote query counts


def _split_by_counts(flat: np.ndarray, counts: np.ndarray) -> list[np.ndarray]:
    """Split a flat array into per-PE views by segment lengths (plain
    slicing — ``np.split`` pays a swapaxes per segment, which dominates
    the fused step's host time at P=256)."""
    ends = np.cumsum(counts)
    starts = ends - counts
    return [flat[a:b] for a, b in zip(starts, ends)]


def resolve_device(device) -> torch.device:
    """The torch device a port entry point runs on. ``"cuda"`` without a
    card raises: the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    return dev


class DeviceEngine:
    """Device-resident twin of :class:`PrefetchEngine` (the fused hot path).

    Construction snapshots a warm-started ``PrefetchEngine`` into
    persistent torch tensors on ``device`` (ids int32, scores float32,
    valid / accessed / in-capacity masks, degree weights when the policy
    reads them) and from then on advances the whole cluster's buffer
    state one single-launch frontier step per training step
    (:meth:`fused_step_raw`): one ``(P, Mt + 1)`` upload, one launch,
    one packed readback. The ``(P, C)`` state never round-trips.

    Statistics are *shared* with the source engine (``self.stats is
    engine.stats``); :meth:`sync_to_engine` writes the tensor state
    back for post-run introspection and state-equality tests.

    This slice serves the narrow int32 id space only: ``id_base != 0``
    or ids past :data:`repro_torch.kernels.ops.INT32_ID_MAX` (the
    reference's wide ``(hi, lo)`` mode) raise ``NotImplementedError``.
    """

    def __init__(
        self,
        engine: PrefetchEngine,
        device="cuda",
        part_of: np.ndarray | None = None,
        id_base: int | None = None,
    ):
        from ..kernels import ops

        self.device = resolve_device(device)
        self.id_base = int(engine.id_base if id_base is None else id_base)
        max_known = int(engine.ids.max()) if engine.ids.size else -1
        if part_of is not None:
            max_known = max(max_known, len(part_of) - 1)
        if self.id_base or not ops.int32_id_eligible(max_known):
            raise NotImplementedError(
                "wide ids (id_base != 0 or ids > INT32_ID_MAX) need the wide "
                "frontier-step kernel, which is not ported yet (ROADMAP "
                "Queue B #6)"
            )
        dev = self.device
        self.engine = engine
        self.policy = engine.policy
        self.stats = engine.stats  # shared — trainer.engine.stats stays live
        self.capacity = engine.capacity
        self.num_pes = P = engine.num_pes
        self.max_capacity = engine.max_capacity
        self.feature_dim = engine.feature_dim
        self._node_weights = engine._node_weights

        def upload(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self._ids = upload(engine.ids.astype(np.int32), torch.int32)
        self._scores = upload(engine.scores, torch.float32)
        self._valid = upload(engine.valid, torch.bool)
        self._accessed = upload(engine.accessed, torch.bool)
        self._in_cap = upload(engine.in_capacity, torch.bool)
        # Weights ride on device only when the policy reads them; with
        # use_weights=False the staged weights array is dead state.
        self._weights = (
            upload(engine.weights, torch.float32)
            if self.policy.use_weights
            else None
        )
        self._weights0 = engine.weights.copy()
        self.last_placed = [np.array([], dtype=np.int64) for _ in range(P)]
        self.last_slots = [np.array([], dtype=np.int64) for _ in range(P)]
        self.last_hit_slots = [np.array([], dtype=np.int64) for _ in range(P)]

        # part_of rides on device so dedup + remoteness run in-launch;
        # node degree weights likewise when the policy scores with them.
        self._num_nodes = len(part_of) if part_of is not None else 0
        self._part_of_dev = (
            upload(np.asarray(part_of).astype(np.int32), torch.int32)
            if part_of is not None
            else None
        )
        self._node_w_dev = (
            upload(self._node_weights.astype(np.float32), torch.float32)
            if (self.policy.use_weights and self._node_weights is not None)
            else None
        )
        # Two-deep candidate rotation: launch t replaces with the misses
        # launch t-2 compacted on device (prime probes only, so the
        # admission stream lags the probe stream by exactly one step).
        self.cand_cap = 2 * self.max_capacity
        empty64 = np.array([], dtype=np.int64)
        self._cand_ready = torch.full((P, 1), -1, dtype=torch.int32, device=dev)
        self._cand_ready_ids = [empty64 for _ in range(P)]
        self._cand_pending = None
        self._cand_pending_ids = None
        # Host-boundary audit: one upload + one packed readback per step.
        self.transfers = {"h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0}

    # ------------------------------------------------------------------ #
    def occupancy_of(self, n_valid: np.ndarray) -> np.ndarray:
        """`PrefetchEngine.occupancy` from a launch's n_valid output."""
        return np.where(
            self.capacity > 0, n_valid / np.maximum(self.capacity, 1), 0.0
        )

    def fused_step_raw(
        self,
        touched: np.ndarray,
        active_score: np.ndarray,
        do_replace: np.ndarray,
        active_probe: np.ndarray,
        want: str = "full",
    ) -> FrontierStepOut:
        """One single-launch device step over the *raw* sampled frontier:
        dedup → score → replace → probe, one launch, one ``(P, Mt+1)``
        upload (frontier + packed gate bits) and one packed readback.

        ``touched`` is the dense ``(P, Mt)`` frontier block straight from
        the sampler (unsorted, duplicated; -1 padding allowed), with ids
        in ``[0, len(part_of))``. Replacement candidates are the misses
        the launch two steps back compacted on device. Bookkeeping and
        stats mirror the staged ``lookup`` / ``replace_round`` exactly.
        The reference's ``want="counts"`` readback cadence is not ported
        yet.
        """
        from ..kernels import ops

        if want != "full":
            raise NotImplementedError(
                "the counts-only readback cadence (readback_every > 1) is not "
                "ported yet (ROADMAP Queue A, readback cadence)"
            )
        P = self.num_pes
        if self._part_of_dev is None:
            raise ValueError(
                "fused_step_raw needs the partition map: construct the "
                "DeviceEngine with part_of=..."
            )
        touched = np.asarray(touched)
        if touched.ndim != 2 or touched.shape[0] != P:
            raise ValueError(
                f"touched must be (P, Mt) with P={P}, got {touched.shape}"
            )
        max_in = int(touched.max()) if touched.size else -1
        if max_in >= self._num_nodes:
            raise ValueError(
                f"frontier id {max_in} outside the partition map "
                f"(len(part_of) = {self._num_nodes})"
            )
        touched = touched.astype(np.int32, copy=False)
        if touched.shape[1] == 0:
            # Final drained launch: keep the (P, Mt>=1) shape the sort
            # prologue needs; an all(-1) row dedups to zero queries.
            touched = np.full((P, 1), -1, dtype=np.int32)
        do_rep = np.asarray(do_replace, dtype=bool)
        gates = (
            np.asarray(active_score, dtype=bool).astype(np.int32)
            | (do_rep.astype(np.int32) << 1)
            | (np.asarray(active_probe, dtype=bool).astype(np.int32) << 2)
        )
        aug = np.concatenate([touched, gates[:, None]], axis=1)
        aug_d = torch.from_numpy(aug).to(self.device)
        self.transfers["h2d"] += 1
        self.transfers["h2d_bytes"] += aug.nbytes
        tel.count("device.h2d_bytes", aug.nbytes)

        Kc = self._cand_ready.shape[1]
        _launch_sp = tel.begin("device.launch", plane="device")
        (
            self._ids,
            self._scores,
            self._valid,
            self._accessed,
            w2,
            cand_next,
            packed_d,
            _counters_d,
        ) = ops.fused_frontier_step_batch(
            self._ids,
            self._scores,
            self._valid,
            self._accessed,
            self._in_cap,
            self._weights,
            aug_d,
            self._part_of_dev,
            self._cand_ready,
            self._node_w_dev,
            cand_cap=self.cand_cap,
            **self.policy.kernel_constants(),
        )
        tel.end(_launch_sp)
        if w2 is not None:
            self._weights = w2

        with tel.span("device.readback", plane="device"):
            packed = packed_d.cpu().numpy()
        self.transfers["d2h"] += 1
        self.transfers["d2h_bytes"] += packed.nbytes
        tel.count("device.d2h_bytes", packed.nbytes)
        C = self.max_capacity
        Mt = aug.shape[1] - 1
        sk = packed[:, :Mt]
        code = packed[:, Mt : 2 * Mt]
        placed_m = packed[:, 2 * Mt : 2 * Mt + Kc] != 0
        slot_pos = packed[:, 2 * Mt + Kc : 2 * Mt + Kc + C]
        n_valid = packed[:, -1].astype(np.int64)

        # --- probe bookkeeping (lookup over the deduped remote sets) --- #
        remote_mask = code > 0
        n_remote = remote_mask.sum(axis=1).astype(np.int64)
        lengths = np.where(np.asarray(active_probe, dtype=bool), n_remote, 0)
        self.stats.lookups += lengths
        hits_per_pe = (code >= 2).sum(axis=1).astype(np.int64)
        self.stats.hits += hits_per_pe
        self.stats.misses += lengths - hits_per_pe
        flat_code = code[remote_mask]
        flat_hit = flat_code >= 2
        sk_remote = sk[remote_mask].astype(np.int64)
        remote = _split_by_counts(sk_remote, n_remote)
        hit_masks = _split_by_counts(flat_hit, n_remote)
        missed = _split_by_counts(sk_remote[~flat_hit], n_remote - hits_per_pe)
        hit_slots = _split_by_counts(
            (flat_code[flat_hit] - 2).astype(np.int64), hits_per_pe
        )
        self.last_hit_slots = list(hit_slots)

        # --- replacement bookkeeping (replace_round) ------------------- #
        clen = np.fromiter(map(len, self._cand_ready_ids), np.int64, count=P)
        cmask = np.arange(Kc) < clen[:, None]
        pm = placed_m & cmask
        n_per = pm.sum(axis=1).astype(np.int64)
        rounds = do_rep & (n_per > 0)
        self.stats.skipped_rounds += do_rep & (n_per == 0)
        self.stats.replaced_total += np.where(rounds, n_per, 0)
        self.stats.replacement_rounds += rounds
        replaced = np.where(rounds, n_per, 0)
        allc = (
            np.concatenate(self._cand_ready_ids)
            if clen.sum()
            else np.array([], dtype=np.int64)
        )
        self.last_placed = _split_by_counts(allc[pm[cmask]], n_per)
        # Placed candidates come out in candidate (= fresh-rank) order and
        # the r-th placed candidate fills the slot of fill rank r: a
        # stable argsort of the per-slot fill ranks pairs them up.
        order = np.argsort(slot_pos, axis=1, kind="stable").astype(np.int64)
        rank_mask = np.arange(slot_pos.shape[1]) < n_per[:, None]
        self.last_slots = _split_by_counts(order[rank_mask], n_per)

        # --- candidate rotation (device + host mirror) ----------------- #
        kc_next = cand_next.shape[1]
        if self._cand_pending is not None:
            self._cand_ready = self._cand_pending
            self._cand_ready_ids = self._cand_pending_ids
        self._cand_pending = cand_next
        self._cand_pending_ids = [m[:kc_next] for m in missed]

        return FrontierStepOut(
            hit_masks=hit_masks,
            missed=missed,
            hits=hits_per_pe,
            hit_slots=hit_slots,
            replaced=replaced,
            placed=list(self.last_placed),
            placed_slots=list(self.last_slots),
            n_valid=n_valid,
            remote=remote,
            n_remote=n_remote,
        )

    # ------------------------------------------------------------------ #
    def sync_to_engine(self) -> PrefetchEngine:
        """Write the device state back into the numpy twin (end of a
        device-mode run: snapshots, state-equality tests, reuse)."""
        eng = self.engine
        eng.ids = self._ids.cpu().numpy().astype(np.int64)
        eng.scores = self._scores.cpu().numpy()
        eng.valid = self._valid.cpu().numpy()
        eng.accessed = self._accessed.cpu().numpy()
        if self._weights is not None:
            eng.weights = self._weights.cpu().numpy()
        elif self._node_weights is not None:
            # use_weights=False but node_weights given: the staged engine
            # still refreshes slot weights at placement (dead state for
            # scoring); reconstruct it instead of tracking it on device.
            eng.weights = np.where(
                eng.valid,
                self._node_weights[
                    np.maximum(eng.ids - self.id_base, 0)
                ].astype(np.float32),
                self._weights0,
            ).astype(np.float32)
        eng.last_placed = [a.copy() for a in self.last_placed]
        eng.last_slots = [a.copy() for a in self.last_slots]
        eng.last_hit_slots = [a.copy() for a in self.last_hit_slots]
        return eng
