"""Vectorized multi-PE persistent-buffer state (the prefetch engine).

One :class:`PrefetchEngine` replaces the list of per-trainer
:class:`repro_torch.core.buffer.PersistentBuffer` objects: membership,
scores, validity and per-round access marks for *all* P trainer PEs live
in dense ``(P, C)`` numpy arrays (C = max buffer capacity across PEs;
slots past a PE's own capacity are permanent padding). It is the numpy
twin the trainer builds and warm-starts, and the engine of the staged
pipeline (:class:`repro_torch.runtime.stage.FetchStage`), whose scoring
round runs as a kernel with ``use_kernels``; its semantics are those of
the reference package's ``PrefetchEngine``.

:class:`DeviceEngine` is the device-resident twin the port's runtime
drives: the same ``(P, C)`` state (and, with a feature store, the
``(P*C, F)`` feature payload) held as persistent torch tensors on one
device and advanced one launch per training step — the single-launch
frontier step over the raw frontier
(:func:`repro_torch.kernels.ops.fused_frontier_step_batch`), or, for
ragged seed blocks, the fused step over host-deduped query sets in its
engine form, the uploaded gate words in and the packed readback out
(:func:`repro_torch.kernels.ops.fused_step_readback_batch`); the Hopper
kernels on a CUDA device, the plain versions on the CPU. Semantics and streams are
bit-identical to the reference's ``DeviceEngine``, in its narrow int32 id
mode and in its wide mode (int64 ids here, where the reference carries
``(hi, lo)`` int32 word planes).
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
    use_kernels:
        Route :meth:`end_round`'s scoring pass through the multi-PE
        kernel (``kernels.ops.score_policy_update_batch``) on ``device``:
        the Hopper kernel on a card, its plain version on the CPU. Both
        give the numpy path's float32 scores bit for bit.
    device:
        Where the kernel route runs (``"cuda"`` by default, or
        ``"cpu"``); resolved only when ``use_kernels`` is set, and
        ``"cuda"`` without a card raises ``RuntimeError``.
    """

    def __init__(
        self,
        capacities: list[int],
        policy: str | scoring.ScoringPolicy = "rudder",
        node_weights: np.ndarray | None = None,
        feature_dim: int = 0,
        id_base: int = 0,
        use_kernels: bool = False,
        device="cuda",
    ):
        self.capacity = np.asarray(capacities, dtype=np.int64)
        if (self.capacity < 0).any():
            raise ValueError("capacities must be >= 0")
        self.num_pes = P = len(capacities)
        self.max_capacity = C = int(self.capacity.max(initial=1)) if P else 1
        self.policy = scoring.make_policy(policy)
        self._node_weights = node_weights
        self.id_base = int(id_base)
        self.use_kernels = use_kernels
        self.device = resolve_device(device) if use_kernels else None
        # The kernel route's kept host blocks: the packed upload and the
        # readback (pinned on a card).
        self._stage = None
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
        if self.use_kernels:
            new = self._score_on_device(weights)
        else:
            new = self.policy.update(self.scores, self.accessed, weights)
        mask = active[:, None] & self.valid
        self.scores = np.where(mask, new, self.scores).astype(np.float32)
        self.accessed[active] = False

    def _score_on_device(self, weights: np.ndarray | None) -> np.ndarray:
        """The kernel route of :meth:`end_round`'s scoring pass: scores,
        access marks and (when the policy uses them) weights packed into
        one host block the engine keeps (pinned on a card), uploaded in
        one copy; ``ops.score_policy_update_batch`` on the device; the new
        scores read back in one copy and one wait. Returns the new scores
        ``(P, C)`` float32 (the kept readback buffer: the caller merges
        them into a fresh array before the next round)."""
        from ..kernels import ops

        P, C = self.scores.shape
        n = P * C
        # Byte offsets of the three parts, each on a 16-byte boundary so
        # that the kernel's vector loads apply.
        at_w = -(-4 * n // 16) * 16
        at_a = at_w + (at_w if weights is not None else 0)
        nbytes = at_a + n
        pinned = self.device.type == "cuda"
        if (self._stage is None or self._stage[0].numel() < nbytes
                or self._stage[1].numel() < 4 * n):
            self._stage = (
                torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned),
                torch.empty(4 * n, dtype=torch.uint8, pin_memory=pinned),
            )
        stage, back = self._stage
        host = stage.numpy()
        host[: 4 * n].view(np.float32)[:] = self.scores.ravel()
        if weights is not None:
            host[at_w : at_w + 4 * n].view(np.float32)[:] = weights.ravel()
        host[at_a:nbytes].view(bool)[:] = self.accessed.ravel()
        dev = stage[:nbytes].to(self.device, non_blocking=True)

        def part(at, dtype, size):
            return dev[at : at + size * dtype.itemsize].view(dtype).view(P, C)

        kc = self.policy.kernel_constants()
        kc.pop("initial_score")  # the scoring pass never places slots
        new, _ = ops.score_policy_update_batch(
            part(0, torch.float32, n),
            part(at_a, torch.bool, n),
            None if weights is None else part(at_w, torch.float32, n),
            **kc,
        )
        out = back.view(torch.float32)[:n].view(P, C)
        out.copy_(new, non_blocking=True)
        if pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()

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
class FusedStepOut:
    """Host-visible outputs of one fused step (:meth:`DeviceEngine.fused_step`)."""

    hit_masks: list[np.ndarray]    # per PE, aligned with its query list
    missed: list[np.ndarray]       # per PE, int64 miss ids (query order)
    hits: np.ndarray               # (P,) int64
    hit_slots: list[np.ndarray]    # per PE, slots of the hits (query order)
    replaced: np.ndarray           # (P,) int64 — nodes newly placed
    placed: list[np.ndarray]       # per PE, int64 placed ids (cand order)
    placed_slots: list[np.ndarray] # per PE, slots filled (aligned w/ placed)
    n_valid: np.ndarray            # (P,) int64 post-round occupancy counts


@dataclass
class FrontierStepOut(FusedStepOut):
    """:class:`FusedStepOut` of a single-launch frontier step
    (:meth:`DeviceEngine.fused_step_raw`), which also derives the deduped
    remote query sets on device — the host never sees the raw frontier
    again after the upload."""

    remote: list[np.ndarray] = None   # per PE, int64 unique remote ids (sorted)
    n_remote: np.ndarray = None       # (P,) int64 remote query counts


def _split_by_counts(flat: np.ndarray, counts: np.ndarray) -> list[np.ndarray]:
    """Split a flat array into per-PE views by segment lengths (plain
    slicing — ``np.split`` pays a swapaxes per segment, which dominates
    the fused step's host time at P=256)."""
    ends = np.cumsum(counts)
    starts = ends - counts
    return [flat[a:b] for a, b in zip(starts, ends)]


def _gate_bits(active_score, do_replace, active_probe) -> np.ndarray:
    """Per-PE int32 gate bits ``active_score | do_replace << 1 |
    active_probe << 2``, as the kernels read them."""
    return (
        np.asarray(active_score, dtype=bool).astype(np.int32)
        | (np.asarray(do_replace, dtype=bool).astype(np.int32) << 1)
        | (np.asarray(active_probe, dtype=bool).astype(np.int32) << 2)
    )


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
    reads them, the feature payload when the engine has one) and from
    then on advances the whole cluster's buffer state one launch per
    training step: :meth:`fused_step_raw` (one ``(P, Mt + 1)`` upload,
    one launch, one packed readback) or, for ragged seed blocks,
    :meth:`fused_step` (one packed upload of queries, candidates and
    gates, one launch, one packed readback). The ``(P, C)`` state never
    round-trips.

    Statistics are *shared* with the source engine (``self.stats is
    engine.stats``); :meth:`sync_to_engine` writes the tensor state
    back for post-run introspection and state-equality tests.

    Narrow mode holds ids as int32 and serves id universes up to
    :data:`repro_torch.kernels.ops.INT32_ID_MAX`. Whenever ``id_base``
    is nonzero or an id passes that bound the engine takes **wide
    mode**, as the reference does: ids are int64 on the device and every
    launch goes through the ``_wide`` kernels, up to
    :data:`repro_torch.kernels.ops.WIDE_ID_MAX` (about 2^61). Ids past
    the wide bound raise ``ValueError`` at construction and per launch.
    ``fused_step_raw(want="counts")`` serves the K-step readback cadence.
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
        # Any nonzero base puts the whole id universe at or above it.
        max_known = max(max_known, self.id_base)
        if part_of is not None:
            # Every global id of the run is id_base + a local index.
            max_known = max(max_known, self.id_base + len(part_of) - 1)
        self.wide = bool(self.id_base) or not ops.int32_id_eligible(max_known)
        if self.wide and not ops.wide_id_eligible(max_known):
            raise ValueError(
                "device engine ids exceed the wide-id bound "
                f"(max id {max_known} > {ops.WIDE_ID_MAX}); use the staged "
                "pipeline"
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
            a = np.ascontiguousarray(a)
            tel.copied("engine.state", "h2d", a.nbytes)
            return torch.from_numpy(a).to(dev, dtype)

        self._id_dtype = torch.int64 if self.wide else torch.int32
        self._ids = upload(engine.ids, self._id_dtype)
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
        # The payload is written in place (place_rows_batch): a copy, so
        # the numpy twin never changes under it on the CPU.
        self.payload = (
            upload(engine.payload.reshape(-1, engine.feature_dim), torch.float32).clone()
            if engine.payload is not None
            else None
        )
        self._store = None  # FeatureStore for the in-launch payload scatter
        self.last_placed = [np.array([], dtype=np.int64) for _ in range(P)]
        self.last_slots = [np.array([], dtype=np.int64) for _ in range(P)]
        self.last_hit_slots = [np.array([], dtype=np.int64) for _ in range(P)]

        # part_of rides on device so dedup + remoteness run in-launch;
        # node degree weights likewise when the policy scores with them.
        self._num_nodes = len(part_of) if part_of is not None else 0
        # Id range of the kernels' direct-mapped maps, [_id_lo, _id_bound):
        # every id the state holds or a launch brings lies in it (grown as
        # ids arrive). Narrow mode keys the maps by the id itself.
        live = engine.ids[engine.valid]
        self._id_lo = (
            min(self.id_base, int(live.min()) if live.size else self.id_base)
            if self.wide
            else 0
        )
        self._id_bound = max(self.id_base + self._num_nodes, max_known + 1)
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
        self._cand_ready = torch.full((P, 1), -1, dtype=self._id_dtype, device=dev)
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

    def _transfer(self, site: str, way: str, nbytes: int) -> None:
        """One audited copy of the step's host boundary (``transfers``),
        counted by site in the telemetry (:func:`repro_torch.telemetry.copied`)."""
        self.transfers[way] += 1
        self.transfers[f"{way}_bytes"] += int(nbytes)
        tel.copied(site, way, nbytes)

    def fused_step(
        self,
        queries: list[np.ndarray],
        candidates: list[np.ndarray],
        active_score: np.ndarray,
        do_replace: np.ndarray,
        active_probe: np.ndarray,
    ) -> FusedStepOut:
        """One fused launch: score (``end_round(active_score)``) → replace
        (``replace_round(candidates, do_replace)``) → probe
        (``lookup(queries, active_probe)``) — the step of the
        ragged-seed-block loop (see the pipeline rotation in
        :class:`repro_torch.runtime.stage.FusedFetchStage`).

        Ragged inputs are -1 padded to the widest PE (at least 1;
        candidate dedup happens in the step). Queries, candidates, gates
        and (for weighted policies) the candidate weights, bit-cast to
        int32 words (two per id in wide mode), travel as one flat upload
        — one h2d transfer per step where the reference makes five (six
        when weighted, seven and eight in wide mode); the five outputs
        come back as one packed readback. Per-PE stats and the
        ``last_*`` bookkeeping are updated exactly as the staged engine
        does."""
        from ..kernels import ops

        _pack_sp = tel.begin("fetch.pack", plane="engine")
        P = self.num_pes
        do_rep = np.asarray(do_replace, dtype=bool)
        empty64 = np.array([], dtype=np.int64)
        qlen = np.fromiter(map(len, queries), np.int64, count=P)
        cands = (
            list(candidates)
            if do_rep.all()
            else [candidates[p] if do_rep[p] else empty64 for p in range(P)]
        )
        clen = np.fromiter(map(len, cands), np.int64, count=P)
        allq = (
            np.concatenate(queries, dtype=np.int64, casting="unsafe")
            if qlen.sum()
            else empty64
        )
        allc = (
            np.concatenate(cands, dtype=np.int64, casting="unsafe")
            if clen.sum()
            else empty64
        )
        max_in = max(
            int(allq.max()) if allq.size else -1,
            int(allc.max()) if allc.size else -1,
        )
        if self.wide:
            if not ops.wide_id_eligible(max_in):
                raise ValueError(
                    "device engine ids exceed the wide-id bound "
                    f"(max id {max_in} > {ops.WIDE_ID_MAX})"
                )
        elif not ops.int32_id_eligible(max_in):
            raise ValueError("device engine needs node ids < 2^31")
        if self._num_nodes and max_in - self.id_base >= self._num_nodes:
            raise ValueError(
                f"id {max_in} outside the partition map "
                f"(id_base {self.id_base}, len(part_of) = {self._num_nodes})"
            )
        self._id_bound = max(self._id_bound, max_in + 1)
        if self.wide:
            live = np.concatenate([allq, allc])
            live = live[live >= 0]
            if live.size:
                self._id_lo = min(self._id_lo, int(live.min()))
        M = max(int(qlen.max(initial=0)), 1)
        K = max(int(clen.max(initial=0)), 1)
        qmask = np.arange(M) < qlen[:, None]
        cmask = np.arange(K) < clen[:, None]
        idt = np.int64 if self.wide else np.int32
        q = np.full((P, M), -1, dtype=idt)
        c = np.full((P, K), -1, dtype=idt)
        q[qmask] = allq
        c[cmask] = allc
        parts = [
            q.view(np.int32).ravel(),
            c.view(np.int32).ravel(),
            _gate_bits(active_score, do_rep, active_probe),
        ]
        if self._weights is not None:
            cw = np.ones((P, K), dtype=np.float32)
            if self._node_weights is not None and allc.size:
                cw[cmask] = self._node_weights[allc - self.id_base]
            parts.append(cw.view(np.int32).ravel())
        block = np.concatenate(parts)
        blk = torch.from_numpy(block).to(self.device)
        self._transfer("engine.frontier", "h2d", block.nbytes)
        # Int32 words per id; the id slices start at even offsets, so a
        # wide slice views as int64 in place.
        nq = P * M * q.itemsize // 4
        nc = P * K * c.itemsize // 4
        q_d = blk[:nq].view(self._id_dtype).view(P, M)
        c_d = blk[nq : nq + nc].view(self._id_dtype).view(P, K)
        g_d = blk[nq + nc : nq + nc + P]
        cw_d = (
            blk[nq + nc + P :].view(torch.float32).view(P, K)
            if self._weights is not None
            else None
        )
        tel.end(_pack_sp)
        _launch_sp = tel.begin("device.launch", plane="device")
        lo, span = (
            (self._id_lo, self._id_bound - self._id_lo)
            if self.wide
            else (None, self._id_bound)
        )
        (
            self._ids,
            self._scores,
            self._valid,
            self._accessed,
            w2,
            packed_d,
        ) = ops.fused_step_readback_batch(
            self._ids,
            self._scores,
            self._valid,
            self._accessed,
            self._in_cap,
            self._weights,
            q_d,
            c_d,
            cw_d,
            g_d,
            id_lo=lo,
            num_ids=span,
            **self.policy.kernel_constants(),
        )
        tel.end(_launch_sp)
        if w2 is not None:
            self._weights = w2
        ready = tel.mark(self.device)
        with tel.span("device.readback", plane="device"):
            tel.wait(ready)
            packed = packed_d.cpu().numpy()
        self._transfer("engine.packed", "d2h", packed.nbytes)
        _unpack_sp = tel.begin("fetch.unpack", plane="engine")
        C = self.max_capacity
        hit = packed[:, :M] != 0
        hit_slot = packed[:, M : 2 * M]
        placed_m = packed[:, 2 * M : 2 * M + K] != 0
        slot_pos = packed[:, 2 * M + K : 2 * M + K + C]
        n_valid = packed[:, -1].astype(np.int64)

        # --- probe bookkeeping (PrefetchEngine.lookup) ----------------- #
        lengths = np.where(np.asarray(active_probe, dtype=bool), qlen, 0)
        self.stats.lookups += lengths
        hits_per_pe = hit.sum(axis=1).astype(np.int64)
        self.stats.hits += hits_per_pe
        self.stats.misses += lengths - hits_per_pe
        flat_hit = hit[qmask]
        hit_masks = _split_by_counts(flat_hit, qlen)
        missed = _split_by_counts(allq[~flat_hit], qlen - hits_per_pe)
        hit_slots = _split_by_counts(
            hit_slot[qmask][flat_hit].astype(np.int64), hits_per_pe
        )
        self.last_hit_slots = list(hit_slots)

        # --- replacement bookkeeping (PrefetchEngine.replace_round) ---- #
        pm = placed_m & cmask
        n_per = pm.sum(axis=1).astype(np.int64)
        rounds = do_rep & (n_per > 0)
        self.stats.skipped_rounds += do_rep & (n_per == 0)
        self.stats.replaced_total += np.where(rounds, n_per, 0)
        self.stats.replacement_rounds += rounds
        replaced = np.where(rounds, n_per, 0)
        self.last_placed = _split_by_counts(allc[pm[cmask]], n_per)
        # Placed candidates come out in candidate (= fresh-rank) order and
        # the r-th placed candidate fills the slot of fill rank r: a
        # stable argsort of the per-slot fill ranks pairs them up.
        order = np.argsort(slot_pos, axis=1, kind="stable").astype(np.int64)
        rank_mask = np.arange(slot_pos.shape[1]) < n_per[:, None]
        self.last_slots = _split_by_counts(order[rank_mask], n_per)
        out = FusedStepOut(
            hit_masks=hit_masks,
            missed=missed,
            hits=hits_per_pe,
            hit_slots=hit_slots,
            replaced=replaced,
            placed=list(self.last_placed),
            placed_slots=list(self.last_slots),
            n_valid=n_valid,
        )
        tel.end(_unpack_sp)
        return out

    def attach_store(self, store) -> None:
        """Wire a :class:`repro_torch.store.FeatureStore` into the
        single-launch step: admission rows are copied from the store's
        flat table (:meth:`FeatureStore.device_view` on this engine's
        device) straight into the payload."""
        self._store = store

    def fused_step_raw(
        self,
        touched: np.ndarray,
        active_score: np.ndarray,
        do_replace: np.ndarray,
        active_probe: np.ndarray,
        want: str = "full",
    ):
        """One single-launch device step over the *raw* sampled frontier:
        dedup → score → replace → probe → payload scatter, one launch,
        one ``(P, Mt+1)`` upload (frontier + packed gate bits) and one
        packed readback.

        ``touched`` is the dense ``(P, Mt)`` frontier block straight from
        the sampler (unsorted, duplicated; -1 padding allowed), with ids
        in ``[id_base, id_base + len(part_of))``. Replacement candidates
        are the misses the launch two steps back compacted on device.
        Bookkeeping and stats mirror the staged ``lookup`` /
        ``replace_round`` exactly; returns a :class:`FrontierStepOut`.

        ``want="counts"`` is the K-step readback cadence: the launch's
        host-facing block stays on the device and only its ``(P, 4)`` int32
        ``[n_remote, hits, n_place, n_valid]`` counters are returned, as a
        *device* tensor (the caller stacks K of them and pulls once). The
        candidate buffers rotate on the device; no stats or ``last_*``
        bookkeeping happens, and nothing is read back.
        """
        from ..kernels import ops

        if want not in ("full", "counts"):
            raise ValueError(f"want must be 'full' or 'counts', got {want!r}")
        _pack_sp = tel.begin("fetch.pack", plane="engine")
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
        if self.wide:
            if not ops.wide_id_eligible(max_in):
                raise ValueError(
                    "device engine ids exceed the wide-id bound "
                    f"(max id {max_in} > {ops.WIDE_ID_MAX})"
                )
            live = touched[touched >= 0]
            min_in = int(live.min()) if live.size else self.id_base
        else:
            min_in = 0
        if max_in - self.id_base >= self._num_nodes or min_in < self.id_base:
            raise ValueError(
                f"frontier ids [{min_in}, {max_in}] outside the partition map "
                f"(id_base {self.id_base}, len(part_of) = {self._num_nodes})"
            )
        idt = np.int64 if self.wide else np.int32
        touched = touched.astype(idt, copy=False)
        if touched.shape[1] == 0:
            # Final drained launch: keep the (P, Mt>=1) shape the sort
            # prologue needs; an all(-1) row dedups to zero queries.
            touched = np.full((P, 1), -1, dtype=idt)
        do_rep = np.asarray(do_replace, dtype=bool)
        gates = _gate_bits(active_score, do_rep, active_probe).astype(idt)
        aug = np.concatenate([touched, gates[:, None]], axis=1)
        aug_d = torch.from_numpy(aug).to(self.device)
        self._transfer("engine.frontier", "h2d", aug.nbytes)

        table = loc = None
        if self._store is not None and self.payload is not None:
            table, loc = self._store.device_view(self.device)

        Kc = self._cand_ready.shape[1]
        if self.wide:
            step = ops.fused_frontier_step_wide_batch
            extra = dict(id_base=self.id_base)
        else:
            step, extra = ops.fused_frontier_step_batch, {}
        tel.end(_pack_sp)
        _launch_sp = tel.begin("device.launch", plane="device")
        (
            self._ids,
            self._scores,
            self._valid,
            self._accessed,
            w2,
            payload2,
            cand_next,
            packed_d,
            counters_d,
        ) = step(
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
            self.payload,
            table,
            loc,
            cand_cap=self.cand_cap,
            **extra,
            **self.policy.kernel_constants(),
        )
        tel.end(_launch_sp)
        if w2 is not None:
            self._weights = w2
        if payload2 is not None:
            self.payload = payload2

        if want == "counts":
            # Rotate the device candidate buffers and hand back only the
            # counters, still on the device; the host mirrors are not kept
            # (no per-step bookkeeping on the cadence path).
            if self._cand_pending is not None:
                self._cand_ready = self._cand_pending
            self._cand_pending = cand_next
            return counters_d

        ready = tel.mark(self.device)
        with tel.span("device.readback", plane="device"):
            tel.wait(ready)
            packed = packed_d.cpu().numpy()
        self._transfer("engine.packed", "d2h", packed.nbytes)
        _unpack_sp = tel.begin("fetch.unpack", plane="engine")
        C = self.max_capacity
        Mt = aug.shape[1] - 1
        # The keys lead the block: int32, or int64 as int32 pairs.
        w = touched.itemsize // 4
        sk = packed[:, : w * Mt]
        if self.wide:
            sk = np.ascontiguousarray(sk).view(np.int64)
        code = packed[:, w * Mt : (w + 1) * Mt]
        head = (w + 1) * Mt
        placed_m = packed[:, head : head + Kc] != 0
        slot_pos = packed[:, head + Kc : head + Kc + C]
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

        out = FrontierStepOut(
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
        tel.end(_unpack_sp)
        return out

    # ------------------------------------------------------------------ #
    # feature payload (device-resident)
    # ------------------------------------------------------------------ #
    def pull_rows(self, slots_per_pe: list[np.ndarray]) -> list[np.ndarray]:
        """Payload rows at per-PE slots, one batched device gather and one
        readback (the probe-time hit-row capture of the store data
        plane)."""
        if self.payload is None:
            raise ValueError("engine has no payload (feature_dim=0)")
        C = self.max_capacity
        lengths = [len(s) for s in slots_per_pe]
        if sum(lengths) == 0:
            empty = np.zeros((0, self.feature_dim), dtype=np.float32)
            return [empty.copy() for _ in slots_per_pe]
        flat = np.concatenate(
            [
                np.asarray(s, dtype=np.int64) + p * C
                for p, s in enumerate(slots_per_pe)
            ]
        )
        with tel.span("device.readback", plane="device"):
            tel.copied("engine.hit_index", "h2d", flat.nbytes)
            rows = (
                self.payload.index_select(0, torch.from_numpy(flat).to(self.device))
                .cpu()
                .numpy()
            )
        self._transfer("engine.hit_rows", "d2h", rows.nbytes)
        return [
            np.ascontiguousarray(b)
            for b in np.split(rows, np.cumsum(lengths)[:-1])
        ]

    def place_rows_batch(self, slots_per_pe, blocks, device_block=None):
        """Scatter admission rows into the device payload (one indexed
        write, in place); ``device_block`` skips the host→device upload
        when the store gather already produced a device copy."""
        if self.payload is None:
            raise ValueError("engine has no payload (feature_dim=0)")
        C = self.max_capacity
        idx, rows = [], []
        for p, slots in enumerate(slots_per_pe):
            if len(slots) != len(blocks[p]):
                raise ValueError(
                    f"PE {p}: {len(slots)} slots != {len(blocks[p])} rows"
                )
            if len(slots):
                idx.append(np.asarray(slots, dtype=np.int64) + p * C)
                rows.append(blocks[p])
        if not idx:
            return
        flat = np.concatenate(idx)
        tel.copied("engine.placed_index", "h2d", flat.nbytes)
        flat = torch.from_numpy(flat).to(self.device)
        if device_block is not None:
            data = device_block.to(self.device)
        else:
            host = np.concatenate(rows, dtype=np.float32)
            data = torch.from_numpy(host).to(self.device)
            self._transfer("engine.placed_rows", "h2d", host.nbytes)
        self.payload[flat] = data

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
        if self.payload is not None:
            eng.payload = self.payload.cpu().numpy().reshape(
                self.num_pes, self.max_capacity, self.feature_dim
            )
        if tel.enabled():
            state = (self._ids, self._scores, self._valid, self._accessed,
                     self._weights, self.payload)
            tel.copied("engine.state", "d2h", sum(
                t.numel() * t.element_size() for t in state if t is not None
            ))
        eng.last_placed = [a.copy() for a in self.last_placed]
        eng.last_slots = [a.copy() for a in self.last_slots]
        eng.last_hit_slots = [a.copy() for a in self.last_hit_slots]
        return eng
