"""The runtime's explicit three-stage pipeline: sample → decide → fetch.

One minibatch of the whole cluster flows through three stage objects,
each advancing all P trainer PEs in one batched pass:

* :class:`SampleStage` — per-PE seed blocks through the batched
  :class:`repro_torch.graph.sampler.SamplerPlane`: dense ``(P, B)``
  fanout expansion on the shared CSR, handing the raw ``(P, Mt)``
  frontier to the device (uniform seed blocks on the device loop), or
  the deduped remote sets (the staged loop, and ragged seed blocks);
* :class:`DecisionStage` — the paper's request/response queue hand-off
  (§4.5, Fig. 11) as a double-buffered two-slot stage over the batched
  :class:`repro_torch.core.controller.DecisionPlane`;
* :class:`FetchStage` — the staged fetch plane over the numpy
  :class:`repro_torch.runtime.engine.PrefetchEngine`: one batched buffer
  probe, then the scoring and replacement round (the scoring pass and
  the sampler's dedup optionally on kernels) and the accounting;
* :class:`FusedFetchStage` — the device-resident fetch plane: one
  launch per training step
  (:meth:`repro_torch.runtime.engine.DeviceEngine.fused_step_raw` or
  :meth:`~repro_torch.runtime.engine.DeviceEngine.fused_step`), the
  feature-store data path when a store is attached, and the wall-clock
  accounting via the run's time engine (:mod:`repro_torch.sim`).

Each stage preserves the reference runtime's operation order, so
hit/miss/byte counts, decision streams and modeled step times are
bit-identical to it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import telemetry as tel
from ..core.controller import Controller, DecisionPlane
from ..core.metrics import Metrics
from ..graph.sampler import MiniBatch, SamplerPlane
from ..sim import build_step_comm


class DecisionStage:
    """Two-slot (request, response) pipeline over the batched decision plane."""

    def __init__(self, controllers: list[Controller]):
        self.plane = DecisionPlane(controllers)
        self.controllers = self.plane.controllers
        self.uses_buffer = self.plane.uses_buffer
        self.inference_cost = self.plane.inference_cost
        self._request: list[Metrics] | None = None

    def submit(self, metrics: list[Metrics]) -> None:
        """Fill the request buffer (one Metrics per PE)."""
        if self._request is not None:
            raise RuntimeError("request buffer full: collect() the previous round")
        if len(metrics) != len(self.controllers):
            raise ValueError(
                f"expected {len(self.controllers)} metrics, got {len(metrics)}"
            )
        self._request = list(metrics)

    @tel.spanned("decision", plane="decision")
    def collect(self):
        """Drain the response buffer: ``(decisions, stall_ticks)`` per PE."""
        if self._request is None:
            raise RuntimeError("request buffer empty: submit() metrics first")
        pending, self._request = self._request, None
        return self.plane.step(pending)


class SampleStage:
    """Batched sampling stage: per-PE seed blocks → minibatches + fetch
    sets. ``seed_fn(p, epoch, mb)`` supplies PE p's seed block; only the
    fanout draws consume the shared RNG, in the reference's PE-major
    order."""

    def __init__(self, plane: SamplerPlane, num_pes: int, seed_fn, part_of):
        self.plane = plane
        self.num_pes = num_pes
        self.seed_fn = seed_fn
        self.part_of = part_of

    @tel.spanned("sample", plane="sampling")
    def run(
        self, epoch: int, mb: int, rng: np.random.Generator
    ) -> tuple[list[MiniBatch], list[np.ndarray], np.ndarray]:
        """``(minibatches, remote, n_remote)`` for all P PEs: the deduped
        remote fetch sets of the staged loop and of the ragged-seed-block
        loop."""
        seed_blocks = [self.seed_fn(p, epoch, mb) for p in range(self.num_pes)]
        minibatches, remote = self.plane.sample_all(
            seed_blocks, rng, part_of=self.part_of
        )
        n_remote = np.array([len(r) for r in remote], dtype=np.int64)
        return minibatches, remote, n_remote

    @tel.spanned("sample", plane="sampling")
    def run_raw(
        self, epoch: int, mb: int, rng: np.random.Generator
    ) -> tuple[list[MiniBatch], np.ndarray]:
        """``(minibatches, touched)`` where ``touched`` is the raw
        ``(P, Mt)`` frontier destined for the single-launch device step
        — no host dedup or remote extraction (same RNG consumption as
        :meth:`run`)."""
        seed_blocks = [self.seed_fn(p, epoch, mb) for p in range(self.num_pes)]
        return self.plane.sample_all_raw(seed_blocks, rng)


@dataclass
class ProbeResult:
    """Per-PE outputs of the buffer probe (stage-3 metrics inputs)."""

    hit_masks: list[np.ndarray]
    missed: list[np.ndarray]
    hits: np.ndarray          # (P,) int64
    pct_hits: np.ndarray      # (P,) float64
    comm: np.ndarray          # (P,) int64 — miss fetches only
    occupancy: np.ndarray     # (P,) float64, pre-replacement
    replaced_pct: np.ndarray  # (P,) float64, previous round's churn
    #: The probed remote query sets, on the device loops (on the raw
    #: path derived on device from the frontier and handed back in the
    #: packed readback); None on the staged loop, whose driver holds them.
    remote: list[np.ndarray] | None = None
    n_remote: np.ndarray | None = None


@dataclass
class CommitResult:
    """Per-PE outputs of the scoring/replacement/accounting half."""

    replaced: np.ndarray      # (P,) int64
    total_comm: np.ndarray    # (P,) int64 — misses + replacement traffic
    step_time: np.ndarray     # (P,) float64, §4.5.3 model
    occupancy: np.ndarray     # (P,) float64, post-replacement
    missed: list[np.ndarray]  # this minibatch's miss fetches
    placed: list[np.ndarray]  # this round's replacement admissions
    #: Feature-store outputs (None / empty when the store is off).
    #: ``features[p]`` is PE p's (n_remote, F) remote feature block in
    #: sampled-remote order — hits served from the engine payload,
    #: misses from the store gather.
    features: list[np.ndarray] | None = None
    feat_sums: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float64)
    )                         # (P,) float64 — content-sensitive block sums
    bytes_measured: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )                         # (P,) int64 — bytes the store actually moved
    bytes_modeled: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )                         # (P,) int64 — §4.5.3 accounting bytes
    fetch_seconds: float = 0.0  # wall-clock time of this step's gathers


def _count_fetch(miss_comm, replaced, feature_dim, feature_bytes):
    """Telemetry-on-only fetch accounting: per-PE node and byte counters.
    Observational — reads the same exact streams the time engine already
    priced, never alters them."""
    row_bytes = feature_dim * feature_bytes
    miss_comm = np.asarray(miss_comm, dtype=np.float64)
    replaced = np.asarray(replaced, dtype=np.float64)
    tel.count("fetch.miss_nodes", miss_comm)
    tel.count("fetch.replaced_nodes", replaced)
    tel.count("fetch.bytes_modeled", (miss_comm + replaced) * row_bytes)


class FetchStage:
    """Two-phase batched fetch plane: probe → (decisions) → commit.

    ``probe(remote, n_remote)`` answers every PE's buffer membership
    query in one batched pass and buffers the miss sets; after the
    decision stage, ``commit(decisions, stalls)`` closes the round —
    batched scoring, batched replacement (admitting the *previous*
    minibatch's misses; Algorithm 1 queues the next minibatch before the
    decision lands), and the communication/step-time accounting.

    Wall-clock pricing is delegated to the run's ``time_engine``
    (:mod:`repro_torch.sim`): the closed-form §4.5.3 model (flat constants or
    per-pair :class:`Topology` costs) or the discrete-event cluster
    simulator. The stage hands it the exact miss/replacement node sets
    (``engine.last_placed``) split by home partition when the engine
    asks (``needs_pairs``).

    With a :class:`repro_torch.store.FeatureStore` attached (``store=``), the
    stage additionally *moves* the bytes the accounting counts: hit rows
    come out of the engine payload (captured at probe time), miss and
    admission rows come out of the store in one batched timed gather,
    admissions fill the payload (``engine.place_rows``), and the commit
    reports per-PE remote feature blocks plus measured-vs-modeled byte
    and wall-clock streams. The store never alters the exact streams —
    hit/miss/byte/decision payloads stay bit-identical to the modeled
    path (the golden-trace conformance contract).
    """

    def __init__(
        self,
        engine,
        uses_buffer: np.ndarray,
        inference_cost: np.ndarray,
        time_engine,
        feature_dim: int,
        mode: str,
        part_of: np.ndarray | None = None,
        store=None,
        feature_bytes: int = 4,
    ):
        if time_engine.needs_pairs and part_of is None:
            raise ValueError("per-home comm pricing needs part_of")
        if store is not None and engine.payload is None:
            raise ValueError(
                "feature store needs an engine payload "
                "(PrefetchEngine(feature_dim=...))"
            )
        P = engine.num_pes
        self.engine = engine
        self.uses_buffer = uses_buffer
        self.inference_cost = inference_cost
        self.time_engine = time_engine
        self.feature_dim = feature_dim
        self.feature_bytes = int(feature_bytes)
        self.mode = mode
        self.part_of = part_of
        self.store = store
        self.active = uses_buffer & (engine.capacity > 0)
        self._capacity = engine.capacity.astype(np.float64)
        self._prev_missed: list[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(P)
        ]
        self._missed: list[np.ndarray] | None = None
        self._hit_masks: list[np.ndarray] | None = None
        self._hit_rows: list[np.ndarray] | None = None
        self._last_replaced = np.zeros(P, dtype=np.int64)
        self._have_replaced = False

    @tel.spanned("fetch.probe", plane="engine")
    def probe(self, remote: list[np.ndarray], n_remote: np.ndarray) -> ProbeResult:
        """Batched buffer lookup; buffers the miss sets for commit()."""
        if self._missed is not None:
            raise RuntimeError("probe already pending: commit() the round first")
        hit_masks, missed = self.engine.lookup(remote, self.active)
        hits = np.array([int(h.sum()) for h in hit_masks], dtype=np.int64)
        pct_hits = np.where(
            self.active,
            np.where(n_remote > 0, 100.0 * hits / np.maximum(n_remote, 1), 100.0),
            0.0,
        )
        comm = np.array([len(m) for m in missed], dtype=np.int64)
        replaced_pct = np.where(
            self._have_replaced & (self._capacity > 0),
            100.0 * self._last_replaced / np.maximum(self._capacity, 1.0),
            0.0,
        )
        self._missed = missed
        if self.store is not None:
            # Hit rows must be captured now: the payload slots of this
            # round's hits may be overwritten by commit()'s admissions.
            self._hit_masks = hit_masks
            self._hit_rows = [
                self.engine.hit_rows(p) for p in range(self.engine.num_pes)
            ]
        return ProbeResult(
            hit_masks=hit_masks,
            missed=missed,
            hits=hits,
            pct_hits=pct_hits,
            comm=comm,
            occupancy=self.engine.occupancy(),
            replaced_pct=replaced_pct,
        )

    @tel.spanned("fetch.commit", plane="engine")
    def commit(self, decisions: np.ndarray, stalls: np.ndarray) -> CommitResult:
        """Scoring + replacement round + wall-clock accounting."""
        if self._missed is None:
            raise RuntimeError("nothing probed: probe() the round first")
        engine = self.engine
        engine.end_round(self.uses_buffer)
        replaced = engine.replace_round(
            self._prev_missed, decisions & self.uses_buffer
        )
        missed, self._missed = self._missed, None
        self._prev_missed = missed
        self._last_replaced = replaced
        self._have_replaced = True
        comm = np.array([len(m) for m in missed], dtype=np.int64)
        # Replacement traffic is communication (Alg. 1 line 14).
        total_comm = comm + replaced
        if tel.enabled():
            _count_fetch(comm, replaced, self.feature_dim, self.feature_bytes)
        t = self.time_engine.step(
            build_step_comm(
                missed,
                engine.last_placed,
                self.part_of,
                engine.num_pes,
                self.time_engine.needs_pairs,
                id_base=engine.id_base,
            ),
            stalls,
        )
        result = CommitResult(
            replaced=replaced,
            total_comm=total_comm,
            step_time=t,
            occupancy=engine.occupancy(),
            missed=missed,
            placed=list(engine.last_placed),
        )
        if self.store is not None:
            self._serve_features(result)
        return result

    @tel.spanned("fetch.serve", plane="store")
    def _serve_features(self, result: CommitResult) -> None:
        """Move the bytes the accounting counted: one batched store
        gather for every PE's misses, one for every PE's admissions
        (which then fill the engine payload), and the per-PE remote
        block assembly — hits from the probe-time payload capture,
        misses from the store, in sampled-remote order."""
        engine = self.engine
        P = engine.num_pes
        F = engine.feature_dim
        miss_gather = self.store.gather_batch(result.missed)
        placed_gather = self.store.gather_batch(engine.last_placed)
        hit_masks, self._hit_masks = self._hit_masks, None
        hit_rows, self._hit_rows = self._hit_rows, None
        features: list[np.ndarray] = []
        feat_sums = np.zeros(P, dtype=np.float64)
        bytes_measured = np.zeros(P, dtype=np.int64)
        for p in range(P):
            if len(engine.last_placed[p]):
                engine.place_rows(p, engine.last_slots[p], placed_gather.blocks[p])
            block = np.empty((len(hit_masks[p]), F), dtype=np.float32)
            block[hit_masks[p]] = hit_rows[p]
            block[~hit_masks[p]] = miss_gather.blocks[p]
            features.append(block)
            feat_sums[p] = block.sum(dtype=np.float64)
            bytes_measured[p] = (
                miss_gather.blocks[p].nbytes + placed_gather.blocks[p].nbytes
            )
        result.features = features
        result.feat_sums = feat_sums
        result.bytes_measured = bytes_measured
        result.bytes_modeled = (
            result.total_comm * self.feature_dim * self.feature_bytes
        )
        result.fetch_seconds = miss_gather.seconds + placed_gather.seconds


class FusedFetchStage:
    """Device-resident fetch plane: one launch per training step.

    Drives a :class:`repro_torch.runtime.engine.DeviceEngine`: buffer
    state persists on the device and each training step issues exactly
    one launch — over the raw frontier (:meth:`prime_raw` /
    :meth:`step_raw`) or, for ragged seed blocks, over host-deduped
    remote sets (:meth:`prime` / :meth:`step`).

    **Pipeline rotation.** The controller decision for step t is
    computed on host from probe(t)'s metrics, so probe(t+1) — not
    probe(t) — rides in step t's launch::

        prime:   launch [probe(0)]                      (score/replace gated off)
        step t:  decide(t) → sample(t+1) →
                 launch [score(t), replace(t), probe(t+1)]

    The in-kernel order score(t) → replace(t) → probe(t+1) is exactly
    the staged order ``end_round`` → ``replace_round`` → next
    ``lookup``, so RNG draws, decision streams, and every exact stream
    stay bit-identical to the reference runtime.

    **Feature store.** With a store attached, :meth:`begin_gather` lets
    the driver dispatch step t's miss-row gather before drawing step
    t+1's sample. On the ragged path admission rows land in the device
    payload in one batched scatter (``DeviceEngine.place_rows_batch``);
    on the raw path the launch itself copied them in. Hit rows for the
    next probe are captured from the updated payload — the
    capture-before-overwrite order of the reference.
    """

    def __init__(
        self,
        dev,
        uses_buffer: np.ndarray,
        inference_cost: np.ndarray,
        time_engine,
        feature_dim: int,
        mode: str,
        part_of: np.ndarray | None = None,
        store=None,
        feature_bytes: int = 4,
    ):
        if time_engine.needs_pairs and part_of is None:
            raise ValueError("per-home comm pricing needs part_of")
        if store is not None and dev.payload is None:
            raise ValueError(
                "feature store needs an engine payload "
                "(PrefetchEngine(feature_dim=...))"
            )
        P = dev.num_pes
        self.dev = dev
        self.uses_buffer = uses_buffer
        self.inference_cost = inference_cost
        self.time_engine = time_engine
        self.feature_dim = feature_dim
        self.feature_bytes = int(feature_bytes)
        self.mode = mode
        self.part_of = part_of
        self.store = store
        self.active = uses_buffer & (dev.capacity > 0)
        self._capacity = dev.capacity.astype(np.float64)
        self._prev_missed: list[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(P)
        ]
        self._pending: dict | None = None
        self._last_replaced = np.zeros(P, dtype=np.int64)
        self._have_replaced = False
        self._no_decision = np.zeros(P, dtype=bool)

    # ------------------------------------------------------------------ #
    @tel.spanned("fused.prime", plane="engine")
    def prime(self, remote: list[np.ndarray], n_remote: np.ndarray) -> ProbeResult:
        """Launch 0 of the ragged loop: probe the first minibatch only
        (score and replace gated off)."""
        if self._pending is not None:
            raise RuntimeError("already primed: step() the pending round")
        P = self.dev.num_pes
        out = self.dev.fused_step(
            remote,
            [np.array([], dtype=np.int64)] * P,
            self._no_decision,
            self._no_decision,
            self.active,
        )
        return self._stash_probe(remote, n_remote, out)

    @tel.spanned("fused.prime", plane="engine")
    def prime_raw(self, touched: np.ndarray) -> ProbeResult:
        """Launch 0 of the raw loop: probe the first minibatch only
        (score and replace gated off); dedup and the remote extraction
        happen on device."""
        if self._pending is not None:
            raise RuntimeError("already primed: step() the pending round")
        out = self.dev.fused_step_raw(
            touched, self._no_decision, self._no_decision, self.active
        )
        return self._stash_probe(out.remote, out.n_remote, out)

    def begin_gather(self) -> None:
        """Overlap hook: dispatch the pending round's miss-row gather now
        (before the next sample draw). Idempotent; no-op without a store."""
        pending = self._pending
        if self.store is None or pending is None or "miss_gather" in pending:
            return
        pending["miss_gather"] = self.store.gather_batch(pending["missed"])

    @tel.spanned("fetch.account", plane="engine")
    def _commit(self, out, missed, stalls) -> CommitResult:
        """Round t's accounting from the launch that closed it."""
        dev = self.dev
        self._prev_missed = missed
        self._last_replaced = out.replaced
        self._have_replaced = True
        comm = np.array([len(m) for m in missed], dtype=np.int64)
        total_comm = comm + out.replaced
        if tel.enabled():
            _count_fetch(comm, out.replaced, self.feature_dim, self.feature_bytes)
        t = self.time_engine.step(
            build_step_comm(
                missed,
                dev.last_placed,
                self.part_of,
                dev.num_pes,
                self.time_engine.needs_pairs,
                id_base=dev.id_base,
            ),
            stalls,
        )
        return CommitResult(
            replaced=out.replaced,
            total_comm=total_comm,
            step_time=t,
            occupancy=dev.occupancy_of(out.n_valid),
            missed=missed,
            placed=list(dev.last_placed),
        )

    @tel.spanned("fused.step", plane="engine")
    def step(
        self,
        decisions: np.ndarray,
        stalls: np.ndarray,
        next_remote: list[np.ndarray],
        next_n_remote: np.ndarray,
    ) -> tuple[CommitResult, ProbeResult]:
        """Close round t and open round t+1 in one fused launch over the
        host-deduped remote sets. Returns ``(commit(t), probe(t+1))``;
        the final step passes empty ``next_remote`` sets and discards
        the returned probe."""
        if self._pending is None:
            raise RuntimeError("nothing probed: prime() the pipeline first")
        pending, self._pending = self._pending, None
        out = self.dev.fused_step(
            next_remote,
            self._prev_missed,
            self.uses_buffer,
            decisions & self.uses_buffer,
            self.active,
        )
        commit = self._commit(out, pending["missed"], stalls)
        if self.store is not None:
            self._serve_features(commit, pending)
        # Stash after serving: probe(t+1)'s hit rows must see round t's
        # admissions in the payload (capture-before-overwrite order).
        probe = self._stash_probe(next_remote, next_n_remote, out)
        return commit, probe

    @tel.spanned("fused.step", plane="engine")
    def step_raw(
        self,
        decisions: np.ndarray,
        stalls: np.ndarray,
        next_touched: np.ndarray,
    ) -> tuple[CommitResult, ProbeResult]:
        """Close round t and open round t+1 from the raw ``(P, Mt)``
        frontier — one launch covers dedup(t+1) → score(t) → replace(t)
        → probe(t+1) → payload scatter(t). Replacement candidates never
        touch the host: the launch two steps back compacted its misses on
        device. The final step passes an empty ``next_touched`` block and
        discards the returned probe."""
        if self._pending is None:
            raise RuntimeError("nothing probed: prime_raw() the pipeline first")
        pending, self._pending = self._pending, None
        out = self.dev.fused_step_raw(
            next_touched,
            self.uses_buffer,
            decisions & self.uses_buffer,
            self.active,
        )
        commit = self._commit(out, pending["missed"], stalls)
        if self.store is not None:
            self._serve_features_raw(commit, pending)
        probe = self._stash_probe(out.remote, out.n_remote, out)
        return commit, probe

    # ------------------------------------------------------------------ #
    def _stash_probe(self, remote, n_remote, out) -> ProbeResult:
        pending = {"missed": out.missed}
        if self.store is not None:
            pending["hit_masks"] = out.hit_masks
            pending["hit_rows"] = self.dev.pull_rows(out.hit_slots)
        self._pending = pending
        pct_hits = np.where(
            self.active,
            np.where(
                n_remote > 0, 100.0 * out.hits / np.maximum(n_remote, 1), 100.0
            ),
            0.0,
        )
        replaced_pct = np.where(
            self._have_replaced & (self._capacity > 0),
            100.0 * self._last_replaced / np.maximum(self._capacity, 1.0),
            0.0,
        )
        return ProbeResult(
            hit_masks=out.hit_masks,
            missed=out.missed,
            hits=out.hits,
            pct_hits=pct_hits,
            comm=np.array([len(m) for m in out.missed], dtype=np.int64),
            occupancy=self.dev.occupancy_of(out.n_valid),
            replaced_pct=replaced_pct,
            remote=list(remote),
            n_remote=np.asarray(n_remote, dtype=np.int64),
        )

    def _assemble(self, result, pending, miss_gather, placed_bytes) -> None:
        """Per-PE remote blocks (hits from the probe-time payload
        capture, misses from the store, in sampled-remote order) and the
        measured streams."""
        P = self.dev.num_pes
        F = self.dev.feature_dim
        hit_masks = pending["hit_masks"]
        hit_rows = pending["hit_rows"]
        features: list[np.ndarray] = []
        feat_sums = np.zeros(P, dtype=np.float64)
        bytes_measured = np.zeros(P, dtype=np.int64)
        for p in range(P):
            block = np.empty((len(hit_masks[p]), F), dtype=np.float32)
            block[hit_masks[p]] = hit_rows[p]
            block[~hit_masks[p]] = miss_gather.blocks[p]
            features.append(block)
            feat_sums[p] = block.sum(dtype=np.float64)
            bytes_measured[p] = miss_gather.blocks[p].nbytes + placed_bytes[p]
        result.features = features
        result.feat_sums = feat_sums
        result.bytes_measured = bytes_measured
        result.bytes_modeled = (
            result.total_comm * self.feature_dim * self.feature_bytes
        )

    @tel.spanned("fetch.serve", plane="store")
    def _serve_features(self, result: CommitResult, pending: dict) -> None:
        """Store data path of the ragged loop: the miss gather (maybe
        pre-dispatched by :meth:`begin_gather`) and one store gather of
        the admissions, which scatter into the device payload."""
        dev = self.dev
        miss_gather = pending.get("miss_gather") or self.store.gather_batch(
            result.missed
        )
        placed_gather = self.store.gather_batch(dev.last_placed, device=True)
        dev.place_rows_batch(
            dev.last_slots,
            placed_gather.blocks,
            device_block=placed_gather.device_block,
        )
        self._assemble(
            result, pending, miss_gather, [b.nbytes for b in placed_gather.blocks]
        )
        result.fetch_seconds = miss_gather.seconds + placed_gather.seconds

    @tel.spanned("fetch.serve", plane="store")
    def _serve_features_raw(self, result: CommitResult, pending: dict) -> None:
        """Store data path of the raw loop: admission rows were copied
        into the device payload inside the launch (verbatim float32 store
        rows), so only the miss rows cross the store here. Admissions
        are charged at exactly the staged gather's size
        (``n_placed * F * 4``)."""
        dev = self.dev
        miss_gather = pending.get("miss_gather") or self.store.gather_batch(
            result.missed
        )
        row_bytes = dev.feature_dim * 4  # store rows are float32
        self._assemble(
            result, pending, miss_gather,
            [len(placed) * row_bytes for placed in dev.last_placed],
        )
        result.fetch_seconds = miss_gather.seconds
