"""The runtime's explicit three-stage pipeline: sample → decide → fetch.

One minibatch of the whole cluster flows through three stage objects,
each advancing all P trainer PEs in one batched pass:

* :class:`SampleStage` — per-PE seed blocks through the batched
  :class:`repro_torch.graph.sampler.SamplerPlane`: dense ``(P, B)``
  fanout expansion on the shared CSR, handing the raw ``(P, Mt)``
  frontier to the device;
* :class:`DecisionStage` — the paper's request/response queue hand-off
  (§4.5, Fig. 11) as a double-buffered two-slot stage over the batched
  :class:`repro_torch.core.controller.DecisionPlane`;
* :class:`FusedFetchStage` — the device-resident fetch plane: one
  single-launch frontier step per training step
  (:meth:`repro_torch.runtime.engine.DeviceEngine.fused_step_raw`) plus
  the wall-clock accounting via the run's time engine
  (:mod:`repro_torch.sim`).

Each stage preserves the reference runtime's operation order, so
hit/miss/byte counts, decision streams and modeled step times are
bit-identical to it.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    """Batched sampling stage: per-PE seed blocks → minibatches + the raw
    frontier. ``seed_fn(p, epoch, mb)`` supplies PE p's seed block; only
    the fanout draws consume the shared RNG, in the reference's PE-major
    order."""

    def __init__(self, plane: SamplerPlane, num_pes: int, seed_fn):
        self.plane = plane
        self.num_pes = num_pes
        self.seed_fn = seed_fn

    @tel.spanned("sample", plane="sampling")
    def run_raw(
        self, epoch: int, mb: int, rng: np.random.Generator
    ) -> tuple[list[MiniBatch], np.ndarray]:
        """``(minibatches, touched)`` where ``touched`` is the raw
        ``(P, Mt)`` frontier destined for the single-launch device step
        — no host dedup or remote extraction."""
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
    #: The probed remote query sets, derived on device from the raw
    #: frontier and handed back in the packed readback.
    remote: list[np.ndarray]
    n_remote: np.ndarray


@dataclass
class CommitResult:
    """Per-PE outputs of the scoring/replacement/accounting half."""

    replaced: np.ndarray      # (P,) int64
    total_comm: np.ndarray    # (P,) int64 — misses + replacement traffic
    step_time: np.ndarray     # (P,) float64, §4.5.3 model
    occupancy: np.ndarray     # (P,) float64, post-replacement
    missed: list[np.ndarray]  # this minibatch's miss fetches
    placed: list[np.ndarray]  # this round's replacement admissions


def _count_fetch(
    missed, placed, part_of, num_pes, miss_comm, replaced, feature_dim,
    feature_bytes, id_base=0,
):
    """Telemetry-on-only fetch accounting: per-PE node/byte counters and
    the per-(PE, home) byte matrix. Observational — reads the same
    exact streams the time engine already priced, never alters them."""
    row_bytes = feature_dim * feature_bytes
    miss_comm = np.asarray(miss_comm, dtype=np.float64)
    replaced = np.asarray(replaced, dtype=np.float64)
    tel.count("fetch.miss_nodes", miss_comm)
    tel.count("fetch.replaced_nodes", replaced)
    tel.count("fetch.bytes_modeled", (miss_comm + replaced) * row_bytes)
    if part_of is not None:
        by_home = np.zeros((num_pes, num_pes), dtype=np.float64)
        for p in range(num_pes):
            ids = np.concatenate([missed[p], placed[p]])
            if len(ids):
                by_home[p] = np.bincount(
                    part_of[ids - id_base], minlength=num_pes
                )
        tel.count("fetch.bytes_by_home", by_home * row_bytes)


class FusedFetchStage:
    """Device-resident fetch plane: one single-launch step per training step.

    Drives a :class:`repro_torch.runtime.engine.DeviceEngine`: buffer
    state persists on the device and each training step issues exactly
    one launch over the raw frontier.

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
        feature_bytes: int = 4,
    ):
        if time_engine.needs_pairs and part_of is None:
            raise ValueError("per-home comm pricing needs part_of")
        P = dev.num_pes
        self.dev = dev
        self.uses_buffer = uses_buffer
        self.inference_cost = inference_cost
        self.time_engine = time_engine
        self.feature_dim = feature_dim
        self.feature_bytes = int(feature_bytes)
        self.mode = mode
        self.part_of = part_of
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
    def prime_raw(self, touched: np.ndarray) -> ProbeResult:
        """Launch 0: probe the first minibatch only (score and replace
        gated off); dedup and the remote extraction happen on device."""
        if self._pending is not None:
            raise RuntimeError("already primed: step_raw() the pending round")
        out = self.dev.fused_step_raw(
            touched, self._no_decision, self._no_decision, self.active
        )
        return self._stash_probe(out)

    @tel.spanned("fused.step", plane="engine")
    def step_raw(
        self,
        decisions: np.ndarray,
        stalls: np.ndarray,
        next_touched: np.ndarray,
    ) -> tuple[CommitResult, ProbeResult]:
        """Close round t and open round t+1 from the raw ``(P, Mt)``
        frontier — one launch covers dedup(t+1) → score(t) → replace(t)
        → probe(t+1). Replacement candidates never touch the host: the
        launch two steps back compacted its misses on device. The final
        step passes an empty ``next_touched`` block and discards the
        returned probe."""
        if self._pending is None:
            raise RuntimeError("nothing probed: prime_raw() the pipeline first")
        pending, self._pending = self._pending, None
        dev = self.dev
        out = dev.fused_step_raw(
            next_touched,
            self.uses_buffer,
            decisions & self.uses_buffer,
            self.active,
        )
        missed = pending["missed"]
        self._prev_missed = missed
        self._last_replaced = out.replaced
        self._have_replaced = True
        comm = np.array([len(m) for m in missed], dtype=np.int64)
        total_comm = comm + out.replaced
        if tel.enabled():
            _count_fetch(
                missed, dev.last_placed, self.part_of, dev.num_pes,
                comm, out.replaced, self.feature_dim, self.feature_bytes,
                id_base=dev.id_base,
            )
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
        commit = CommitResult(
            replaced=out.replaced,
            total_comm=total_comm,
            step_time=t,
            occupancy=dev.occupancy_of(out.n_valid),
            missed=missed,
            placed=list(dev.last_placed),
        )
        return commit, self._stash_probe(out)

    # ------------------------------------------------------------------ #
    def _stash_probe(self, out) -> ProbeResult:
        self._pending = {"missed": out.missed}
        n_remote = out.n_remote
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
            remote=list(out.remote),
            n_remote=np.asarray(n_remote, dtype=np.int64),
        )
