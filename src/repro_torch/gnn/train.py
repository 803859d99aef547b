"""Distributed GNN training driver — the paper's evaluation harness.

Port of the reference's ``gnn/train.py``. Runs the variants of §5 on a
partitioned graph:

* ``distdgl``      — no prefetch: every sampled remote node is fetched;
* ``fixed``        — static prefetch: replacement round every minibatch;
* ``massivegnn``   — warm-started buffer, fixed replacement interval;
* ``rudder``       — adaptive replacement via LLM agent / ML classifier
                     behind the async/sync queue protocol.

What is *exact*: partitioning, sampling, buffer membership/scoring,
hit/miss sets, remote fetch counts (bytes), decision streams — all
bit-identical to the reference package — and the GNN training math
(PyTorch GraphSAGE with data-parallel gradient averaging, allclose to
the reference). What is *modeled*: wall-clock epoch time, via the
paper's §4.5.3 performance model driven by the exact byte counts (see
:class:`TimeModel`), or the discrete-event simulator of
:mod:`repro_torch.sim` with ``time_engine="event"``.

A device run is device-resident (:func:`repro_torch.runtime.driver.
run_device`): the buffer state, the graph features (or the feature
store's tables) and the model live on ``device`` — the card by default
(``device="cuda"``), or the CPU (``device="cpu"``), where the kernels run
as their plain versions. Graphs whose global ids sit at an ``id_base``
(``Graph.rebase``) or pass ``2**31 - 2`` run in the engine's wide mode,
and ``readback_every=K > 1`` runs the K-step counter readback cadence.
``device=False`` (the reference's default) runs the staged loop
(:func:`repro_torch.runtime.driver.run_vectorized`) on the host, numpy
over the :class:`repro_torch.runtime.engine.PrefetchEngine`, with the
model on the CPU; a device run whose ids pass ``WIDE_ID_MAX`` falls back
to it, with the sampler's dedup and the scoring round on the device.

``runtime="legacy"`` runs the reference's one-PE-at-a-time loop
(:meth:`DistributedTrainer.run_legacy`), the semantic oracle of the
others: per-PE :class:`PersistentBuffer` lookups and replacement rounds
on the host, the GraphSAGE step (and a store built on the device) on the
trainer's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import telemetry as tel
from ..core import scoring
from ..core.buffer import PersistentBuffer
from ..core.controller import Controller, make_controller
from ..core.metrics import GraphMeta, Metrics
from ..graph.generate import (
    CongestionModel,
    Graph,
    StragglerModel,
    Topology,
    make_congestion,
    make_stragglers,
    make_topology,
)
from ..graph.partition import Partitioned
from ..graph.sampler import MiniBatch, NeighborSampler, SamplerPlane, unique_remote
from ..runtime.engine import PrefetchEngine, resolve_device
from ..kernels import ops
from .sage import GraphSAGE, fanout_mean, init_sage, params_from_jax


@dataclass
class TimeModel:
    """Calibrated constants for the §4.5.3 performance model.

    ``t_ddp`` is the data-parallel compute time of one minibatch on one
    trainer (forward+backward+allreduce). At paper scale (A100, batch
    2000, fanout {10,25}) this is ~50 ms. ``link_bw`` is the per-trainer
    effective bandwidth of the RPC fetch path: Slingshot gives ~2.5 GB/s
    effective per trainer at full scale; our graphs (and therefore the
    per-minibatch fetch sets) are scaled down ~100x, so the default
    bandwidth is scaled by the same factor (~1 MB/s, i.e. ~100 MB/s
    effective TCP RPC bandwidth at full scale) to keep
    T_COMM / T_DDP in the paper's regime (baseline communication roughly
    comparable to compute, §5.1). ``alpha`` is the per-round RPC latency.
    """

    t_ddp: float = 0.050
    link_bw: float = 1e6
    alpha: float = 5e-4
    feature_bytes: int = 4

    def t_comm(self, fetched_nodes: int, feature_dim: int) -> float:
        if fetched_nodes == 0:
            return 0.0
        return self.alpha + fetched_nodes * feature_dim * self.feature_bytes / self.link_bw

    def t_comm_batch(self, fetched_nodes: np.ndarray, feature_dim: int) -> np.ndarray:
        """Vectorized :meth:`t_comm` over all trainer PEs at once (the
        single source of the formula for the vectorized runtime)."""
        fetched_nodes = np.asarray(fetched_nodes)
        return np.where(
            fetched_nodes > 0,
            self.alpha
            + fetched_nodes * feature_dim * self.feature_bytes / self.link_bw,
            0.0,
        )

    def step_time_batch(
        self,
        t_comm: np.ndarray,
        stalls: np.ndarray,
        inference_cost: np.ndarray,
        mode: str,
        t_ddp: np.ndarray | float | None = None,
        t_stall: float | None = None,
    ) -> np.ndarray:
        """The §4.5.3 async/sync step-time composition, all PEs at once.

        This is the **single** statement of the paper's formulas —
        ``async = max(T_DDP, T_COMM)`` (inference hidden) and
        ``sync = T_DDP + T_COMM + stalls * T_A/C`` for PEs whose
        controller pays inference (non-adaptive PEs overlap comm with
        compute in either mode). The legacy loop, the vectorized
        :class:`repro.runtime.stage.FetchStage` and the event engine's
        parity path all price steps through here, so the three cannot
        drift. ``t_ddp`` admits per-PE compute durations (the event
        engine's straggler axis) and ``t_stall`` re-prices one stall
        tick (its wall-clock agent axis); both default to the closed
        form's flat ``t_ddp`` constant.
        """
        t_ddp = self.t_ddp if t_ddp is None else t_ddp
        t_stall = self.t_ddp if t_stall is None else t_stall
        if mode == "sync":
            return np.where(
                np.asarray(inference_cost) > 0,
                t_ddp + t_comm + np.asarray(stalls) * t_stall,
                np.maximum(t_ddp, t_comm),
            )
        return np.maximum(t_ddp, t_comm)


@dataclass
class TrainerLog:
    pct_hits: list[float] = field(default_factory=list)
    comm_volume: list[int] = field(default_factory=list)
    comm_missed: list[int] = field(default_factory=list)
    occupancy: list[float] = field(default_factory=list)
    unique_remote: list[int] = field(default_factory=list)
    replaced: list[int] = field(default_factory=list)
    decisions: list[bool] = field(default_factory=list)
    step_time: list[float] = field(default_factory=list)
    # Feature-store streams (populated only when the store is enabled):
    # bytes the store actually moved vs the §4.5.3 accounting bytes, the
    # host wall-clock of the step's gathers, and the content-sensitive
    # float64 sum of the delivered remote block.
    bytes_measured: list[int] = field(default_factory=list)
    bytes_modeled: list[int] = field(default_factory=list)
    #: Host seconds of the step's store gathers (``StoreGather.seconds``),
    #: not device time: on a card a gather's launches run asynchronously,
    #: so this is the host's time to issue them and to wait for the rows
    #: it reads back. Device time is the profiler's: the operations
    #: launched inside the ``repro.store.gather`` ranges.
    fetch_seconds: list[float] = field(default_factory=list)
    feat_sums: list[float] = field(default_factory=list)


@dataclass
class RunResult:
    variant: str
    #: Per epoch, the paper's §4.5.3 time model summed over the epoch's
    #: steps (each step's slowest PE), priced from exact byte counts by
    #: the run's time engine (:mod:`repro_torch.sim`): modeled seconds,
    #: not wall time. Wall time is the telemetry's ``run`` and ``step``
    #: spans.
    epoch_times: list[float]
    losses: list[float]
    accuracy: float
    logs: list[TrainerLog]
    controllers: list[Controller]
    graph_meta: list[GraphMeta]
    #: Event timeline of the run (``repro_torch.sim.EventLog``) when
    #: priced by the event engine; None under the closed-form model.
    sim_events: object | None = None
    #: Recorded run trace (``repro_torch.trace.Trace``) when the trainer
    #: was built with ``trace=...``; None otherwise.
    trace: object | None = None
    #: Flat telemetry summary (``TelemetrySession.summary()``) when the
    #: trainer was built with ``telemetry=...``; None otherwise.
    telemetry: dict | None = None

    # ---- aggregates used across the benchmark suite ------------------- #
    # Aggregates over an *empty* run (zero epochs / zero logged
    # minibatches) are NaN, not 0.0: a silent zero looks like a perfect
    # run, while NaN trips any downstream gate.
    @property
    def mean_epoch_time(self) -> float:
        return float(np.mean(self.epoch_times)) if self.epoch_times else float("nan")

    @property
    def mean_pct_hits(self) -> float:
        vals = [h for log in self.logs for h in log.pct_hits]
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def total_comm(self) -> int:
        return int(sum(sum(log.comm_volume) for log in self.logs))

    @property
    def comm_per_minibatch(self) -> float:
        n = sum(len(log.comm_volume) for log in self.logs)
        return self.total_comm / n if n else float("nan")

    @property
    def steady_pct_hits(self) -> float:
        """Mean %-Hits over the last quarter of the run (post cold-start)."""
        vals = []
        for log in self.logs:
            n = len(log.pct_hits)
            vals.extend(log.pct_hits[max(n - n // 4, 1):])
        return float(np.mean(vals)) if vals else float("nan")

    def comm_p99(self) -> float:
        vals = [c for log in self.logs for c in log.comm_volume]
        return float(np.percentile(vals, 99)) if vals else float("nan")

    # ---- feature-store aggregates (0 when the store was off) ---------- #
    @property
    def total_bytes_measured(self) -> int:
        return int(sum(sum(log.bytes_measured) for log in self.logs))

    @property
    def total_bytes_modeled(self) -> int:
        return int(sum(sum(log.bytes_modeled) for log in self.logs))

    @property
    def total_fetch_seconds(self) -> float:
        """Host wall-clock spent in store gathers (cluster steps sum the
        per-step maximum across PEs, like epoch_times does); not device
        time (see ``TrainerLog.fetch_seconds``)."""
        per_step = zip(*(log.fetch_seconds for log in self.logs))
        vals = [max(step) for step in per_step]
        return float(sum(vals)) if vals else float("nan")


class DistributedTrainer:
    """One experiment: (graph, partitioning, variant, controller, buffer).

    Takes the reference's arguments. ``device`` is where the run lives:
    ``"cuda"`` (default; raises ``RuntimeError`` without a card) or
    ``"cpu"``. ``init_params`` seeds the GraphSAGE model: a
    :class:`repro_torch.gnn.sage.GraphSAGE`, or the reference's
    ``SageParams`` with numpy leaves (see :func:`params_from_jax`) —
    the reference draws its initial weights with ``jax.random``, which
    torch cannot reproduce, so parity runs pass them in. Without it the
    weights come from a ``torch.Generator`` seeded with ``seed``.

    ``trace`` (``True`` or a :class:`repro_torch.trace.TraceRecorder`)
    records the run's exact streams onto ``last_trace``;
    ``feature_store`` (``True`` or a :class:`repro_torch.store.FeatureStore`)
    moves real feature rows — ``True`` builds a store on the trainer's
    device.

    ``device=False`` (or ``None``) runs the reference's staged loop on
    the host, with no kernel, the model and a ``feature_store=True``
    store on the CPU; ``readback_every > 1`` needs a device. Wide ids (an
    ``id_base``, or ids past ``2**31 - 2``, up to ``WIDE_ID_MAX``) and
    ``readback_every > 1`` run on both devices; past ``WIDE_ID_MAX`` a
    device run falls back to the staged loop, whose sampler dedup and
    scoring round then run as kernels on the device
    (``SamplerPlane(use_kernels=True)``, ``PrefetchEngine(use_kernels=True)``).
    ``telemetry`` (``True`` or a :class:`repro_torch.telemetry.TelemetrySession`)
    runs the experiment under a session that times every kernel
    dispatcher and span; it lands on ``last_telemetry``.

    ``runtime="legacy"`` runs :meth:`run_legacy`, the reference's
    per-PE host loop, with the model (and a store built here) on
    ``device``; ``readback_every > 1`` needs the vectorized runtime.
    """

    def __init__(
        self,
        parts: Partitioned,
        variant: str = "rudder",
        deciders: list | None = None,
        buffer_frac: float = 0.25,
        batch_size: int = 256,
        fanouts: tuple[int, ...] = (10, 25),
        epochs: int = 5,
        lr: float = 1e-2,
        hidden_dim: int = 64,
        mode: str = "async",
        interval: int = 32,
        warm_start: bool = True,
        train_model: bool = True,
        time_model: TimeModel | None = None,
        seed: int = 0,
        runtime: str = "vectorized",
        policy: str | scoring.ScoringPolicy = "rudder",
        topology: str | Topology | None = None,
        time_engine: str = "closed_form",
        stragglers: str | StragglerModel | None = None,
        congestion: str | CongestionModel | None = None,
        sim=None,
        trace: object = False,
        feature_store: object = False,
        device: object = "cuda",
        readback_every: int = 1,
        telemetry: object = False,
        init_params: object = None,
    ):
        if runtime not in ("vectorized", "legacy"):
            raise ValueError(
                f"runtime must be 'vectorized' or 'legacy', got {runtime!r}"
            )
        # False/None: the staged loop on the host; else the device of the
        # device-resident loop (and of the staged fall-back's kernels).
        self.device = (
            False if device is False or device is None else resolve_device(device)
        )
        # Where the model, the graph features and a store built here live.
        self.torch_device = home = (
            torch.device("cpu") if self.device is False else self.device
        )
        if not isinstance(readback_every, (int, np.integer)) or isinstance(
            readback_every, bool
        ) or readback_every < 1:
            raise ValueError(
                f"readback_every must be an int >= 1, got {readback_every!r}"
            )
        if readback_every > 1 and self.device is False:
            raise ValueError("readback_every > 1 requires device=...")
        if readback_every > 1 and runtime == "legacy":
            raise ValueError("readback_every > 1 requires runtime='vectorized'")
        self.readback_every = int(readback_every)
        if time_engine not in ("closed_form", "event"):
            raise ValueError(
                "time_engine must be 'closed_form' or 'event', "
                f"got {time_engine!r}"
            )
        self.parts = parts
        self.graph: Graph = parts.graph
        self.variant = variant
        self.runtime = runtime
        self.policy = scoring.make_policy(policy)
        self.buffer_frac = buffer_frac
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.mode = mode
        self.train_model = train_model
        self.tm = time_model or TimeModel()
        # Per-pair comm pricing (None keeps the flat §4.5.3 constants).
        if isinstance(topology, str):
            topology = make_topology(
                topology, parts.num_parts,
                link_bw=self.tm.link_bw, alpha=self.tm.alpha,
            )
        if topology is not None and topology.num_parts != parts.num_parts:
            raise ValueError(
                f"topology is {topology.num_parts}-way but the graph is "
                f"partitioned {parts.num_parts}-way"
            )
        self.topology = topology
        if isinstance(stragglers, str):
            stragglers = (
                None
                if stragglers == "none"
                else make_stragglers(stragglers, parts.num_parts, seed=seed)
            )
        if isinstance(congestion, str):
            congestion = (
                None
                if congestion == "none"
                else make_congestion(
                    congestion, parts.num_parts, link_bw=self.tm.link_bw
                )
            )
        if time_engine == "closed_form" and (
            stragglers is not None or congestion is not None
        ):
            raise ValueError(
                "stragglers/congestion scenarios require time_engine='event' "
                "(the closed-form model cannot express them)"
            )
        self.time_engine = time_engine
        self.stragglers = stragglers
        self.congestion = congestion
        self.sim = sim
        self.last_time_engine = None
        self.last_device_engine = None
        # Trace capture: False/None = off, True = a default recorder, or a
        # TraceRecorder instance used as-is. The trace lands on last_trace.
        self.trace = trace
        self.last_trace = None
        # Telemetry (repro_torch.telemetry): False/None = off (zero cost),
        # True = a fresh TelemetrySession per run, or a session instance
        # used as-is. The session lands on self.last_telemetry and its
        # summary on RunResult.telemetry. Never perturbs exact streams.
        self.telemetry = telemetry
        self.last_telemetry = None
        # Feature store: False/None = modeled bytes only; True = a store
        # over this graph's partitioned features on the trainer's device
        # (the CPU without one); a FeatureStore instance is used as-is.
        self.feature_store = None
        if feature_store:
            from ..store import FeatureStore

            self.feature_store = (
                feature_store
                if isinstance(feature_store, FeatureStore)
                else FeatureStore.for_partitions(parts, device=home)
            )
        self.rng = np.random.default_rng(seed)
        self.sampler = NeighborSampler(self.graph, fanouts)
        # A device trainer's staged fall-back runs the sampler's dedup and
        # the engine's scoring round as kernels on its device; the device
        # loops never call either hook.
        staged_kernels = self.device is not False
        self.sampler_plane = SamplerPlane(
            self.graph, fanouts, use_kernels=staged_kernels, device=home
        )

        P = parts.num_parts
        self.graph_meta = [
            GraphMeta(
                name=self.graph.name,
                num_nodes=self.graph.num_nodes,
                num_edges=self.graph.num_edges,
                part_nodes=len(parts.local_nodes[p]),
                part_edges=parts.part_edges(p),
                num_partitions=P,
            )
            for p in range(P)
        ]

        # Halo (total remote nodes per partition): distinct 1-hop
        # neighbors homed elsewhere — the reference set for buffer sizing
        # ("5%/25% of remote nodes relative to total remote nodes per
        # partition", §5.1).
        self.halos = []
        for p in range(P):
            nodes = parts.local_nodes[p]
            nbrs = np.unique(
                np.concatenate(
                    [self.graph.neighbors(int(u)) for u in nodes]
                    or [np.array([], dtype=np.int64)]
                )
            )
            self.halos.append(nbrs[parts.part_of[nbrs] != p])

        # The degree policy weighs accesses by the node's (log) degree.
        node_weights = (
            scoring.degree_weights(self.graph.degree())
            if self.policy.use_weights
            else None
        )
        payload_dim = (
            self.graph.features.shape[1] if self.feature_store is not None else 0
        )
        self.buffers = [
            PersistentBuffer(
                capacity=max(int(len(self.halos[p]) * buffer_frac), 1),
                feature_dim=payload_dim,
                policy=self.policy,
                node_weights=node_weights,
                id_base=self.graph.id_base,
            )
            for p in range(P)
        ]
        # Vectorized twin of the per-PE buffers: one (P, C) array state,
        # the staged loop's engine, uploaded to the device at the start of
        # every device run.
        self.engine = PrefetchEngine(
            [b.capacity for b in self.buffers],
            policy=self.policy,
            node_weights=node_weights,
            feature_dim=payload_dim,
            id_base=self.graph.id_base,
            use_kernels=staged_kernels,
            device=home,
        )

        # Controllers (one per trainer, as in the paper: each trainer has
        # its own prefetcher + daemon inference thread).
        self.controllers: list[Controller] = []
        for p in range(P):
            decider = None
            if variant == "rudder":
                if deciders is None:
                    raise ValueError("rudder variant needs deciders")
                decider = deciders[p % len(deciders)]
            self.controllers.append(
                make_controller(
                    variant,
                    graph=self.graph_meta[p],
                    decider=decider,
                    mode=mode,
                    interval=interval,
                    warm_start=warm_start,
                )
            )

        # MassiveGNN warm start: prefetch the highest-degree remote halo
        # nodes before training (§5.1 "Comparison with MassiveGNN").
        if variant == "massivegnn" and warm_start:
            deg = self.graph.degree()
            base = np.int64(self.graph.id_base)
            for p in range(P):
                halo = self.halos[p]
                top = halo[np.argsort(-deg[halo])][: self.buffers[p].capacity]
                top = top + base
                n = self.buffers[p].insert(top)
                self.engine.insert(p, top)
                if self.feature_store is not None and n:
                    # Warm-started admissions place real rows too (top is
                    # unique and the buffer empty, so exactly top[:n]
                    # landed, in order, in both twins).
                    rows = self.feature_store.gather(top[:n])
                    self.buffers[p].fill_rows(top[:n], rows)
                    self.engine.place_rows(p, self.engine.last_slots[p], rows)

        self.local_train = [parts.local_train_nodes(p) for p in range(P)]
        self.mb_per_epoch = max(
            1,
            max(
                (len(t) + batch_size - 1) // batch_size
                for t in self.local_train
                if len(t)
            ),
        )

        self.model: GraphSAGE | None = None
        self.features = None
        self.labels = None
        if train_model:
            if isinstance(init_params, GraphSAGE):
                model = init_params
            elif init_params is not None:
                model = params_from_jax(init_params)
            else:
                model = init_sage(
                    self.graph.features.shape[1],
                    hidden_dim,
                    self.graph.num_classes,
                    generator=torch.Generator().manual_seed(seed),
                )
            self.model = model.to(home)
            # Graph features and labels live on the device as one tensor
            # each; minibatch rows are indexed there (or, with a store,
            # gathered through it).
            if self.feature_store is None:
                self.features = torch.from_numpy(
                    np.ascontiguousarray(self.graph.features, dtype=np.float32)
                ).to(home)
            self.labels = torch.from_numpy(
                np.asarray(self.graph.labels, dtype=np.int64)
            ).to(home)

    # ------------------------------------------------------------------ #
    def _seed_batch(self, p: int, epoch: int, mb: int) -> np.ndarray:
        t = self.local_train[p]
        if len(t) == 0:
            return self.graph.train_nodes[: self.batch_size]
        perm = np.random.default_rng((epoch * 1000003 + p) ^ 0xC0FFEE).permutation(
            len(t)
        )
        start = (mb * self.batch_size) % len(t)
        idx = perm[start : start + self.batch_size]
        if len(idx) < min(self.batch_size, len(t)):
            idx = np.concatenate([idx, perm[: self.batch_size - len(idx)]])
        return t[idx]

    def _features_of(self, minibatch: MiniBatch):
        """``(x_seed, x_n1, n2_mean, labels)`` of a minibatch, the inputs of
        :meth:`GraphSAGE.forward_aggregated`: ``n2_mean (B, f1, F)`` is
        the layer-2 neighbours' mean.

        Without a store the rows come from the device-resident feature
        tensor (one index upload): ``x_seed`` and ``x_n1`` are gathered as
        rows, and ``gather_mean`` reads the layer-2 neighbours straight
        from the table, so their ``(B, f1, f2, F)`` block is never built.
        With a store attached, its one gather serves every row (its rows
        are bit-identical to ``graph.features`` rows: it only re-homes
        them, and they stay on the device when it gathers there), and
        ``segment_sum_equal`` reduces the layer-2 rows; both means round
        alike, so the two paths give the same ``n2_mean``."""
        n1, n2 = minibatch.layer_nbrs[0], minibatch.layer_nbrs[1]
        b, f1 = n1.shape
        idx = np.concatenate(
            [minibatch.seeds, n1.ravel(), n2.ravel()]
        ).astype(np.int64)
        head = b + n1.size
        if self.feature_store is not None:
            # Minibatch ids are local; the store is keyed by global id.
            rows = self.feature_store.gather_tensor(
                idx + np.int64(self.graph.id_base), self.torch_device
            )
            n2_mean = fanout_mean(rows[head:].reshape(n2.shape + (rows.shape[1],)))
        else:
            tel.copied("train.ids", "h2d", idx.nbytes)
            idx_dev = torch.from_numpy(idx).to(self.torch_device)
            rows = self.features[idx_dev[:head]]
            n2_mean = ops.gather_mean(self.features, idx_dev[head:].view(n2.shape))
        x_seed = rows[:b]
        x_n1 = rows[b:head].reshape(b, f1, -1)
        tel.copied("train.seeds", "h2d", minibatch.seeds.nbytes)
        labels = self.labels[torch.from_numpy(minibatch.seeds).to(self.torch_device)]
        return x_seed, x_n1, n2_mean.reshape(b, f1, -1), labels

    # ------------------------------------------------------------------ #
    def make_time_engine(self):
        """Build a fresh per-run wall-clock engine (``repro_torch.sim``);
        it stays reachable as ``self.last_time_engine``."""
        from .. import sim

        engine = sim.make_time_engine(
            self.time_engine,
            tm=self.tm,
            mode=self.mode,
            inference_cost=np.array(
                [c.inference_cost for c in self.controllers],
                dtype=np.float64,
            ),
            feature_dim=self.graph.features.shape[1],
            num_pes=self.parts.num_parts,
            topology=self.topology,
            stragglers=self.stragglers,
            congestion=self.congestion,
            config=self.sim,
            total_steps=self.epochs * self.mb_per_epoch,
        )
        self.last_time_engine = engine
        return engine

    # ------------------------------------------------------------------ #
    def make_trace_recorder(self):
        """Resolve the ``trace`` flag to a recorder (or None when off): a
        pre-built :class:`repro_torch.trace.TraceRecorder` is used as-is
        (single-use, like time engines); ``trace=True`` builds a fresh
        default recorder from the trainer's own axes."""
        if not self.trace:
            return None
        from ..trace import TraceRecorder

        if isinstance(self.trace, TraceRecorder):
            return self.trace
        return TraceRecorder.for_trainer(self)

    # ------------------------------------------------------------------ #
    def make_telemetry(self):
        """Resolve the ``telemetry`` flag to a session (or None when off):
        a pre-built :class:`repro_torch.telemetry.TelemetrySession` is
        used as-is, ``telemetry=True`` builds a fresh default session."""
        if not self.telemetry:
            return None
        from ..telemetry import TelemetrySession

        if isinstance(self.telemetry, TelemetrySession):
            return self.telemetry
        return TelemetrySession(label=self.variant)

    # ------------------------------------------------------------------ #
    def run(self) -> RunResult:
        """Execute the experiment: with ``runtime="legacy"`` on
        :meth:`run_legacy`; else on the trainer's device
        (:func:`repro_torch.runtime.driver.run_device`), or on the staged
        loop with ``device=False`` or past ``WIDE_ID_MAX``
        (:func:`repro_torch.runtime.driver.run_vectorized`).

        With ``telemetry=...`` set, the run executes under an active
        :class:`repro_torch.telemetry.TelemetrySession`; the session lands
        on ``self.last_telemetry`` and its summary on the result."""
        session = self.make_telemetry()
        if session is None:
            return self._run_impl()

        with tel.active(session):
            with session.tracer.span("run", plane="runtime"):
                result = self._run_impl()
        session.meta.setdefault("variant", self.variant)
        session.meta.setdefault("mode", self.mode)
        session.meta.setdefault("num_pes", self.parts.num_parts)
        self.last_telemetry = session
        result.telemetry = session.summary()
        return result

    def _run_impl(self) -> RunResult:
        if self.runtime == "vectorized":
            from ..runtime.driver import run_vectorized

            return run_vectorized(self)
        return self.run_legacy()

    def run_legacy(self) -> RunResult:
        """The reference's loop: one PE at a time, one Python loop.

        The semantic oracle of the vectorized runtimes: per-PE buffer
        lookups, decisions and replacement rounds on the host, in PE
        order, on the numpy :class:`PersistentBuffer` s; the feature store
        serves each step's misses and admissions in two batched gathers
        after the PE loop (on its device); the GraphSAGE step is the
        vectorized loops' :func:`repro_torch.runtime.driver.train_step`
        on the trainer's device. Every exact stream equals the vectorized
        runtimes'."""
        from ..runtime.driver import accuracy_pass, train_step
        from ..sim import build_step_comm

        P = self.parts.num_parts
        logs = [TrainerLog() for _ in range(P)]
        epoch_times: list[float] = []
        losses: list[float] = []
        time_engine = self.make_time_engine()
        recorder = self.make_trace_recorder()

        # Pipeline staleness: ReplaceandFetch overlaps with training, so a
        # replacement round admits the miss set of the *previous*
        # minibatch (Algorithm 1 queues the next minibatch before the
        # decision lands).
        prev_missed = [np.array([], dtype=np.int64) for _ in range(P)]
        empty = np.array([], dtype=np.int64)

        for epoch in range(self.epochs):
            epoch_time = 0.0
            for mb in range(self.mb_per_epoch):
                minibatches: list[MiniBatch] = []
                missed_sets: list[np.ndarray] = []
                placed_sets: list[np.ndarray] = []
                stall_ticks: list[float] = []
                # Trace-only per-PE collections (references, not copies).
                seed_sets: list[np.ndarray] = []
                remote_sets: list[np.ndarray] = []
                hit_counts: list[int] = []
                occ_pre: list[float] = []
                # Feature-store captures: hit rows are read at lookup
                # time, before a replacement can overwrite their slots.
                hit_mask_sets: list[np.ndarray] = []
                hit_row_sets: list[np.ndarray] = []
                _step_sp = tel.begin(
                    "step", plane="runtime", step=epoch * self.mb_per_epoch + mb
                )
                for p in range(P):
                    _pe_sp = tel.begin("pe_step", pe=p, plane="runtime")
                    ctrl = self.controllers[p]
                    buf = self.buffers[p]
                    batch = self._seed_batch(p, epoch, mb)
                    minibatch = self.sampler.sample(batch, self.rng)
                    minibatches.append(minibatch)
                    remote = unique_remote(
                        minibatch, self.parts.part_of, p,
                        id_base=self.graph.id_base,
                    )
                    n_remote = len(remote)

                    slots = None
                    if ctrl.uses_buffer and buf.capacity > 0:
                        hit_mask, slots = buf.lookup(remote)
                        missed = remote[~hit_mask]
                        hits = int(hit_mask.sum())
                        pct_hits = (
                            100.0 * hits / n_remote if n_remote else 100.0
                        )
                    else:
                        hit_mask = np.zeros(n_remote, dtype=bool)
                        missed = remote
                        hits = 0
                        pct_hits = 0.0
                    if self.feature_store is not None:
                        hit_mask_sets.append(hit_mask)
                        hit_row_sets.append(
                            buf.features[slots[hit_mask]]
                            if slots is not None
                            else np.zeros(
                                (0, self.feature_store.feature_dim),
                                dtype=np.float32,
                            )
                        )
                    if recorder is not None:
                        seed_sets.append(batch)
                        remote_sets.append(remote)
                        hit_counts.append(hits)
                        occ_pre.append(buf.occupancy)

                    comm = len(missed)
                    metrics = Metrics(
                        minibatch=mb,
                        total_minibatches=self.mb_per_epoch,
                        epoch=epoch,
                        total_epochs=self.epochs,
                        pct_hits=pct_hits,
                        comm_volume=comm,
                        replaced_pct=(
                            100.0 * logs[p].replaced[-1] / buf.capacity
                            if logs[p].replaced and buf.capacity
                            else 0.0
                        ),
                        buffer_occupancy=buf.occupancy,
                        buffer_capacity=buf.capacity,
                    )
                    replace = ctrl.should_replace(metrics)
                    if ctrl.uses_buffer:
                        buf.end_round()
                    replaced = 0
                    if replace and ctrl.uses_buffer:
                        replaced = buf.replace(prev_missed[p])
                    prev_missed[p] = missed
                    # Replacement traffic (Alg. 1 line 14): the admitted
                    # nodes are fetched by their own RPC.
                    comm += replaced

                    logs[p].pct_hits.append(pct_hits)
                    logs[p].comm_volume.append(comm)
                    logs[p].comm_missed.append(len(missed))
                    logs[p].occupancy.append(buf.occupancy)
                    logs[p].unique_remote.append(n_remote)
                    logs[p].replaced.append(replaced)
                    logs[p].decisions.append(bool(replace))

                    # Per-PE communication artifacts, priced after the PE
                    # loop (link contention couples the PEs).
                    missed_sets.append(missed)
                    placed_sets.append(
                        buf.last_placed
                        if replace and ctrl.uses_buffer
                        else empty
                    )
                    stall_ticks.append(ctrl.step_stall())
                    tel.end(_pe_sp)

                step_times = time_engine.step(
                    build_step_comm(
                        missed_sets,
                        placed_sets,
                        self.parts.part_of,
                        P,
                        time_engine.needs_pairs,
                        id_base=self.graph.id_base,
                    ),
                    np.asarray(stall_ticks, dtype=np.float64),
                )
                for p in range(P):
                    logs[p].step_time.append(float(step_times[p]))
                epoch_time += float(step_times.max())

                # Feature store: serve the step's misses and admissions in
                # two batched gathers (hit rows were captured at lookup).
                store_kwargs: dict = {}
                if self.feature_store is not None:
                    store = self.feature_store
                    F = store.feature_dim
                    miss_g = store.gather_batch(missed_sets)
                    placed_g = store.gather_batch(placed_sets)
                    fetch_seconds = miss_g.seconds + placed_g.seconds
                    feat_sums = np.zeros(P, dtype=np.float64)
                    bytes_measured = np.zeros(P, dtype=np.int64)
                    bytes_modeled = np.zeros(P, dtype=np.int64)
                    for p in range(P):
                        if len(placed_sets[p]):
                            self.buffers[p].fill_rows(
                                placed_sets[p], placed_g.blocks[p]
                            )
                        block = np.empty(
                            (len(hit_mask_sets[p]), F), dtype=np.float32
                        )
                        block[hit_mask_sets[p]] = hit_row_sets[p]
                        block[~hit_mask_sets[p]] = miss_g.blocks[p]
                        feat_sums[p] = block.sum(dtype=np.float64)
                        bytes_measured[p] = (
                            miss_g.blocks[p].nbytes + placed_g.blocks[p].nbytes
                        )
                        bytes_modeled[p] = (
                            logs[p].comm_volume[-1] * F * self.tm.feature_bytes
                        )
                        logs[p].bytes_measured.append(int(bytes_measured[p]))
                        logs[p].bytes_modeled.append(int(bytes_modeled[p]))
                        logs[p].fetch_seconds.append(float(fetch_seconds))
                        logs[p].feat_sums.append(float(feat_sums[p]))
                    store_kwargs = dict(
                        feat_sums=feat_sums,
                        bytes_measured=bytes_measured,
                        bytes_modeled=bytes_modeled,
                        fetch_time_measured=np.full(
                            P, fetch_seconds, dtype=np.float64
                        ),
                    )
                if recorder is not None:
                    recorder.record_step(
                        seeds=seed_sets,
                        remote=remote_sets,
                        missed=missed_sets,
                        placed=placed_sets,
                        decisions=[logs[p].decisions[-1] for p in range(P)],
                        stalls=np.asarray(stall_ticks, dtype=np.float64),
                        pct_hits=[logs[p].pct_hits[-1] for p in range(P)],
                        hits=hit_counts,
                        n_remote=[logs[p].unique_remote[-1] for p in range(P)],
                        replaced=[logs[p].replaced[-1] for p in range(P)],
                        total_comm=[logs[p].comm_volume[-1] for p in range(P)],
                        occupancy_pre=occ_pre,
                        occupancy_post=[logs[p].occupancy[-1] for p in range(P)],
                        step_times=step_times,
                        controllers=self.controllers,
                        **store_kwargs,
                    )
                if self.train_model:
                    _train_sp = tel.begin("train", plane="train")
                    losses.append(train_step(self, minibatches))
                    tel.end(_train_sp)
                tel.end(_step_sp)
            epoch_times.append(epoch_time)

        accuracy = accuracy_pass(self)

        trace = None
        if recorder is not None:
            trace = recorder.finalize(epoch_times, time_engine.events)
            self.last_trace = trace

        return RunResult(
            variant=self.variant,
            epoch_times=epoch_times,
            losses=losses,
            accuracy=accuracy,
            logs=logs,
            controllers=self.controllers,
            graph_meta=self.graph_meta,
            sim_events=time_engine.events,
            trace=trace,
        )


def collect_traces(
    parts: Partitioned,
    buffer_frac: float = 0.25,
    batch_size: int = 256,
    epochs: int = 3,
    seed: int = 0,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Trace-only mode (§4.4): run DistDGL+fixed with training disabled,
    record per-minibatch features and S'-labels for offline classifier
    training. Returns (X, y), equal to the reference's: every stream the
    features are built from is exact, and the features are numpy.
    ``device`` is the trainer's (``"cuda"``, ``"cpu"`` or ``False``)."""
    from ..core.classifiers import featurize, label_traces

    trainer = DistributedTrainer(
        parts,
        variant="fixed",
        buffer_frac=buffer_frac,
        batch_size=batch_size,
        epochs=epochs,
        train_model=False,
        seed=seed,
        device=device,
    )
    result = trainer.run()
    X_rows, y_rows = [], []
    for p, log in enumerate(result.logs):
        hits = np.array(log.pct_hits)
        comm = np.array(log.comm_volume, dtype=np.float64)
        repl = np.array(log.replaced, dtype=np.float64)
        labels = label_traces(hits, comm, repl)
        cap = trainer.buffers[p].capacity
        prev = None
        recent: list[float] = []
        recent_c: list[int] = []
        for i in range(len(hits)):
            m = Metrics(
                minibatch=i % trainer.mb_per_epoch,
                total_minibatches=trainer.mb_per_epoch,
                epoch=i // trainer.mb_per_epoch,
                total_epochs=epochs,
                pct_hits=float(hits[i]),
                comm_volume=int(comm[i]),
                replaced_pct=100.0 * repl[i] / cap if cap else 0.0,
                buffer_occupancy=float(log.occupancy[i]),
                buffer_capacity=cap,
            )
            recent.append(float(hits[i]))
            recent_c.append(int(comm[i]))
            X_rows.append(featurize(m, prev, recent[-16:], recent_c[-16:]))
            y_rows.append(labels[i])
            prev = m
    return np.stack(X_rows), np.array(y_rows, dtype=np.float32)
