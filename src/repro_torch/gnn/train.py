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

Every run is device-resident (:func:`repro_torch.runtime.driver.
run_device`): the buffer state, the graph features and the model live
on ``device`` — the card by default (``device="cuda"``), or the CPU
(``device="cpu"``), where the kernels run as their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import scoring
from ..core.buffer import PersistentBuffer
from ..core.controller import Controller, make_controller
from ..core.metrics import GraphMeta
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
from ..graph.sampler import MiniBatch, NeighborSampler, SamplerPlane
from ..runtime.engine import PrefetchEngine, resolve_device
from .sage import GraphSAGE, init_sage, params_from_jax


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


@dataclass
class RunResult:
    variant: str
    epoch_times: list[float]
    losses: list[float]
    accuracy: float
    logs: list[TrainerLog]
    controllers: list[Controller]
    graph_meta: list[GraphMeta]
    #: Event timeline of the run (``repro_torch.sim.EventLog``) when
    #: priced by the event engine; None under the closed-form model.
    sim_events: object | None = None

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



def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


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

    Not ported yet, and refused with ``NotImplementedError``:
    ``runtime="legacy"``, the staged (non-device) path
    (``device=False``), ``trace``, ``feature_store`` and ``telemetry``.
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
        if runtime == "legacy":
            raise _not_ported("runtime='legacy'", "ROADMAP Queue A item 6")
        if runtime != "vectorized":
            raise ValueError(
                f"runtime must be 'vectorized' or 'legacy', got {runtime!r}"
            )
        if device is False or device is None:
            raise _not_ported(
                "the staged (non-device) path", "ROADMAP Queue A item 6"
            )
        if trace:
            raise _not_ported("trace recording", "ROADMAP Queue A item 4")
        if feature_store:
            raise _not_ported("the feature store", "ROADMAP Queue A item 4")
        if telemetry:
            raise _not_ported("the telemetry session", "ROADMAP Queue A item 4")
        self.device = resolve_device(device)
        if not isinstance(readback_every, (int, np.integer)) or isinstance(
            readback_every, bool
        ) or readback_every < 1:
            raise ValueError(
                f"readback_every must be an int >= 1, got {readback_every!r}"
            )
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
        self.rng = np.random.default_rng(seed)
        self.sampler = NeighborSampler(self.graph, fanouts)
        self.sampler_plane = SamplerPlane(self.graph, fanouts)

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
        self.buffers = [
            PersistentBuffer(
                capacity=max(int(len(self.halos[p]) * buffer_frac), 1),
                policy=self.policy,
                node_weights=node_weights,
                id_base=self.graph.id_base,
            )
            for p in range(P)
        ]
        # Vectorized twin of the per-PE buffers: one (P, C) array state,
        # uploaded to the device at the start of every run.
        self.engine = PrefetchEngine(
            [b.capacity for b in self.buffers],
            policy=self.policy,
            node_weights=node_weights,
            id_base=self.graph.id_base,
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
                self.buffers[p].insert(top)
                self.engine.insert(p, top)

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
            self.model = model.to(self.device)
            # Graph features and labels live on the device as one tensor
            # each; minibatch rows are indexed there.
            self.features = torch.from_numpy(
                np.ascontiguousarray(self.graph.features, dtype=np.float32)
            ).to(self.device)
            self.labels = torch.from_numpy(
                np.asarray(self.graph.labels, dtype=np.int64)
            ).to(self.device)

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
        """``(x_seed, x_n1, x_n2, labels)`` of a minibatch, gathered from
        the device-resident feature tensor (one index upload)."""
        n1, n2 = minibatch.layer_nbrs[0], minibatch.layer_nbrs[1]
        b, f1 = n1.shape
        idx = np.concatenate(
            [minibatch.seeds, n1.ravel(), n2.ravel()]
        ).astype(np.int64)
        rows = self.features[torch.from_numpy(idx).to(self.device)]
        x_seed = rows[:b]
        x_n1 = rows[b : b + n1.size].reshape(b, f1, -1)
        x_n2 = rows[b + n1.size :].reshape(b, f1, -1, rows.shape[1])
        labels = self.labels[torch.from_numpy(minibatch.seeds).to(self.device)]
        return x_seed, x_n1, x_n2, labels

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
    def run(self) -> RunResult:
        """Execute the experiment on the trainer's device."""
        from ..runtime.driver import run_device

        return run_device(self)
