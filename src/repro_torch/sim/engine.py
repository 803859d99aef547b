"""Time engines: closed-form §4.5.3 formulas vs discrete-event cluster sim.

Both runtimes (the legacy per-trainer loop and the vectorized
three-stage pipeline) delegate *all* wall-clock modeling to one
:class:`TimeEngine` per run. Per minibatch the runtime hands the engine
the **exact** communication artifacts it produced — per-PE missed-fetch
and replacement-admission counts, split by home partition when the
engine asks for it (``needs_pairs``) — plus the controller stall ticks;
the engine returns the per-PE step times the §4.5.3 accounting logs. The byte/hit/decision streams are never touched:
time engines only *price* them.

* :class:`ClosedFormTimeEngine` — the paper's closed-form model
  (``async = max(T_DDP, T_COMM)``, ``sync = T_DDP + T_COMM + T_A/C``),
  flat constants or per-pair :class:`repro_torch.graph.generate.Topology`
  pricing. One shared helper, :meth:`repro_torch.gnn.train.TimeModel.
  step_time_batch`, holds the async/sync arithmetic.

* :class:`EventTimeEngine` — the simulation plane. Each minibatch step
  is scheduled on per-trainer and per-link timelines starting at the
  gradient all-reduce barrier: compute intervals (per-PE straggler
  multipliers + seeded jitter), fetch RPCs as fluid flows with max–min
  fair egress sharing (:mod:`repro_torch.sim.contention`), the agent daemon
  as a real interval that async mode hides only while compute+comm
  cover it, and optional prefetcher-thread replacement overlap.

**Parity contract** (``tests/test_runtime_parity.py``): with no
stragglers, no congestion, default :class:`SimConfig` and a flat (or
``None``) topology, the event engine's per-step times are **bit
identical** to the closed-form engine for all four variants in both
modes — the event decomposition degenerates to single uncontended flows
whose finish times are computed by the *same* arithmetic, and the step
composition calls the *same* ``TimeModel.step_time_batch`` helper.
Divergence appears exactly when a dynamic condition is injected:
stragglers stretch compute and skew the barrier, congestion shares home
egress links, ``SimConfig.t_agent`` prices the inference daemon in
wall-clock, ``SimConfig.replacement_overlap`` lets the prefetcher's
ReplaceandFetch RPC run concurrently with the miss fetch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.generate import CongestionModel, StragglerModel, Topology
from .contention import Flow, simulate_flows
from .events import EventLog, SimEvent


@dataclass
class StepComm:
    """One minibatch's exact communication artifacts, all PEs.

    ``miss[p]`` / ``repl[p]`` are PE p's missed-fetch and
    replacement-admission node counts; the ``*_pairs`` matrices split
    them by home partition (``pairs[p, q]`` = nodes trainer p pulls from
    partition q) and are built only when the engine's ``needs_pairs``
    asks for them.
    """

    miss: np.ndarray                      # (P,) int64
    repl: np.ndarray                      # (P,) int64
    miss_pairs: np.ndarray | None = None  # (P, P) int64
    repl_pairs: np.ndarray | None = None  # (P, P) int64


def build_step_comm(
    missed: list[np.ndarray],
    placed: list[np.ndarray],
    part_of: np.ndarray | None,
    num_parts: int,
    needs_pairs: bool,
    id_base: int = 0,
) -> StepComm:
    """Assemble one step's :class:`StepComm` from per-PE node-id lists.

    ``missed[p]`` / ``placed[p]`` are the exact node ids PE p fetched on
    miss / admitted into its buffer this round. The per-home split is
    one flattened bincount per stream, keyed ``trainer_row * P + home``.
    Node ids are global (``id_base`` + local index); ``part_of`` is
    local-indexed, so ids are rebased before the home lookup.
    """
    P = num_parts
    miss = np.array([len(m) for m in missed], dtype=np.int64)
    repl = np.array([len(x) for x in placed], dtype=np.int64)
    if not needs_pairs:
        return StepComm(miss, repl)
    if part_of is None:
        raise ValueError("per-home pricing needs part_of")

    def pairs_of(node_lists: list[np.ndarray]) -> np.ndarray:
        lengths = [len(x) for x in node_lists]
        rows = np.repeat(np.arange(P, dtype=np.int64), lengths)
        nodes = (
            np.concatenate(node_lists)
            if sum(lengths)
            else np.array([], dtype=np.int64)
        )
        return np.bincount(
            rows * P + part_of[nodes - id_base], minlength=P * P
        ).reshape(P, P)

    return StepComm(miss, repl, pairs_of(missed), pairs_of(placed))


@dataclass(frozen=True)
class SimConfig:
    """Event-engine knobs beyond the scenario models.

    Defaults are the **parity configuration**: inference priced exactly
    as the closed form does (hidden in async, ``stalls * t_ddp`` in
    sync) and replacement traffic aggregated into the miss RPC. Setting
    ``t_agent`` prices the daemon thread in wall-clock seconds per
    latency tick — async then hides it only while compute+comm actually
    cover it, and the sync stall is charged at ``t_agent`` per tick.
    ``replacement_overlap`` issues ReplaceandFetch as its own concurrent
    RPC (Algorithm 1's prefetcher thread) instead of serializing its
    bytes into the miss fetch.
    """

    t_agent: float | None = None
    replacement_overlap: bool = False
    collect_events: bool = True


def _closed_form_t_comm(tm, topology, comm: StepComm, feature_dim: int):
    """The §4.5.3 T_COMM pricing — the single source both the closed-form
    engine and the event engine's parity path call, so the two cannot
    drift (drift would silently break the bit-identical parity contract).
    """
    if topology is None:
        return tm.t_comm_batch(comm.miss + comm.repl, feature_dim)
    return topology.t_comm_pairs(
        comm.miss_pairs + comm.repl_pairs, feature_dim, tm.feature_bytes
    )


class TimeEngine:
    """Per-run wall-clock model; see module docstring."""

    kind: str = "base"
    #: Whether :meth:`step` needs the per-home ``*_pairs`` matrices.
    needs_pairs: bool = False
    #: Event timeline (:class:`repro_torch.sim.events.EventLog`) or None.
    events: EventLog | None = None

    def step(self, comm: StepComm, stalls: np.ndarray) -> np.ndarray:
        """Price one minibatch; returns (P,) step times in seconds."""
        raise NotImplementedError


class ClosedFormTimeEngine(TimeEngine):
    """The paper's §4.5.3 closed-form model (flat or per-pair priced)."""

    kind = "closed_form"

    def __init__(
        self,
        tm,
        mode: str,
        inference_cost: np.ndarray,
        feature_dim: int,
        num_pes: int,
        topology: Topology | None = None,
    ):
        self.tm = tm
        self.mode = mode
        self.inference_cost = np.asarray(inference_cost, dtype=np.float64)
        self.feature_dim = int(feature_dim)
        self.num_pes = int(num_pes)
        self.topology = topology
        self.needs_pairs = topology is not None

    def step(self, comm, stalls):
        t_comm = _closed_form_t_comm(
            self.tm, self.topology, comm, self.feature_dim
        )
        return self.tm.step_time_batch(
            t_comm, np.asarray(stalls, dtype=np.float64),
            self.inference_cost, self.mode,
        )


class EventTimeEngine(TimeEngine):
    """Discrete-event cluster simulation (see module docstring).

    Every step starts at the previous gradient all-reduce barrier, so
    event times are step-relative; the engine keeps the absolute cluster
    clock (``clock``) for the cross-step agent-daemon lane. One engine
    instance prices one run — construct a fresh one per ``run()``.
    """

    kind = "event"

    def __init__(
        self,
        tm,
        mode: str,
        inference_cost: np.ndarray,
        feature_dim: int,
        num_pes: int,
        topology: Topology | None = None,
        stragglers: StragglerModel | None = None,
        congestion: CongestionModel | None = None,
        config: SimConfig | None = None,
        total_steps: int = 0,
    ):
        self.tm = tm
        self.mode = mode
        self.inference_cost = np.asarray(inference_cost, dtype=np.float64)
        self.feature_dim = int(feature_dim)
        self.num_pes = P = int(num_pes)
        self.topology = topology
        self.stragglers = stragglers
        self.congestion = congestion
        self.config = config or SimConfig()
        self.total_steps = int(total_steps)
        if stragglers is not None and stragglers.num_parts != P:
            raise ValueError(
                f"straggler model is {stragglers.num_parts}-way, cluster is {P}"
            )
        if congestion is not None and congestion.num_parts != P:
            raise ValueError(
                f"congestion model is {congestion.num_parts}-way, cluster is {P}"
            )
        # The flow decomposition issues per-peer RPCs in parallel; a
        # serialized fetch loop (reduce='sum') has no static flow starts.
        if (
            topology is not None
            and topology.reduce != "max"
            and (congestion is not None or self.config.replacement_overlap
                 or self.config.t_agent is not None)
        ):
            raise ValueError(
                "event-engine flow decomposition requires a reduce='max' "
                f"topology, got reduce={topology.reduce!r}"
            )
        self.needs_pairs = topology is not None or congestion is not None
        self.events = EventLog() if self.config.collect_events else None
        self._rng = np.random.default_rng(
            stragglers.seed if stragglers is not None else 0
        )
        self._step_idx = 0
        self.clock = 0.0
        # Async agent-daemon twin (mirrors InferencePipe tick accounting,
        # priced in wall-clock on the `agent` lane).
        self._agent_busy = np.zeros(P, dtype=bool)
        self._agent_ready_tick = np.zeros(P, dtype=np.float64)
        self._agent_free_at = np.zeros(P, dtype=np.float64)  # cluster time

    # ------------------------------------------------------------------ #
    def _compute_durations(self) -> np.ndarray:
        """Per-PE compute interval lengths (stragglers + seeded jitter)."""
        if self.stragglers is None:
            return np.full(self.num_pes, self.tm.t_ddp, dtype=np.float64)
        mult = np.asarray(self.stragglers.compute_mult, dtype=np.float64)
        if self.stragglers.jitter > 0:
            mult = mult * np.exp(
                self.stragglers.jitter
                * self._rng.standard_normal(self.num_pes)
            )
        return self.tm.t_ddp * mult

    def _agent_tick_async(self) -> np.ndarray:
        """Advance the daemon lane one tick; returns per-PE shift.

        The shift is how long the prefetcher must wait, past the step
        barrier, for the in-flight inference to finish in wall-clock —
        zero whenever the covered steps were long enough to hide it (and
        always zero in the parity configuration, where inference is
        priced at ``t_ddp`` per tick and every step lasts >= t_ddp).
        """
        P = self.num_pes
        shift = np.zeros(P, dtype=np.float64)
        t_agent = (
            self.config.t_agent if self.config.t_agent is not None
            else self.tm.t_ddp
        )
        now = self._step_idx
        for p in range(P):
            latency = self.inference_cost[p]
            if latency <= 0:
                continue
            if self._agent_busy[p] and now >= self._agent_ready_tick[p]:
                lag = max(0.0, self._agent_free_at[p] - self.clock)
                if self.config.t_agent is not None:
                    shift[p] = lag
                self._agent_busy[p] = False
            if not self._agent_busy[p]:
                self._agent_busy[p] = True
                self._agent_ready_tick[p] = now + max(latency, 1e-9)
                self._agent_free_at[p] = (
                    self.clock + shift[p] + latency * t_agent
                )
                if self.events is not None:
                    self.events.add(SimEvent(
                        step=now, lane="agent", kind="infer", pe=p,
                        t0=float(shift[p]),
                        t1=float(shift[p] + latency * t_agent),
                    ))
        return shift

    # ------------------------------------------------------------------ #
    def step(self, comm, stalls):
        tm = self.tm
        P = self.num_pes
        fd = self.feature_dim
        stalls = np.asarray(stalls, dtype=np.float64)
        d_compute = self._compute_durations()
        shift = (
            self._agent_tick_async()
            if self.mode == "async"
            else np.zeros(P, dtype=np.float64)
        )
        t_stall = self.config.t_agent  # None -> helper charges t_ddp

        split = (
            self.congestion is not None
            or self.config.replacement_overlap
            or (self.config.t_agent is not None and self.mode == "async")
        )
        if not split:
            # Parity path: identical arithmetic to the closed form —
            # one aggregated uncontended RPC per PE (or per-pair
            # topology pricing), composed by the shared helpers.
            t_comm = _closed_form_t_comm(tm, self.topology, comm, fd)
            step_times = tm.step_time_batch(
                t_comm, stalls, self.inference_cost, self.mode,
                t_ddp=d_compute, t_stall=t_stall,
            )
            if self.events is not None:
                serial = (self.mode == "sync") & (self.inference_cost > 0)
                nbytes = (comm.miss + comm.repl) * fd * tm.feature_bytes
                for p in range(P):
                    start = float(d_compute[p]) if serial[p] else 0.0
                    if t_comm[p] > 0:
                        self.events.add(SimEvent(
                            step=self._step_idx, lane="net", kind="fetch",
                            pe=p, t0=start, t1=start + float(t_comm[p]),
                            nbytes=int(nbytes[p]),
                        ))
        else:
            step_times = self._step_flows(
                comm, stalls, d_compute, shift, t_stall
            )

        if self.events is not None:
            for p in range(P):
                self.events.add(SimEvent(
                    step=self._step_idx, lane="compute", kind="ddp", pe=p,
                    t0=0.0, t1=float(d_compute[p]),
                ))
            barrier = float(step_times.max()) if P else 0.0
            self.events.add(SimEvent(
                step=self._step_idx, lane="cluster", kind="barrier", pe=-1,
                t0=barrier, t1=barrier,
            ))
        self.clock += float(step_times.max()) if P else 0.0
        self._step_idx += 1
        return step_times

    # ------------------------------------------------------------------ #
    def _step_flows(
        self, comm, stalls, d_compute, shift, t_stall
    ) -> np.ndarray:
        """Full event decomposition: per-link fluid flows + lane merge."""
        tm = self.tm
        P = self.num_pes
        fd = self.feature_dim
        fb = tm.feature_bytes
        serial = (self.mode == "sync") & (self.inference_cost > 0)
        miss_start = np.where(serial, d_compute, 0.0)
        # Replacement RPCs wait for the daemon's wall-clock completion
        # (async agent lag) and, without overlap, ride the miss RPC.
        overlap = self.config.replacement_overlap

        # One RPC descriptor per (PE, link): per home partition when the
        # engine prices per-pair / shares egress, else the flat model's
        # single aggregated RPC on the PE's own ingress link (home=-1).
        def rpcs(p: int):
            if not self.needs_pairs:
                yield -1, int(comm.miss[p]), int(comm.repl[p]), tm.alpha, tm.link_bw
                return
            for q in range(P):
                if q == p:
                    continue
                alpha, bw = (
                    (float(self.topology.alpha[p, q]),
                     float(self.topology.bw[p, q]))
                    if self.topology is not None
                    else (tm.alpha, tm.link_bw)
                )
                yield q, int(comm.miss_pairs[p, q]), int(comm.repl_pairs[p, q]), alpha, bw

        flows: list[Flow] = []
        for p in range(P):
            for home, m, r, alpha, bw in rpcs(p):
                if not overlap and shift[p] == 0.0:
                    m, r = m + r, 0
                if m > 0:
                    flows.append(Flow(
                        pe=p, home=home, nbytes=float(m * fd * fb),
                        alpha=alpha, bw=bw, start=float(miss_start[p]),
                    ))
                if r > 0:
                    flows.append(Flow(
                        pe=p, home=home, nbytes=float(r * fd * fb),
                        alpha=alpha, bw=bw,
                        start=float(miss_start[p] + shift[p]),
                        kind="replace",
                    ))
        egress = (
            self.congestion.egress_at(self._step_idx, self.total_steps)
            if self.congestion is not None
            else None
        )
        finish = simulate_flows(flows, egress)
        comm_end = np.zeros(P, dtype=np.float64)
        for flow, end in zip(flows, finish):
            comm_end[flow.pe] = max(comm_end[flow.pe], float(end))
            if self.events is not None:
                self.events.add(SimEvent(
                    step=self._step_idx, lane="net", kind=flow.kind,
                    pe=flow.pe, t0=flow.start, t1=float(end),
                    src=flow.home, nbytes=int(flow.nbytes),
                ))
        base = np.maximum(d_compute, comm_end)
        t_per_tick = t_stall if t_stall is not None else tm.t_ddp
        return base + np.where(serial, stalls * t_per_tick, 0.0)
