"""Flow-level discrete-event contention model for fetch RPCs.

The closed-form §4.5.3 model prices every trainer's fetch traffic
independently — as if each home partition had infinite egress. Real
clusters serialize: when several trainers pull features from the same
home partition concurrently, they share that partition's egress link.

This module simulates one minibatch's fetch RPCs as *fluid flows* on an
event timeline (the standard flow-level network model): each flow has a
start offset, a per-RPC latency ``alpha``, a byte size, and a per-flow
rate cap (the pair's bandwidth from :class:`repro_torch.graph.generate.
Topology`, or the flat ``TimeModel.link_bw``). Flows pulling from the
same home partition share its egress capacity **max–min fairly**; rates
are recomputed at every event (flow arrival or completion), and the
simulation advances from event to event — a deterministic progressive
filling with no randomness and no time discretization.

With no egress capacities (``egress_bw=None``) every flow runs at its
own cap and the finish time degenerates to the closed-form
``start + alpha + nbytes / bw`` — the arithmetic the parity contract
relies on (``tests/test_sim.py::TestFlowSim``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Flow:
    """One aggregated fetch RPC: trainer ``pe`` pulling from ``home``.

    ``home == -1`` marks a flat-model flow on the trainer's own ingress
    link — never subject to egress sharing.
    """

    pe: int
    home: int
    nbytes: float
    alpha: float
    bw: float
    start: float = 0.0
    kind: str = "fetch"

    def __post_init__(self):
        if self.nbytes <= 0:
            raise ValueError("flows must carry bytes (skip empty fetches)")
        if self.bw <= 0:
            raise ValueError("flow rate cap must be > 0")


def _waterfill(caps: np.ndarray, capacity: float) -> np.ndarray:
    """Max–min fair rates for flows with per-flow ``caps`` sharing one
    link of ``capacity``. Ascending-cap order: a flow capped below its
    fair share frees the residual for the rest."""
    n = len(caps)
    rates = np.empty(n, dtype=np.float64)
    remaining = float(capacity)
    left = n
    for i in np.argsort(caps, kind="stable"):
        rate = min(float(caps[i]), remaining / left)
        rates[i] = rate
        remaining -= rate
        left -= 1
    return rates


def _rates(
    flows: list[Flow], active: list[int], egress_bw: np.ndarray | None
) -> dict[int, float]:
    """Current rate of every active flow under max–min egress sharing."""
    by_home: dict[int, list[int]] = {}
    for i in active:
        by_home.setdefault(flows[i].home, []).append(i)
    rates: dict[int, float] = {}
    for home, members in by_home.items():
        caps = np.array([flows[i].bw for i in members], dtype=np.float64)
        if home < 0 or egress_bw is None or egress_bw[home] >= caps.sum():
            fair = caps  # uncontended: every flow at its own cap
        else:
            fair = _waterfill(caps, float(egress_bw[home]))
        for i, rate in zip(members, fair):
            rates[i] = float(rate)
    return rates


def simulate_flows(
    flows: list[Flow], egress_bw: np.ndarray | None = None
) -> np.ndarray:
    """Run the fluid simulation; returns each flow's finish time.

    ``egress_bw[q]`` is home partition q's egress capacity in bytes/s
    (``None`` disables sharing entirely). Finish times are absolute on
    the same clock as ``Flow.start``. Completions fire at their exactly
    projected instants (no residual-byte thresholds), so the simulation
    is deterministic and never stalls on rounding.
    """
    n = len(flows)
    finish = np.zeros(n, dtype=np.float64)
    if n == 0:
        return finish
    # Transfer begins after the per-RPC latency.
    arrival = np.array([f.start + f.alpha for f in flows], dtype=np.float64)
    order = np.argsort(arrival, kind="stable")
    remaining = np.array([f.nbytes for f in flows], dtype=np.float64)
    shared = np.zeros(n, dtype=bool)  # ever ran below its own cap
    active: list[int] = []
    next_arrival = 0  # index into `order`
    t = float(arrival[order[0]])
    while active or next_arrival < n:
        # Admit every flow that has arrived by now.
        while next_arrival < n and arrival[order[next_arrival]] <= t:
            active.append(int(order[next_arrival]))
            next_arrival += 1
        if not active:
            t = float(arrival[order[next_arrival]])
            continue
        rates = _rates(flows, active, egress_bw)
        for i in active:
            if rates[i] < flows[i].bw:
                shared[i] = True
        projected = {i: t + remaining[i] / rates[i] for i in active}
        t_fin = min(projected.values())
        t_arr = (
            float(arrival[order[next_arrival]]) if next_arrival < n else np.inf
        )
        if t_arr < t_fin:
            # An arrival changes the rate allocation before anything
            # completes: advance the fluid state and re-solve.
            for i in active:
                remaining[i] -= rates[i] * (t_arr - t)
            t = t_arr
            continue
        # One or more completions fire at t_fin (ties complete together).
        tol = 1e-12 * max(abs(t_fin), 1.0)
        done = [i for i in active if projected[i] <= t_fin + tol]
        for i in active:
            if i not in done:
                remaining[i] -= rates[i] * (t_fin - t)
        for i in done:
            # A flow that was never shared ran at its cap start-to-end:
            # report the closed-form finish (exact arithmetic, which the
            # parity contract depends on) instead of the fluid-advance
            # rounding of the same value.
            finish[i] = (
                flows[i].start + (flows[i].alpha + flows[i].nbytes / flows[i].bw)
                if not shared[i]
                else projected[i]
            )
            remaining[i] = 0.0
            active.remove(i)
        t = t_fin
    return finish
