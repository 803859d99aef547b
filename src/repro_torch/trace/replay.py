"""Replay adapters: feed a recorded upstream stream into one plane.

The point of the trace plane: any single plane can be regression-tested
against a recorded run *without re-running everything upstream of it*.

* :func:`replay_decisions` — re-run the decision plane
  (:class:`repro_torch.runtime.DecisionStage` over fresh controllers) against
  the recorded probe-metric stream; returns the replayed
  decision/stall streams.
* :func:`replay_time_engine` — re-price the recorded miss/replacement
  streams (counts + home-partition splits) and stall ticks through any
  :class:`repro_torch.sim.TimeEngine`; returns the replayed per-PE step times.

Each adapter has a ``*_report`` twin that diffs the replayed streams
against the recorded ones (bit-exact, first divergence located) — the
round-trip contract ``tests/test_trace.py`` asserts and the
``python -m repro_torch.trace replay --plane=...`` CLI exposes.

The metrics reconstruction mirrors the runtimes exactly: ``comm_volume``
is the *pre-replacement* miss count, ``replaced_pct`` reads the previous
step's replacement count, ``buffer_occupancy`` is the probe-time
occupancy — see ``ProbeResult`` / the legacy loop in ``gnn/train.py``.
"""

from __future__ import annotations

import numpy as np

from .diff import DiffReport, diff_traces
from .schema import Trace


def metrics_at(trace: Trace, step: int):
    """The per-PE :class:`repro_torch.core.metrics.Metrics` list of one step."""
    from ..core.metrics import Metrics

    m = trace.manifest
    P = trace.num_pes
    mb_per_epoch = int(m.get("mb_per_epoch") or 1)
    capacities = m.get("capacities") or [0] * P
    a = trace.arrays
    replaced_prev = a["replaced"][step - 1] if step > 0 else np.zeros(P)
    return [
        Metrics(
            minibatch=step % mb_per_epoch,
            total_minibatches=mb_per_epoch,
            epoch=step // mb_per_epoch,
            total_epochs=int(m.get("epochs") or 1),
            pct_hits=float(a["pct_hits"][step, p]),
            comm_volume=int(a["miss"][step, p]),
            replaced_pct=(
                100.0 * float(replaced_prev[p]) / capacities[p]
                if step > 0 and capacities[p]
                else 0.0
            ),
            buffer_occupancy=float(a["occupancy_pre"][step, p]),
            buffer_capacity=int(capacities[p]),
        )
        for p in range(P)
    ]


def replay_decisions(trace: Trace, controllers) -> tuple[np.ndarray, np.ndarray]:
    """Drive fresh controllers with the recorded metric stream.

    Returns ``(decisions (S, P) bool, stalls (S, P) float64)`` — the
    decision plane's full output under the recorded inputs. Controllers
    must be *fresh* (same construction as the recorded run); reusing the
    recorded run's controllers replays their mutated state, not the run.
    """
    from ..runtime.stage import DecisionStage

    S, P = trace.num_steps, trace.num_pes
    if len(controllers) != P:
        raise ValueError(f"expected {P} controllers, got {len(controllers)}")
    stage = DecisionStage(controllers)
    decisions = np.zeros((S, P), dtype=bool)
    stalls = np.zeros((S, P), dtype=np.float64)
    for s in range(S):
        stage.submit(metrics_at(trace, s))
        decisions[s], stalls[s] = stage.collect()
    return decisions, stalls


def replay_time_engine(trace: Trace, engine) -> np.ndarray:
    """Re-price the recorded communication streams through ``engine``.

    Builds one :class:`repro_torch.sim.StepComm` per step from the recorded
    miss/replacement counts (and home-split matrices when the engine
    asks for them) and the recorded stall ticks; returns the replayed
    ``(S, P)`` step times. The engine must be fresh (one engine prices
    one run).
    """
    from ..sim import StepComm

    S, P = trace.num_steps, trace.num_pes
    a = trace.arrays
    if engine.needs_pairs and "miss_pairs" not in a:
        raise ValueError(
            "engine needs per-home pairs but the trace has no "
            "miss_pairs/repl_pairs (recorded without part_of)"
        )
    times = np.zeros((S, P), dtype=np.float64)
    for s in range(S):
        comm = StepComm(
            miss=a["miss"][s].astype(np.int64),
            repl=a["replaced"][s].astype(np.int64),
            miss_pairs=(
                a["miss_pairs"][s].astype(np.int64) if "miss_pairs" in a else None
            ),
            repl_pairs=(
                a["repl_pairs"][s].astype(np.int64) if "repl_pairs" in a else None
            ),
        )
        times[s] = engine.step(comm, a["stalls"][s])
    return times


# ---------------------------------------------------------------------- #
# report twins: replayed streams vs recorded streams, bit-exact
# ---------------------------------------------------------------------- #
def _with_arrays(trace: Trace, **overrides) -> Trace:
    return Trace(
        manifest=trace.manifest, arrays={**trace.arrays, **overrides}
    )


def replay_decisions_report(trace: Trace, controllers) -> DiffReport:
    """Replay the decision plane and diff decisions/stalls vs recorded."""
    decisions, stalls = replay_decisions(trace, controllers)
    replayed = _with_arrays(trace, decisions=decisions, stalls=stalls)
    return diff_traces(trace, replayed, fields=("decisions", "stalls"))


def replay_time_engine_report(trace: Trace, engine) -> DiffReport:
    """Replay the time engine and diff step times vs recorded."""
    times = replay_time_engine(trace, engine)
    replayed = _with_arrays(trace, step_time=times)
    return diff_traces(trace, replayed, fields=("step_time",))
