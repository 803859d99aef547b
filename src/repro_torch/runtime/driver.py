"""The minibatch loops of :meth:`repro_torch.gnn.train.DistributedTrainer.run`.

Port of the reference's ``run_device`` and ``run_vectorized``. On the
device-resident loop (:func:`run_device`) the whole cluster goes, per step,
through the stages of :mod:`repro_torch.runtime.stage`,
pipeline-rotated so the host decision plane runs between probes::

    sample(0) ── prime launch [probe(0)]
    step t:   decide(t) → begin miss gather(t) → sample(t+1)
              → launch [score(t), replace(t), probe(t+1)]
              → accounting / trace / train for step t

Buffer state (and, with a feature store, the feature payload) lives on
the trainer's device (:class:`repro_torch.runtime.engine.DeviceEngine`).
When every PE's seed block has one constant length the loop takes the
single-launch raw path: each step uploads the raw ``(P, Mt)`` frontier,
makes one ``fused_frontier_step`` launch and reads one packed block
back. Ragged seed blocks take the reference's staged-gather loop: the
host dedups each PE's remote set and each step makes one ``fused_step``
launch. The RNG draws, controller calls and in-kernel round order are
those of the reference, so every exact stream (hits, misses, bytes,
decisions, feat_sums, modeled step times, the trace's ``exact_digest``)
is bit-identical to it. The GraphSAGE step is data-parallel: per-PE
gradients are summed, averaged over PEs and applied with SGD.

Graphs whose global ids sit at an ``id_base`` or pass ``2**31 - 2`` run
both loops in the engine's wide mode (int64 ids, the ``_wide`` kernels).
With ``readback_every=K > 1`` the raw loop reads back only each launch's
``(P, 4)`` counters, K launches at a time
(:func:`_run_device_cadence`), for runs that consume no per-step id
stream (:func:`_check_cadence_eligible`).

:func:`run_vectorized` is the entry of ``DistributedTrainer.run`` and the
port of the reference's staged loop: sample → probe → decide → commit
over the numpy :class:`repro_torch.runtime.engine.PrefetchEngine`
(:class:`repro_torch.runtime.stage.FetchStage`). A trainer built with
``device=False`` runs it on the host; a device trainer goes to
:func:`run_device` unless its graph's ids pass ``WIDE_ID_MAX``, where
it falls back to the staged loop (counted as ``device.fallback_int64``,
warned once per trainer) with the sampler's dedup and the engine's
scoring round on the trainer's device (``frontier_unique_batch`` and
``score_policy_update_batch``). Its streams equal the device loops'.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import telemetry as tel
from ..core.controller import (
    FixedController,
    NoPrefetchController,
    PeriodicController,
)
from ..core.metrics import Metrics
from ..graph.sampler import SamplerPlane
from ..sim import StepComm
from .stage import DecisionStage, FetchStage, FusedFetchStage, SampleStage


def run_vectorized(trainer) -> "RunResult":  # noqa: F821 — see lazy import
    """Execute ``trainer``'s experiment on the staged loop (see the module
    note); a device trainer whose ids fit the wide-id bound goes to
    :func:`run_device` instead. The run's state stays in
    ``trainer.engine``; a recorded trace lands on ``trainer.last_trace``."""
    if trainer.device is not False:
        from ..kernels import ops

        # Past WIDE_ID_MAX (about 2^61) no device loop can carry the ids:
        # the run takes the staged loop (identical streams, no device
        # residency). Counted, so a sweep can report how many cells took
        # it; warned once per trainer.
        max_id = trainer.graph.id_base + trainer.graph.num_nodes - 1
        if ops.wide_id_eligible(max_id):
            return run_device(trainer)
        tel.count("device.fallback_int64")
        if not getattr(trainer, "_warned_int64_fallback", False):
            trainer._warned_int64_fallback = True
            warnings.warn(
                "device=... requested but graph node ids exceed int32 "
                "and the wide-id bound; falling back to the staged "
                "pipeline",
                RuntimeWarning,
                stacklevel=2,
            )
    from ..gnn.train import RunResult, TrainerLog

    P = trainer.parts.num_parts
    sample = SampleStage(
        trainer.sampler_plane, P, trainer._seed_batch, trainer.parts.part_of
    )
    decide = DecisionStage(trainer.controllers)
    time_engine = trainer.make_time_engine()
    fetch = FetchStage(
        trainer.engine,
        decide.uses_buffer,
        decide.inference_cost,
        time_engine,
        trainer.graph.features.shape[1],
        trainer.mode,
        part_of=trainer.parts.part_of,
        store=trainer.feature_store,
        feature_bytes=trainer.tm.feature_bytes,
    )

    logs = [TrainerLog() for _ in range(P)]
    epoch_times: list[float] = []
    losses: list[float] = []
    recorder = trainer.make_trace_recorder()

    for epoch in range(trainer.epochs):
        epoch_time = 0.0
        for mb in range(trainer.mb_per_epoch):
            _step_sp = tel.begin(
                "step", plane="runtime", step=epoch * trainer.mb_per_epoch + mb
            )
            # -- stage 1: batched sampling ----------------------------- #
            minibatches, remote, n_remote = sample.run(epoch, mb, trainer.rng)

            # -- stage 2: batched probe + controller decisions --------- #
            probe = fetch.probe(remote, n_remote)
            decide.submit(
                [
                    Metrics(
                        minibatch=mb,
                        total_minibatches=trainer.mb_per_epoch,
                        epoch=epoch,
                        total_epochs=trainer.epochs,
                        pct_hits=float(probe.pct_hits[p]),
                        comm_volume=int(probe.comm[p]),
                        replaced_pct=float(probe.replaced_pct[p]),
                        buffer_occupancy=float(probe.occupancy[p]),
                        buffer_capacity=int(trainer.engine.capacity[p]),
                    )
                    for p in range(P)
                ]
            )
            decisions, stalls = decide.collect()

            # -- stage 3: scoring + replacement + accounting ----------- #
            commit = fetch.commit(decisions, stalls)

            for p in range(P):
                logs[p].pct_hits.append(float(probe.pct_hits[p]))
                logs[p].comm_volume.append(int(commit.total_comm[p]))
                logs[p].comm_missed.append(int(probe.comm[p]))
                logs[p].occupancy.append(float(commit.occupancy[p]))
                logs[p].unique_remote.append(int(n_remote[p]))
                logs[p].replaced.append(int(commit.replaced[p]))
                logs[p].decisions.append(bool(decisions[p]))
                logs[p].step_time.append(float(commit.step_time[p]))
                if trainer.feature_store is not None:
                    logs[p].bytes_measured.append(int(commit.bytes_measured[p]))
                    logs[p].bytes_modeled.append(int(commit.bytes_modeled[p]))
                    logs[p].fetch_seconds.append(float(commit.fetch_seconds))
                    logs[p].feat_sums.append(float(commit.feat_sums[p]))
            epoch_time += float(commit.step_time.max())

            if recorder is not None:
                store_kwargs: dict = {}
                if trainer.feature_store is not None:
                    store_kwargs = dict(
                        feat_sums=commit.feat_sums,
                        bytes_measured=commit.bytes_measured,
                        bytes_modeled=commit.bytes_modeled,
                        fetch_time_measured=np.full(
                            P, commit.fetch_seconds, dtype=np.float64
                        ),
                    )
                recorder.record_step(
                    seeds=[m.seeds for m in minibatches],
                    remote=remote,
                    missed=commit.missed,
                    placed=commit.placed,
                    decisions=decisions,
                    stalls=stalls,
                    pct_hits=probe.pct_hits,
                    hits=probe.hits,
                    n_remote=n_remote,
                    replaced=commit.replaced,
                    total_comm=commit.total_comm,
                    occupancy_pre=probe.occupancy,
                    occupancy_post=commit.occupancy,
                    step_times=commit.step_time,
                    controllers=trainer.controllers,
                    **store_kwargs,
                )

            if trainer.train_model:
                _train_sp = tel.begin("train", plane="train")
                losses.append(train_step(trainer, minibatches))
                tel.end(_train_sp)
            tel.end(_step_sp)
        epoch_times.append(epoch_time)

    accuracy = accuracy_pass(trainer)

    trace = None
    if recorder is not None:
        trace = recorder.finalize(epoch_times, time_engine.events)
        trainer.last_trace = trace
    return RunResult(
        variant=trainer.variant,
        epoch_times=epoch_times,
        losses=losses,
        accuracy=accuracy,
        logs=logs,
        controllers=trainer.controllers,
        graph_meta=trainer.graph_meta,
        sim_events=time_engine.events,
        trace=trace,
    )


def accuracy_pass(trainer) -> float:
    """The run's closing accuracy pass (0.0 without a model): one sample of
    the first 512 train nodes and a forward, the ``call.accuracy`` span."""
    if not trainer.train_model:
        return 0.0
    _acc_sp = tel.begin("call.accuracy", plane="runtime")
    batch = trainer.graph.train_nodes[: min(512, len(trainer.graph.train_nodes))]
    minibatch = trainer.sampler.sample(batch, trainer.rng)
    accuracy = trainer.model.accuracy(*trainer._features_of(minibatch), aggregated=True)
    tel.end(_acc_sp)
    return accuracy


def _device_raw_supported(trainer) -> bool:
    """True when every PE's seed block has the same constant length for
    all minibatches — the dense ``(P, Mt)`` frontier block the
    single-launch raw path uploads. A PE with ``0 < len(local_train) <
    batch_size`` yields ragged blocks (see ``_seed_batch``'s wraparound)."""
    B = trainer.batch_size
    lens = set()
    for t in trainer.local_train:
        L = len(t)
        if L == 0:
            lens.add(min(B, len(trainer.graph.train_nodes)))
        elif L >= B:
            lens.add(B)
        else:
            return False
    return len(lens) == 1


def train_step(trainer, minibatches) -> float:
    """One data-parallel GraphSAGE step over the P trainers' minibatches:
    per-PE loss and gradients (the neighbour means through the
    ``gather_mean`` / ``segment_sum_equal`` kernels, see
    ``DistributedTrainer._features_of``), gradients summed in PE order
    and averaged, one SGD update of ``trainer.model``. Returns the mean
    loss. Each PE's inputs are the ``train.features`` span, its wait for
    the loss (and so for its forward and backward) the ``train.wait``
    span."""
    model = trainer.model
    P = len(minibatches)
    grads_acc = None
    loss_acc = 0.0
    for mb in minibatches:
        _feat_sp = tel.begin("train.features", plane="train")
        inputs = trainer._features_of(mb)
        tel.end(_feat_sp)
        loss, grads = model.loss_and_grads(*inputs, aggregated=True)
        _wait_sp = tel.begin("train.wait", plane="train")
        loss_acc += float(loss) / P
        tel.end(_wait_sp)
        grads_acc = (
            grads if grads_acc is None else [a + b for a, b in zip(grads_acc, grads)]
        )
    with torch.no_grad():
        for prm, g in zip(model.parameters(), grads_acc):
            prm.sub_(trainer.lr * (g / P))
    return loss_acc


def _check_cadence_eligible(trainer, time_engine, use_raw: bool) -> None:
    """``readback_every > 1`` trades per-step readbacks for counters —
    valid only when nothing consumes the per-step id streams. Anything
    else is a configuration error, not a silent downgrade."""
    K = trainer.readback_every
    reasons = []
    if not use_raw:
        reasons.append("ragged per-PE seed blocks (staged fallback path)")
    if trainer.trace:
        reasons.append("trace recording needs per-step id streams")
    if trainer.feature_store is not None:
        reasons.append("the feature store moves per-step rows")
    if time_engine.needs_pairs:
        reasons.append("per-home comm pricing needs per-step id sets")
    bad = [
        type(c).__name__
        for c in trainer.controllers
        if type(c) not in (NoPrefetchController, FixedController, PeriodicController)
    ]
    if bad:
        reasons.append(f"controllers {sorted(set(bad))} read per-step metrics")
    if reasons:
        raise ValueError(
            f"readback_every={K} is incompatible with this run: " + "; ".join(reasons)
        )


def _run_device_cadence(
    trainer, sample, decide, time_engine, dev, fused, K: int
) -> "RunResult":  # noqa: F821 — see lazy import
    """The K-step readback cadence of the raw loop.

    Launches run as in :func:`run_device`'s raw loop, but each hands back
    only its ``(P, 4)`` ``[n_remote, hits, n_place, n_valid]`` counters as
    a device tensor (``fused_step_raw(want="counts")``), and one
    ``torch.stack(pending).cpu()`` every K launches pulls them
    (``dev.transfers["d2h"]`` counts each pull). Per-step logs, stats and
    step times are rebuilt from the counters: step t's probe counters
    ride in launch t, its replacement counters in launch t+1 (the
    pipeline rotation), so a step is accounted once both are on the
    host. :func:`_check_cadence_eligible` guarantees nothing in the run
    reads the per-step id streams this loop never materialises, and the
    eligible controllers never read the metrics, so the decision stream
    is that of the K=1 loop. ``last_*`` bookkeeping stays stale; the
    state is written back by ``sync_to_engine`` and the stats are
    shared."""
    from ..gnn.train import RunResult, TrainerLog

    P = dev.num_pes
    active = fused.active
    uses_buffer = fused.uses_buffer
    logs = [TrainerLog() for _ in range(P)]
    epoch_times = [0.0] * trainer.epochs
    losses: list[float] = []
    total = trainer.epochs * trainer.mb_per_epoch

    counters: list[np.ndarray] = []  # per launch, (P, 4) on the host
    pending: list[torch.Tensor] = []  # device counter blocks not pulled yet
    meta: list[tuple] = []            # per step: (epoch, decisions, stalls)
    done = 0                          # steps fully accounted

    def account(t: int) -> None:
        epoch, decisions, stalls = meta[t]
        probe_c, repl_c = counters[t], counters[t + 1]
        n_remote = probe_c[:, 0].astype(np.int64)
        hits = probe_c[:, 1].astype(np.int64)
        n_place = repl_c[:, 2].astype(np.int64)
        n_valid = repl_c[:, 3].astype(np.int64)
        do_rep = decisions & uses_buffer
        # Probe bookkeeping (lookup): inactive PEs probe nothing but still
        # fetch their whole remote set (hits == 0 there).
        lengths = np.where(active, n_remote, 0)
        miss = n_remote - hits
        dev.stats.lookups += lengths
        dev.stats.hits += hits
        dev.stats.misses += lengths - hits
        # Replacement bookkeeping (replace_round).
        rounds = do_rep & (n_place > 0)
        dev.stats.skipped_rounds += do_rep & (n_place == 0)
        dev.stats.replaced_total += np.where(rounds, n_place, 0)
        dev.stats.replacement_rounds += rounds
        replaced = np.where(rounds, n_place, 0)
        total_comm = miss + replaced
        step_time = time_engine.step(StepComm(miss, replaced), stalls)
        pct_hits = np.where(
            active,
            np.where(n_remote > 0, 100.0 * hits / np.maximum(n_remote, 1), 100.0),
            0.0,
        )
        occupancy = dev.occupancy_of(n_valid)
        for p in range(P):
            logs[p].pct_hits.append(float(pct_hits[p]))
            logs[p].comm_volume.append(int(total_comm[p]))
            logs[p].comm_missed.append(int(miss[p]))
            logs[p].occupancy.append(float(occupancy[p]))
            logs[p].unique_remote.append(int(n_remote[p]))
            logs[p].replaced.append(int(replaced[p]))
            logs[p].decisions.append(bool(decisions[p]))
            logs[p].step_time.append(float(step_time[p]))
        epoch_times[epoch] += float(step_time.max())

    def flush() -> None:
        nonlocal pending, done
        if pending:
            with tel.span("device.readback", plane="device"):
                block = torch.stack(pending).cpu().numpy()
            dev._transfer("engine.counts", "d2h", block.nbytes)
            counters.extend(block)
            pending = []
        while done < len(meta) and done + 1 < len(counters):
            account(done)
            done += 1

    minibatches, touched = sample.run_raw(0, 0, trainer.rng)
    pending.append(
        dev.fused_step_raw(
            touched, fused._no_decision, fused._no_decision, active, want="counts"
        )
    )

    for step in range(total):
        _step_sp = tel.begin("step", plane="runtime", step=step)
        epoch, mb = divmod(step, trainer.mb_per_epoch)
        # The eligible controllers never read the metric values, so zeros
        # keep the decision stream that of the K=1 loop while the real
        # counters wait on the device for the next flush.
        decide.submit(
            [
                Metrics(
                    minibatch=mb,
                    total_minibatches=trainer.mb_per_epoch,
                    epoch=epoch,
                    total_epochs=trainer.epochs,
                    pct_hits=0.0,
                    comm_volume=0,
                    replaced_pct=0.0,
                    buffer_occupancy=0.0,
                    buffer_capacity=int(trainer.engine.capacity[p]),
                )
                for p in range(P)
            ]
        )
        decisions, stalls = decide.collect()

        if step + 1 < total:
            e2, m2 = divmod(step + 1, trainer.mb_per_epoch)
            nxt_mb, nxt_touched = sample.run_raw(e2, m2, trainer.rng)
        else:
            nxt_mb = None
            nxt_touched = np.full((P, 0), -1, dtype=np.int32)
        pending.append(
            dev.fused_step_raw(
                nxt_touched, uses_buffer, decisions & uses_buffer, active,
                want="counts",
            )
        )
        meta.append((epoch, decisions, stalls))
        if len(pending) >= K:
            flush()

        if trainer.train_model:
            _train_sp = tel.begin("train", plane="train")
            losses.append(train_step(trainer, minibatches))
            tel.end(_train_sp)

        minibatches = nxt_mb
        tel.end(_step_sp)

    flush()

    accuracy = accuracy_pass(trainer)

    _sync_sp = tel.begin("call.sync", plane="runtime")
    dev.sync_to_engine()
    tel.end(_sync_sp)
    return RunResult(
        variant=trainer.variant,
        epoch_times=epoch_times,
        losses=losses,
        accuracy=accuracy,
        logs=logs,
        controllers=trainer.controllers,
        graph_meta=trainer.graph_meta,
        sim_events=time_engine.events,
        trace=None,
    )


def run_device(trainer) -> "RunResult":  # noqa: F821 — see lazy import
    """Execute ``trainer``'s experiment on its device (see the module
    note). At the end of the run the device state is written back to
    ``trainer.engine`` for introspection; the kernel engine stays on
    ``trainer.last_device_engine`` and a recorded trace on
    ``trainer.last_trace``."""
    from ..gnn.train import RunResult, TrainerLog
    from ..kernels import ops
    from .engine import DeviceEngine

    max_id = trainer.graph.id_base + trainer.graph.num_nodes - 1
    if not ops.wide_id_eligible(max_id):
        # Past the wide-id bound only the staged pipeline serves the run.
        return run_vectorized(trainer)
    P = trainer.parts.num_parts
    # The device loops dedup inside their launch (raw) or on the host
    # (ragged), never through the staged fall-back's kernel hook: a ragged
    # run's step whose seed blocks happen to be of one length would reach
    # it in the plane's fused pass.
    plane = trainer.sampler_plane
    if plane.use_kernels:
        plane = SamplerPlane(plane.graph, plane.fanouts)
    sample = SampleStage(plane, P, trainer._seed_batch, trainer.parts.part_of)
    decide = DecisionStage(trainer.controllers)
    time_engine = trainer.make_time_engine()
    _engine_sp = tel.begin("call.engine", plane="runtime")
    dev = DeviceEngine(
        trainer.engine, device=trainer.device, part_of=trainer.parts.part_of
    )
    store = trainer.feature_store
    if store is not None:
        dev.attach_store(store)
    tel.end(_engine_sp)
    trainer.last_device_engine = dev
    fused = FusedFetchStage(
        dev,
        decide.uses_buffer,
        decide.inference_cost,
        time_engine,
        trainer.graph.features.shape[1],
        trainer.mode,
        part_of=trainer.parts.part_of,
        store=store,
        feature_bytes=trainer.tm.feature_bytes,
    )
    use_raw = _device_raw_supported(trainer)
    if trainer.readback_every > 1:
        _check_cadence_eligible(trainer, time_engine, use_raw)
        return _run_device_cadence(
            trainer, sample, decide, time_engine, dev, fused, trainer.readback_every
        )

    logs = [TrainerLog() for _ in range(P)]
    epoch_times = [0.0] * trainer.epochs
    losses: list[float] = []
    recorder = trainer.make_trace_recorder()
    total = trainer.epochs * trainer.mb_per_epoch

    if use_raw:
        minibatches, touched = sample.run_raw(0, 0, trainer.rng)
        probe = fused.prime_raw(touched)
    else:
        minibatches, remote, n_remote = sample.run(0, 0, trainer.rng)
        probe = fused.prime(remote, n_remote)

    for step in range(total):
        _step_sp = tel.begin("step", plane="runtime", step=step)
        epoch, mb = divmod(step, trainer.mb_per_epoch)
        decide.submit(
            [
                Metrics(
                    minibatch=mb,
                    total_minibatches=trainer.mb_per_epoch,
                    epoch=epoch,
                    total_epochs=trainer.epochs,
                    pct_hits=float(probe.pct_hits[p]),
                    comm_volume=int(probe.comm[p]),
                    replaced_pct=float(probe.replaced_pct[p]),
                    buffer_occupancy=float(probe.occupancy[p]),
                    buffer_capacity=int(trainer.engine.capacity[p]),
                )
                for p in range(P)
            ]
        )
        decisions, stalls = decide.collect()

        # Double buffer: this step's miss gather overlaps the next draw.
        if store is not None:
            _gather_sp = tel.begin("fetch.gather", plane="store")
            fused.begin_gather()
            tel.end(_gather_sp)
        nxt_mb = None
        last = step + 1 == total
        if not last:
            e2, m2 = divmod(step + 1, trainer.mb_per_epoch)
        if use_raw:
            if last:
                nxt_touched = np.full((P, 0), -1, dtype=np.int32)
            else:
                nxt_mb, nxt_touched = sample.run_raw(e2, m2, trainer.rng)
            commit, next_probe = fused.step_raw(decisions, stalls, nxt_touched)
        else:
            if last:
                nxt_remote = [np.array([], dtype=np.int64) for _ in range(P)]
                nxt_n_remote = np.zeros(P, dtype=np.int64)
            else:
                nxt_mb, nxt_remote, nxt_n_remote = sample.run(e2, m2, trainer.rng)
            commit, next_probe = fused.step(
                decisions, stalls, nxt_remote, nxt_n_remote
            )

        for p in range(P):
            logs[p].pct_hits.append(float(probe.pct_hits[p]))
            logs[p].comm_volume.append(int(commit.total_comm[p]))
            logs[p].comm_missed.append(int(probe.comm[p]))
            logs[p].occupancy.append(float(commit.occupancy[p]))
            logs[p].unique_remote.append(int(probe.n_remote[p]))
            logs[p].replaced.append(int(commit.replaced[p]))
            logs[p].decisions.append(bool(decisions[p]))
            logs[p].step_time.append(float(commit.step_time[p]))
            if store is not None:
                logs[p].bytes_measured.append(int(commit.bytes_measured[p]))
                logs[p].bytes_modeled.append(int(commit.bytes_modeled[p]))
                logs[p].fetch_seconds.append(float(commit.fetch_seconds))
                logs[p].feat_sums.append(float(commit.feat_sums[p]))
        epoch_times[epoch] += float(commit.step_time.max())

        if recorder is not None:
            store_kwargs: dict = {}
            if store is not None:
                store_kwargs = dict(
                    feat_sums=commit.feat_sums,
                    bytes_measured=commit.bytes_measured,
                    bytes_modeled=commit.bytes_modeled,
                    fetch_time_measured=np.full(
                        P, commit.fetch_seconds, dtype=np.float64
                    ),
                )
            recorder.record_step(
                seeds=[m.seeds for m in minibatches],
                remote=probe.remote,
                missed=commit.missed,
                placed=commit.placed,
                decisions=decisions,
                stalls=stalls,
                pct_hits=probe.pct_hits,
                hits=probe.hits,
                n_remote=probe.n_remote,
                replaced=commit.replaced,
                total_comm=commit.total_comm,
                occupancy_pre=probe.occupancy,
                occupancy_post=commit.occupancy,
                step_times=commit.step_time,
                controllers=trainer.controllers,
                **store_kwargs,
            )

        if trainer.train_model:
            _train_sp = tel.begin("train", plane="train")
            losses.append(train_step(trainer, minibatches))
            tel.end(_train_sp)

        minibatches = nxt_mb
        probe = next_probe
        tel.end(_step_sp)

    accuracy = accuracy_pass(trainer)

    _sync_sp = tel.begin("call.sync", plane="runtime")
    dev.sync_to_engine()
    tel.end(_sync_sp)
    trace = None
    if recorder is not None:
        trace = recorder.finalize(epoch_times, time_engine.events)
        trainer.last_trace = trace
    return RunResult(
        variant=trainer.variant,
        epoch_times=epoch_times,
        losses=losses,
        accuracy=accuracy,
        logs=logs,
        controllers=trainer.controllers,
        graph_meta=trainer.graph_meta,
        sim_events=time_engine.events,
        trace=trace,
    )
