"""The device-resident minibatch loop of
:meth:`repro_torch.gnn.train.DistributedTrainer.run`.

Port of the reference's ``run_device`` single-launch raw path. Per step
the whole cluster goes through the stages of
:mod:`repro_torch.runtime.stage`, pipeline-rotated so the host decision
plane runs between probes::

    sample(0) ── prime launch [probe(0)]
    step t:   decide(t) → sample(t+1)
              → launch [score(t), replace(t), probe(t+1)]
              → accounting / train for step t

Buffer state lives on the trainer's device
(:class:`repro_torch.runtime.engine.DeviceEngine`); each step uploads the
raw ``(P, Mt)`` frontier once, makes one kernel launch and reads one
packed block back. The RNG draws, controller calls and in-kernel round
order are those of the reference, so every exact stream (hits, misses,
bytes, decisions, modeled step times) is bit-identical to it. The
GraphSAGE step is data-parallel: per-PE gradients are summed, averaged
over PEs and applied with SGD.

Not ported yet, and refused with ``NotImplementedError``: ragged per-PE
seed blocks (the reference's staged-gather loop over ``fused_step``) and
the ``readback_every > 1`` counter cadence.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as tel
from ..core.metrics import Metrics
from .stage import DecisionStage, FusedFetchStage, SampleStage


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
    per-PE loss and gradients, gradients summed in PE order and averaged,
    one SGD update of ``trainer.model``. Returns the mean loss."""
    model = trainer.model
    P = len(minibatches)
    grads_acc = None
    loss_acc = 0.0
    for mb in minibatches:
        x_seed, x_n1, x_n2, labels = trainer._features_of(mb)
        loss, grads = model.loss_and_grads(x_seed, x_n1, x_n2, labels)
        loss_acc += float(loss) / P
        grads_acc = (
            grads if grads_acc is None else [a + b for a, b in zip(grads_acc, grads)]
        )
    with torch.no_grad():
        for prm, g in zip(model.parameters(), grads_acc):
            prm.sub_(trainer.lr * (g / P))
    return loss_acc


def run_device(trainer) -> "RunResult":  # noqa: F821 — see lazy import
    """Execute ``trainer``'s experiment on its device (see the module
    note). At the end of the run the device state is written back to
    ``trainer.engine`` for introspection; the kernel engine stays on
    ``trainer.last_device_engine``."""
    from ..gnn.train import RunResult, TrainerLog
    from .engine import DeviceEngine

    if trainer.readback_every > 1:
        raise NotImplementedError(
            "readback_every > 1 (the K-step counter cadence) is not ported "
            "yet (ROADMAP Queue A, readback cadence)"
        )
    if not _device_raw_supported(trainer):
        raise NotImplementedError(
            "ragged per-PE seed blocks need the staged-gather device loop over "
            "fused_step_pallas, which is not ported yet (ROADMAP Queue B #2)"
        )
    P = trainer.parts.num_parts
    sample = SampleStage(trainer.sampler_plane, P, trainer._seed_batch)
    decide = DecisionStage(trainer.controllers)
    time_engine = trainer.make_time_engine()
    dev = DeviceEngine(
        trainer.engine, device=trainer.device, part_of=trainer.parts.part_of
    )
    trainer.last_device_engine = dev
    fused = FusedFetchStage(
        dev,
        decide.uses_buffer,
        decide.inference_cost,
        time_engine,
        trainer.graph.features.shape[1],
        trainer.mode,
        part_of=trainer.parts.part_of,
        feature_bytes=trainer.tm.feature_bytes,
    )

    logs = [TrainerLog() for _ in range(P)]
    epoch_times = [0.0] * trainer.epochs
    losses: list[float] = []
    total = trainer.epochs * trainer.mb_per_epoch

    minibatches, touched = sample.run_raw(0, 0, trainer.rng)
    probe = fused.prime_raw(touched)

    for step in range(total):
        _step_sp = tel.begin("step", plane="runtime")
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

        nxt_mb = None
        if step + 1 < total:
            e2, m2 = divmod(step + 1, trainer.mb_per_epoch)
            nxt_mb, nxt_touched = sample.run_raw(e2, m2, trainer.rng)
        else:
            nxt_touched = np.full((P, 0), -1, dtype=np.int32)
        commit, next_probe = fused.step_raw(decisions, stalls, nxt_touched)

        for p in range(P):
            logs[p].pct_hits.append(float(probe.pct_hits[p]))
            logs[p].comm_volume.append(int(commit.total_comm[p]))
            logs[p].comm_missed.append(int(probe.comm[p]))
            logs[p].occupancy.append(float(commit.occupancy[p]))
            logs[p].unique_remote.append(int(probe.n_remote[p]))
            logs[p].replaced.append(int(commit.replaced[p]))
            logs[p].decisions.append(bool(decisions[p]))
            logs[p].step_time.append(float(commit.step_time[p]))
        epoch_times[epoch] += float(commit.step_time.max())

        if trainer.train_model:
            _train_sp = tel.begin("train", plane="train")
            losses.append(train_step(trainer, minibatches))
            tel.end(_train_sp)

        minibatches = nxt_mb
        probe = next_probe
        tel.end(_step_sp)

    accuracy = 0.0
    if trainer.train_model:
        batch = trainer.graph.train_nodes[
            : min(512, len(trainer.graph.train_nodes))
        ]
        minibatch = trainer.sampler.sample(batch, trainer.rng)
        accuracy = trainer.model.accuracy(*trainer._features_of(minibatch))

    dev.sync_to_engine()
    return RunResult(
        variant=trainer.variant,
        epoch_times=epoch_times,
        losses=losses,
        accuracy=accuracy,
        logs=logs,
        controllers=trainer.controllers,
        graph_meta=trainer.graph_meta,
        sim_events=time_engine.events,
    )
