"""The K-step readback cadence (``readback_every=K > 1``) of the port.

On the raw loop the cadence reads back only each launch's ``(P, 4)``
counters, K launches per pull, and rebuilds the logs and statistics from
them. Checked here, on the CPU, against the port's own ``K = 1`` run and
the reference's cadence run (``device="jnp"``), narrow and on a graph
rebased past ``2**31`` (wide mode): every log stream, ``engine.stats`` and
the buffer state are bit-identical, and the run pulls ``ceil(launches /
K)`` blocks. ``DeviceEngine.fused_step_raw(want="counts")`` is held to the
reference's counters launch by launch. Every configuration the
reference's ``_check_cadence_eligible`` refuses raises its ``ValueError``,
word for word. Tolerance: none (no GNN step runs, so there are no
losses).
"""

import math

import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.runtime import engine as jeng
from repro_torch.gnn import DistributedTrainer
from repro_torch.graph import generate, partition_graph
from repro_torch.kernels import scenarios
from repro_torch.runtime import engine as teng

BASE = scenarios.BASE
K = 4
TRAIN_COMMON = dict(
    epochs=1, batch_size=16, fanouts=(3, 5), train_model=False,
    buffer_frac=0.25, interval=4,
)
STATE = ("ids", "scores", "valid", "accessed")
STATS = ("lookups", "hits", "misses", "replaced_total", "replacement_rounds",
         "skipped_rounds")


@pytest.fixture(scope="module")
def graphs():
    return (
        jgraph.generate("products", seed=0, scale=0.05),
        generate("products", seed=0, scale=0.05),
    )


def _digest(result):
    return [
        (log.pct_hits, log.comm_volume, log.comm_missed, log.occupancy,
         log.unique_remote, log.replaced, log.decisions, log.step_time)
        for log in result.logs
    ]


@pytest.mark.parametrize("variant", ["distdgl", "fixed", "massivegnn"])
@pytest.mark.parametrize("base", [0, BASE], ids=["narrow", "wide"])
def test_cadence_reproduces_k1_and_the_reference(graphs, variant, base):
    jg, tg = graphs
    if base:
        jg, tg = jg.rebase(base), tg.rebase(base)
    jparts, tparts = jgraph.partition_graph(jg, 2), partition_graph(tg, 2)
    kw = dict(TRAIN_COMMON, variant=variant)
    t1 = DistributedTrainer(tparts, device="cpu", **kw)
    r1 = t1.run()
    tk = DistributedTrainer(tparts, device="cpu", readback_every=K, **kw)
    rk = tk.run()
    rj = jgnn.DistributedTrainer(jparts, device="jnp", readback_every=K, **kw).run()
    assert _digest(rk) == _digest(r1) == _digest(rj)
    assert rk.epoch_times == r1.epoch_times == rj.epoch_times
    for f in STATE:
        np.testing.assert_array_equal(getattr(tk.engine, f), getattr(t1.engine, f), err_msg=f)
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(tk.engine.stats, f), getattr(t1.engine.stats, f), err_msg=f
        )
    dev = tk.last_device_engine
    assert dev.wide == bool(base)
    launches = tk.epochs * tk.mb_per_epoch + 1
    assert launches > K
    assert dev.transfers["h2d"] == launches
    assert dev.transfers["d2h"] == math.ceil(launches / K)
    assert dev.transfers["d2h_bytes"] == launches * 2 * 4 * 4  # (P, 4) int32 each
    assert t1.last_device_engine.transfers["d2h"] == launches


def test_counts_mode_matches_reference_counters():
    """``want="counts"`` hands back the launch's ``(P, 4)`` int32
    counters as a device tensor, reads nothing back, keeps no host
    bookkeeping, and rotates the candidates as the full mode does: a
    counts launch followed by full launches gives the reference's
    streams."""
    P, n_nodes = 3, 150
    rng = np.random.default_rng(5)
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    caps = [6, 0, 9]
    for base in (0, BASE):
        ref_dev = jeng.DeviceEngine(
            jeng.PrefetchEngine(caps, id_base=base), backend="jnp", part_of=part_of
        )
        port_dev = teng.DeviceEngine(
            teng.PrefetchEngine(caps, id_base=base), device="cpu", part_of=part_of
        )
        on = np.ones(P, dtype=bool)
        for t in range(6):
            f = rng.integers(-1, n_nodes, size=(P, 30)).astype(np.int64)
            f[f >= 0] += base
            args = (f, on if t else ~on, on if t else ~on, on)
            want_mode = "counts" if t in (1, 2, 4) else "full"
            want = ref_dev.fused_step_raw(*args, want=want_mode)
            got = port_dev.fused_step_raw(*args, want=want_mode)
            if want_mode == "counts":
                assert isinstance(got, torch.Tensor)
                assert got.dtype == torch.int32 and tuple(got.shape) == (P, 4)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                for fld in ("missed", "remote", "hit_masks", "replaced", "n_valid"):
                    x, y = getattr(got, fld), getattr(want, fld)
                    for u, v in zip(x if isinstance(x, list) else [x],
                                    y if isinstance(y, list) else [y]):
                        np.testing.assert_array_equal(u, v, err_msg=f"{base} {t} {fld}")
        assert port_dev.transfers["d2h"] == 3  # the full launches only
        assert port_dev.transfers["h2d"] == 6
        for f in STATE:
            np.testing.assert_array_equal(
                getattr(port_dev.sync_to_engine(), f), getattr(ref_dev.sync_to_engine(), f)
            )


def _both_raise(jparts, tparts, kw_ref, kw_port):
    with pytest.raises(ValueError) as want:
        jgnn.DistributedTrainer(jparts, device="jnp", readback_every=2, **kw_ref).run()
    with pytest.raises(ValueError) as got:
        DistributedTrainer(tparts, device="cpu", readback_every=2, **kw_port).run()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("readback_every=2 is incompatible with this run")
    return str(got.value)


@pytest.mark.parametrize(
    "case,match",
    [
        ("ragged", "ragged per-PE seed blocks"),
        ("trace", "trace recording needs per-step id streams"),
        ("store", "the feature store moves per-step rows"),
        ("topology", "per-home comm pricing needs per-step id sets"),
        ("adaptive", "read per-step metrics"),
    ],
)
def test_ineligible_configurations_raise_the_reference_error(graphs, case, match):
    from repro.store import FeatureStore as JStore
    from repro_torch.store import FeatureStore

    jg, tg = graphs
    jparts, tparts = jgraph.partition_graph(jg, 2), partition_graph(tg, 2)
    kw = dict(TRAIN_COMMON, variant="fixed")
    kw_ref, kw_port = dict(kw), dict(kw)
    if case == "ragged":
        kw_ref["batch_size"] = kw_port["batch_size"] = 48  # local sets of 44 and 52
    elif case == "trace":
        kw_ref["trace"] = kw_port["trace"] = True
    elif case == "store":
        kw_ref["feature_store"] = JStore.for_partitions(jparts, backend="numpy")
        kw_port["feature_store"] = FeatureStore.for_partitions(tparts, device="cpu")
    elif case == "topology":
        kw_ref["topology"] = kw_port["topology"] = "rack"
    else:
        for d in (kw_ref, kw_port):
            d.update(variant="rudder", deciders=["gemma3-4b"])
    assert match in _both_raise(jparts, tparts, kw_ref, kw_port)


def test_counts_launch_reads_nothing_back(monkeypatch):
    """Nothing in a counts launch reads a device tensor on the host: with
    ``Tensor.cpu``, ``.numpy``, ``.item`` and ``.tolist`` made to raise,
    the counts launches still run (the full launch would not)."""
    P, n_nodes = 2, 50
    rng = np.random.default_rng(9)
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([5, 5], id_base=BASE), device="cpu", part_of=part_of
    )
    on = np.ones(P, dtype=bool)
    frontiers = [rng.integers(0, n_nodes, size=(P, 12)).astype(np.int64) + BASE
                 for _ in range(3)]

    def refuse(*a, **k):
        raise AssertionError("a device tensor was read on the host")

    with monkeypatch.context() as m:
        for name in ("cpu", "numpy", "item", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        outs = [dev.fused_step_raw(f, on, on, on, want="counts") for f in frontiers]
        with pytest.raises(AssertionError, match="read on the host"):
            dev.fused_step_raw(frontiers[0], on, on, on)
    assert dev.transfers["d2h"] == 0
    assert torch.stack(outs).shape == (3, P, 4)
