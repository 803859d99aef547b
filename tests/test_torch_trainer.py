"""The port's whole slice against the reference trainer, on the CPU.

``repro.gnn.DistributedTrainer(device="jnp")`` and
``repro_torch.gnn.DistributedTrainer(device="cpu")`` run the same
experiment (the ``products`` preset at ``scale=0.15``, 4 trainers, batch 16,
2 epochs, GraphSAGE training on) for every variant: sampling, decisions,
the single-launch device step, the time engine and the data-parallel SGD
step. Then the ragged-seed-block loop (batch 72 and 1000: the PEs' local
train sets of 73, 70, 74 and 71 nodes give blocks of unequal length) and
feature-store runs on both loops. The graph arrays the two packages
generate are equal; every log stream (the store's ``bytes_measured``,
``bytes_modeled`` and ``feat_sums`` included), ``engine.stats`` and the
final buffer state and payload are bit-identical; the losses agree per
step to ``rtol=1e-5, atol=1e-6`` (float32 sums in another order,
compounded over the SGD steps) and the accuracies exactly.
"""

import jax
import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
import repro_torch.gnn as tgnn
import repro_torch.graph as tgraph
from repro.store import FeatureStore as JStore
from repro_torch.runtime import driver
from repro_torch.store import FeatureStore

RTOL, ATOL = 1e-5, 1e-6
COMMON = dict(epochs=2, batch_size=16, train_model=True, buffer_frac=0.25)
STREAMS = (
    "pct_hits", "comm_volume", "comm_missed", "occupancy", "unique_remote",
    "replaced", "decisions", "step_time",
)
STATS = (
    "lookups", "hits", "misses", "replaced_total", "replacement_rounds",
    "skipped_rounds",
)
STORE_STREAMS = ("bytes_measured", "bytes_modeled", "feat_sums")


@pytest.fixture(scope="module")
def parts():
    ref = jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.15), 4)
    port = tgraph.partition_graph(tgraph.generate("products", seed=0, scale=0.15), 4)
    return ref, port


def test_generated_graph_and_partition_match(parts):
    ref, port = parts
    for f in ("indptr", "indices", "features", "labels", "train_nodes", "communities"):
        a, b = getattr(port.graph, f), getattr(ref.graph, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.graph.num_classes == ref.graph.num_classes
    np.testing.assert_array_equal(port.part_of, ref.part_of)
    assert port.edge_cut == ref.edge_cut
    for a, b in zip(port.local_nodes, ref.local_nodes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "variant,mode",
    [
        ("distdgl", "async"),
        ("fixed", "async"),
        ("massivegnn", "async"),
        ("rudder", "async"),
        ("rudder", "sync"),
    ],
)
def test_run_matches_reference(parts, variant, mode):
    ref_parts, port_parts = parts
    kw = dict(COMMON, mode=mode)
    if variant == "rudder":
        kw["deciders"] = ["gemma3-4b"]
    ref_tr = jgnn.DistributedTrainer(ref_parts, variant=variant, device="jnp", **kw)
    init = jax.tree_util.tree_map(np.asarray, ref_tr.params)
    port_tr = tgnn.DistributedTrainer(
        port_parts, variant=variant, device="cpu", init_params=init, **kw
    )
    ref_run, port_run = ref_tr.run(), port_tr.run()

    assert len(port_run.logs) == 4
    for p, (a, b) in enumerate(zip(port_run.logs, ref_run.logs)):
        for f in STREAMS:
            assert getattr(a, f) == getattr(b, f), f"PE {p} {f}"
    assert port_run.epoch_times == ref_run.epoch_times
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_tr.engine.stats, f), getattr(ref_tr.engine.stats, f), err_msg=f
        )
    for f in ("ids", "scores", "valid", "accessed", "weights"):
        np.testing.assert_array_equal(
            getattr(port_tr.engine, f), getattr(ref_tr.engine, f), err_msg=f
        )
    steps = COMMON["epochs"] * port_tr.mb_per_epoch
    transfers = port_tr.last_device_engine.transfers
    assert transfers["h2d"] == transfers["d2h"] == steps + 1
    assert len(port_run.losses) == len(ref_run.losses) == steps
    np.testing.assert_allclose(port_run.losses, ref_run.losses, rtol=RTOL, atol=ATOL)
    assert port_run.accuracy == pytest.approx(ref_run.accuracy, abs=1e-7)


def test_features_live_on_the_device(parts):
    _, port = parts
    tr = tgnn.DistributedTrainer(port, variant="fixed", device="cpu", **COMMON)
    assert isinstance(tr.features, torch.Tensor)
    assert tr.features.shape == port.graph.features.shape
    assert tr.features.device == tr.device == torch.device("cpu")


def test_torch_init_without_reference_params(parts):
    _, port = parts
    kw = dict(COMMON, epochs=1)
    a = tgnn.DistributedTrainer(port, variant="fixed", device="cpu", seed=4, **kw).run()
    b = tgnn.DistributedTrainer(port, variant="fixed", device="cpu", seed=4, **kw).run()
    assert a.losses == b.losses and np.isfinite(a.losses).all()


def _compare(parts, variant, store=None, port_store=None, **kw):
    """Run both trainers; assert every stream, stat and state is equal."""
    ref_parts, port_parts = parts
    kw = dict(COMMON, **kw)
    if variant == "rudder":
        kw["deciders"] = ["gemma3-4b"]
    ref_tr = jgnn.DistributedTrainer(
        ref_parts, variant=variant, device="jnp", feature_store=store, **kw
    )
    init = jax.tree_util.tree_map(np.asarray, ref_tr.params) if kw["train_model"] else None
    port_tr = tgnn.DistributedTrainer(
        port_parts, variant=variant, device="cpu", init_params=init,
        feature_store=port_store, **kw,
    )
    ref_run, port_run = ref_tr.run(), port_tr.run()
    streams = STREAMS + (STORE_STREAMS if store is not None else ())
    for p, (a, b) in enumerate(zip(port_run.logs, ref_run.logs)):
        for f in streams:
            assert getattr(a, f) == getattr(b, f), f"PE {p} {f}"
    assert port_run.epoch_times == ref_run.epoch_times
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_tr.engine.stats, f), getattr(ref_tr.engine.stats, f), err_msg=f
        )
    state = ("ids", "scores", "valid", "accessed", "weights")
    for f in state + (("payload",) if store is not None else ()):
        np.testing.assert_array_equal(
            getattr(port_tr.engine, f), getattr(ref_tr.engine, f), err_msg=f
        )
    np.testing.assert_allclose(port_run.losses, ref_run.losses, rtol=RTOL, atol=ATOL)
    assert port_run.accuracy == pytest.approx(ref_run.accuracy, abs=1e-7)
    return port_tr, port_run


@pytest.mark.parametrize(
    "variant,batch,train",
    [("rudder", 72, True), ("fixed", 72, False), ("massivegnn", 1000, True)],
)
def test_ragged_seed_blocks_match_reference(parts, variant, batch, train):
    _, port = parts
    tr, run = _compare(parts, variant, batch_size=batch, train_model=train)
    assert not driver._device_raw_supported(tr)
    steps = COMMON["epochs"] * tr.mb_per_epoch
    assert len(run.logs[0].pct_hits) == steps
    # One packed upload and one packed readback per fused_step launch
    # (prime + one per step); the reference makes five uploads per launch.
    assert tr.last_device_engine.transfers["h2d"] == steps + 1
    assert tr.last_device_engine.transfers["d2h"] == steps + 1


@pytest.mark.parametrize(
    "variant,batch,use_kernel",
    [("massivegnn", 16, True), ("rudder", 16, False), ("fixed", 72, True),
     ("massivegnn", 72, False)],
)
def test_feature_store_runs_match_reference(parts, variant, batch, use_kernel):
    """Store-enabled runs on the raw loop (batch 16: the in-launch payload
    scatter) and the ragged loop (batch 72: ``place_rows_batch``). The
    reference's store gathers on the host; the port's goes through its
    ``gather_rows_batch`` route where ``use_kernel`` is set (the training
    rows through ``gather_rows`` on the flat table) — the rows are the
    same either way."""
    ref_parts, port_parts = parts
    store = JStore.for_partitions(ref_parts, backend="numpy")
    port_store = FeatureStore.for_partitions(port_parts, device="cpu", use_kernel=use_kernel)
    tr, run = _compare(
        parts, variant, store=store, port_store=port_store, batch_size=batch
    )
    assert driver._device_raw_supported(tr) == (batch == 16)
    assert run.total_bytes_measured == run.total_bytes_modeled > 0
    assert all(np.isfinite(log.fetch_seconds).all() for log in run.logs)
    assert (port_store.kernel_gathers > 0) == use_kernel
    # The training rows take the flat route: one gather a PE and step, and
    # one for the accuracy pass.
    steps = len(run.losses)
    assert port_store.flat_gathers == (4 * steps + 1 if use_kernel else 0)


def test_feature_store_true_builds_a_store_on_the_trainer_device(parts):
    _, port = parts
    tr = tgnn.DistributedTrainer(
        port, variant="fixed", device="cpu", feature_store=True, **COMMON
    )
    assert isinstance(tr.feature_store, FeatureStore)
    assert tr.feature_store.device == tr.device
    assert tr.engine.payload.shape[2] == port.graph.features.shape[1]
    assert tr.features is None  # the training step reads through the store


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(runtime="eager"), "legacy"),
    ],
)
def test_unported_options_raise(parts, kwargs, match):
    """Every option of the reference is ported; an unknown runtime raises
    ``ValueError`` naming the two there are, as the reference's does."""
    _, port = parts
    kw = dict(COMMON, variant="fixed", device="cpu")
    kw.update(kwargs)
    with pytest.raises(ValueError, match=match):
        tgnn.DistributedTrainer(port, **kw)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(readback_every=2), "readback_every"),
    ],
)
def test_unported_run_paths_raise(parts, kwargs, match):
    """Once refused, now run: ``readback_every=2`` (the K-step counter
    cadence) reproduces the K = 1 run and the reference's cadence run,
    with one counter readback per two launches."""
    ref, port = parts
    kw = dict(COMMON, variant="fixed", train_model=False)
    k1 = tgnn.DistributedTrainer(port, device="cpu", **kw)
    tr = tgnn.DistributedTrainer(port, device="cpu", **kw, **kwargs)
    ref_run = jgnn.DistributedTrainer(ref, device="jnp", **kw, **kwargs).run()
    run, run1 = tr.run(), k1.run()
    assert tr.readback_every == kwargs[match] == 2
    for p, (a, b, c) in enumerate(zip(run.logs, run1.logs, ref_run.logs)):
        for f in STREAMS:
            assert getattr(a, f) == getattr(b, f) == getattr(c, f), f"PE {p} {f}"
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(tr.engine.stats, f), getattr(k1.engine.stats, f), err_msg=f
        )
    launches = COMMON["epochs"] * tr.mb_per_epoch + 1
    assert tr.last_device_engine.transfers["d2h"] == -(-launches // 2)


FETCH_LOGS = [
    # (PE 0, PE 1, PE 2) fetch_seconds per step
    ([0.5, 0.25, 1.0], [0.75, 0.125, 0.5], [0.25, 2.0, 0.0]),
    ([0.0, 0.0], [0.0, 0.0]),
    ([3.0], [1.5], [4.5], [0.5]),
]


def _run_result(pkg, fetch):
    logs = [pkg.TrainerLog(fetch_seconds=list(f)) for f in fetch]
    return pkg.RunResult(
        variant="fixed", epoch_times=[], losses=[], accuracy=0.0, logs=logs,
        controllers=[], graph_meta=[],
    )


@pytest.mark.parametrize("fetch", FETCH_LOGS, ids=["3pe", "zeros", "4pe-1step"])
def test_total_fetch_seconds_matches_the_reference(fetch):
    """Per step, the slowest PE's gather time; summed over the steps."""
    from repro.gnn import train as jtrain
    from repro_torch.gnn import train as ttrain

    port = _run_result(ttrain, fetch).total_fetch_seconds
    want = float(sum(max(step) for step in zip(*fetch)))
    assert port == want == _run_result(jtrain, fetch).total_fetch_seconds


def test_total_fetch_seconds_is_nan_without_steps():
    from repro.gnn import train as jtrain
    from repro_torch.gnn import train as ttrain

    for fetch in ((), ([], [])):
        assert np.isnan(_run_result(ttrain, fetch).total_fetch_seconds)
        assert np.isnan(_run_result(jtrain, fetch).total_fetch_seconds)
