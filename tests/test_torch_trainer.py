"""The port's whole slice against the reference trainer, on the CPU.

``repro.gnn.DistributedTrainer(device="jnp")`` and
``repro_torch.gnn.DistributedTrainer(device="cpu")`` run the same
experiment (the ``products`` preset at ``scale=0.15``, 4 trainers, batch 16,
2 epochs, GraphSAGE training on) for every variant: sampling, decisions,
the single-launch device step, the time engine and the data-parallel SGD
step. The graph arrays the two packages generate are equal; every log
stream, ``engine.stats`` and the final buffer state are bit-identical; the
losses agree per step to ``rtol=1e-5, atol=1e-6`` (float32 sums in another
order, compounded over the SGD steps) and the accuracies exactly.
"""

import jax
import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
import repro_torch.gnn as tgnn
import repro_torch.graph as tgraph

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


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(trace=True), "trace"),
        (dict(feature_store=True), "feature store"),
        (dict(telemetry=True), "telemetry"),
        (dict(runtime="legacy"), "legacy"),
        (dict(device=False), "staged"),
    ],
)
def test_unported_options_raise(parts, kwargs, match):
    _, port = parts
    kw = dict(COMMON, variant="fixed", device="cpu")
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=match):
        tgnn.DistributedTrainer(port, **kw)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(readback_every=2), "readback_every"),
        (dict(batch_size=1000), "ragged"),
    ],
)
def test_unported_run_paths_raise(parts, kwargs, match):
    _, port = parts
    kw = dict(COMMON, variant="fixed", device="cpu", train_model=False)
    kw.update(kwargs)
    tr = tgnn.DistributedTrainer(port, **kw)
    with pytest.raises(NotImplementedError, match=match):
        tr.run()


def test_sampler_kernels_not_ported(parts):
    _, port = parts
    with pytest.raises(NotImplementedError, match="frontier_unique_batch"):
        tgraph.SamplerPlane(port.graph, (10, 25), use_kernels=True)
