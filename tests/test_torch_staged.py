"""The port's staged pipeline against the reference package, on the CPU.

The staged loop (``repro_torch.runtime.driver.run_vectorized`` over
``SampleStage`` → ``FetchStage.probe`` → ``DecisionStage`` →
``FetchStage.commit`` on the numpy ``PrefetchEngine``) is the reference
trainer's default (``device=False``) and the fall-back of a device run
whose ids pass ``WIDE_ID_MAX``. Checked here:

* ``PrefetchEngine(use_kernels=True, device="cpu")`` (the scoring round
  through ``ops.score_policy_update_batch``) against ``use_kernels=False``
  and the reference's ``PrefetchEngine(use_kernels=True)`` (interpret
  Pallas) over every policy, as ``tests/test_policies.py`` holds the
  reference's two routes;
* ``SamplerPlane(use_kernels=True, device="cpu")`` (the raw block
  sorted on the device and deduplicated by the sampler's form of
  ``ops.frontier_unique_batch``) against the reference's kernel route and
  the port's numpy route, with and without ``part_of``, at an
  ``id_base``;
* ``DistributedTrainer(device=False)`` against the reference's
  ``device=False`` for the four variants, async and sync, the event time
  engine, one topology and the feature store, with GraphSAGE training
  on (the reference's initial weights passed in);
* a device trainer's loops (raw and ragged) never call either hook;
* the fall-back: ``products`` at ``scale=0.02`` rebased to
  ``WIDE_ID_MAX`` on ``device="cpu"`` warns once per trainer, runs both
  hooks through the dispatchers, and its trace arrays equal the narrow
  run's with the id streams shifted by ``WIDE_ID_MAX``.

Tolerance: none on streams, stats, state and scores (bit patterns);
losses ``rtol=1e-5, atol=1e-6`` (float32 sums in another order,
compounded over the SGD steps).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.graph.sampler import SamplerPlane as JSamplerPlane
from repro.runtime import PrefetchEngine as JPrefetchEngine
from repro.store import FeatureStore as JStore
from repro_torch.core import scoring
from repro_torch.gnn import DistributedTrainer
from repro_torch.graph import SamplerPlane, generate, partition_graph
from repro_torch.kernels import native, ops
from repro_torch.runtime import PrefetchEngine

RTOL, ATOL = 1e-5, 1e-6
COMMON = dict(epochs=2, batch_size=16, train_model=True, buffer_frac=0.25)
STREAMS = (
    "pct_hits", "comm_volume", "comm_missed", "occupancy", "unique_remote",
    "replaced", "decisions", "step_time",
)
STORE_STREAMS = ("bytes_measured", "bytes_modeled", "feat_sums")
STATS = (
    "lookups", "hits", "misses", "replaced_total", "replacement_rounds",
    "skipped_rounds",
)
STATE = ("ids", "scores", "valid", "accessed", "weights")


@pytest.fixture(scope="module")
def parts():
    ref = jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.15), 4)
    port = partition_graph(generate("products", seed=0, scale=0.15), 4)
    return ref, port


class _Spy:
    """Counts calls of an ``ops`` dispatcher and passes them on."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(ops, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(ops, name, spy)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(scoring.POLICIES))
def test_engine_kernel_route_matches_numpy_and_reference(name, monkeypatch):
    spy = _Spy(monkeypatch, "score_policy_update_batch")
    rng = np.random.default_rng(7)
    weights = (
        scoring.degree_weights(rng.integers(0, 500, size=2000))
        if scoring.POLICIES[name].use_weights
        else None
    )
    engines = [
        PrefetchEngine([96, 64], policy=name, node_weights=weights),
        PrefetchEngine([96, 64], policy=name, node_weights=weights,
                       use_kernels=True, device="cpu"),
        JPrefetchEngine([96, 64], use_kernels=True, policy=name, node_weights=weights),
    ]
    ids = rng.choice(2000, size=120, replace=False)
    for eng in engines:
        eng.insert(0, ids[:70])
        eng.insert(1, ids[70:])
    active = np.array([True, True])
    for _ in range(4):
        remote = [rng.choice(2000, size=40), rng.choice(2000, size=40)]
        for eng in engines:
            eng.lookup(remote, active)
            eng.end_round(active)
            eng.replace_round(remote, np.array([True, True]))
    assert spy.calls == 4
    for eng in engines[1:]:
        np.testing.assert_array_equal(
            engines[0].scores.view(np.int32), eng.scores.view(np.int32)
        )
        for f in ("ids", "valid", "accessed"):
            np.testing.assert_array_equal(getattr(engines[0], f), getattr(eng, f))


def test_sampler_kernel_route_matches_numpy_and_reference(parts, monkeypatch):
    spy = _Spy(monkeypatch, "frontier_unique_batch")
    ref_parts, port_parts = parts
    blocks = [port_parts.local_train_nodes(p)[:12] for p in range(4)]
    blocks = [b[: min(len(x) for x in blocks)] for b in blocks]
    runs = [
        plane.sample_all(blocks, np.random.default_rng(2), part_of=port_parts.part_of)
        for plane in (
            SamplerPlane(port_parts.graph, (4, 6)),
            SamplerPlane(port_parts.graph, (4, 6), use_kernels=True, device="cpu"),
            JSamplerPlane(ref_parts.graph, (4, 6), use_kernels=True),
        )
    ]
    assert spy.calls == 1
    (mb0, rem0), *others = runs
    for mbs, rem in others:
        for a, b in zip(mb0, mbs):
            np.testing.assert_array_equal(a.unique_nodes, b.unique_nodes)
            for x, y in zip(a.layer_nbrs, b.layer_nbrs):
                np.testing.assert_array_equal(x, y)
        for a, b in zip(rem0, rem):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    # Without part_of the kernel route still dedups (no remote sets).
    mbs, rem = SamplerPlane(port_parts.graph, (4, 6), use_kernels=True, device="cpu") \
        .sample_all(blocks, np.random.default_rng(2))
    assert rem is None and spy.calls == 2
    for a, b in zip(mb0, mbs):
        np.testing.assert_array_equal(a.unique_nodes, b.unique_nodes)


@pytest.mark.parametrize("with_part_of", [True, False], ids=["part_of", "no-part_of"])
@pytest.mark.parametrize("base", [0, 2**31 + 1000], ids=["narrow", "id_base"])
def test_sampler_device_dedup_matches_numpy_and_reference(parts, base, with_part_of,
                                                          monkeypatch):
    """The kernel route's device dedup (upload of the raw block, sort and
    the compact form on ``device="cpu"``, the split on the host) on a graph
    at an ``id_base``, with and without ``part_of``: the same unique and
    remote sets, int64 and global, as the numpy route and the reference's
    plane over three batches; the kept host buffers are reused and the
    partition map is converted once; the host never sorts."""
    spy = _Spy(monkeypatch, "frontier_unique_batch")
    ref_parts, port_parts = parts
    ref_g, port_g = ref_parts.graph.rebase(base), port_parts.graph.rebase(base)
    part_of = port_parts.part_of if with_part_of else None
    kernel = SamplerPlane(port_g, (4, 6), use_kernels=True, device="cpu")
    planes = (SamplerPlane(port_g, (4, 6)), kernel,
              JSamplerPlane(ref_g, (4, 6), use_kernels=True))
    rngs = [np.random.default_rng(5) for _ in planes]
    buffers = set()
    for step in range(3):
        blocks = [port_parts.local_train_nodes(p)[step * 9:(step + 1) * 9] for p in range(4)]
        blocks = [b[: min(len(x) for x in blocks)] for b in blocks]
        np_sort = np.sort
        monkeypatch.setattr(np, "sort", lambda *a, **k: pytest.fail("host sort"))
        got = kernel.sample_all(blocks, rngs[1], part_of=part_of)
        monkeypatch.setattr(np, "sort", np_sort)
        runs = [plane.sample_all(blocks, rng, part_of=part_of)
                for plane, rng in ((planes[0], rngs[0]), (planes[2], rngs[2]))]
        buffers.add(kernel._host["touched"].data_ptr())
        (mb0, rem0), (mb2, rem2) = runs
        mb1, rem1 = got
        for mbs, rem in ((mb1, rem1), (mb2, rem2)):
            for a, b in zip(mb0, mbs):
                assert b.unique_nodes.dtype == np.int64
                np.testing.assert_array_equal(a.unique_nodes, b.unique_nodes)
            if part_of is None:
                assert rem is None
            else:
                for a, b in zip(rem0, rem):
                    assert b.dtype == np.int64
                    np.testing.assert_array_equal(a, b)
        if base:
            assert min(int(u.min()) for u in (m.unique_nodes for m in mb1)) >= base
    assert spy.calls == 3 and len(buffers) == 1
    if with_part_of:
        assert kernel._part_of[0] is part_of


def test_kernel_routes_on_cuda_without_a_card_raise(monkeypatch, parts):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = parts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerPlane(port.graph, (4, 6), use_kernels=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchEngine([4, 4], use_kernels=True, device="cuda")
    # Without the kernel route the device is never resolved.
    assert SamplerPlane(port.graph, (4, 6)).device is None
    assert PrefetchEngine([4, 4]).device is None


# --------------------------------------------------------------------------- #
def _compare(parts, variant, store=False, **kw):
    """The reference's ``device=False`` run against the port's; asserts
    every stream, stat and state is equal."""
    ref_parts, port_parts = parts
    kw = dict(COMMON, **kw)
    if variant == "rudder":
        kw["deciders"] = ["gemma3-4b"]
    ref_store = JStore.for_partitions(ref_parts, backend="numpy") if store else False
    ref_tr = jgnn.DistributedTrainer(ref_parts, variant=variant, feature_store=ref_store, **kw)
    init = jax.tree_util.tree_map(np.asarray, ref_tr.params) if kw["train_model"] else None
    port_tr = DistributedTrainer(
        port_parts, variant=variant, device=False, init_params=init,
        feature_store=store, **kw,
    )
    assert ref_tr.device is False and port_tr.device is False
    assert not port_tr.sampler_plane.use_kernels and not port_tr.engine.use_kernels
    before = dict(native.LAUNCHES)
    ref_run, port_run = ref_tr.run(), port_tr.run()
    assert native.LAUNCHES == before and port_tr.last_device_engine is None
    streams = STREAMS + (STORE_STREAMS if store else ())
    for p, (a, b) in enumerate(zip(port_run.logs, ref_run.logs)):
        for f in streams:
            assert getattr(a, f) == getattr(b, f), f"PE {p} {f}"
    assert port_run.epoch_times == ref_run.epoch_times
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_tr.engine.stats, f), getattr(ref_tr.engine.stats, f), err_msg=f
        )
    for f in STATE + (("payload",) if store else ()):
        np.testing.assert_array_equal(
            getattr(port_tr.engine, f), getattr(ref_tr.engine, f), err_msg=f
        )
    assert len(port_run.losses) == len(ref_run.losses)
    np.testing.assert_allclose(port_run.losses, ref_run.losses, rtol=RTOL, atol=ATOL)
    assert port_run.accuracy == pytest.approx(ref_run.accuracy, abs=1e-7)
    return port_tr, port_run


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("variant", ["distdgl", "fixed", "massivegnn", "rudder"])
def test_staged_run_matches_reference(parts, variant, mode):
    _compare(parts, variant, mode=mode)


@pytest.mark.parametrize(
    "variant,kw",
    [
        ("rudder", dict(time_engine="event")),
        ("fixed", dict(topology="rack", train_model=False, epochs=3)),
        ("massivegnn", dict(store=True)),
    ],
    ids=["event", "topology", "store"],
)
def test_staged_run_options_match_reference(parts, variant, kw):
    tr, run = _compare(parts, variant, **kw)
    if kw.get("store"):
        assert tr.feature_store.device == torch.device("cpu")
        assert run.total_bytes_measured == run.total_bytes_modeled > 0


def test_staged_run_equals_the_device_loop(parts):
    """The host pipeline and the device loop agree on every stream,
    stat and the final state."""
    _, port = parts
    kw = dict(COMMON, variant="rudder", deciders=["gemma3-4b"], train_model=False)
    staged = DistributedTrainer(port, device=False, **kw)
    device = DistributedTrainer(port, device="cpu", **kw)
    a, b = staged.run(), device.run()
    for la, lb in zip(a.logs, b.logs):
        for f in STREAMS:
            assert getattr(la, f) == getattr(lb, f), f
    for f in STATE + STATS:
        obj = "stats" if f in STATS else None
        x = getattr(staged.engine.stats if obj else staged.engine, f)
        y = getattr(device.engine.stats if obj else device.engine, f)
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("batch", [16, 72], ids=["raw", "ragged"])
def test_device_loops_never_reach_the_staged_hooks(parts, batch, monkeypatch):
    """A device trainer carries both hooks for its fall-back, but its
    loops never call them: the raw loop dedups in its launch, the ragged
    loop on the host, also on a step whose seed blocks share one length
    (batch 72 here has such steps)."""
    _, port = parts
    dedup = _Spy(monkeypatch, "frontier_unique_batch")
    score = _Spy(monkeypatch, "score_policy_update_batch")
    tr = DistributedTrainer(port, variant="fixed", device="cpu",
                            **dict(COMMON, batch_size=batch, train_model=False))
    assert tr.sampler_plane.use_kernels and tr.engine.use_kernels
    tr.run()
    assert tr.last_device_engine is not None
    assert dedup.calls == score.calls == 0


def test_readback_cadence_needs_a_device(parts):
    _, port = parts
    with pytest.raises(ValueError, match="readback_every > 1 requires device"):
        DistributedTrainer(port, variant="fixed", device=False, readback_every=2, **COMMON)
    with pytest.raises(ValueError, match="readback_every > 1 requires device"):
        DistributedTrainer(port, variant="fixed", device=None, readback_every=2, **COMMON)


# --------------------------------------------------------------------------- #
def test_fallback_past_the_wide_bound(monkeypatch):
    """Past ``WIDE_ID_MAX`` a device run takes the staged loop with both
    hooks on the trainer's device; one warning per trainer; the trace's
    arrays are the narrow device run's, id streams shifted."""
    g = generate("products", seed=0, scale=0.02)
    kw = dict(variant="massivegnn", epochs=2, batch_size=16, fanouts=(3, 5),
              train_model=False, trace=True, device="cpu")
    narrow_tr = DistributedTrainer(partition_graph(g, 2), **kw)
    narrow = narrow_tr.run()
    wide_tr = DistributedTrainer(partition_graph(g.rebase(ops.WIDE_ID_MAX), 2), **kw)
    assert wide_tr.sampler_plane.use_kernels and wide_tr.engine.use_kernels
    dedup = _Spy(monkeypatch, "frontier_unique_batch")
    score = _Spy(monkeypatch, "score_policy_update_batch")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wide = wide_tr.run()
    assert [str(w.message) for w in caught] == [
        "device=... requested but graph node ids exceed int32 and the wide-id "
        "bound; falling back to the staged pipeline"
    ]
    assert caught[0].category is RuntimeWarning
    steps = kw["epochs"] * wide_tr.mb_per_epoch
    assert dedup.calls == score.calls == steps
    assert wide_tr.last_device_engine is None
    tn, tw = narrow.trace, wide.trace
    assert set(tn.arrays) == set(tw.arrays)
    shifted = {"remote_flat", "miss_ids_flat", "placed_ids_flat"}
    for name in tn.arrays:
        a, b = np.asarray(tn.arrays[name]), np.asarray(tw.arrays[name])
        if name in shifted:
            np.testing.assert_array_equal(a + np.int64(ops.WIDE_ID_MAX), b, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    valid = wide_tr.engine.valid
    np.testing.assert_array_equal(
        wide_tr.engine.ids[valid], narrow_tr.engine.ids[valid] + np.int64(ops.WIDE_ID_MAX)
    )
    # A second run on the same trainer does not warn again.
    wide_tr.trace = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wide_tr.run()
    assert not caught
