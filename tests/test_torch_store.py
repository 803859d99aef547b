"""The port's gathers and ``FeatureStore`` against the reference package.

* ``repro_torch.kernels.ref.gather_rows`` / ``gather_rows_batch`` (the specs
  of ``csrc/gather_rows.cu``) against the reference's jnp oracles and its
  Pallas kernels in interpret mode, over the seeded gather scenarios that
  ``chip_smoke.py`` also runs on the card (``F`` in {1, 3, 100, 128, 602},
  ``M == 0``, repeated indices).
* ``repro_torch.store.FeatureStore`` — the host ``numpy`` table, the
  ``torch`` device table and the ``use_kernel=True`` per-home route —
  against ``repro.store.FeatureStore``: ``gather``, ``gather_batch`` blocks
  and ``nbytes``, ``home_of``, ``shards``, ``device_view`` and ``poke``.
* ``gather_tensor``'s flat route (one ``gather_rows`` launch on the flat
  table through ``device_view``'s map, no bucketing by home) against
  ``feats[ids - id_base]`` and the reference, with its launch and copy
  counts, and a training run through it against one on the numpy store.

Tolerance: none. A gather copies rows; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from repro_torch import telemetry as tel

from repro.kernels import ref as jref
from repro.kernels.gather_rows import gather_rows as jgather_rows
from repro.kernels.gather_rows import gather_rows_batch as jgather_rows_batch
from repro.store import FeatureStore as JStore
from repro_torch.kernels import native, ops, scenarios
from repro_torch.store import FeatureStore

GATHERS = scenarios.gather_scenarios()


@pytest.mark.parametrize("sc", GATHERS, ids=[s.name for s in GATHERS])
def test_gathers_match_oracle_and_pallas(sc):
    before = dict(native.LAUNCHES)
    got = ops.gather_rows_batch(torch.from_numpy(sc.tables), torch.from_numpy(sc.idx))
    single = ops.gather_rows(torch.from_numpy(sc.tables[0]), torch.from_numpy(sc.idx[0]))
    assert native.LAUNCHES == before  # the CPU route launches nothing
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.gather_rows_batch(sc.tables, sc.idx))
    )
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(jref.gather_rows(sc.tables[0], sc.idx[0]))
    )
    assert got.shape == (sc.tables.shape[0], sc.idx.shape[1], sc.tables.shape[2])
    if sc.idx.shape[1]:  # the Pallas grid has no step to run at M == 0
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgather_rows_batch(sc.tables, sc.idx, interpret=True))
        )
        np.testing.assert_array_equal(
            single.numpy(),
            np.asarray(jgather_rows(sc.tables[0], sc.idx[0], interpret=True)),
        )


def test_gather_scenarios_cover_the_widths():
    widths = {s.tables.shape[2] for s in GATHERS}
    assert widths == {1, 3, 100, 128, 602}
    assert any(s.idx.shape[1] == 0 for s in GATHERS)
    assert any(len(np.unique(s.idx[0])) < s.idx.shape[1] for s in GATHERS if s.idx.size)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.gather_rows import gather_rows_batch_cuda, gather_rows_cuda

    sc = GATHERS[2]
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_rows_batch_cuda(torch.from_numpy(sc.tables), torch.from_numpy(sc.idx))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_rows_cuda(torch.from_numpy(sc.tables[0]), torch.from_numpy(sc.idx[0]))


@pytest.mark.parametrize("shape", [(3, 90, 128, 0), (1, 90, 128, 0), (3, 90, 0, 5)])
def test_empty_gather_launches_nothing(shape):
    # No rows (or no columns) to copy: the wrappers start no kernel, so
    # their launch counts stay put. Nothing here reaches the CUDA library.
    from repro_torch.kernels import gather_rows as gr

    P, N, F, M = shape
    before = dict(native.LAUNCHES)
    tables = torch.zeros((P, N, F), dtype=torch.float32)
    idx = torch.zeros((P, M), dtype=torch.int32)
    assert gr._launch(tables, idx, torch.empty((P, M, F))) is False
    assert native.LAUNCHES == before


# --------------------------------------------------------------------------- #
def _data(seed=0, N=60, F=7, K=3, id_base=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    part_of = rng.integers(0, K, size=N)
    return feats, part_of, K, id_base


STORES = {
    "numpy": dict(backend="numpy"),
    "torch": dict(backend="torch"),
    "kernel": dict(backend="numpy", use_kernel=True),
}


@pytest.mark.parametrize("kind", list(STORES))
@pytest.mark.parametrize("id_base", [0, 1000])
def test_store_matches_reference(kind, id_base):
    feats, part_of, K, _ = _data()
    ref = JStore(feats, part_of, K, backend="numpy", id_base=id_base)
    store = FeatureStore(feats, part_of, K, id_base=id_base, device="cpu", **STORES[kind])
    assert store.nbytes == ref.nbytes
    np.testing.assert_array_equal(store.shards, ref.shards)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, len(feats), size=(4, 5)) + id_base
    np.testing.assert_array_equal(store.home_of(ids), ref.home_of(ids))
    np.testing.assert_array_equal(store.gather(ids), ref.gather(ids))
    np.testing.assert_array_equal(store.gather(ids), feats[ids - id_base])
    lists = [rng.integers(0, len(feats), size=n) + id_base for n in (3, 0, 9)]
    got = store.gather_batch(lists, device=True)
    want = ref.gather_batch(lists)
    assert got.nbytes == want.nbytes
    for a, b in zip(got.blocks, want.blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.device_block.numpy(), np.concatenate(want.blocks))
    assert store.gather_batch(lists).device_block is None
    flat = np.concatenate(lists)
    np.testing.assert_array_equal(
        store.gather_tensor(flat, "cpu").numpy(), feats[flat - id_base]
    )
    with pytest.raises(IndexError):
        store.gather([id_base + len(feats)])


def test_kernel_route_buckets_by_home_and_counts_launches():
    feats, part_of, K, _ = _data(seed=3)
    ref = JStore(feats, part_of, K, backend="numpy", use_kernel=True)
    store = FeatureStore(feats, part_of, K, use_kernel=True, device="cpu")
    ids = np.array([5, 1, 5, 40, 2, 59, 0])
    np.testing.assert_array_equal(store.gather(ids), ref.gather(ids))
    store.gather_batch([[], []])  # empty: no gather is served
    assert store.kernel_gathers == 1


def test_device_view_and_poke_match_reference():
    feats, part_of, K, _ = _data(seed=5)
    ref = JStore(feats, part_of, K, backend="numpy")
    store = FeatureStore(feats, part_of, K, device="cpu")
    table, loc = store.device_view()
    rtable, rloc = ref.device_view()
    assert table.dtype == torch.float32 and loc.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(rtable))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(rloc))
    assert store.device_view() is store.device_view()  # cached
    for s in (store, ref):
        s.poke(7, 2.5)
    np.testing.assert_array_equal(store.gather([7]), ref.gather([7]))
    assert store.gather([7])[0, 0] == feats[7, 0] + np.float32(2.5)
    np.testing.assert_array_equal(store.device_view()[0].numpy(), np.asarray(ref.device_view()[0]))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_one_device_table_serves_every_route(monkeypatch, backend):
    # The kernel's shard view, device_view and the torch backend share one
    # upload of the flat table; poke drops it and the next use uploads once.
    feats, part_of, K, _ = _data(seed=9)
    store = FeatureStore(feats, part_of, K, backend=backend, use_kernel=True, device="cpu")
    uploads = []
    real = store._upload
    monkeypatch.setattr(
        store, "_upload",
        lambda a, device=None, **kw: (uploads.append(a.size), real(a, device, **kw))[1],
    )
    table_size = K * store.n_max * store.feature_dim  # flat or shard view
    ids = np.array([3, 8, 3, 59])
    for _ in range(2):
        np.testing.assert_array_equal(store.gather(ids), feats[ids])
        np.testing.assert_array_equal(store.gather_tensor(ids, "cpu").numpy(), feats[ids])
        table, _loc = store.device_view()
        assert table is store._table()
        assert uploads.count(table_size) == 1
        store.poke(3, 1.0)
        feats[3] += np.float32(1.0)
        uploads.clear()


def test_store_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats, part_of, K, _ = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureStore(feats, part_of, K)


# --------------------------------------------------------------------------- #
# gather_tensor's flat route
# --------------------------------------------------------------------------- #
def test_flat_gather_with_a_map_matches_the_oracle():
    # ref.gather_rows with the node -> row map reads table[loc[idx]].
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    loc = torch.from_numpy(rng.permutation(50)[:30].astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 30, size=200).astype(np.int32))
    got = ops.gather_rows(table, idx, loc)
    np.testing.assert_array_equal(got.numpy(), table.numpy()[loc.numpy()[idx.numpy()]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.gather_rows(table.numpy(), loc.numpy()[idx.numpy()]))
    )


def test_cuda_wrapper_refuses_a_cpu_map():
    from repro_torch.kernels.gather_rows import gather_rows_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_rows_cuda(torch.zeros((4, 3)), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32))


def _flat_requests(N, id_base):
    rng = np.random.default_rng(11)
    dup = rng.integers(0, N, size=400)  # ~7 repeats a node at N = 60
    return {
        "duplicates": dup + id_base,
        "one": np.array([N - 1]) + id_base,
        "empty": np.array([], dtype=np.int64),
        "every": rng.permutation(N) + id_base,
    }


@pytest.mark.parametrize("kind", ["kernel", "torch"])
@pytest.mark.parametrize("request_name", ["duplicates", "one", "empty", "every"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("id_base", [0, 1000])
def test_gather_tensor_is_one_flat_gather(kind, request_name, dtype, id_base):
    feats, part_of, K, _ = _data(seed=13)
    ref = JStore(feats, part_of, K, backend="numpy", id_base=id_base)
    store = FeatureStore(feats, part_of, K, id_base=id_base, device="cpu", **STORES[kind])
    ids = _flat_requests(len(feats), id_base)[request_name].astype(dtype)
    session = tel.TelemetrySession()
    with tel.active(session):
        got = store.gather_tensor(ids, "cpu")
    assert got.dtype == torch.float32 and got.shape == (len(ids), feats.shape[1])
    np.testing.assert_array_equal(got.numpy(), feats[ids.astype(np.int64) - id_base])
    np.testing.assert_array_equal(got.numpy(), ref.gather(ids))
    reg = session.registry
    calls = lambda name: reg[name].total if name in reg else 0  # noqa: E731
    launched = int(len(ids) > 0)
    assert calls("kernel.gather_rows.calls") == launched
    assert calls("kernel.gather_rows_batch.calls") == 0
    assert store.flat_gathers == calls("store.flat_gathers") == launched
    assert store.kernel_gathers == 0
    assert calls("store.flat_rows") == len(ids)
    assert calls("device.h2d_bytes.store.ids") == 4 * len(ids)
    assert calls("device.h2d_bytes.store.index") == 0  # no per-home index


@pytest.mark.parametrize("id_base", [0, 1000])
@pytest.mark.parametrize("bad", ["below", "above"])
def test_gather_tensor_checks_the_range_before_any_gather(id_base, bad):
    feats, part_of, K, _ = _data(seed=2)
    store = FeatureStore(feats, part_of, K, id_base=id_base, use_kernel=True, device="cpu")
    wrong = id_base - 1 if bad == "below" else id_base + len(feats)
    session = tel.TelemetrySession()
    with tel.active(session), pytest.raises(IndexError, match="out of range"):
        store.gather_tensor(np.array([id_base, wrong, id_base + 1]), "cpu")
    assert "kernel.gather_rows.calls" not in session.registry
    assert "device.h2d_bytes.store.ids" not in session.registry
    assert store.flat_gathers == 0 and store._dev_view == {}


def test_gather_batch_keeps_the_per_home_route():
    # The miss pull stays bucketed by home: one gather_rows_batch launch,
    # counted by kernel_gathers; gather_tensor beside it adds a flat one.
    feats, part_of, K, _ = _data(seed=17)
    ref = JStore(feats, part_of, K, backend="numpy")
    store = FeatureStore(feats, part_of, K, use_kernel=True, device="cpu")
    lists = [np.array([5, 1, 5]), np.array([40, 2, 59, 0])]
    session = tel.TelemetrySession()
    with tel.active(session):
        got = store.gather_batch(lists, device=True)
        rows = store.gather_tensor(np.concatenate(lists), "cpu")
    reg = session.registry
    assert reg["kernel.gather_rows_batch.calls"].total == 1 == store.kernel_gathers
    assert reg["kernel.gather_rows.calls"].total == 1 == store.flat_gathers
    assert reg["device.h2d_bytes.store.index"].total > 0
    for a, b in zip(got.blocks, ref.gather_batch(lists).blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rows.numpy(), got.device_block.numpy())


def test_training_through_the_flat_route_matches_the_numpy_store():
    # Same rows, same bits: a trainer on the kernel store (flat route for
    # the training rows) gives the numpy store's losses and accuracy
    # exactly, with one flat gather per PE and step plus the accuracy pass.
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    parts = partition_graph(generate("products", seed=0, scale=0.05), 4)
    kw = dict(variant="fixed", epochs=1, batch_size=16, fanouts=(3, 5), train_model=True,
              buffer_frac=0.25, device="cpu", seed=3)
    runs = {}
    for kind in ("numpy", "kernel"):
        store = FeatureStore.for_partitions(parts, device="cpu", **STORES[kind])
        torch.manual_seed(0)
        tr = DistributedTrainer(parts, feature_store=store, **kw)
        runs[kind] = (store, tr.run())
    (np_store, want), (k_store, got) = runs["numpy"], runs["kernel"]
    assert got.losses == want.losses and got.accuracy == want.accuracy
    assert np_store.flat_gathers == 0
    assert k_store.flat_gathers == 4 * len(got.losses) + 1 > 1
