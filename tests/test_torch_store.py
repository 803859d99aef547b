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

Tolerance: none. A gather copies rows; every comparison is exact.
"""

import numpy as np
import pytest
import torch

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
