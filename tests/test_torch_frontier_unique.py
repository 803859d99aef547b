"""The port's plain ``frontier_unique_batch`` against the reference package.

``repro_torch.kernels.ref.frontier_unique_batch`` is the spec the Hopper
kernel ``csrc/frontier_unique.cu`` is held to on the card, in both its
instantiations (int32 keys, and int64 keys for the reference's wide
twin). Here, on the CPU, it and the port's dispatcher
(``repro_torch.kernels.ops.frontier_unique_batch``) are held bit for bit
against the reference's jnp oracle (``repro.kernels.ref``, int32 keys)
and the reference's dispatcher over its Pallas kernels in interpret mode
(``repro.kernels.ops``, which routes keys past ``INT32_ID_MAX`` through
``frontier_unique_batch_wide`` on ``(hi, lo)`` word planes), on the
seeded set ``chip_smoke.py`` also runs on the card. Masks and counts are
compared exactly, dtypes included.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import native, ops, ref, scenarios

SCENARIOS = scenarios.frontier_unique_scenarios()
NAMES = ("first", "remote", "unique_count", "remote_count")
DTYPES = (np.bool_, np.bool_, np.int32, np.int32)


def _port(sc, fn):
    out = fn(torch.from_numpy(sc.keys), torch.from_numpy(sc.is_remote))
    return [t.numpy() for t in out]


def _assert_same(got, want, what):
    for name, dt, a, b in zip(NAMES, DTYPES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == dt, f"{what}: {name} is {a.dtype}"
        assert a.shape == b.shape, f"{what}: {name} {a.shape} vs {b.shape}"
        np.testing.assert_array_equal(a, b.astype(dt), err_msg=f"{what}: {name}")


def _numpy(sc):
    first, remote = ref.frontier_dedup(sc.keys, sc.is_remote)
    return first, remote, first.sum(1), remote.sum(1)


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_plain_and_dispatcher_match_reference(sc):
    want = jops.frontier_unique_batch(sc.keys, sc.is_remote)  # interpret Pallas
    _assert_same(_port(sc, ops.frontier_unique_batch), want, f"{sc.name} ops")
    _assert_same(_port(sc, ref.frontier_unique_batch), want, f"{sc.name} plain")
    _assert_same(want, _numpy(sc), f"{sc.name} reference vs numpy")
    if sc.keys.dtype == np.int32 or sc.keys.max(initial=0) < 2**31 - 1:
        oracle = jref.frontier_unique_batch(sc.keys, sc.is_remote)
        _assert_same(_port(sc, ref.frontier_unique_batch), oracle, f"{sc.name} oracle")


def test_int64_keys_route_by_range(monkeypatch):
    """int64 keys within ``INT32_ID_MAX`` run the narrow route as int32;
    larger ones the int64 route; both dispatch to the plain version on
    the CPU with the keys' route dtype."""
    seen = []
    real = ref.frontier_unique_batch

    def spy(keys, is_remote):
        seen.append(keys.dtype)
        return real(keys, is_remote)

    monkeypatch.setattr(ref, "frontier_unique_batch", spy)
    by = {s.name: s for s in SCENARIOS}
    for name in ("int64-narrow", "int64-base", "int64-top"):
        _port(by[name], ops.frontier_unique_batch)
    assert seen == [torch.int32, torch.int64, torch.int64]


def test_past_the_wide_bound_raises():
    keys = torch.tensor([[0, ops.WIDE_ID_MAX + 1]], dtype=torch.int64)
    flags = torch.zeros((1, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="wide-id device bound"):
        ops.frontier_unique_batch(keys, flags)
    with pytest.raises(ValueError, match="wide-id device bound"):
        jops.frontier_unique_batch(keys.numpy(), flags.numpy())


def test_int_remote_flags_and_cpu_launch_nothing():
    sc = {s.name: s for s in SCENARIOS}["random-remote0.5"]
    before = dict(native.LAUNCHES)
    a = _port(sc, ops.frontier_unique_batch)
    b = ops.frontier_unique_batch(
        torch.from_numpy(sc.keys), torch.from_numpy(sc.is_remote.astype(np.int32))
    )
    _assert_same([t.numpy() for t in b], a, "int32 flags")
    assert native.LAUNCHES == before
