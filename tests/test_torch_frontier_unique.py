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
compared exactly, dtypes included. The sampler's form
(``ops.frontier_unique_batch(..., compact=True)``, plain version
``ref.frontier_unique_compact``) is held against the reference's masks
selected in flat row order, with the remote flags from the set's
``part_of`` and without one. The ``@given`` twin of the reference's
``test_frontier_unique_batch_property`` holds the dispatcher against the
reference's numpy and jnp oracles with the reference's strategies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.graph.sampler import frontier_dedup as j_frontier_dedup
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


def _route_dtype(keys: np.ndarray):
    """The dtype the dispatcher runs the keys in (int64 keys within
    ``INT32_ID_MAX`` narrow to int32)."""
    if keys.dtype == np.int32 or ops.int32_id_eligible(keys.max(initial=0)):
        return np.int32
    return np.int64


def _compact_want(keys: np.ndarray, is_remote: np.ndarray):
    """The sampler's form from the reference's masks (interpret Pallas):
    the unique and remote ids in flat row order, and the counts."""
    first, remote, ucount, rcount = (
        np.asarray(x) for x in jops.frontier_unique_batch(keys, is_remote)
    )
    flat = keys.ravel().astype(_route_dtype(keys))
    return flat[first.ravel()], flat[remote.ravel()], ucount, rcount


def _assert_compact(got, want, what, with_remote=True):
    uniq, rem, ucount, rcount = got
    w_uniq, w_rem, w_ucount, w_rcount = want
    assert uniq.dtype == torch.from_numpy(w_uniq).dtype, f"{what}: {uniq.dtype}"
    np.testing.assert_array_equal(uniq.numpy(), w_uniq, err_msg=f"{what}: uniq")
    np.testing.assert_array_equal(ucount.numpy(), w_ucount, err_msg=f"{what}: ucount")
    assert ucount.dtype == rcount.dtype == torch.int32
    if with_remote:
        np.testing.assert_array_equal(rem.numpy(), w_rem, err_msg=f"{what}: rem")
        np.testing.assert_array_equal(rcount.numpy(), w_rcount, err_msg=f"{what}: rcount")
    else:
        assert rem is None and not rcount.any(), what


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_compact_form_matches_reference_masks(sc):
    """The sampler's form on every set (``M == 0``, one PE, rows of 1, 5,
    16 and 17, lengths off 16, several tiles, int64 keys on both routes):
    without ``part_of`` its ids are the unique ids; with the set's
    ``part_of`` the remote flags are ``part_of[key] != row``. Plain version
    and dispatcher alike; the dispatcher launches nothing on the CPU."""
    P = sc.keys.shape[0]
    keys = torch.from_numpy(sc.keys)
    before = dict(native.LAUNCHES)
    none = _compact_want(sc.keys, np.zeros(sc.keys.shape, dtype=bool))
    _assert_compact(ops.frontier_unique_batch(keys, compact=True), none,
                    f"{sc.name} ops", with_remote=False)
    if sc.part_of is not None:
        is_remote = sc.part_of[sc.keys] != np.arange(P)[:, None]
        want = _compact_want(sc.keys, is_remote)
        part_of = torch.from_numpy(sc.part_of)
        _assert_compact(ops.frontier_unique_batch(keys, part_of=part_of, compact=True),
                        want, f"{sc.name} ops, part_of")
        _assert_compact(ref.frontier_unique_compact(keys, part_of), want,
                        f"{sc.name} plain, part_of")
        # An int64 map routes as int32.
        _assert_compact(
            ops.frontier_unique_batch(keys, part_of=part_of.long(), compact=True),
            want, f"{sc.name} ops, int64 part_of")
    assert native.LAUNCHES == before


def test_form_arguments_are_checked():
    keys = torch.zeros((1, 3), dtype=torch.int32)
    flags = torch.zeros((1, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="compact form takes part_of"):
        ops.frontier_unique_batch(keys, flags, compact=True)
    with pytest.raises(ValueError, match="mask form takes remote flags"):
        ops.frontier_unique_batch(keys)
    with pytest.raises(ValueError, match="mask form takes remote flags"):
        ops.frontier_unique_batch(keys, flags, part_of=torch.zeros(1, dtype=torch.int32))


@given(
    P=st.integers(1, 5),
    M=st.integers(0, 200),
    dtype=st.sampled_from([np.int32, np.int64]),
    shape_kind=st.sampled_from(["random", "all-duplicate", "all-unique"]),
    p_remote=st.floats(0.0, 1.0),
    seed=st.integers(0, 10_000),
)
@settings(max_examples=30, deadline=None)
def test_frontier_unique_batch_property(P, M, dtype, shape_kind, p_remote, seed):
    """Twin of the reference's property: the port's dispatcher == the
    reference's numpy oracle == its jnp oracle over random shapes and
    dtypes, empty rows (M = 0) and all-duplicate rows; the sampler's form
    gives the same ids in flat row order."""
    rng = np.random.default_rng(seed)
    if shape_kind == "all-duplicate":
        keys = np.full((P, M), int(rng.integers(0, 100)), dtype=dtype)
    elif shape_kind == "all-unique":
        base = rng.integers(0, 10, size=(P, M)) + 1 if M else np.zeros((P, 0))
        keys = np.cumsum(base, axis=1).astype(dtype)
    else:
        keys = np.sort(rng.integers(0, max(1, 2 * M), size=(P, M)), axis=1).astype(dtype)
    rem = rng.random((P, M)) < p_remote

    first, remote, ucount, rcount = (
        t.numpy() for t in ops.frontier_unique_batch(torch.from_numpy(keys),
                                                     torch.from_numpy(rem))
    )
    want_first, want_remote = j_frontier_dedup(keys, rem)          # numpy oracle
    np.testing.assert_array_equal(first, want_first)
    np.testing.assert_array_equal(remote, want_remote)
    np.testing.assert_array_equal(ucount, want_first.sum(axis=1))
    np.testing.assert_array_equal(rcount, want_remote.sum(axis=1))
    assert ucount.dtype == np.int32 and rcount.dtype == np.int32
    if M:                                                          # jnp oracle
        jf, jr, juc, jrc = jref.frontier_unique_batch(
            jnp.asarray(keys.astype(np.int32)), jnp.asarray(rem)
        )
        np.testing.assert_array_equal(first, np.asarray(jf))
        np.testing.assert_array_equal(remote, np.asarray(jr))
        np.testing.assert_array_equal(ucount, np.asarray(juc))
        np.testing.assert_array_equal(rcount, np.asarray(jrc))
    uniq, _, uc, _ = ops.frontier_unique_batch(torch.from_numpy(keys), compact=True)
    np.testing.assert_array_equal(uniq.numpy(), keys.ravel()[want_first.ravel()])
    np.testing.assert_array_equal(uc.numpy(), ucount)
