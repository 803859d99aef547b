"""The port's ``DeviceEngine`` against the reference's, launch by launch.

Several rotated ``fused_step_raw`` launches over raw sampled frontiers
(duplicates, -1 padding, empty and all-duplicate rows, a zero-capacity PE)
run through ``repro.runtime.engine.DeviceEngine(backend="jnp")`` and
through ``repro_torch.runtime.engine.DeviceEngine(device="cpu")`` from the
same warm-started state. Every ``FrontierStepOut`` field, the buffer state
after ``sync_to_engine``, the engine statistics and the ``transfers`` audit
must be equal, and resident ids stay unique per PE after every launch (the
Hopper kernel's direct-mapped slot index relies on it).
"""

import copy

import numpy as np
import pytest
import torch

from repro.runtime import engine as jeng
from repro_torch.core import scoring
from repro_torch.runtime import engine as teng

FIELDS = (
    "hit_masks", "missed", "hits", "hit_slots", "replaced", "placed",
    "placed_slots", "n_valid", "remote", "n_remote",
)
STATE = ("ids", "scores", "valid", "accessed", "weights")
STATS = (
    "lookups", "hits", "misses", "replaced_total", "replacement_rounds",
    "skipped_rounds",
)


def _engines(seed, P, n_nodes, policy):
    """The same warm-started engine in both packages."""
    rng = np.random.default_rng(seed)
    caps = [int(x) for x in rng.integers(1, 12, size=P)]
    caps[0] = 0  # a zero-capacity PE rides along
    pol = scoring.make_policy(policy)
    node_weights = (
        scoring.degree_weights(rng.integers(1, 50, size=n_nodes))
        if pol.use_weights
        else None
    )
    ref_eng = jeng.PrefetchEngine(caps, policy=policy, node_weights=node_weights)
    port_eng = teng.PrefetchEngine(caps, policy=policy, node_weights=node_weights)
    for p in range(P):
        ids = rng.choice(n_nodes, size=int(rng.integers(0, 8)), replace=False)
        ref_eng.insert(p, ids.astype(np.int64))
        port_eng.insert(p, ids.astype(np.int64))
    return rng, ref_eng, port_eng


def _assert_unique_resident(dev):
    ids = dev._ids.numpy()
    valid = dev._valid.numpy()
    for p in range(ids.shape[0]):
        live = ids[p][valid[p]]
        assert len(np.unique(live)) == len(live), f"PE {p} holds an id twice"


def _assert_out_equal(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, list):
            assert len(x) == len(y), f"{what} {f}"
            for p, (u, v) in enumerate(zip(x, y)):
                np.testing.assert_array_equal(u, v, err_msg=f"{what} {f} PE {p}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


@pytest.mark.parametrize(
    "seed,policy,dtype,special",
    [
        (0, "rudder", np.int64, ()),
        (1, "degree", np.int32, ((1, "empty"), (2, "dup"))),
        (2, "hybrid", np.int64, ((3, "dup"),)),
        (3, "recency", np.int32, ()),
        (4, "frequency", np.int64, ((2, "empty"),)),
    ],
)
def test_rotated_launches_match_reference(seed, policy, dtype, special):
    P, n_nodes, steps = 4, 200, 6
    rng, ref_eng, port_eng = _engines(seed, P, n_nodes, policy)
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    ref_dev = jeng.DeviceEngine(copy.deepcopy(ref_eng), backend="jnp", part_of=part_of)
    port_dev = teng.DeviceEngine(port_eng, device="cpu", part_of=part_of)

    uses_buffer = rng.random(P) > 0.2
    active = uses_buffer & (ref_eng.capacity > 0)
    frontiers = []
    Mt = 20 + seed  # one frontier width per run, as the trainer's
    for _ in range(steps):
        f = rng.integers(0, n_nodes, size=(P, Mt))
        f[rng.random(f.shape) < 0.2] = -1
        for p, kind in special:
            f[p, :] = -1 if kind == "empty" else f[p, 0]
        frontiers.append(f.astype(dtype))
    decisions = [rng.random(P) > 0.3 for _ in range(steps)]

    zeros = np.zeros(P, dtype=bool)
    calls = [(frontiers[0], zeros, zeros, active)]
    for t in range(steps):
        nxt = frontiers[t + 1] if t + 1 < steps else np.full((P, 0), -1, dtype)
        calls.append((nxt, uses_buffer, decisions[t] & uses_buffer, active))
    for i, args in enumerate(calls):
        want = ref_dev.fused_step_raw(*args)
        got = port_dev.fused_step_raw(*args)
        _assert_out_equal(got, want, f"launch {i}")
        _assert_unique_resident(port_dev)

    assert port_dev.transfers == ref_dev.transfers
    assert port_dev.transfers["h2d"] == port_dev.transfers["d2h"] == len(calls)
    ref_state, port_state = ref_dev.sync_to_engine(), port_dev.sync_to_engine()
    for f in STATE:
        a, b = getattr(port_state, f), getattr(ref_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_dev.stats, f), getattr(ref_dev.stats, f), err_msg=f
        )
    assert port_dev.stats is port_eng.stats


def test_prefetch_engine_matches_reference():
    """The numpy engine (the trainer's warm-start state) is a copy."""
    rng, ref_eng, port_eng = _engines(9, 3, 100, "rudder")
    for _ in range(4):
        queries = [np.unique(rng.integers(0, 100, size=12)) for _ in range(3)]
        on = np.ones(3, dtype=bool)
        for eng in (ref_eng, port_eng):
            eng.lookup(queries, on)
            eng.end_round(on)
            eng.replace_round(queries, on)
    for f in STATE:
        np.testing.assert_array_equal(getattr(port_eng, f), getattr(ref_eng, f))


def test_wide_ids_are_not_ported():
    """Once refused, now served: an engine at ``id_base = 2**33`` takes
    wide mode (int64 ids on the device) and its rotated raw launches
    equal the reference's wide ``DeviceEngine`` (``(hi, lo)`` planes)."""
    base = 2**33
    part_of = np.arange(10, dtype=np.int64) % 2
    ref_dev = jeng.DeviceEngine(
        jeng.PrefetchEngine([4, 4], id_base=base), backend="jnp", part_of=part_of
    )
    port_dev = teng.DeviceEngine(
        teng.PrefetchEngine([4, 4], id_base=base), device="cpu", part_of=part_of
    )
    assert port_dev.wide and ref_dev.wide
    assert port_dev._ids.dtype == torch.int64
    rng = np.random.default_rng(3)
    on = np.ones(2, dtype=bool)
    for t in range(5):
        f = rng.integers(-1, 10, size=(2, 6)).astype(np.int64)
        f[f >= 0] += base
        args = (f, on if t else ~on, on if t else ~on, on)
        _assert_out_equal(
            port_dev.fused_step_raw(*args), ref_dev.fused_step_raw(*args), f"launch {t}"
        )
    np.testing.assert_array_equal(
        port_dev.sync_to_engine().ids, ref_dev.sync_to_engine().ids
    )


def test_counts_cadence_is_not_ported():
    """Once refused, now served: ``want="counts"`` returns the launch's
    ``(P, 4)`` counters as a device tensor, equal to the reference's, and
    reads nothing back."""
    part_of = np.zeros(10, np.int64)
    dev = teng.DeviceEngine(teng.PrefetchEngine([4]), device="cpu", part_of=part_of)
    ref_dev = jeng.DeviceEngine(jeng.PrefetchEngine([4]), backend="jnp", part_of=part_of)
    on = np.ones(1, dtype=bool)
    touched = np.array([[1, 3, 3, -1]], np.int64)
    got = dev.fused_step_raw(touched, on, on, on, want="counts")
    want = ref_dev.fused_step_raw(touched, on, on, on, want="counts")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dev.transfers["d2h"] == 0 and dev.transfers["h2d"] == 1


def test_frontier_outside_partition_map_raises():
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([4, 4]), device="cpu", part_of=np.zeros(10, np.int64)
    )
    on = np.ones(2, dtype=bool)
    with pytest.raises(ValueError, match="partition map"):
        dev.fused_step_raw(np.full((2, 3), 10, np.int64), on, on, on)


# --------------------------------------------------------------------------- #
# The ragged loop's staged fused step, and the feature payload.
STEP_FIELDS = (
    "hit_masks", "missed", "hits", "hit_slots", "replaced", "placed",
    "placed_slots", "n_valid",
)


def _assert_fields_equal(a, b, fields, what):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, list):
            assert len(x) == len(y), f"{what} {f}"
            for p, (u, v) in enumerate(zip(x, y)):
                np.testing.assert_array_equal(u, v, err_msg=f"{what} {f} PE {p}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


def _stores(P, n_nodes, part_of, F=5):
    from repro.store import FeatureStore as JStore
    from repro_torch.store import FeatureStore

    feats = np.random.default_rng(7).standard_normal((n_nodes, F)).astype(np.float32)
    return (
        JStore(feats, part_of, P, backend="numpy"),
        FeatureStore(feats, part_of, P, device="cpu"),
    )


@pytest.mark.parametrize(
    "seed,policy,with_store",
    [
        (10, "rudder", False),
        (11, "degree", True),
        (12, "hybrid", False),
        (13, "frequency", True),
    ],
)
def test_rotated_fused_steps_match_reference(seed, policy, with_store):
    """The ragged loop's launches: host-deduped query sets of different
    lengths per PE, the previous round's misses as candidates (duplicates
    and resident ids included), rotated as ``FusedFetchStage`` drives
    them; with a store, admission rows go through ``place_rows_batch``
    and hit rows come back through ``pull_rows``."""
    P, n_nodes, steps = 4, 200, 6
    rng, ref_eng, port_eng = _engines(seed, P, n_nodes, policy)
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    F = 5
    if with_store:
        caps = [int(c) for c in ref_eng.capacity]
        ref_eng = jeng.PrefetchEngine(caps, policy=policy, feature_dim=F,
                                      node_weights=ref_eng._node_weights)
        port_eng = teng.PrefetchEngine(caps, policy=policy, feature_dim=F,
                                       node_weights=port_eng._node_weights)
    ref_dev = jeng.DeviceEngine(copy.deepcopy(ref_eng), backend="jnp", part_of=part_of)
    port_dev = teng.DeviceEngine(port_eng, device="cpu", part_of=part_of)
    if with_store:
        jstore, tstore = _stores(P, n_nodes, part_of, F)

    uses_buffer = rng.random(P) > 0.2
    active = uses_buffer & (ref_eng.capacity > 0)
    zeros = np.zeros(P, dtype=bool)
    prev = [np.array([], np.int64)] * P
    for t in range(steps + 1):
        queries = [
            np.unique(rng.integers(0, n_nodes, size=int(rng.integers(0, 25))))
            for _ in range(P)
        ]
        if t == 0:
            args = (queries, [np.array([], np.int64)] * P, zeros, zeros, active)
        else:
            dec = (rng.random(P) > 0.3) & uses_buffer
            args = (queries, prev, uses_buffer, dec, active)
        want = ref_dev.fused_step(*args)
        got = port_dev.fused_step(*args)
        _assert_fields_equal(got, want, STEP_FIELDS, f"launch {t}")
        _assert_unique_resident(port_dev)
        prev = [np.concatenate([m, m[:2]]) for m in want.missed]  # with repeats
        if with_store:
            for dev, store in ((ref_dev, jstore), (port_dev, tstore)):
                g = store.gather_batch(dev.last_placed, device=True)
                dev.place_rows_batch(dev.last_slots, g.blocks, device_block=g.device_block)
            for a, b in zip(port_dev.pull_rows(got.hit_slots), ref_dev.pull_rows(want.hit_slots)):
                np.testing.assert_array_equal(a, b)

    # One packed upload and one packed readback per launch (plus one
    # readback per non-empty pull_rows), where the reference makes five
    # uploads per launch (six with degree weights); its d2h bytes follow
    # its 64-bucketed widths, the port's the exact ones.
    n = steps + 1
    assert port_dev.transfers["d2h"] == ref_dev.transfers["d2h"] >= n
    assert port_dev.transfers["h2d"] == n
    assert ref_dev.transfers["h2d"] == n * (6 if policy == "degree" else 5)
    ref_state, port_state = ref_dev.sync_to_engine(), port_dev.sync_to_engine()
    for f in STATE + (("payload",) if with_store else ()):
        a, b = getattr(port_state, f), getattr(ref_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_dev.stats, f), getattr(ref_dev.stats, f), err_msg=f
        )


def test_raw_launches_scatter_admission_rows_like_the_reference():
    """The single-launch step with a store attached: admission rows are
    copied from the store's device view into the payload inside the step."""
    P, n_nodes = 3, 120
    rng = np.random.default_rng(21)
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    caps = [6, 0, 9]
    ref_dev = jeng.DeviceEngine(
        jeng.PrefetchEngine(caps, feature_dim=5), backend="jnp", part_of=part_of
    )
    port_dev = teng.DeviceEngine(
        teng.PrefetchEngine(caps, feature_dim=5), device="cpu", part_of=part_of
    )
    jstore, tstore = _stores(P, n_nodes, part_of)
    ref_dev.attach_store(jstore)
    port_dev.attach_store(tstore)
    on = np.ones(P, dtype=bool)
    for t in range(6):
        f = rng.integers(-1, n_nodes, size=(P, 30))
        args = (f, on if t else ~on, on if t else ~on, on)
        want, got = ref_dev.fused_step_raw(*args), port_dev.fused_step_raw(*args)
        _assert_out_equal(got, want, f"launch {t}")
        np.testing.assert_array_equal(port_dev.payload.numpy(), np.asarray(ref_dev.payload))
    assert int(port_dev.stats.replaced_total.sum()) > 0
    ref_state, port_state = ref_dev.sync_to_engine(), port_dev.sync_to_engine()
    np.testing.assert_array_equal(port_state.payload, ref_state.payload)


def test_fused_step_ids_outside_partition_map_raise():
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([4, 4]), device="cpu", part_of=np.zeros(10, np.int64)
    )
    on = np.ones(2, dtype=bool)
    empty = [np.array([], np.int64)] * 2
    with pytest.raises(ValueError, match="partition map"):
        dev.fused_step([np.array([10]), np.array([1])], empty, on, on, on)
