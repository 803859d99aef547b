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
    eng = teng.PrefetchEngine([4, 4], id_base=2**33)
    with pytest.raises(NotImplementedError, match="wide"):
        teng.DeviceEngine(eng, device="cpu", part_of=np.zeros(10, np.int64))


def test_counts_cadence_is_not_ported():
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([4]), device="cpu", part_of=np.zeros(10, np.int64)
    )
    on = np.ones(1, dtype=bool)
    with pytest.raises(NotImplementedError, match="readback_every"):
        dev.fused_step_raw(np.zeros((1, 3), np.int64), on, on, on, want="counts")


def test_frontier_outside_partition_map_raises():
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([4, 4]), device="cpu", part_of=np.zeros(10, np.int64)
    )
    on = np.ones(2, dtype=bool)
    with pytest.raises(ValueError, match="partition map"):
        dev.fused_step_raw(np.full((2, 3), 10, np.int64), on, on, on)
