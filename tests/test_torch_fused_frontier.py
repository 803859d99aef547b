"""The port's plain ``fused_frontier_step`` against the reference package.

``repro_torch.kernels.ref.fused_frontier_step`` is the spec the Hopper
kernel is held to on the card. Here, on the CPU, it is held bit for bit
against the reference's jnp oracle (``repro.kernels.ref``) and against the
reference's Pallas kernel in interpret mode, on the seeded scenario set
that ``chip_smoke.py`` also runs on the card: all five scoring policies,
weighted and unweighted, scores on the stale threshold, capacity-masked
slots, empty and all-duplicate frontier rows, the drained ``Mt == 1``
launch and the initial all -1 ``(P, 1)`` candidate block — each with and
without a feature-store table, whose admission rows the step copies into
the payload. Scores are compared as their int32 bit patterns.

Also here: the kernels' count sort and cumsum miss compaction as plain
twins (``ref.frontier_count_sort``, ``ref.compact_misses``) against
``torch.sort``, the reference's prologue and the step's ``cand_next``,
and the ``@given`` twin of the reference's raw-vs-staged frontier
property on the port's engines.
"""

import copy

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels.fused_step import fused_frontier_step_pallas
from repro_torch.kernels import native, ops, ref, scenarios

SCENARIOS = scenarios.frontier_scenarios()
OUT_NAMES = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "payload2",
    "cand_next", "packed", "counters",
)


def _torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what):
    for name, a, b in zip(OUT_NAMES, got, want):
        if a is None or b is None:
            assert a is None and b is None, f"{what}: {name}"
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, f"{what}: {name} {a.shape} vs {b.shape}"
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what}: {name}")


def _store_view(sc, F=3):
    """A seeded ``(payload, table, loc)`` triple for the scenario: the
    flat store table is a permutation of its rows, as the store's
    partition-major layout is."""
    P, C = sc.ids.shape
    N = sc.part_of.shape[0]
    rng = np.random.default_rng(P * 1000 + C)
    payload = rng.standard_normal((P * C, F)).astype(np.float32)
    table = rng.standard_normal((N + 5, F)).astype(np.float32)
    loc = rng.permutation(N + 5)[:N].astype(np.int32)
    return payload, table, loc


def _check(sc, view):
    arr = sc.arrays()
    kw = dict(cand_cap=sc.cand_cap, **sc.constants)
    got = ops.fused_frontier_step_batch(
        *[_torch(a) for a in (*arr.values(), *view)], **kw
    )
    oracle = jref.fused_frontier_step(*arr.values(), *view, **kw)
    pallas = fused_frontier_step_pallas(*arr.values(), *view, interpret=True, **kw)
    _assert_same(got, oracle, f"{sc.name} vs jnp oracle")
    _assert_same(got, pallas, f"{sc.name} vs Pallas")
    return got


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_plain_matches_oracle_and_pallas(sc):
    _check(sc, (None, None, None))


STORE_CASES = [s for s in SCENARIOS if s.name in ("rudder-u", "degree-w", "drained-Mt1", "one-pe")]


@pytest.mark.parametrize("sc", STORE_CASES, ids=[s.name for s in STORE_CASES])
def test_payload_scatter_matches_oracle_and_pallas(sc):
    payload, table, loc = _store_view(sc)
    got = _check(sc, (payload, table, loc))
    assert got[5].shape == payload.shape


def test_scenarios_cover_the_edge_cases():
    names = {s.name for s in SCENARIOS}
    for policy in scenarios.POLICIES:
        assert {f"{policy}-u", f"{policy}-w"} <= names
    drained = [s for s in SCENARIOS if s.touched_aug.shape[1] == 2]
    assert drained and all((s.touched_aug[:, 0] == -1).all() for s in drained)
    initial = [s for s in SCENARIOS if s.cand.shape[1] == 1]
    assert initial and all((s.cand == -1).all() for s in initial)
    assert any((~s.in_capacity).any() for s in SCENARIOS)
    # Resident ids are unique per PE: the kernel's direct-mapped slot
    # index relies on it.
    for s in SCENARIOS:
        for p in range(s.ids.shape[0]):
            live = s.ids[p][s.valid[p]]
            assert len(np.unique(live)) == len(live)


def test_scores_on_the_threshold_flip_exactly():
    """A score that decays onto the threshold is not stale (``<``), and one
    a float32 ulp below is: the plain version rounds like the oracle."""
    pol_t = np.float32(0.95)
    scores = np.array([[1.0, np.nextafter(np.float32(1.0), np.float32(0))]], np.float32)
    P, C = scores.shape
    args = dict(
        ids=np.array([[3, 4]], np.int32),
        scores=scores,
        valid=np.ones((P, C), bool),
        accessed=np.zeros((P, C), bool),
        in_capacity=np.ones((P, C), bool),
        weights=None,
        touched_aug=np.array([[-1, 3]], np.int32),  # score + replace, no probe
        part_of=np.zeros(8, np.int32),
        cand=np.array([[5, 6]], np.int32),
        node_weights=None,
    )
    kw = dict(cand_cap=4, threshold=float(pol_t))
    out = ref.fused_frontier_step(*[_torch(a) for a in args.values()], **kw)
    oracle = jref.fused_frontier_step(*args.values(), None, None, None, **kw)
    _assert_same(out, oracle, "threshold")
    # slot 0 decays to exactly 0.95 and stays; slot 1 goes stale and is replaced
    assert out[0].tolist() == [[3, 5]]


def test_frontier_dedup_matches_reference():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 20, size=(3, 30)), axis=1)
    rem = rng.random((3, 30)) < 0.5
    for a, b in zip(ref.frontier_dedup(keys, rem), jref.frontier_dedup(keys, rem)):
        np.testing.assert_array_equal(a, b)
    first, remote = ref.frontier_dedup(keys)
    assert remote is None and first[:, 0].all()


def test_cpu_route_launches_nothing():
    sc = SCENARIOS[0]
    before = dict(native.LAUNCHES)
    ops.fused_frontier_step_batch(
        *[_torch(a) for a in sc.arrays().values()],
        cand_cap=sc.cand_cap, **sc.constants,
    )
    assert native.LAUNCHES == before


def test_other_devices_raise():
    sc = SCENARIOS[0]
    args = [
        None if a is None else _torch(a).to("meta") for a in sc.arrays().values()
    ]
    with pytest.raises(ValueError, match="no fused_frontier_step kernel"):
        ops.fused_frontier_step_batch(*args, cand_cap=sc.cand_cap)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: given CPU
    tensors it raises before building anything."""
    from repro_torch.kernels.fused_step import fused_frontier_step_cuda

    sc = SCENARIOS[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_frontier_step_cuda(
            *[_torch(a) for a in sc.arrays().values()],
            cand_cap=sc.cand_cap, **sc.constants,
        )


def test_id_codec_matches_reference():
    from repro.kernels import ops as jops

    for name in ("INT32_SENTINEL", "INT32_ID_MAX", "WIDE_ID_MAX"):
        assert getattr(ops, name) == getattr(jops, name), name
    assert (ops.WIDE_SHIFT, ops.WIDE_MASK) == (jref.WIDE_SHIFT, jref.WIDE_MASK)
    ids = np.array([-2, -1, 0, 5, 2**31 - 2, 2**40 + 3, ops.WIDE_ID_MAX], np.int64)
    for a, b in zip(ops.split_ids(ids), jops.split_ids(ids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ops.join_ids(*ops.split_ids(ids)), ids)
    for v in (0, ops.INT32_ID_MAX, ops.INT32_SENTINEL, ops.WIDE_ID_MAX, ops.WIDE_ID_MAX + 1):
        assert ops.int32_id_eligible(v) == jops.int32_id_eligible(v)
        assert ops.wide_id_eligible(v) == jops.wide_id_eligible(v)


# --------------------------------------------------------------------------- #
# The kernels' count sort and miss compaction, as plain twins.
@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_count_sort_matches_sort_and_reference_prologue(sc):
    """``ref.frontier_count_sort`` (the kernels' count sort over the local
    ids) gives ``torch.sort``'s keys and the reference prologue's keys and
    unique-remote mask; ``ref.compact_misses`` (a ``cumsum`` of the miss
    flags) gives the step's ``cand_next``."""
    aug, part_of = _torch(sc.touched_aug), _torch(sc.part_of)
    sk, remote = ref.frontier_count_sort(aug, part_of)
    np.testing.assert_array_equal(sk.numpy(), torch.sort(aug[:, :-1], dim=1).values.numpy())
    want = jref.frontier_prologue(sc.touched_aug, sc.part_of)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(remote.numpy(), np.asarray(want[6]))
    out = ref.fused_frontier_step(
        *[_torch(a) for a in sc.arrays().values()], cand_cap=sc.cand_cap, **sc.constants
    )
    Mt = sc.touched_aug.shape[1] - 1
    packed = out[7]
    np.testing.assert_array_equal(packed[:, :Mt].numpy(), sk.numpy())
    cand_next = ref.compact_misses(packed[:, :Mt], packed[:, Mt : 2 * Mt], cand_cap=sc.cand_cap)
    np.testing.assert_array_equal(cand_next.numpy(), out[6].numpy())


def test_new_scenarios_cover_padding_and_hubs():
    by = {s.name: s for s in SCENARIOS}
    keys = by["neg-padding"].touched_aug[:, :-1]
    assert {-1, -2, -7} <= set(np.unique(keys[keys < 0]).tolist())
    hub = by["hub-row"].touched_aug[1, :-1]
    assert np.bincount(hub[hub >= 0]).max() >= 4096


# --------------------------------------------------------------------------- #
# The @given twin of the reference's frontier property
# (tests/test_frontier_step.py::TestFrontierProperties): rotated raw
# launches of the port's DeviceEngine on the CPU against the port's staged
# pipeline (host dedup feeding the numpy engine).
def _host_dedup(frontier, part_of):
    remote = []
    for p in range(frontier.shape[0]):
        u = np.unique(frontier[p].astype(np.int64))
        u = u[u >= 0]
        remote.append(u[part_of[u] != p])
    return remote


def _check_frontier_vs_staged(seed, P, steps, dtype, special_rows, feature_dim, n_nodes=300):
    from repro_torch.runtime import engine as teng
    from repro_torch.store import FeatureStore

    rng = np.random.default_rng(seed)
    caps = [int(x) for x in rng.integers(1, 10, size=P)]
    if P > 1:
        caps[0] = 0  # zero-capacity PE rides along
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    store = None
    if feature_dim:
        feats = rng.random((n_nodes, feature_dim)).astype(np.float32)
        store = FeatureStore(feats, part_of, num_parts=P, backend="numpy", device="cpu")
    eng = teng.PrefetchEngine(caps, feature_dim=feature_dim, device="cpu")
    for p in range(P):
        ids = rng.choice(n_nodes, size=int(rng.integers(0, 6)), replace=False)
        eng.insert(p, ids.astype(np.int64))
        if store is not None and len(eng.last_slots[p]):
            eng.place_rows(p, eng.last_slots[p], store.gather(eng.ids[p][eng.last_slots[p]]))
    dev = teng.DeviceEngine(copy.deepcopy(eng), device="cpu", part_of=part_of)
    if store is not None:
        dev.attach_store(store)
    uses_buffer = rng.random(P) > 0.2
    active = uses_buffer & (eng.capacity > 0)
    frontiers = []
    for _ in range(steps):
        Mt = int(rng.integers(1, 16))
        f = rng.integers(0, n_nodes, size=(P, Mt))
        f[rng.random((P, Mt)) < 0.2] = -1
        for p, kind in special_rows:
            if p < P:
                f[p, :] = -1 if kind == "empty" else f[p, 0]
        frontiers.append(f.astype(dtype))
    decisions = [rng.random(P) > 0.4 for _ in range(steps)]

    staged_remote, staged_hits, prev_missed = [], [], [np.array([], np.int64)] * P
    for t in range(steps):
        remote = _host_dedup(frontiers[t], part_of)
        staged_remote.append(remote)
        hm, missed = eng.lookup(remote, active)
        staged_hits.append([m.copy() for m in hm])
        eng.end_round(uses_buffer)
        eng.replace_round(prev_missed, decisions[t] & uses_buffer)
        if store is not None:
            for p in range(P):
                if len(eng.last_placed[p]):
                    eng.place_rows(p, eng.last_slots[p], store.gather(eng.last_placed[p]))
        prev_missed = missed

    zeros = np.zeros(P, dtype=bool)
    out = dev.fused_step_raw(frontiers[0], zeros, zeros, active)
    fused_remote, fused_hits = [out.remote], [out.hit_masks]
    for t in range(steps):
        nf = frontiers[t + 1] if t + 1 < steps else np.full((P, 0), -1, dtype=dtype)
        out = dev.fused_step_raw(nf, uses_buffer, decisions[t] & uses_buffer, active)
        if t + 1 < steps:
            fused_remote.append(out.remote)
            fused_hits.append(out.hit_masks)
    for t in range(steps):
        for p in range(P):
            np.testing.assert_array_equal(staged_remote[t][p], fused_remote[t][p])
            np.testing.assert_array_equal(staged_hits[t][p], fused_hits[t][p])
    synced = dev.sync_to_engine()
    for name in ("ids", "scores", "valid", "accessed"):
        np.testing.assert_array_equal(getattr(eng, name), getattr(synced, name), err_msg=name)
    for name in ("lookups", "hits", "misses", "replaced_total", "replacement_rounds",
                 "skipped_rounds"):
        np.testing.assert_array_equal(
            getattr(eng.stats, name), getattr(dev.stats, name), err_msg=name
        )
    if store is not None:
        np.testing.assert_array_equal(eng.payload, synced.payload)


@st.composite
def _frontier_cases(draw):
    P = draw(st.integers(min_value=1, max_value=5))
    specials = draw(st.lists(
        st.tuples(st.integers(min_value=0, max_value=P - 1),
                  st.sampled_from(["empty", "dup"])),
        max_size=2,
    ))
    return (
        draw(st.integers(min_value=0, max_value=2**31 - 1)),
        P,
        draw(st.integers(min_value=1, max_value=5)),
        draw(st.sampled_from([np.int32, np.int64])),
        tuple(specials),
        draw(st.sampled_from([0, 4])),
    )


@settings(max_examples=15, deadline=None)
@given(data=_frontier_cases())
def test_raw_matches_staged_pipeline(data):
    seed, P, steps, dtype, specials, fdim = data
    _check_frontier_vs_staged(seed, P, steps, dtype, specials, fdim)
