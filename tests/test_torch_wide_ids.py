"""Wide ids in the port, against the reference package.

Graphs whose global ids sit at an ``id_base`` (``Graph.rebase``) or pass
``2**31 - 2`` run the reference's device loops in wide mode, with ids as
``(hi, lo)`` int32 word planes; the port carries them as int64. Checked
here, on the CPU:

* the port's plain ``fused_frontier_step_wide`` / ``fused_step_wide``
  (the specs of the wide CUDA entries) against the reference's jnp
  oracles through ``split_ids`` / ``join_ids``, on every seeded wide
  scenario (``kernels/scenarios.py``), and against the reference's Pallas
  twins in interpret mode on a few;
* every wide scenario against its narrow source under the id map (the
  base shift);
* the dispatcher's int64 routing and the eligibility ``ValueError`` past
  ``WIDE_ID_MAX``, at the points where the reference raises;
* ``DeviceEngine`` wide rotations, raw and ragged, with a payload and
  degree weights, against ``repro``'s ``DeviceEngine(backend="jnp")``;
* whole trainers on ``products`` rebased to ``BASE``, against the
  reference's ``device="jnp"`` wide run and against the port's narrow run
  with id streams shifted by ``BASE``; the traced run's arrays likewise.

Also the kernels' count sort and cumsum miss compaction as plain twins
(``ref.frontier_count_sort``, ``ref.compact_misses``) on every wide
frontier set, and the ``@given`` twin of the reference's base-shift
property.

Tolerance: none — every stream, id and state array is bit-identical
(scores compared as their bit patterns); the trainers here run without
the GNN step, so there are no losses.
"""

import copy

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime import engine as jeng
from repro_torch.core import scoring
from repro_torch.gnn import DistributedTrainer
from repro_torch.graph import generate, partition_graph
from repro_torch.kernels import ops, ref, scenarios
from repro_torch.runtime import engine as teng
from repro_torch.store import FeatureStore

BASE = scenarios.BASE
FRONTIER = scenarios.wide_frontier_scenarios()
STEPS = scenarios.wide_fused_step_scenarios()
PALLAS_FRONTIER = ("rudder-u@", "degree-w@", "drained-Mt1@", "empty-and-dup-rows@")
PALLAS_STEPS = ("rudder-u@base", "degree-w@base", "dup-cand@sparse", "degree-w@top")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


# --------------------------------------------------------------------------- #
# The plain versions against the reference's wide oracles and Pallas twins.
def _port_frontier(sc, view=(None, None, None)):
    args = [_t(a) for a in sc.arrays().values()] + [_t(v) for v in view]
    return ops.fused_frontier_step_wide_batch(*args, **sc.kwargs())


def _ref_frontier(sc, view=(None, None, None), backend="jnp"):
    ids_hi, ids_lo = jops.split_ids(sc.ids)
    c_hi, c_lo = jops.split_ids(sc.cand)
    t_hi, t_lo = jops.split_ids(sc.touched_aug[:, :-1])
    aug = np.concatenate([t_lo, t_hi, sc.touched_aug[:, -1:].astype(np.int32)], axis=1)
    return jops.fused_frontier_step_wide_batch(
        ids_lo, ids_hi, sc.scores, sc.valid, sc.accessed, sc.in_capacity,
        sc.weights, aug, sc.part_of, c_lo, c_hi, sc.node_weights, *view,
        backend=backend, **sc.kwargs(),
    )


def _assert_frontier_same(got, want, sc, what):
    """Port 9-tuple vs reference 11-tuple (ids as planes, packed as
    ``[sk_hi | sk_lo | code | ...]`` against the port's int32 pairs)."""
    name = f"{sc.name} {what}"
    _eq(got[0], jops.join_ids(np.asarray(want[1]), np.asarray(want[0])), f"{name} ids2")
    for i, j, f in ((1, 2, "scores2"), (2, 3, "valid2"), (3, 4, "accessed3"),
                    (4, 5, "weights2"), (5, 6, "payload2"), (8, 10, "counters")):
        _eq(got[i], want[j], f"{name} {f}")
    _eq(got[6], jops.join_ids(np.asarray(want[8]), np.asarray(want[7])), f"{name} cand_next")
    Mt = sc.touched_aug.shape[1] - 1
    packed, wp = got[7].numpy(), np.asarray(want[9])
    assert packed.dtype == np.int32 and packed.shape == wp.shape
    sk = np.ascontiguousarray(packed[:, : 2 * Mt]).view(np.int64)
    _eq(sk, jops.join_ids(wp[:, :Mt], wp[:, Mt : 2 * Mt]), f"{name} packed keys")
    _eq(packed[:, 2 * Mt :], wp[:, 2 * Mt :], f"{name} packed tail")


def _store_view(sc):
    P, C = sc.ids.shape
    N = sc.part_of.shape[0]
    rng = np.random.default_rng(7)
    return (
        rng.standard_normal((P * C, 5)).astype(np.float32),
        rng.standard_normal((N + 3, 5)).astype(np.float32),
        rng.permutation(N + 3)[:N].astype(np.int32),
    )


@pytest.mark.parametrize("sc", FRONTIER, ids=[s.name for s in FRONTIER])
def test_plain_frontier_matches_reference_oracle(sc):
    _assert_frontier_same(_port_frontier(sc), _ref_frontier(sc), sc, "oracle")
    if sc.name.startswith(("rudder-u@", "degree-w@", "drained-Mt1@")):
        view = _store_view(sc)
        _assert_frontier_same(
            _port_frontier(sc, view), _ref_frontier(sc, view), sc, "oracle + store"
        )


@pytest.mark.parametrize(
    "sc",
    [s for s in FRONTIER if s.name.startswith(PALLAS_FRONTIER)
     and s.id_base in (BASE, 2**32 + 2**30 - 20)],
    ids=lambda s: s.name,
)
def test_plain_frontier_matches_reference_pallas(sc):
    _assert_frontier_same(
        _port_frontier(sc), _ref_frontier(sc, backend="pallas"), sc, "Pallas"
    )


def _port_step(sc):
    args = [_t(a) for a in sc.arrays().values()]
    return ops.fused_step_wide_batch(
        *args, id_lo=sc.id_lo, num_ids=sc.num_ids, **sc.constants
    )


def _ref_step(sc, backend="jnp"):
    ih, il = jops.split_ids(sc.ids)
    qh, ql = jops.split_ids(sc.queries)
    ch, cl = jops.split_ids(sc.cand)
    return jops.fused_step_wide_batch(
        il, ih, sc.scores, sc.valid, sc.accessed, sc.in_capacity, sc.weights,
        ql, qh, cl, ch, sc.cand_weights, sc.active_score, sc.do_replace,
        sc.active_probe, backend=backend, **sc.constants,
    )


def _assert_step_same(got, want, sc, what):
    _eq(got[0], jops.join_ids(np.asarray(want[1]), np.asarray(want[0])), f"{sc.name} {what} ids2")
    for i in range(1, 11):
        _eq(got[i], want[i + 1], f"{sc.name} {what} output {i}")


@pytest.mark.parametrize("sc", STEPS, ids=[s.name for s in STEPS])
def test_plain_fused_step_matches_reference_oracle(sc):
    _assert_step_same(_port_step(sc), _ref_step(sc), sc, "oracle")


@pytest.mark.parametrize(
    "sc", [s for s in STEPS if s.name in PALLAS_STEPS], ids=lambda s: s.name
)
def test_plain_fused_step_matches_reference_pallas(sc):
    _assert_step_same(_port_step(sc), _ref_step(sc, backend="pallas"), sc, "Pallas")


# --------------------------------------------------------------------------- #
# Base shift: wide on lifted ids == narrow, lifted.
@pytest.mark.parametrize("sc", FRONTIER, ids=[s.name for s in FRONTIER])
def test_wide_frontier_is_the_lifted_narrow_step(sc):
    n = sc.narrow
    narrow = ops.fused_frontier_step_batch(
        *[_t(a) for a in n.arrays().values()], **n.kwargs()
    )
    wide = _port_frontier(sc)
    ids_of = np.int64(sc.id_base) + np.arange(sc.part_of.shape[0], dtype=np.int64)
    for i in (0, 6):  # ids2, cand_next
        _eq(wide[i], scenarios.lift(narrow[i].numpy(), ids_of), f"{sc.name} {i}")
    for i in (1, 2, 3, 4, 8):
        _eq(wide[i], narrow[i], f"{sc.name} {i}")
    Mt = n.touched_aug.shape[1] - 1
    packed = wide[7].numpy()
    sk = np.ascontiguousarray(packed[:, : 2 * Mt]).view(np.int64)
    _eq(sk, scenarios.lift(narrow[7][:, :Mt].numpy(), ids_of), f"{sc.name} keys")
    _eq(packed[:, 2 * Mt :], narrow[7][:, Mt:], f"{sc.name} packed tail")


@pytest.mark.parametrize("sc", STEPS, ids=[s.name for s in STEPS])
def test_wide_fused_step_is_the_lifted_narrow_step(sc):
    n = sc.narrow
    narrow = ops.fused_step_batch(
        *[_t(a) for a in n.arrays().values()], num_ids=n.num_ids, **n.constants
    )
    wide = _port_step(sc)
    _eq(wide[0], scenarios.lift(narrow[0].numpy(), sc.ids_of), f"{sc.name} ids2")
    for i in range(1, 11):
        _eq(wide[i], narrow[i], f"{sc.name} output {i}")


def test_scenarios_cover_the_wide_edge_cases():
    bases = {s.id_base for s in FRONTIER}
    assert BASE in bases and any(b > 2**32 for b in bases)
    # ids cross a 2**30 word boundary of the reference's (hi, lo) split
    crossing = next(s for s in FRONTIER if s.id_base == 2**32 + 2**30 - 20)
    hi, _ = jops.split_ids(crossing.touched_aug[:, :-1])
    assert len(np.unique(hi[hi >= 0])) == 2
    top = [s for s in FRONTIER + STEPS if s.ids.max() == ops.WIDE_ID_MAX
           or s.cand.max() == ops.WIDE_ID_MAX or (
               hasattr(s, "queries") and s.queries.max() == ops.WIDE_ID_MAX)]
    assert len(top) >= 1
    assert any(s.touched_aug[:, :-1].max() > ops.WIDE_ID_MAX - s.ids.shape[1]
               for s in FRONTIER)
    sparse = [s for s in STEPS if s.name.endswith("@sparse")]
    assert sparse and all(s.ids_of[-1] - s.ids_of[0] == 2**40 for s in sparse)
    for s in FRONTIER + STEPS:
        assert s.ids.dtype == np.int64 and s.cand.dtype == np.int64
        assert all(ops.wide_id_eligible(a.max()) for a in (s.ids, s.cand))


@pytest.mark.parametrize("sc", FRONTIER, ids=[s.name for s in FRONTIER])
def test_count_sort_matches_sort_and_reference_prologue(sc):
    """The kernels' count sort over ``id - id_base`` (its plain twin
    ``ref.frontier_count_sort``) gives ``torch.sort``'s keys and the
    reference wide prologue's ``(hi, lo)`` keys and unique-remote mask;
    ``ref.compact_misses`` gives the step's ``cand_next``."""
    aug, part_of = _t(sc.touched_aug), _t(sc.part_of)
    sk, remote = ref.frontier_count_sort(aug, part_of, id_base=sc.id_base)
    _eq(sk, torch.sort(aug[:, :-1], dim=1).values, f"{sc.name} sort")
    t_hi, t_lo = jops.split_ids(sc.touched_aug[:, :-1])
    planes = np.concatenate([t_lo, t_hi, sc.touched_aug[:, -1:].astype(np.int32)], axis=1)
    want = jref.frontier_prologue_wide(planes, sc.part_of, id_base=sc.id_base)
    _eq(sk, jops.join_ids(np.asarray(want[4]), np.asarray(want[3])), f"{sc.name} keys")
    _eq(remote, want[-1], f"{sc.name} remote")
    out = _port_frontier(sc)
    Mt = sc.touched_aug.shape[1] - 1
    keys = out[7][:, : 2 * Mt].contiguous().view(torch.int64)
    _eq(keys, sk, f"{sc.name} packed keys")
    cand_next = ref.compact_misses(
        keys, out[7][:, 2 * Mt : 3 * Mt], cand_cap=sc.cand_cap, id_base=sc.id_base
    )
    _eq(cand_next, out[6], f"{sc.name} cand_next")


def test_wide_sets_include_an_odd_packed_stride():
    odd = [s for s in FRONTIER if s.name.startswith("odd-stride")]
    assert odd
    for s in odd:
        Mt = s.touched_aug.shape[1] - 1
        assert (3 * Mt + s.cand.shape[1] + s.ids.shape[1] + 1) % 2 == 1


# --------------------------------------------------------------------------- #
# The @given twin of the reference's base-shift property
# (tests/test_wide_ids.py::TestWideHypothesis): the port's fused step on
# ids shifted past 2^31 equals the narrow step, and the reference's jnp
# oracle on the shifted ids.
@settings(max_examples=15, deadline=None)
@given(
    P=st.integers(min_value=1, max_value=3),
    C=st.integers(min_value=1, max_value=5),
    M=st.integers(min_value=1, max_value=5),
    seed=st.integers(min_value=0, max_value=2**16),
    base=st.sampled_from([2**31, 2**31 + 1000, 2**40, 2**55 + 3]),
)
def test_base_shift_invariance(P, C, M, seed, base):
    rng = np.random.default_rng(seed)
    # Resident ids unique per PE, as the engine keeps them.
    ids = np.stack([rng.choice(50, C, replace=False) for _ in range(P)]).astype(np.int64)
    valid = rng.random((P, C)) < 0.7
    ids[~valid] = -1
    scores = (rng.random((P, C)) * 2).astype(np.float32)
    accessed = rng.random((P, C)) < 0.4
    in_cap = np.ones((P, C), bool)
    q = rng.integers(0, 50, (P, M)).astype(np.int64)
    c = rng.integers(0, 50, (P, M)).astype(np.int64)
    gates = tuple(rng.random(P) < 0.8 for _ in range(3))

    def run(i, qq, cc):
        return ops.fused_step_batch(
            _t(i), _t(scores), _t(valid), _t(accessed), _t(in_cap), None,
            _t(qq), _t(cc), None, *[_t(g) for g in gates], num_ids=50,
        )

    shifted = np.where(ids >= 0, ids + base, ids)
    narrow = run(ids, q, c)
    big = run(shifted, q + base, c + base)
    n_ids = narrow[0].numpy().astype(np.int64)
    _eq(big[0], np.where(n_ids >= 0, n_ids + base, -1), "ids2")
    for i in range(1, 11):
        _eq(big[i], narrow[i], f"output {i}")
    want = jops.fused_step_batch(
        shifted, scores, valid, accessed, in_cap, None, q + base, c + base, None, *gates
    )
    for i in range(11):
        _eq(big[i], want[i], f"reference output {i}")


# --------------------------------------------------------------------------- #
# The dispatcher's routing and the eligibility bound.
def test_fused_step_batch_routes_big_ids_wide():
    """Ids past 2^31 run the wide step and give the shifted narrow
    streams, as the reference's dispatcher does on both its backends."""
    P, C, M = 2, 4, 3
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (P, C)).astype(np.int64)
    q = rng.integers(0, 100, (P, M)).astype(np.int64)
    c = rng.integers(0, 100, (P, M)).astype(np.int64)
    state = (np.ones((P, C), np.float32), np.ones((P, C), bool),
             np.zeros((P, C), bool), np.ones((P, C), bool))
    gate = np.ones(P, bool)

    def run(i, qq, cc):
        return ops.fused_step_batch(
            _t(i), *[_t(a) for a in state], None, _t(qq), _t(cc), None,
            *[_t(gate)] * 3, num_ids=100,
        )

    narrow = run(ids, q, c)
    big = run(ids + BASE, q + BASE, c + BASE)
    assert narrow[0].dtype == torch.int32 and big[0].dtype == torch.int64
    _eq(big[0], narrow[0].numpy().astype(np.int64) + BASE, "ids2")
    for i in range(1, 11):
        _eq(big[i], narrow[i], f"output {i}")
    want = jops.fused_step_batch(
        ids + BASE, *state, None, q + BASE, c + BASE, None, gate, gate, gate
    )
    for i in range(11):
        _eq(big[i], want[i], f"reference output {i}")


def test_fused_step_batch_beyond_wide_bound_raises():
    sc = next(s for s in STEPS if s.name == "rudder-u@base")
    args = [_t(a) for a in sc.arrays().values()]
    args[6] = torch.full_like(args[6], ops.WIDE_ID_MAX + 1)
    with pytest.raises(ValueError, match="wide-id"):
        ops.fused_step_batch(*args, num_ids=0, **sc.constants)


def test_device_engine_rejects_beyond_wide_bound():
    for mk in (jeng, teng):
        eng = mk.PrefetchEngine([4], id_base=ops.WIDE_ID_MAX + 1)
        with pytest.raises(ValueError, match="wide-id"):
            if mk is jeng:
                jeng.DeviceEngine(eng, backend="jnp")
            else:
                teng.DeviceEngine(eng, device="cpu")


def test_launches_beyond_wide_bound_raise():
    """Per launch, as the reference's ``fused_step`` and
    ``fused_step_raw`` do."""
    dev = teng.DeviceEngine(
        teng.PrefetchEngine([4, 4], id_base=BASE), device="cpu",
        part_of=np.zeros(10, np.int64),
    )
    assert dev.wide
    on = np.ones(2, dtype=bool)
    big = np.array([ops.WIDE_ID_MAX + 1], dtype=np.int64)
    empty = [np.array([], np.int64)] * 2
    with pytest.raises(ValueError, match="wide-id"):
        dev.fused_step([big, big], empty, on, on, on)
    with pytest.raises(ValueError, match="wide-id"):
        dev.fused_step_raw(np.full((2, 3), ops.WIDE_ID_MAX + 1, np.int64), on, on, on)
    with pytest.raises(ValueError, match="partition map"):
        dev.fused_step_raw(np.full((2, 3), BASE + 10, np.int64), on, on, on)
    with pytest.raises(ValueError, match="partition map"):
        dev.fused_step_raw(np.full((2, 3), BASE - 1, np.int64), on, on, on)


# --------------------------------------------------------------------------- #
# DeviceEngine in wide mode against the reference's.
def test_engine_auto_upgrades_to_wide_mode():
    assert teng.DeviceEngine(teng.PrefetchEngine([4, 4], id_base=BASE), device="cpu").wide
    assert not teng.DeviceEngine(teng.PrefetchEngine([4, 4]), device="cpu").wide
    eng = teng.PrefetchEngine([4])
    eng.insert(0, np.array([2**31], dtype=np.int64))  # past INT32_ID_MAX
    dev = teng.DeviceEngine(eng, device="cpu")
    assert dev.wide and dev._ids.dtype == torch.int64


def _wide_engines(seed, P, n_nodes, policy, feature_dim=0):
    rng = np.random.default_rng(seed)
    caps = [int(x) for x in rng.integers(1, 12, size=P)]
    caps[0] = 0
    pol = scoring.make_policy(policy)
    nw = (
        scoring.degree_weights(rng.integers(1, 50, size=n_nodes))
        if pol.use_weights
        else None
    )
    kw = dict(policy=policy, node_weights=nw, id_base=BASE, feature_dim=feature_dim)
    ref_eng, port_eng = jeng.PrefetchEngine(caps, **kw), teng.PrefetchEngine(caps, **kw)
    for p in range(P):
        ids = rng.choice(n_nodes, size=int(rng.integers(0, 8)), replace=False)
        ref_eng.insert(p, ids.astype(np.int64) + BASE)
        port_eng.insert(p, ids.astype(np.int64) + BASE)
    return rng, ref_eng, port_eng


FIELDS = ("hit_masks", "missed", "hits", "hit_slots", "replaced", "placed",
          "placed_slots", "n_valid")
STATE = ("ids", "scores", "valid", "accessed", "weights")
STATS = ("lookups", "hits", "misses", "replaced_total", "replacement_rounds",
         "skipped_rounds")


def _fields_equal(a, b, fields, what):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, list):
            assert len(x) == len(y), f"{what} {f}"
            for p, (u, v) in enumerate(zip(x, y)):
                np.testing.assert_array_equal(u, v, err_msg=f"{what} {f} PE {p}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


def _states_equal(port_dev, ref_dev, payload=False):
    ref_state, port_state = ref_dev.sync_to_engine(), port_dev.sync_to_engine()
    for f in STATE + (("payload",) if payload else ()):
        a, b = getattr(port_state, f), getattr(ref_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(port_dev.stats, f), getattr(ref_dev.stats, f), err_msg=f
        )


def _stores(P, n_nodes, part_of, F):
    from repro.store import FeatureStore as JStore

    feats = np.random.default_rng(7).standard_normal((n_nodes, F)).astype(np.float32)
    return (
        JStore(feats, part_of, P, backend="numpy", id_base=BASE),
        FeatureStore(feats, part_of, P, device="cpu", id_base=BASE),
    )


@pytest.mark.parametrize(
    "seed,policy,with_store",
    [(30, "rudder", False), (31, "degree", True), (32, "hybrid", True)],
)
def test_wide_raw_rotations_match_reference(seed, policy, with_store):
    """Rotated ``fused_step_raw`` launches over raw frontiers of global
    ids (-1 padding, an empty and an all-duplicate row, a zero-capacity
    PE); with a store, admission rows land in the payload in-launch."""
    P, n_nodes, steps, F = 4, 200, 6, 5
    rng, ref_eng, port_eng = _wide_engines(
        seed, P, n_nodes, policy, feature_dim=F if with_store else 0
    )
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
    ref_dev = jeng.DeviceEngine(copy.deepcopy(ref_eng), backend="jnp", part_of=part_of)
    port_dev = teng.DeviceEngine(port_eng, device="cpu", part_of=part_of)
    assert ref_dev.wide and port_dev.wide
    if with_store:
        jstore, tstore = _stores(P, n_nodes, part_of, F)
        ref_dev.attach_store(jstore)
        port_dev.attach_store(tstore)
    uses_buffer = rng.random(P) > 0.2
    active = uses_buffer & (ref_eng.capacity > 0)
    zeros = np.zeros(P, dtype=bool)
    frontiers = []
    for _ in range(steps):
        f = rng.integers(0, n_nodes, size=(P, 24)).astype(np.int64) + BASE
        f[rng.random(f.shape) < 0.2] = -1
        f[1] = -1
        f[2] = f[2, 0]
        frontiers.append(f)
    calls = [(frontiers[0], zeros, zeros, active)]
    for t in range(steps):
        nxt = frontiers[t + 1] if t + 1 < steps else np.full((P, 0), -1, np.int64)
        calls.append((nxt, uses_buffer, (rng.random(P) > 0.3) & uses_buffer, active))
    for i, args in enumerate(calls):
        want, got = ref_dev.fused_step_raw(*args), port_dev.fused_step_raw(*args)
        _fields_equal(got, want, FIELDS + ("remote", "n_remote"), f"launch {i}")
        if with_store:
            np.testing.assert_array_equal(
                port_dev.payload.numpy(), np.asarray(ref_dev.payload)
            )
    assert int(port_dev.stats.replaced_total.sum()) > 0
    assert port_dev.transfers["h2d"] == port_dev.transfers["d2h"] == len(calls)
    # The packed readback has the reference's wide width; the upload is
    # an int64 block with an int64 gate column, one int32 word per PE
    # wider than the reference's [lo | hi | gates] int32 block.
    for k in ("h2d", "d2h", "d2h_bytes"):
        assert port_dev.transfers[k] == ref_dev.transfers[k], k
    assert port_dev.transfers["h2d_bytes"] == ref_dev.transfers["h2d_bytes"] + 4 * P * len(calls)
    _states_equal(port_dev, ref_dev, payload=with_store)


@pytest.mark.parametrize(
    "seed,policy,with_store",
    [(40, "rudder", False), (41, "degree", True), (42, "frequency", True)],
)
def test_wide_ragged_rotations_match_reference(seed, policy, with_store):
    """The ragged loop's launches on global ids: host-deduped query sets,
    the previous round's misses (with repeats) as candidates; with a
    store, ``place_rows_batch`` and ``pull_rows``. One flat upload per
    launch, ids as int32 word pairs."""
    P, n_nodes, steps, F = 4, 200, 6, 5
    rng, ref_eng, port_eng = _wide_engines(
        seed, P, n_nodes, policy, feature_dim=F if with_store else 0
    )
    part_of = rng.integers(0, P, size=n_nodes).astype(np.int64)
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
            np.unique(rng.integers(0, n_nodes, size=int(rng.integers(0, 25)))) + BASE
            for _ in range(P)
        ]
        if t == 0:
            args = (queries, [np.array([], np.int64)] * P, zeros, zeros, active)
        else:
            args = (queries, prev, uses_buffer, (rng.random(P) > 0.3) & uses_buffer, active)
        want, got = ref_dev.fused_step(*args), port_dev.fused_step(*args)
        _fields_equal(got, want, FIELDS, f"launch {t}")
        prev = [np.concatenate([m, m[:2]]) for m in want.missed]
        if with_store:
            for dev, store in ((ref_dev, jstore), (port_dev, tstore)):
                g = store.gather_batch(dev.last_placed, device=True)
                dev.place_rows_batch(dev.last_slots, g.blocks, device_block=g.device_block)
            for a, b in zip(port_dev.pull_rows(got.hit_slots), ref_dev.pull_rows(want.hit_slots)):
                np.testing.assert_array_equal(a, b)
    assert port_dev.transfers["h2d"] == steps + 1
    assert port_dev.transfers["d2h"] == ref_dev.transfers["d2h"]
    _states_equal(port_dev, ref_dev, payload=with_store)


def test_wide_ragged_matches_narrow_shifted():
    """The reference's own wide engine check: the same launches on ids
    and on ids + BASE give shifted misses and equal masks and state."""
    empty = np.array([], dtype=np.int64)
    seed_n = np.array([3, 5, 9], dtype=np.int64)
    narrow_eng = teng.PrefetchEngine([4, 4], policy="frequency")
    wide_eng = teng.PrefetchEngine([4, 4], policy="frequency", id_base=BASE)
    for p in range(2):
        narrow_eng.insert(p, seed_n)
        wide_eng.insert(p, seed_n + BASE)
    dev_n = teng.DeviceEngine(narrow_eng, device="cpu")
    dev_w = teng.DeviceEngine(wide_eng, device="cpu")
    on = np.ones(2, bool)
    q = [np.array([3, 7], dtype=np.int64), empty]
    c = [np.array([7, 11], dtype=np.int64), np.array([2], dtype=np.int64)]
    out_n = dev_n.fused_step(q, c, on, on, on)
    out_w = dev_w.fused_step([x + BASE for x in q], [x + BASE for x in c], on, on, on)
    for p in range(2):
        np.testing.assert_array_equal(out_w.missed[p], out_n.missed[p] + BASE)
        np.testing.assert_array_equal(out_w.hit_masks[p], out_n.hit_masks[p])
    np.testing.assert_array_equal(out_w.replaced, out_n.replaced)
    host_n, host_w = dev_n.sync_to_engine(), dev_w.sync_to_engine()
    shifted = host_n.ids.copy()
    shifted[shifted >= 0] += BASE
    np.testing.assert_array_equal(host_w.ids, shifted)
    np.testing.assert_array_equal(host_w.valid, host_n.valid)
    np.testing.assert_array_equal(host_w.scores, host_n.scores)


# --------------------------------------------------------------------------- #
# Whole trainers on a rebased graph.
TRAIN_COMMON = dict(
    epochs=1, batch_size=16, fanouts=(3, 5), train_model=False,
    buffer_frac=0.25, interval=4,
)


@pytest.fixture(scope="module")
def graphs():
    return (
        jgraph.generate("products", seed=0, scale=0.05),
        generate("products", seed=0, scale=0.05),
    )


def _digest(result, store=False):
    out = [
        (log.pct_hits, log.comm_volume, log.comm_missed, log.occupancy,
         log.unique_remote, log.replaced, log.decisions, log.step_time)
        for log in result.logs
    ]
    if store:
        out += [(log.feat_sums, log.bytes_measured, log.bytes_modeled)
                for log in result.logs]
    return out


def _runs(graphs, store=False, **kw):
    """Reference wide (device="jnp"), port wide and port narrow runs."""
    jg, tg = graphs
    kw = dict(TRAIN_COMMON, **kw)
    jkw, tkw, nkw = dict(kw), dict(kw), dict(kw)
    if store:
        from repro.store import FeatureStore as JStore

        jparts = jgraph.partition_graph(jg.rebase(BASE), 2)
        tparts = partition_graph(tg.rebase(BASE), 2)
        nparts = partition_graph(tg, 2)
        jkw["feature_store"] = JStore.for_partitions(jparts, backend="numpy")
        tkw["feature_store"] = FeatureStore.for_partitions(tparts, device="cpu", use_kernel=True)
        nkw["feature_store"] = FeatureStore.for_partitions(nparts, device="cpu", use_kernel=True)
    else:
        jparts = jgraph.partition_graph(jg.rebase(BASE), 2)
        tparts = partition_graph(tg.rebase(BASE), 2)
        nparts = partition_graph(tg, 2)
    ref = jgnn.DistributedTrainer(jparts, device="jnp", **jkw)
    wide = DistributedTrainer(tparts, device="cpu", **tkw)
    narrow = DistributedTrainer(nparts, device="cpu", **nkw)
    return (ref, ref.run()), (wide, wide.run()), (narrow, narrow.run())


@pytest.mark.parametrize("variant", ["distdgl", "fixed", "massivegnn", "rudder"])
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_trainer_streams_match_reference_wide(graphs, variant, mode):
    kw = dict(variant=variant, mode=mode)
    if variant == "rudder":
        kw["deciders"] = ["gemma3-4b"]
    (rt, rr), (wt, wr), (_nt, nr) = _runs(graphs, **kw)
    assert wt.last_device_engine.wide and wt.last_device_engine._ids.dtype == torch.int64
    assert _digest(wr) == _digest(rr) == _digest(nr)
    for f in STATS:
        np.testing.assert_array_equal(
            getattr(wt.engine.stats, f), getattr(rt.engine.stats, f), err_msg=f
        )
    for f in STATE:
        np.testing.assert_array_equal(getattr(wt.engine, f), getattr(rt.engine, f), err_msg=f)
    steps = wt.epochs * wt.mb_per_epoch
    assert wt.last_device_engine.transfers["h2d"] == steps + 1


def test_degree_policy_weights_rebase_end_to_end(graphs):
    (rt, rr), (wt, wr), (_nt, nr) = _runs(graphs, variant="fixed", policy="degree")
    assert _digest(wr) == _digest(rr) == _digest(nr)
    np.testing.assert_array_equal(wt.engine.weights, rt.engine.weights)


def test_store_enabled_ragged_run_rebased(graphs):
    """Batch 48 against local train sets of 44 and 52 nodes: ragged seed
    blocks, the wide ``fused_step``, and the store's rows by global id."""
    from repro_torch.runtime import driver

    (rt, rr), (wt, wr), (_nt, nr) = _runs(
        graphs, store=True, variant="massivegnn", batch_size=48
    )
    assert not driver._device_raw_supported(wt)
    assert _digest(wr, True) == _digest(rr, True) == _digest(nr, True)
    np.testing.assert_array_equal(wt.engine.payload, rt.engine.payload)
    assert wr.total_bytes_measured == wr.total_bytes_modeled > 0


def test_trace_arrays_match_reference_and_narrow(graphs):
    """A traced run above 2^31 reproduces the reference's wide trace and
    the port's narrow trace array for array, the prefetch plane's id
    streams exactly BASE higher (the per-home pair matrices exercise the
    part_of rebase)."""
    (_rt, rr), (_wt, wr), (_nt, nr) = _runs(graphs, variant="massivegnn", trace=True)
    tn, tw, tj = nr.trace, wr.trace, rr.trace
    assert set(tn.arrays) == set(tw.arrays) == set(tj.arrays)
    shifted = {"remote_flat", "miss_ids_flat", "placed_ids_flat"}
    for name in tn.arrays:
        a, b = np.asarray(tn.arrays[name]), np.asarray(tw.arrays[name])
        np.testing.assert_array_equal(a + BASE if name in shifted else a, b, err_msg=name)
        np.testing.assert_array_equal(b, np.asarray(tj.arrays[name]), err_msg=name)
    assert tw.exact_digest() == tj.exact_digest()


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_sample_stage_emits_global_int64_ids(graphs, ragged):
    """Both sampling paths of a rebased graph hand the device global ids:
    the raw ``(P, Mt)`` block and the host-deduped remote sets are int64
    and exactly BASE above the narrow graph's, with the same RNG draws."""
    from repro_torch.graph import SamplerPlane

    _, tg = graphs
    narrow_parts, wide_parts = partition_graph(tg, 2), partition_graph(tg.rebase(BASE), 2)
    seeds = [tg.train_nodes[:16], tg.train_nodes[16 : (24 if ragged else 32)]]
    outs = []
    for parts in (narrow_parts, wide_parts):
        plane = SamplerPlane(parts.graph, (3, 5))
        _, remote = plane.sample_all(seeds, np.random.default_rng(1), part_of=parts.part_of)
        touched = None
        if not ragged:
            _, touched = plane.sample_all_raw(seeds, np.random.default_rng(1))
        outs.append((remote, touched))
    (rn, tn), (rw, tw) = outs
    for a, b in zip(rn, rw):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(a.astype(np.int64) + BASE, b)
    if not ragged:
        assert tw.dtype == np.int64
        np.testing.assert_array_equal(tn.astype(np.int64) + BASE, tw)
