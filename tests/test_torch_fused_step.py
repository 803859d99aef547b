"""The port's plain ``fused_step`` against the reference package.

``repro_torch.kernels.ref.fused_step`` is the spec the Hopper kernel
``csrc/fused_step.cu`` is held to on the card. Here, on the CPU, it is held
bit for bit (tolerance: none; scores compared as their int32 bit patterns)
against the reference's jnp oracle (``repro.kernels.ref.fused_step``) and
its Pallas kernel in interpret mode, over the seeded scenario set that
``chip_smoke.py`` also runs on the card: all five scoring policies,
weighted and unweighted, empty query and candidate rows, all-duplicate
candidates, candidates already resident, every gate off, capacity-masked
slots and scores on the stale threshold.
"""

import copy

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels.fused_step import fused_step_pallas
from repro_torch.kernels import native, ops, scenarios
from repro_torch.runtime.engine import PrefetchEngine

SCENARIOS = scenarios.fused_step_scenarios()
OUT_NAMES = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "hit", "hit_slot",
    "placed", "slot_pos", "n_placed", "n_valid",
)


def _torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _run(sc):
    return ops.fused_step_batch(
        *[_torch(a) for a in sc.arrays().values()],
        num_ids=sc.num_ids, **sc.constants,
    )


def _assert_same(got, want, what):
    assert len(got) == len(want) == len(OUT_NAMES)
    for name, a, b in zip(OUT_NAMES, got, want):
        if a is None or b is None:
            assert a is None and b is None, f"{what}: {name}"
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape, f"{what}: {name} {a.shape} vs {b.shape}"
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_plain_matches_oracle_and_pallas(sc):
    arr = sc.arrays()
    got = _run(sc)
    _assert_same(got, jref.fused_step(*arr.values(), **sc.constants), f"{sc.name} oracle")
    _assert_same(
        got,
        fused_step_pallas(*arr.values(), interpret=True, **sc.constants),
        f"{sc.name} Pallas",
    )


def test_scenarios_cover_the_edge_cases():
    by = {s.name: s for s in SCENARIOS}
    for policy in scenarios.POLICIES:
        assert by[f"{policy}-u"].weights is None
        assert by[f"{policy}-w"].cand_weights is not None
    assert (by["empty-rows"].queries[0] == -1).all()
    assert (by["empty-rows"].cand[0] == -1).all()
    dup = by["dup-cand"].cand[-1]
    assert (dup == dup[0]).all()
    res = by["resident-cand"]
    assert np.isin(res.cand[0], res.ids[0][res.valid[0]]).any()
    off = by["gates-off"]
    assert not (off.active_score | off.do_replace | off.active_probe).any()
    assert any((~s.in_capacity).any() for s in SCENARIOS)
    assert any(_run(s)[9].sum() > 0 for s in SCENARIOS)  # something placed
    assert any(_run(s)[5].any() for s in SCENARIOS)      # something hit
    for s in SCENARIOS:
        for p in range(s.ids.shape[0]):
            live = s.ids[p][s.valid[p]]
            assert len(np.unique(live)) == len(live)
        # queries are host-deduped remote sets: unique per row
        for row in s.queries:
            q = row[row >= 0]
            assert len(np.unique(q)) == len(q)


def test_every_gate_off_keeps_the_state():
    sc = next(s for s in SCENARIOS if s.name == "gates-off")
    ids2, s2, valid2, acc3, _w2, hit, hit_slot, placed, *_ = _run(sc)
    np.testing.assert_array_equal(ids2.numpy(), sc.ids)
    np.testing.assert_array_equal(_bits(s2.numpy()), _bits(sc.scores))
    np.testing.assert_array_equal(valid2.numpy(), sc.valid)
    np.testing.assert_array_equal(acc3.numpy(), sc.accessed)
    assert not hit.any() and not placed.any() and (hit_slot == -1).all()


def test_zero_capacity_is_impossible_by_construction():
    """``C == 0`` never reaches a launch: the engine pads ``C`` to at least
    one slot (a zero-capacity PE owns only padding slots), and the
    dispatcher refuses ``C == 0`` on either device — the reference's jnp
    route for it (``ops.py:274-277``) has no counterpart on the card."""
    assert PrefetchEngine([0, 0, 0]).max_capacity == 1
    assert PrefetchEngine([]).max_capacity == 1
    sc = SCENARIOS[0]
    arr = {k: _torch(v) for k, v in sc.arrays().items()}
    for k in ("ids", "scores", "valid", "accessed", "in_capacity"):
        arr[k] = arr[k][:, :0]
    with pytest.raises(ValueError, match="C >= 1"):
        ops.fused_step_batch(*arr.values(), num_ids=sc.num_ids, **sc.constants)


def test_wide_ids_raise():
    """Once refused, now routed as the reference routes them: int64 ids
    that fit int32 run the narrow step, and the same ids past ``2**31``
    the wide one, with the narrow outputs and ``ids`` shifted."""
    sc = SCENARIOS[0]
    args = [_torch(a) for a in sc.arrays().values()]
    narrow = _run(sc)
    args[6] = args[6].to(torch.int64)  # queries
    same = ops.fused_step_batch(*args, num_ids=sc.num_ids, **sc.constants)
    _assert_same(same, [t.numpy() if t is not None else None for t in narrow], "int64 queries")
    base = 2**31 + 1000
    for i in (0, 6, 7):  # ids, queries, cand
        args[i] = torch.where(args[i] >= 0, args[i].to(torch.int64) + base, args[i].to(torch.int64))
    big = ops.fused_step_batch(*args, num_ids=sc.num_ids, **sc.constants)
    assert big[0].dtype == torch.int64
    shifted = narrow[0].to(torch.int64)
    shifted = torch.where(shifted >= 0, shifted + base, shifted)
    np.testing.assert_array_equal(big[0].numpy(), shifted.numpy())
    _assert_same(
        (None,) + tuple(big[1:]),
        (None,) + tuple(t.numpy() if t is not None else None for t in narrow[1:]),
        "wide route",
    )


def test_pack_readback_matches_reference():
    from repro.kernels import ops as jops

    out = _run(SCENARIOS[1])
    host = [out[i] for i in (5, 6, 7, 8, 10)]
    got = ops.pack_readback(*host).numpy()
    want = np.asarray(jops.pack_readback(*[h.numpy() for h in host]))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_cpu_route_launches_nothing_and_wrapper_refuses_cpu():
    before = dict(native.LAUNCHES)
    _run(SCENARIOS[0])
    assert native.LAUNCHES == before
    from repro_torch.kernels.fused_step import fused_step_cuda

    sc = SCENARIOS[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_step_cuda(
            *[_torch(a) for a in sc.arrays().values()],
            num_ids=sc.num_ids, **sc.constants,
        )


# --------------------------------------------------------------------------- #
# The engine's form: gate words in, the packed readback out.
WIDE_SCENARIOS = scenarios.wide_fused_step_scenarios()


def _gate_words(P, shift):
    """Per-PE gate words; over shifts 0..7 every PE sees all 8 patterns."""
    return ((np.arange(P) + shift) % 8).astype(np.int32)


def _bits_of(words):
    return [(words & bit) != 0 for bit in (1, 2, 4)]


def _ref_readback(sc, words, wide):
    """The reference's step on the unpacked gate bits, then its
    ``pack_readback``: ``(ids2, scores2, valid2, accessed3, weights2,
    packed)``."""
    from repro.kernels import ops as jops

    arr = sc.arrays()
    gates = _bits_of(words)
    if wide:
        ih, il = jops.split_ids(sc.ids)
        qh, ql = jops.split_ids(sc.queries)
        ch, cl = jops.split_ids(sc.cand)
        w = jops.fused_step_wide_batch(
            il, ih, sc.scores, sc.valid, sc.accessed, sc.in_capacity, sc.weights,
            ql, qh, cl, ch, sc.cand_weights, *gates, backend="jnp", **sc.constants,
        )
        out = [jops.join_ids(np.asarray(w[1]), np.asarray(w[0]))] + list(w[2:])
    else:
        out = list(jref.fused_step(*list(arr.values())[:9], *gates, **sc.constants))
    packed = jops.pack_readback(out[5], out[6], out[7], out[8], out[10])
    return out[:5] + [packed]


@pytest.mark.parametrize(
    "sc,wide",
    [(s, False) for s in SCENARIOS] + [(s, True) for s in WIDE_SCENARIOS],
    ids=[s.name for s in SCENARIOS] + [s.name for s in WIDE_SCENARIOS],
)
def test_readback_entry_matches_reference_composition(sc, wide):
    """``ops.fused_step_readback_batch`` on the CPU (the engine's form: gate
    words, one packed block) equals the reference's step on the unpacked
    bits followed by its ``pack_readback``, for gate words covering all 8
    bit patterns on every PE."""
    args = [_torch(a) for a in sc.arrays().values()][:9]
    P = sc.ids.shape[0]
    kw = dict(id_lo=sc.id_lo, num_ids=sc.num_ids) if wide else dict(num_ids=sc.num_ids)
    for shift in range(8):
        words = _gate_words(P, shift)
        got = ops.fused_step_readback_batch(*args, torch.from_numpy(words), **kw, **sc.constants)
        want = _ref_readback(sc, words, wide)
        names = ("ids2", "scores2", "valid2", "accessed3", "weights2", "packed")
        assert got[5].dtype == torch.int32
        for name, a, b in zip(names, got, want):
            if a is None or b is None:
                assert a is None and b is None, name
                continue
            np.testing.assert_array_equal(
                _bits(a.numpy()), _bits(np.asarray(b)), err_msg=f"{sc.name} {shift} {name}"
            )


# --------------------------------------------------------------------------- #
# The @given twin of the reference's fused-vs-staged property
# (tests/test_fused_step.py::TestFusedStepProperties): rotated ragged
# launches of the port's DeviceEngine on the CPU against the port's staged
# pipeline (lookup -> end_round -> replace_round), narrow and (ids at a
# base past 2^31) wide, where the reference draws its two backends.
def _check_fused_vs_staged(policy, seed, P, steps, warm_full, base, n_nodes=400):
    from repro_torch.runtime import engine as teng

    empty = np.array([], dtype=np.int64)
    rng = np.random.default_rng(seed)
    caps = [int(x) for x in rng.integers(1, 12, size=P)]
    if P > 1:
        caps[0] = 0  # a zero-capacity PE rides along
    node_weights = (
        (1.0 + rng.random(n_nodes)).astype(np.float32) if policy == "degree" else None
    )
    eng = teng.PrefetchEngine(caps, policy=policy, node_weights=node_weights, id_base=base)
    for p in range(P):
        want = caps[p] if warm_full else int(rng.integers(0, 8))
        ids = rng.choice(n_nodes, size=min(want, n_nodes), replace=False)
        eng.insert(p, ids.astype(np.int64) + base)
    dev = teng.DeviceEngine(copy.deepcopy(eng), device="cpu")
    assert dev.wide == bool(base)

    uses_buffer = rng.random(P) > 0.2
    active = uses_buffer & (eng.capacity > 0)
    # Queries keep duplicates: the staged path dedups candidates on the
    # host, the fused step in the launch.
    queries = [
        [rng.choice(n_nodes, size=rng.integers(0, 10)).astype(np.int64) + base
         for _ in range(P)]
        for _ in range(steps)
    ]
    decisions = [rng.random(P) > 0.4 for _ in range(steps)]

    staged_hits, prev_missed = [], [empty] * P
    for t in range(steps):
        hm, missed = eng.lookup(queries[t], active)
        staged_hits.append([m.copy() for m in hm])
        eng.end_round(uses_buffer)
        eng.replace_round(prev_missed, decisions[t] & uses_buffer)
        prev_missed = missed
        staged_last = (list(eng.last_placed), list(eng.last_slots))

    zeros = np.zeros(P, dtype=bool)
    out = dev.fused_step(queries[0], [empty] * P, zeros, zeros, active)
    fused_hits, prev_d, cur = [out.hit_masks], [empty] * P, out.missed
    for t in range(steps):
        nq = queries[t + 1] if t + 1 < steps else [empty] * P
        out = dev.fused_step(nq, prev_d, uses_buffer, decisions[t] & uses_buffer, active)
        if t + 1 < steps:
            fused_hits.append(out.hit_masks)
        prev_d, cur = cur, out.missed
        fused_last = (list(dev.last_placed), list(dev.last_slots))

    synced = dev.sync_to_engine()
    for t in range(steps):
        for p in range(P):
            np.testing.assert_array_equal(staged_hits[t][p], fused_hits[t][p])
    for name in ("ids", "scores", "valid", "accessed", "weights"):
        np.testing.assert_array_equal(getattr(eng, name), getattr(synced, name), err_msg=name)
    for f in ("lookups", "hits", "misses", "replaced_total", "replacement_rounds",
              "skipped_rounds"):
        np.testing.assert_array_equal(getattr(eng.stats, f), getattr(dev.stats, f), err_msg=f)
    for p in range(P):
        np.testing.assert_array_equal(staged_last[0][p], fused_last[0][p])
        np.testing.assert_array_equal(staged_last[1][p], fused_last[1][p])


@st.composite
def _staged_cases(draw):
    return (
        draw(st.sampled_from(scenarios.POLICIES)),
        draw(st.integers(0, 2**31 - 1)),
        draw(st.integers(min_value=1, max_value=6)),
        draw(st.integers(min_value=1, max_value=5)),
        draw(st.booleans()),
        draw(st.sampled_from([0, scenarios.BASE])),
    )


@settings(max_examples=20, deadline=None)
@given(data=_staged_cases())
def test_fused_matches_staged_pipeline(data):
    policy, seed, P, steps, warm_full, base = data
    _check_fused_vs_staged(policy, seed, P, steps, warm_full, base)
