"""The port's plain scoring rounds against the reference package.

``repro_torch.kernels.ref.score_policy_update_batch`` (and its two
fixed-policy forms ``score_update_batch`` and ``score_update``) is the
spec the Hopper kernel ``csrc/score_update.cu`` is held to on the card.
Here, on the CPU, the plain versions and the port's dispatchers are held
bit for bit against the reference's jnp oracles (``repro.kernels.ref``)
and its Pallas kernels in interpret mode (``repro.kernels.ops``), on the
seeded set ``chip_smoke.py`` also runs on the card: every policy of
``core.scoring.POLICIES`` through its ``kernel_constants()`` (so every
mode), weighted and unweighted, with scores that land on the stale
threshold after the round. Scores are compared as their int32 bit
patterns, stale counts exactly. The dispatcher refuses a policy whose
padding lane would read stale, as the reference does. The ``@given``
twins of the reference's ``test_score_update_property`` and
``test_score_policy_update_batch_property`` run the port's dispatchers
with the reference's strategies and example counts against its jnp
oracles (bit for bit) and the numpy ``ScoringPolicy`` (the reference's
``rtol=1e-6, atol=1e-7``). The engine's kernel route packs its inputs
into one kept block; rows off the 16-byte grid are held here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import scoring
from repro_torch.kernels import native, ops, ref, scenarios

SCENARIOS = scenarios.score_scenarios()
#: Interpret-mode Pallas costs seconds per shape: the long row takes the
#: jnp oracle only.
PALLAS = [s for s in SCENARIOS if s.scores.size < 10_000]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what):
    (new, stale), (new_w, stale_w) = got, want
    new, stale = np.asarray(new), np.asarray(stale)
    assert new.dtype == np.float32 and stale.dtype == np.int32, what
    np.testing.assert_array_equal(_bits(new), _bits(new_w), err_msg=f"{what}: new")
    np.testing.assert_array_equal(stale, np.asarray(stale_w), err_msg=f"{what}: stale")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port(fn, *arrays, **kw):
    return [t.numpy() for t in fn(*(_t(a) for a in arrays), **kw)]


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_policy_round_matches_oracle(sc):
    args = (sc.scores, sc.accessed, sc.weights)
    want = jref.score_policy_update_batch(*args, **sc.constants)
    _assert_same(_port(ref.score_policy_update_batch, *args, **sc.constants), want,
                 f"{sc.name} plain")
    _assert_same(_port(ops.score_policy_update_batch, *args, **sc.constants), want,
                 f"{sc.name} ops")
    policy = scoring.POLICIES.get(sc.name.rsplit("-", 1)[0])
    if policy is not None:  # the numpy host path of the policy agrees too
        new = policy.update(*args)
        np.testing.assert_array_equal(_bits(new), _bits(want[0]))


@pytest.mark.parametrize("sc", PALLAS, ids=[s.name for s in PALLAS])
def test_policy_round_matches_pallas(sc):
    args = (sc.scores, sc.accessed, sc.weights)
    want = jops.score_policy_update_batch(*args, **sc.constants)  # interpret
    _assert_same(_port(ops.score_policy_update_batch, *args, **sc.constants), want,
                 sc.name)


@pytest.mark.parametrize("sc", SCENARIOS[:2] + SCENARIOS[-3:],
                         ids=[s.name for s in SCENARIOS[:2] + SCENARIOS[-3:]])
def test_fixed_policy_rounds_match_reference(sc):
    """``score_update_batch`` (the paper's constants, per PE) and
    ``score_update`` (one buffer) on each row."""
    want = jref.score_update_batch(sc.scores, sc.accessed)
    _assert_same(_port(ref.score_update_batch, sc.scores, sc.accessed), want, "plain")
    _assert_same(_port(ops.score_update_batch, sc.scores, sc.accessed), want, "ops")
    if sc.scores.size < 10_000:
        _assert_same(_port(ops.score_update_batch, sc.scores, sc.accessed),
                     jops.score_update_batch(sc.scores, sc.accessed), "pallas")
    for p in range(sc.scores.shape[0]):
        row = (sc.scores[p], sc.accessed[p])
        want1 = jref.score_update(*row)
        got1 = _port(ops.score_update, *row)
        assert got1[1].shape == ()
        _assert_same(got1, want1, f"score_update row {p}")
        _assert_same(_port(ref.score_update, *row), want1, f"plain row {p}")
        if p == 0 and sc.scores.size < 10_000:
            _assert_same(got1, jops.score_update(*row), f"pallas row {p}")


def test_decay_onto_the_threshold_is_not_stale():
    """1.0 decays to exactly 0.95 in float32: on the threshold, not below
    it, so not a replacement victim; one ulp below 1.0 is."""
    s = np.array([[1.0, np.nextafter(np.float32(1.0), np.float32(0.0))]], np.float32)
    a = np.zeros_like(s, dtype=bool)
    new, stale = _port(ops.score_policy_update_batch, s, a)
    assert new[0, 0] == np.float32(0.95) and stale.tolist() == [1]


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="accumulate", increment=-0.5),
        dict(mode="reset", increment=0.5),
        dict(mode="capped", increment=1.0, score_cap=0.5),
    ],
)
def test_policy_that_marks_padding_stale_raises(kw):
    s = np.ones((2, 5), np.float32)
    a = np.zeros((2, 5), bool)
    with pytest.raises(ValueError, match="padding lanes stale"):
        ops.score_policy_update_batch(_t(s), _t(a), **kw)
    with pytest.raises(ValueError, match="padding lanes stale"):
        jops.score_policy_update_batch(s, a, **kw)


def test_unknown_mode_raises_and_cpu_launches_nothing():
    s, a = torch.ones((1, 3)), torch.zeros((1, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="mode must be one of"):
        ops.score_policy_update_batch(s, a, mode="lru")
    before = dict(native.LAUNCHES)
    ops.score_policy_update_batch(s, a.to(torch.int32))
    ops.score_update_batch(s, a)
    ops.score_update(s[0], a[0])
    assert native.LAUNCHES == before


@given(
    n=st.integers(1, 300),
    p=st.floats(0.0, 1.0),
    seed=st.integers(0, 100),
)
@settings(max_examples=20, deadline=None)
def test_score_update_property(n, p, seed):
    """Twin of the reference's property: the port's ``score_update`` ==
    the reference's oracle for arbitrary buffer sizes and access rates."""
    scores = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n,), maxval=3.0))
    accessed = np.array(jax.random.bernoulli(jax.random.PRNGKey(seed + 1), p, (n,)))
    out, stale = _port(ops.score_update, scores, accessed)
    want, want_stale = jref.score_update(jnp.asarray(scores), jnp.asarray(accessed))
    np.testing.assert_array_equal(_bits(out), _bits(want))
    assert int(stale) == int(want_stale)


@given(
    P=st.integers(1, 4),
    N=st.integers(1, 150),
    mode=st.sampled_from(["accumulate", "reset", "capped"]),
    weighted=st.booleans(),
    p_access=st.floats(0.0, 1.0),
    seed=st.integers(0, 10_000),
)
@settings(max_examples=30, deadline=None)
def test_score_policy_update_batch_property(P, N, mode, weighted, p_access, seed):
    """Twin of the reference's property: the port's dispatcher == the jnp
    oracle == the numpy ``ScoringPolicy`` for random shapes, access
    rates, policy modes and optional per-slot weights."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.0, 4.0, size=(P, N)).astype(np.float32)
    accessed = rng.random((P, N)) < p_access
    weights = (
        rng.uniform(0.5, 2.0, size=(P, N)).astype(np.float32) if weighted else None
    )
    out, stale = _port(ops.score_policy_update_batch, scores, accessed, weights, mode=mode)
    want, want_stale = jref.score_policy_update_batch(
        jnp.asarray(scores), jnp.asarray(accessed),
        None if weights is None else jnp.asarray(weights), mode=mode,
    )
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(stale, np.asarray(want_stale))
    policy = scoring.ScoringPolicy(name="prop", mode=mode, use_weights=weighted)
    np_new = policy.update(scores, accessed, weights)
    np.testing.assert_allclose(out, np_new, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("caps", [[96, 64], [97, 63, 5], [1]], ids=["even", "odd", "one"])
@pytest.mark.parametrize("policy", ["rudder", "degree"])
def test_engine_packed_round_matches_numpy(caps, policy):
    """``PrefetchEngine(use_kernels=True, device="cpu")``'s packed round
    (scores, marks and weights in one kept block, at 16-byte offsets)
    against the numpy round, over capacities whose rows are off the
    16-byte grid and several rounds reusing the block."""
    from repro_torch.runtime import PrefetchEngine

    rng = np.random.default_rng(11)
    weights = scoring.degree_weights(rng.integers(0, 500, size=1000))
    a = PrefetchEngine(caps, policy=policy, node_weights=weights)
    b = PrefetchEngine(caps, policy=policy, node_weights=weights,
                       use_kernels=True, device="cpu")
    ids = rng.choice(1000, size=sum(caps), replace=False)
    at = 0
    for p, c in enumerate(caps):
        for eng in (a, b):
            eng.insert(p, ids[at:at + c])
        at += c
    active = np.ones(len(caps), dtype=bool)
    active[-1] = len(caps) == 1
    blocks = []
    for _ in range(3):
        marks = rng.random(a.accessed.shape) < 0.3
        for eng in (a, b):
            eng.accessed[:] = marks
            eng.end_round(active)
        blocks.append(b._stage[0].data_ptr())
        np.testing.assert_array_equal(a.scores.view(np.int32), b.scores.view(np.int32))
        np.testing.assert_array_equal(a.accessed, b.accessed)
    assert len(set(blocks)) == 1
