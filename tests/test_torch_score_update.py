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
padding lane would read stale, as the reference does.
"""

import numpy as np
import pytest
import torch

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
