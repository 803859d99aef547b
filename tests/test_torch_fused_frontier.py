"""The port's plain ``fused_frontier_step`` against the reference package.

``repro_torch.kernels.ref.fused_frontier_step`` is the spec the Hopper
kernel is held to on the card. Here, on the CPU, it is held bit for bit
against the reference's jnp oracle (``repro.kernels.ref``) and against the
reference's Pallas kernel in interpret mode, on the seeded scenario set
that ``chip_smoke.py`` also runs on the card: all five scoring policies,
weighted and unweighted, scores on the stale threshold, capacity-masked
slots, empty and all-duplicate frontier rows, the drained ``Mt == 1``
launch and the initial all -1 ``(P, 1)`` candidate block. Scores are
compared as their int32 bit patterns.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_step import fused_frontier_step_pallas
from repro_torch.kernels import native, ops, ref, scenarios

SCENARIOS = scenarios.frontier_scenarios()
OUT_NAMES = (
    "ids2", "scores2", "valid2", "accessed3", "weights2", "cand_next",
    "packed", "counters",
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


def _drop_payload(out):
    """The reference returns ``payload2`` in slot 5; the port has no
    feature store on this path yet."""
    return [x for i, x in enumerate(out) if i != 5]


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_plain_matches_oracle_and_pallas(sc):
    arr = sc.arrays()
    kw = dict(cand_cap=sc.cand_cap, **sc.constants)
    got = ops.fused_frontier_step_batch(*[_torch(a) for a in arr.values()], **kw)
    oracle = jref.fused_frontier_step(*arr.values(), None, None, None, **kw)
    pallas = fused_frontier_step_pallas(
        *arr.values(), None, None, None, interpret=True, **kw
    )
    _assert_same(got, _drop_payload(oracle), f"{sc.name} vs jnp oracle")
    _assert_same(got, _drop_payload(pallas), f"{sc.name} vs Pallas")


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
    _assert_same(out, _drop_payload(oracle), "threshold")
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
