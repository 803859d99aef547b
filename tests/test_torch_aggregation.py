"""The GraphSAGE step's neighbour aggregation against the reference package.

* ``repro_torch.kernels.ref.gather_mean`` (the spec of
  ``csrc/gather_mean.cu``) against the reference's Pallas ``gather_mean`` in
  interpret mode, bit for bit in float32 and bfloat16 (both add the K rows
  in neighbour order in float32, then multiply by the float32 ``1 / K``),
  and against the jnp oracle ``ref.gather_mean`` (a ``jnp.mean``, which
  divides instead) at ``rtol=1e-5, atol=1e-6`` in float32 and at the
  reference's own bfloat16 bar, ``rtol=atol=3e-2``
  (``tests/test_kernels.py``).
* ``ref.segment_sum_equal`` (the spec of ``csrc/segment_sum.cu``) against
  the reference's Pallas ``segment_sum_equal`` in interpret mode and the
  jnp oracle ``ref.segment_sum`` at the reference's bar, ``rtol=atol=1e-5``
  (bfloat16 sets against the oracle at ``3e-2``).
* Both over the seeded scenario sets ``chip_smoke.py`` runs on the card,
  and over the shapes of the reference's ``test_gather_mean_sweep`` and
  ``test_segment_sum_sweep`` plus ``K = 1``, ``F = 1`` and empty inputs.
* The dispatchers: CPU tensors take the plain versions and launch nothing;
  an input that requires a gradient raises ``ValueError``; the CUDA
  wrappers refuse CPU tensors before building anything.
* ``GraphSAGE.forward_aggregated`` with a gathered mean equals ``forward``
  on the rows, bit for bit.
* ``train_model=True`` trainers on the CPU, with and without a feature
  store, against the reference: every exact stream and the trace's
  ``exact_digest`` equal, losses allclose at ``rtol=1e-5, atol=1e-6``
  (float32 sums in another order over the SGD steps), and the dispatchers
  called exactly as ``chip_smoke.py`` counts the launches on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
import repro_torch.gnn as tgnn
import repro_torch.graph as tgraph
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.store import FeatureStore as JStore
from repro_torch import telemetry as tel
from repro_torch.gnn.sage import GraphSAGE, fanout_mean
from repro_torch.kernels import native, ops, ref, scenarios
from repro_torch.kernels.gather_mean import gather_mean_cuda
from repro_torch.kernels.segment_sum import segment_sum_equal_cuda
from repro_torch.store import FeatureStore

RTOL, ATOL = 1e-5, 1e-6  # f32 plain vs jnp oracle; losses port vs reference
SEG_TOL = 1e-5           # the reference's own segment-sum bar
BF16_TOL = 3e-2          # the reference's own bfloat16 bar

GATHER_MEANS = scenarios.gather_mean_scenarios()
SEGMENT_SUMS = scenarios.segment_sum_scenarios()


def _torch(a, dtype, offset=0):
    return scenarios.typed(a, dtype, offset=offset)


def _jax(a, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check_gather_mean(table, idx, dtype, offset=0):
    before = dict(native.LAUNCHES)
    got = ops.gather_mean(_torch(table, dtype, offset), torch.from_numpy(idx))
    assert native.LAUNCHES == before  # the CPU route launches nothing
    assert got.shape == (idx.shape[0], table.shape[1])
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(
        _f32(got), _f32(ref.gather_mean(_torch(table, dtype), torch.from_numpy(idx)))
    )
    tol = dict(rtol=BF16_TOL, atol=BF16_TOL) if dtype == "bfloat16" else dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.gather_mean(_jax(table, dtype), jnp.asarray(idx))), **tol
    )
    if idx.shape[0]:  # the Pallas grid has no step to run at B == 0
        want = jops.gather_mean(_jax(table, dtype), jnp.asarray(idx))
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _check_segment_sum(data, k, dtype, offset=0):
    before = dict(native.LAUNCHES)
    got = ops.segment_sum_equal(_torch(data, dtype, offset), k)
    assert native.LAUNCHES == before
    S = data.shape[0] // k
    assert got.shape == (S, data.shape[1])
    np.testing.assert_array_equal(
        _f32(got), _f32(ref.segment_sum_equal(_torch(data, dtype), k))
    )
    rounded = _f32(_torch(data, dtype))  # the values both sides were given
    oracle = jref.segment_sum(
        jnp.asarray(rounded), jnp.repeat(jnp.arange(S), k), S
    )
    tol = BF16_TOL if dtype == "bfloat16" else SEG_TOL
    np.testing.assert_allclose(_f32(got), np.asarray(oracle), rtol=tol, atol=tol)
    if S:  # the Pallas grid has no step to run at S == 0
        want = jops.segment_sum_equal(_jax(data, dtype), k)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=SEG_TOL, atol=SEG_TOL)


@pytest.mark.parametrize("sc", GATHER_MEANS, ids=[s.name for s in GATHER_MEANS])
def test_gather_mean_matches_pallas_and_oracle(sc):
    _check_gather_mean(sc.table, sc.idx, sc.dtype, sc.offset)


@pytest.mark.parametrize("sc", SEGMENT_SUMS, ids=[s.name for s in SEGMENT_SUMS])
def test_segment_sum_matches_pallas_and_oracle(sc):
    _check_segment_sum(sc.data, sc.k, sc.dtype, sc.offset)


def _width(dtype, F, offset):
    """Units a row of width F takes in the kernels: F / V on their 16-byte
    path (V = 4 float32, 8 bfloat16; F % V == 0, aligned), else F."""
    v = 8 if dtype == "bfloat16" else 4
    return F // v if F % v == 0 and not offset else F


def _lanes(sc):
    """Lanes of one ``gather_mean.cu`` group on this set: the row's units
    rounded up to a power of two, at most 32."""
    W = _width(sc.dtype, sc.table.shape[1], sc.offset)
    return min(32, 1 << (W - 1).bit_length())


def test_scenarios_cover_the_contract():
    edges = {k + d for k in scenarios.UNROLL_EDGES for d in (-1, 0, 1)}
    for sets, k_of, f_of in (
        (GATHER_MEANS, lambda s: s.idx.shape[1], lambda s: s.table.shape[1]),
        (SEGMENT_SUMS, lambda s: s.k, lambda s: s.data.shape[1]),
    ):
        assert {k_of(s) for s in sets} == {1, 3, 10, 25} | edges
        assert {f_of(s) for s in sets} == {1, 3, 64, 100, 128, 600}
        assert {s.dtype for s in sets} == {"float32", "bfloat16"}
        # Both paths of both dtypes: 16 bytes a load, and one element.
        paths = {(s.dtype, _width(s.dtype, f_of(s), s.offset) < f_of(s)) for s in sets}
        assert paths == {(d, v) for d in ("float32", "bfloat16") for v in (True, False)}
        # A base pointer off the 16-byte grid, in both dtypes.
        assert {s.dtype for s in sets if s.offset * (2 if s.dtype == "bfloat16" else 4) % 16} \
            == {"float32", "bfloat16"}
    # The segment sum: several 256-thread blocks, the last one partial.
    threads = [s.data.shape[0] // s.k * _width(s.dtype, s.data.shape[1], s.offset)
               for s in SEGMENT_SUMS]
    assert any(n > 256 and n % 256 for n in threads)
    # The gather: every lane-group width, a row wider than 32 units, a
    # block's 256 / G destinations not dividing B, and B past one pass.
    live = [s for s in GATHER_MEANS if s.idx.size]
    assert {_lanes(s) for s in live} >= {1, 4, 8, 16, 32}
    assert any(_width(s.dtype, s.table.shape[1], s.offset) > 32 for s in live)
    assert any(s.idx.shape[0] > 256 // _lanes(s) and s.idx.shape[0] % (256 // _lanes(s))
               for s in live)
    assert any(s.idx.shape[0] * _lanes(s) > scenarios.GATHER_SPAN for s in live)
    assert {s.idx.dtype for s in GATHER_MEANS} == {np.dtype(np.int32), np.dtype(np.int64)}
    for dtype in ("float32", "bfloat16"):
        assert {s.idx.dtype for s in GATHER_MEANS if s.dtype == dtype} == {
            np.dtype(np.int32), np.dtype(np.int64)}
    assert any(s.idx.shape[0] == 0 for s in GATHER_MEANS)
    assert any(s.data.shape[0] == 0 for s in SEGMENT_SUMS)
    assert all((s.idx == s.table.shape[0] - 1).any() for s in live)
    assert any(len(np.unique(s.idx[0])) < s.idx.shape[1] for s in live)


# The reference's sweep shapes (tests/test_kernels.py) plus K = 1, F = 1
# and an empty launch.
@pytest.mark.parametrize(
    "b,k,f", [(4, 3, 64), (9, 10, 300), (16, 25, 100), (2, 7, 600), (5, 1, 1), (0, 4, 8)]
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_mean_sweep(b, k, f, dtype):
    rng = np.random.default_rng(b * 1000 + k * 10 + f)
    table = rng.standard_normal((50, f)).astype(np.float32)
    idx = rng.integers(0, 50, size=(b, k)).astype(np.int32)
    _check_gather_mean(table, idx, dtype)


@pytest.mark.parametrize(
    "s,k,f", [(8, 5, 100), (20, 10, 256), (3, 25, 64), (6, 1, 1), (0, 3, 8)]
)
def test_segment_sum_sweep(s, k, f):
    rng = np.random.default_rng(s * 1000 + k * 10 + f)
    _check_segment_sum(rng.standard_normal((s * k, f)).astype(np.float32), k, "float32")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("sc", SEGMENT_SUMS, ids=[s.name for s in SEGMENT_SUMS])
def test_scaled_segment_sum_is_the_fanout_mean(sc):
    """The scaled form (``scale = 1 / k``, what ``fanout_mean`` asks for)
    against the fanout mean's formula from before the scale moved into the
    kernel, ``segment_sum_equal(x, k) * torch.tensor(1 / k)``: bit for bit
    in float32. In bfloat16, bit for bit against the rounding
    ``ref.segment_sum_equal`` states, bf16(fl32(float(bf16(sum)) * fl32(1 /
    k))), computed here in numpy, which the old formula also gives on the
    CPU."""
    data = sc.tensor()
    k = sc.k
    sums = ref.segment_sum_equal(data, k)
    got = ops.segment_sum_equal(data, k, scale=1.0 / k)
    old = sums * torch.tensor(1.0 / k, dtype=torch.float32)
    stated = torch.from_numpy(_f32(sums) * np.float32(1.0 / k)).to(data.dtype)
    assert got.dtype == data.dtype and got.shape == sums.shape
    assert torch.equal(_bits(got), _bits(stated))
    assert torch.equal(_bits(got), _bits(old))
    mean = fanout_mean(data.reshape(-1, k, data.shape[1]))
    assert torch.equal(_bits(mean), _bits(got))


@pytest.mark.parametrize(
    "call",
    [
        lambda t: ops.gather_mean(t, torch.zeros((2, 3), dtype=torch.int64)),
        lambda t: ops.segment_sum_equal(t, 2),
    ],
    ids=["gather_mean", "segment_sum_equal"],
)
def test_dispatchers_are_forward_only(call):
    x = torch.ones((4, 3), requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        call(x)
    call(x.detach())  # the same data without a gradient runs


def test_cuda_wrappers_refuse_cpu_tensors():
    table = torch.ones((5, 4))
    with pytest.raises(ValueError, match="CUDA"):
        gather_mean_cuda(table, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_equal_cuda(table, 5)
    with pytest.raises(ValueError, match="dividing"):
        segment_sum_equal_cuda(table, 2)
    with pytest.raises(ValueError, match="K >= 1"):
        ops.gather_mean(table, torch.zeros((2, 0), dtype=torch.int32))


def test_aggregated_forward_equals_forward_on_rows():
    rng = np.random.default_rng(3)
    B, f1, f2, F, H, C = 6, 4, 5, 7, 8, 3
    table = torch.from_numpy(rng.standard_normal((40, F)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 40, B))
    n1 = torch.from_numpy(rng.integers(0, 40, (B, f1)))
    n2 = torch.from_numpy(rng.integers(0, 40, (B * f1, f2)))
    model = GraphSAGE(F, H, C)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32)))
    x_seed, x_n1 = table[seeds], table[n1]
    x_n2 = table[n2].reshape(B, f1, f2, F)
    n2_mean = ops.gather_mean(table, n2).reshape(B, f1, F)
    assert torch.equal(fanout_mean(x_n2), n2_mean)  # the two means round alike
    a = model(x_seed, x_n1, x_n2)
    b = model.forward_aggregated(x_seed, x_n1, n2_mean)
    assert torch.equal(a, b)
    labels = torch.from_numpy(rng.integers(0, C, B))
    la, ga = model.loss_and_grads(x_seed, x_n1, x_n2, labels)
    lb, gb = model.loss_and_grads(x_seed, x_n1, n2_mean, labels, aggregated=True)
    assert torch.equal(la, lb) and all(torch.equal(p, q) for p, q in zip(ga, gb))
    assert model.accuracy(x_seed, x_n1, x_n2, labels) == model.accuracy(
        x_seed, x_n1, n2_mean, labels, aggregated=True
    )


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def parts():
    ref_parts = jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.15), 4)
    port_parts = tgraph.partition_graph(tgraph.generate("products", seed=0, scale=0.15), 4)
    return ref_parts, port_parts


@pytest.mark.parametrize("with_store", [False, True], ids=["table", "store"])
def test_training_matches_reference(parts, with_store):
    ref_parts, port_parts = parts
    kw = dict(variant="fixed", epochs=2, batch_size=16, fanouts=(3, 5),
              train_model=True, buffer_frac=0.25, trace=True)
    store = JStore.for_partitions(ref_parts, backend="numpy") if with_store else None
    port_store = (
        FeatureStore.for_partitions(port_parts, device="cpu") if with_store else None
    )
    ref_tr = jgnn.DistributedTrainer(ref_parts, device="jnp", feature_store=store, **kw)
    init = jax.tree_util.tree_map(np.asarray, ref_tr.params)
    port_tr = tgnn.DistributedTrainer(
        port_parts, device="cpu", init_params=init, feature_store=port_store, **kw
    )
    ref_run = ref_tr.run()
    session = tel.TelemetrySession()
    with tel.active(session):
        port_run = port_tr.run()
    assert port_tr.last_trace.exact_digest() == ref_tr.last_trace.exact_digest()
    for p, (a, b) in enumerate(zip(port_run.logs, ref_run.logs)):
        for f in ("pct_hits", "comm_volume", "decisions", "feat_sums", "bytes_measured"):
            assert getattr(a, f) == getattr(b, f), f"PE {p} {f}"
    np.testing.assert_allclose(port_run.losses, ref_run.losses, rtol=RTOL, atol=ATOL)
    assert port_run.accuracy == pytest.approx(ref_run.accuracy, abs=1e-7)
    # One aggregation call per PE per step and per mean, plus the
    # accuracy pass: what chip_smoke.py asserts as launches on the card.
    calls = 4 * port_tr.epochs * port_tr.mb_per_epoch + 1
    reg = session.registry
    gm = reg["kernel.gather_mean.calls"].total if "kernel.gather_mean.calls" in reg else 0
    assert gm == (0 if with_store else calls)
    assert reg["kernel.segment_sum_equal.calls"].total == (2 if with_store else 1) * calls
