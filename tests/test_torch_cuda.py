"""The port's kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an NVIDIA card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels are built from ``src/repro_torch/kernels/csrc`` at first use.
Every kernel is held bit for bit against its plain PyTorch version on the
same CUDA tensors (``fused_frontier_step``, ``fused_step``,
``gather_rows_batch`` and ``gather_rows`` over their seeded scenario
sets, and the feature store's flat training gather at the papers shape,
four PEs back to back on one kept pinned id buffer; ``fused_frontier_step_wide`` and ``fused_step_wide`` over the wide
sets, in both index modes of the kernels; ``frontier_unique_batch`` in
both instantiations and both forms (the reference's masks and the
sampler's compacted ids) and the three score entries over theirs, and
at phase 8's shapes (one block per row, several, off the 16-byte grid),
each as one device operation a call with its kept scratch clean after;
``gather_mean`` and ``segment_sum_equal`` over theirs, float32 and
bfloat16, the sum also with a scale in its epilogue, and ``fanout_mean``
as one device operation a call; ``mla_flash_decode`` to allclose over the reference test's
shapes, the full-width serve shape and the tensor-core kernel's edge
shapes up to the widest row, at the tile and split edges, on
near-uniform and on peaked scores, on caches whose rows past pos are
NaN, and with its per-kernel launch counts by dtype), short
trainer runs on the card (narrow, rebased past ``2**31``, on the
readback cadence, the staged fall-back past ``WIDE_ID_MAX``, and one
under a telemetry session) against the same runs on the CPU, and one
committed golden trace re-recorded on the card; the legacy runtime at
``scale=1`` (its GraphSAGE step on the card), the six classifiers fitted
on the card and a 2-cell sweep, each against the CPU; the zoo's MoE layer
card vs CPU and bit-identical across two card runs, GQA serving card vs
CPU (Gemma2, Qwen3), and prefill against decode on the card; the
training path's embedding backward (float32 sums, bit-identical runs) and
three train steps card vs CPU with remat bit-identical on the card; the
recurrent mixers (Mamba2, mLSTM, sLSTM: forward, decode with its state,
gradients) card vs CPU, mLSTM's chunk checkpoint bit-identical to the plain
loop on the card, and xLSTM-350M's and Zamba2-1.2B's serving, prefill and
train steps card vs CPU.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import native, ops, ref, scenarios

pytestmark = pytest.mark.cuda

SCENARIOS = scenarios.frontier_scenarios()
STEP_SCENARIOS = scenarios.fused_step_scenarios()
GATHERS = scenarios.gather_scenarios()
WIDE = scenarios.wide_frontier_scenarios()
WIDE_STEPS = scenarios.wide_fused_step_scenarios()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("sc", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_fused_frontier_kernel_matches_plain(card, sc):
    args = [
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(card)
        for a in sc.arrays().values()
    ]
    kw = dict(cand_cap=sc.cand_cap, **sc.constants)
    before = native.LAUNCHES["fused_frontier_step"]
    got = ops.fused_frontier_step_batch(*args, **kw)
    want = ref.fused_frontier_step(*args, **kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_frontier_step"] == before + 1
    assert all(_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sc", STEP_SCENARIOS, ids=[s.name for s in STEP_SCENARIOS])
def test_fused_step_kernel_matches_plain(card, sc):
    args = [
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(card)
        for a in sc.arrays().values()
    ]
    before = native.LAUNCHES["fused_step"]
    got = ops.fused_step_batch(*args, num_ids=sc.num_ids, **sc.constants)
    want = ref.fused_step(*args, **sc.constants)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_step"] == before + 1
    assert all(_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sc", GATHERS, ids=[s.name for s in GATHERS])
def test_gather_kernels_match_plain(card, sc):
    tables = torch.from_numpy(sc.tables).to(card)
    idx = torch.from_numpy(sc.idx).to(card)
    before = dict(native.LAUNCHES)
    got = ops.gather_rows_batch(tables, idx)
    single = ops.gather_rows(tables[0].contiguous(), idx[0].contiguous())
    torch.cuda.synchronize()
    # An empty gather (M == 0) returns without a launch and counts none.
    ran = int(sc.idx.size > 0)
    assert native.LAUNCHES["gather_rows_batch"] == before["gather_rows_batch"] + ran
    assert native.LAUNCHES["gather_rows"] == before["gather_rows"] + ran
    assert _equal(got, ref.gather_rows_batch(tables, idx))
    assert _equal(single, ref.gather_rows(tables[0], idx[0]))


@pytest.mark.parametrize("id_base", [0, 1000])
def test_store_flat_gather_at_the_papers_shape(card, id_base):
    # The training rows' route: gather_tensor's flat gather (one
    # gather_rows launch, the map read inside it) at the papers cell's
    # shape, four PEs back to back with the card held busy first, so each
    # PE's id copy is still queued when the next PE writes its ids: the
    # kept pinned buffer must wait for the earlier copy. Every PE's rows
    # equal the host table's, bit for bit.
    from repro_torch.store import FeatureStore

    N, F, K, M = 600_000, 128, 4, 522_000
    rng = np.random.default_rng(32)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    part_of = rng.integers(0, K, size=N)
    store = FeatureStore(feats, part_of, K, id_base=id_base, use_kernel=True, device=card)
    store.device_view()  # the table's upload, outside the timed queue
    # Duplicate-heavy requests: most ids from a hot set of 20,000 nodes.
    hot = rng.integers(0, N, size=20_000)
    requests = [
        np.where(rng.random(M) < 0.8, hot[rng.integers(0, len(hot), size=M)],
                 rng.integers(0, N, size=M)).astype(np.int64) + id_base
        for _ in range(4)
    ]
    assert all(len(np.unique(r)) < M // 2 for r in requests)
    before = dict(native.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of a busy stream
    outs = [store.gather_tensor(r, card) for r in requests]
    torch.cuda.synchronize()
    assert native.LAUNCHES["gather_rows"] == before["gather_rows"] + 4
    assert native.LAUNCHES["gather_rows_batch"] == before["gather_rows_batch"]
    assert store.flat_gathers == 4 and store.kernel_gathers == 0
    for r, out in zip(requests, outs):
        assert out.shape == (M, F)
        assert np.array_equal(out.cpu().numpy().view(np.int32),
                              feats[r - id_base].view(np.int32))


@pytest.mark.parametrize("store", [False, True], ids=["modeled", "store"])
def test_golden_re_records_on_the_card(card, store):
    from pathlib import Path

    from repro_torch.trace import load_trace
    from repro_torch.trace.cli import record_trace

    golden = load_trace(str(Path(__file__).parent / "golden" / "rudder_sync"))
    fresh = record_trace(dict(golden.config, feature_store=store), device="cuda")
    assert fresh.exact_digest() == golden.exact_digest()


def test_trainer_on_the_card_matches_cpu(card):
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    parts = partition_graph(generate("products", seed=0, scale=0.15), 4)
    kw = dict(variant="rudder", deciders=["gemma3-4b"], epochs=2, batch_size=16)
    on_card = DistributedTrainer(parts, device="cuda", **kw)
    on_cpu = DistributedTrainer(parts, device="cpu", **kw)
    a, b = on_card.run(), on_cpu.run()
    for x, y in zip(a.logs, b.logs):
        assert x == y
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-5)


def _on(card, sc):
    return [
        None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(card)
        for a in sc.arrays().values()
    ]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_frontier_direct_route_is_a_few_device_ops(card, wide):
    """One direct-route call of each frontier wrapper, profiled: no sort
    kernel, and at most 6 device operations (it issues two memsets and
    three kernels), on the hub-row set."""
    from repro_torch.kernels import fused_step as fs

    sc = next(s for s in (WIDE if wide else SCENARIOS) if s.name.startswith("hub-row"))
    args = _on(card, sc)
    wrapper = fs.fused_frontier_step_wide_cuda if wide else fs.fused_frontier_step_cuda
    wrapper(*args, **sc.kwargs())  # builds the library
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        wrapper(*args, **sc.kwargs())
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 6, names
    assert not any("sort" in n.lower() for n in names), names


@pytest.mark.parametrize("budget", [None, 0], ids=["direct", "sorted"])
@pytest.mark.parametrize("sc", WIDE, ids=[s.name for s in WIDE])
def test_fused_frontier_wide_kernel_matches_plain(card, sc, budget, monkeypatch):
    from repro_torch.kernels import fused_step as fs

    if budget is not None:  # no room for the maps: the sorted mode
        monkeypatch.setattr(fs, "MAP_BUDGET_BYTES", budget)
    args = _on(card, sc)
    before = native.LAUNCHES["fused_frontier_step_wide"]
    got = fs.fused_frontier_step_wide_cuda(*args, **sc.kwargs())
    want = ref.fused_frontier_step_wide(*args, **sc.kwargs())
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_frontier_step_wide"] == before + 1
    assert all(_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("budget", [None, 0], ids=["auto", "sorted"])
@pytest.mark.parametrize("sc", WIDE_STEPS, ids=[s.name for s in WIDE_STEPS])
def test_fused_step_wide_kernel_matches_plain(card, sc, budget, monkeypatch):
    from repro_torch.kernels import fused_step as fs

    if budget is not None:
        monkeypatch.setattr(fs, "MAP_BUDGET_BYTES", budget)
    args = _on(card, sc)
    before = native.LAUNCHES["fused_step_wide"]
    got = fs.fused_step_wide_cuda(
        *args, id_lo=sc.id_lo, num_ids=sc.num_ids, **sc.constants
    )
    want = ref.fused_step_wide(*args, **sc.constants)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_step_wide"] == before + 1
    assert all(_equal(a, b) for a, b in zip(got, want))


STEP_SETS = [(s, False) for s in STEP_SCENARIOS] + [(s, True) for s in WIDE_STEPS]
STEP_IDS = [s.name for s in STEP_SCENARIOS] + [s.name for s in WIDE_STEPS]


def _plain_readback(args, words, constants):
    """The engine's form composed of plain versions: the gate bits, the
    step, ``pack_readback``."""
    bits = [(words & bit) != 0 for bit in (1, 2, 4)]
    out = ref.fused_step(*args, *bits, **constants)
    return (*out[:5], ref.pack_readback(*out[5:9], out[10]))


def _assert_maps_clean():
    from repro_torch.kernels import fused_step as fs

    torch.cuda.synchronize()
    for slot_of, cand_first in fs._MAPS.values():
        assert bool((slot_of == -1).all()) and bool((cand_first == 0).all())


@pytest.mark.parametrize("budget", [None, 0], ids=["auto", "sorted"])
@pytest.mark.parametrize("sc,wide", STEP_SETS, ids=STEP_IDS)
def test_fused_step_readback_matches_plain(card, sc, wide, budget, monkeypatch):
    """The engine's form (gate words in, the packed readback written by the
    kernel) bit-identical to the plain composition, for gate words covering
    all 8 bit patterns on every PE; the kept maps clean after each launch."""
    from repro_torch.kernels import fused_step as fs

    if budget is not None:
        monkeypatch.setattr(fs, "MAP_BUDGET_BYTES", budget)
    args = _on(card, sc)[:9]
    P = sc.ids.shape[0]
    name = "fused_step_wide" if wide else "fused_step"
    kw = dict(id_lo=sc.id_lo, num_ids=sc.num_ids) if wide else dict(num_ids=sc.num_ids)
    for shift in range(8):
        words = ((torch.arange(P) + shift) % 8).to(torch.int32).to(card)
        before = native.LAUNCHES[name]
        got = ops.fused_step_readback_batch(*args, words, **kw, **sc.constants)
        want = _plain_readback(args, words, sc.constants)
        torch.cuda.synchronize()
        assert native.LAUNCHES[name] == before + 1
        assert all(_equal(a, b) for a, b in zip(got, want)), shift
        _assert_maps_clean()


def test_kept_maps_stay_clean(card):
    """A sequence of launches on one stream: every gate off, zero
    candidates, a full buffer with stale slots to refill, both forms, and
    wide launches whose span grows from one to the next. After each the
    outputs equal the plain version's and the kept maps are all -1 / 0;
    the maps are allocated once per size."""
    from repro_torch.kernels import fused_step as fs

    fs._MAPS.clear()
    sc = next(s for s in STEP_SCENARIOS if s.name == "rudder-w")
    base = _on(card, sc)
    P, C = sc.ids.shape
    rng = np.random.default_rng(5)
    full = list(base)
    full[0] = torch.from_numpy(np.stack([
        rng.choice(sc.num_ids, size=C, replace=False) for _ in range(P)
    ]).astype(np.int32)).to(card)
    full[1] = torch.from_numpy(rng.uniform(0.5, 1.5, (P, C)).astype(np.float32)).to(card)
    full[2] = torch.ones((P, C), dtype=torch.bool, device=card)
    full[4] = torch.ones((P, C), dtype=torch.bool, device=card)
    no_cand = list(base)
    no_cand[7] = torch.full_like(base[7], -1)
    on = torch.full((P,), 7, dtype=torch.int32, device=card)
    off = torch.zeros((P,), dtype=torch.int32, device=card)
    seen = set()
    for args, words in ((base, off), (no_cand, on), (full, on), (base, on)):
        for packed in (True, False):
            bits = [(words & bit) != 0 for bit in (1, 2, 4)]
            if packed:
                got = fs.fused_step_readback_cuda(
                    *args[:9], words, num_ids=sc.num_ids, **sc.constants)
                want = _plain_readback(args[:9], words, sc.constants)
            else:
                got = fs.fused_step_cuda(*args[:9], *bits, num_ids=sc.num_ids, **sc.constants)
                want = ref.fused_step(*args[:9], *bits, **sc.constants)
            assert all(_equal(a, b) for a, b in zip(got, want))
            _assert_maps_clean()
            seen.update(m[0].data_ptr() for m in fs._MAPS.values())
    assert len(seen) == 1, "a narrow launch of one size reallocated its maps"
    assert int(_plain_readback(full[:9], on, sc.constants)[5][:, -1].sum()) == P * C
    wsc = next(s for s in WIDE_STEPS if s.name.startswith("rudder-w@"))
    wargs = _on(card, wsc)[:9]
    for span in (wsc.num_ids, 4 * wsc.num_ids, 64 * wsc.num_ids):
        got = fs.fused_step_readback_cuda(
            *wargs, on, id_lo=wsc.id_lo, num_ids=span, **wsc.constants)
        assert all(_equal(a, b) for a, b in zip(got, _plain_readback(wargs, on, wsc.constants)))
        _assert_maps_clean()
        assert fs._MAPS[(card.index, torch.cuda.current_stream(card).cuda_stream)][0].numel() >= P * span


def _unique_row(rng, n, m):
    """``m`` distinct ids below ``n`` in ascending order, -1 padded."""
    q = np.unique(rng.choice(n, m))
    return np.pad(q, (0, m - len(q)), constant_values=-1)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_fused_step_slices_of_several_tiles(card, wide):
    """A launch whose blocks hold several tiles of slots and candidates
    (C and K past 8 blocks x 4096), so the state round re-reads its flags
    between passes: the engine's form equals the plain version, and the
    maps are clean after it."""
    from repro_torch.kernels import fused_step as fs

    P, C, M, K, N = 2, 40_000, 30_000, 45_000, 200_000
    rng = np.random.default_rng(11)
    base = scenarios.BASE if wide else 0
    idt = np.int64 if wide else np.int32
    ids = np.stack([rng.choice(N, C, replace=False) for _ in range(P)])
    valid = rng.random((P, C)) < 0.9
    host = [
        np.where(valid, ids, -1),
        rng.uniform(0.5, 2.0, (P, C)).astype(np.float32),
        valid,
        rng.random((P, C)) < 0.3,
        rng.random((P, C)) < 0.95,
        None,
        np.stack([_unique_row(rng, N, M) for _ in range(P)]),
        np.stack([np.concatenate([rng.choice(ids[p], K // 10), rng.choice(N, K - K // 10)])
                  for p in range(P)]),
        None,
    ]
    args = [None if a is None else torch.from_numpy(
        np.where(a >= 0, a + base, a).astype(idt) if i in (0, 6, 7) else a).to(card)
        for i, a in enumerate(host)]
    words = torch.tensor([7, 5], dtype=torch.int32, device=card)
    span = dict(id_lo=base, num_ids=N) if wide else dict(num_ids=N)
    got = fs.fused_step_readback_cuda(*args, words, **span, **STEP_SCENARIOS[0].constants)
    want = _plain_readback(args, words, STEP_SCENARIOS[0].constants)
    assert all(_equal(a, b) for a, b in zip(got, want))
    assert int(want[5][:, 2 * M : 2 * M + K].sum()) > 0  # something placed
    _assert_maps_clean()


def _device_ops_per_call(call, reps, path):
    """The device operations each of ``reps`` profiled calls of ``call``
    put on the card: its ``record_function`` range's runtime calls,
    matched to the trace's kernels, memsets and copies by correlation id
    (the chrome trace, which holds operations the event list can miss)."""
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(reps):
            with torch.profiler.record_function(f"call_{i}"):
                call()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if str(e.get("name", "")).startswith("call_")
              and e.get("cat") in ("user_annotation", "cpu_op")]
    call_of = {
        e["args"]["correlation"]: r["name"]
        for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and "correlation" in (e.get("args") or {})
        for r in ranges if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
    }
    ops = {r["name"]: [] for r in ranges}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and corr in call_of:
            ops[call_of[corr]].append(e["name"])
    return list(ops.values())


@pytest.mark.parametrize("form", ["reference", "readback"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_fused_step_direct_route_is_one_device_op(card, wide, form, tmp_path):
    """Direct-route calls of each fused-step wrapper, profiled (after a
    call that builds the library and allocates the maps): one device
    operation a call, the kernel, and no fill, zero, memset or sort. The
    profiler can miss a call's only kernel, so no call may show anything
    else and at least one must show it."""
    from repro_torch.kernels import fused_step as fs

    sc = next(s for s in (WIDE_STEPS if wide else STEP_SCENARIOS)
              if s.name.startswith("rudder-w"))
    args = _on(card, sc)
    span = dict(id_lo=sc.id_lo, num_ids=sc.num_ids) if wide else dict(num_ids=sc.num_ids)
    if form == "readback":
        words = torch.full((sc.ids.shape[0],), 7, dtype=torch.int32, device=card)

        def call():
            return fs.fused_step_readback_cuda(*args[:9], words, **span, **sc.constants)
    else:
        wrapper = fs.fused_step_wide_cuda if wide else fs.fused_step_cuda

        def call():
            return wrapper(*args, **span, **sc.constants)
    call()
    torch.cuda.synchronize()
    per_call = _device_ops_per_call(call, 5, tmp_path / "trace.json")
    assert all(len(names) <= 1 for names in per_call), per_call
    assert any(names for names in per_call), per_call
    assert all("fused_step_kernel" in n for names in per_call for n in names), per_call
    _assert_maps_clean()


@pytest.mark.parametrize("readback_every", [1, 4])
def test_wide_trainer_on_the_card_matches_cpu(card, readback_every):
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    g = generate("products", seed=0, scale=0.15).rebase(scenarios.BASE)
    parts = partition_graph(g, 4)
    kw = dict(variant="fixed", epochs=2, batch_size=16, readback_every=readback_every)
    on_card = DistributedTrainer(parts, device="cuda", **kw)
    on_cpu = DistributedTrainer(parts, device="cpu", **kw)
    before = native.LAUNCHES["fused_frontier_step_wide"]
    a, b = on_card.run(), on_cpu.run()
    launches = on_card.epochs * on_card.mb_per_epoch + 1
    assert native.LAUNCHES["fused_frontier_step_wide"] == before + launches
    for x, y in zip(a.logs, b.logs):
        assert x == y
    np.testing.assert_array_equal(on_card.engine.ids, on_cpu.engine.ids)
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-5)
    assert on_card.last_device_engine.transfers["d2h"] == -(-launches // readback_every)


FRONTIER_UNIQUE = scenarios.frontier_unique_scenarios()
SCORES = scenarios.score_scenarios()


@pytest.mark.parametrize("sc", FRONTIER_UNIQUE, ids=[s.name for s in FRONTIER_UNIQUE])
def test_frontier_unique_kernel_matches_plain(card, sc):
    keys = torch.from_numpy(sc.keys).to(card)
    flags = torch.from_numpy(sc.is_remote).to(card)
    before = dict(native.LAUNCHES)
    got = ops.frontier_unique_batch(keys, flags)
    torch.cuda.synchronize()
    wide = sc.keys.dtype == np.int64 and not ops.int32_id_eligible(sc.keys.max(initial=0))
    name = "frontier_unique_batch_wide" if wide else "frontier_unique_batch"
    ran = int(sc.keys.size > 0)
    assert native.LAUNCHES[name] == before[name] + ran
    want = ref.frontier_unique_batch(keys if wide else keys.to(torch.int32), flags)
    assert all(a.dtype == b.dtype and _equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sc", SCORES, ids=[s.name for s in SCORES])
def test_score_kernels_match_plain(card, sc):
    s, a = torch.from_numpy(sc.scores).to(card), torch.from_numpy(sc.accessed).to(card)
    w = None if sc.weights is None else torch.from_numpy(sc.weights).to(card)
    before = dict(native.LAUNCHES)
    got = ops.score_policy_update_batch(s, a, w, **sc.constants)
    got_b = ops.score_update_batch(s, a)
    got_1 = ops.score_update(s[0].contiguous(), a[0].contiguous())
    torch.cuda.synchronize()
    for name in ("score_policy_update_batch", "score_update_batch", "score_update"):
        assert native.LAUNCHES[name] == before[name] + 1
    assert all(_equal(x, y) for x, y in zip(
        got, ref.score_policy_update_batch(s, a, w, **sc.constants)))
    assert all(_equal(x, y) for x, y in zip(got_b, ref.score_update_batch(s, a)))
    assert all(_equal(x, y) for x, y in zip(got_1, ref.score_update(s[0], a[0])))


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (the kernels' element-at-a-time path)."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    step = max(1, 4 // t.element_size())
    out = flat[step:step + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _assert_scratch_clean():
    from repro_torch.kernels import frontier_unique as fu

    torch.cuda.synchronize()
    for ctl, tiles in fu._SCRATCH.values():
        assert not ctl.any() and not tiles.any()


def _phase8_block(card, seed=8):
    """Phase 8's dedup input from a seed: (4, 522,000) int32 local ids of
    a 240,000-node graph, row-sorted, and a 4-way partition map."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 240_000, size=(4, 522_000)), axis=1).astype(np.int32)
    part_of = rng.integers(0, 4, size=240_000).astype(np.int32)
    return torch.from_numpy(keys).to(card), torch.from_numpy(part_of).to(card)


def _assert_compact_equal(got, want, P):
    uniq, rem, ucount, rcount = got
    w_uniq, w_rem, w_ucount, w_rcount = want
    assert _equal(ucount, w_ucount) and _equal(rcount, w_rcount)
    assert ucount.dtype == rcount.dtype == torch.int32 and ucount.shape == (P,)
    assert uniq.dtype == w_uniq.dtype and uniq.shape[0] >= w_uniq.shape[0]
    assert _equal(uniq[: w_uniq.shape[0]], w_uniq)
    if w_rem is None:
        assert rem is None and not rcount.any()
    else:
        assert _equal(rem[: w_rem.shape[0]], w_rem)


@pytest.mark.parametrize("sc", FRONTIER_UNIQUE, ids=[s.name for s in FRONTIER_UNIQUE])
def test_frontier_unique_compact_kernel_matches_plain(card, sc):
    """The sampler's form on every set, with the set's ``part_of`` and
    without, bit for bit against its plain version; one launch a call
    under the keys' route; the scratch clean after."""
    keys = torch.from_numpy(sc.keys).to(card)
    wide = sc.keys.dtype == np.int64 and not ops.int32_id_eligible(sc.keys.max(initial=0))
    name = "frontier_unique_batch_wide" if wide else "frontier_unique_batch"
    plain_keys = keys if wide else keys.to(torch.int32)
    maps = [None] + ([torch.from_numpy(sc.part_of).to(card)] if sc.part_of is not None else [])
    for part_of in maps:
        before = native.LAUNCHES[name]
        got = ops.frontier_unique_batch(keys, part_of=part_of, compact=True)
        torch.cuda.synchronize()
        assert native.LAUNCHES[name] == before + int(sc.keys.size > 0)
        _assert_compact_equal(got, ref.frontier_unique_compact(plain_keys, part_of),
                              sc.keys.shape[0])
    _assert_scratch_clean()


def test_frontier_unique_at_phase8_shape(card):
    """Both forms at phase 8's shape, twice in a row (the kept scratch
    reused), and on keys and flags off the 16-byte grid."""
    from repro_torch.kernels import frontier_unique as fu

    keys, part_of = _phase8_block(card)
    flags = part_of[keys.long()] != torch.arange(4, device=card)[:, None]
    want = ref.frontier_unique_batch(keys, flags)
    want_c = ref.frontier_unique_compact(keys, part_of)
    for k, f in ((keys, flags), (keys, flags), (_misaligned(keys), _misaligned(flags))):
        got = fu.frontier_unique_batch_cuda(k, f)
        torch.cuda.synchronize()
        assert all(_equal(a, b) for a, b in zip(got, want))
        _assert_compact_equal(fu.frontier_unique_compact_cuda(k, part_of), want_c, 4)
    _assert_scratch_clean()


@pytest.mark.parametrize("N", [1, 5, 12_603, 12_600, 16_384, 40_001], ids=str)
@pytest.mark.parametrize("weighted", [False, True], ids=["u", "w"])
def test_score_kernel_at_staged_shapes(card, N, weighted):
    """The scoring round at the staged shape (P = 4, N = C), rows off the
    16-byte grid, rows shorter than the cluster and longer than one pass
    of its blocks, aligned and not: bit for bit against the plain
    version."""
    from repro_torch.kernels import score_update as su

    sc = scenarios.make_score_scenario(f"staged-{N}", N, "degree" if weighted else "rudder",
                                       weighted, P=4, N=N)
    s, a = torch.from_numpy(sc.scores).to(card), torch.from_numpy(sc.accessed).to(card)
    w = None if sc.weights is None else torch.from_numpy(sc.weights).to(card)
    want = ref.score_policy_update_batch(s, a, w, **sc.constants)
    for args in ((s, a, w), (_misaligned(s), _misaligned(a),
                             None if w is None else _misaligned(w))):
        got = su.score_policy_update_batch_cuda(*args, **sc.constants)
        torch.cuda.synchronize()
        assert all(_equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("form", ["mask", "compact", "score"])
def test_staged_kernels_are_one_device_op(card, form, tmp_path):
    """One device operation a call, the kernel, and no fill, memset or
    copy, at phase 8's shapes (after a call that builds the library and
    allocates the scratch). The profiler can miss a call's only kernel, so
    no call may show anything else and at least one must show it."""
    from repro_torch.kernels import frontier_unique as fu
    from repro_torch.kernels import score_update as su

    keys, part_of = _phase8_block(card)
    if form == "mask":
        flags = part_of[keys.long()] != torch.arange(4, device=card)[:, None]

        def call():
            return fu.frontier_unique_batch_cuda(keys, flags)
        kernel = "frontier_unique_kernel"
    elif form == "compact":
        def call():
            return fu.frontier_unique_compact_cuda(keys, part_of)
        kernel = "frontier_unique_kernel"
    else:
        sc = scenarios.make_score_scenario("staged", 9, "rudder", False, P=4, N=12_603)
        s, a = torch.from_numpy(sc.scores).to(card), torch.from_numpy(sc.accessed).to(card)

        def call():
            return su.score_policy_update_batch_cuda(s, a, None, **sc.constants)
        kernel = "score_update_kernel"
    call()
    torch.cuda.synchronize()
    per_call = _device_ops_per_call(call, 5, tmp_path / "trace.json")
    assert all(len(names) <= 1 for names in per_call), per_call
    assert any(names for names in per_call), per_call
    assert all(kernel in n for names in per_call for n in names), per_call
    _assert_scratch_clean()


def test_staged_fallback_on_the_card_matches_cpu(card):
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    g = generate("products", seed=0, scale=0.15).rebase(ops.WIDE_ID_MAX)
    parts = partition_graph(g, 4)
    kw = dict(variant="rudder", deciders=["gemma3-4b"], epochs=2, batch_size=16)
    on_card = DistributedTrainer(parts, device="cuda", **kw)
    on_cpu = DistributedTrainer(parts, device="cpu", **kw)
    before = dict(native.LAUNCHES)
    with pytest.warns(RuntimeWarning, match="staged pipeline"):
        a = on_card.run()
    steps = on_card.epochs * on_card.mb_per_epoch
    for name in ("frontier_unique_batch", "score_policy_update_batch"):
        assert native.LAUNCHES[name] == before[name] + steps
    with pytest.warns(RuntimeWarning, match="staged pipeline"):
        b = on_cpu.run()
    for x, y in zip(a.logs, b.logs):
        assert x == y
    np.testing.assert_array_equal(on_card.engine.scores, on_cpu.engine.scores)
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-5)


GATHER_MEANS = scenarios.gather_mean_scenarios()
SEGMENT_SUMS = scenarios.segment_sum_scenarios()


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return _equal(a, b)


@pytest.mark.parametrize("sc", GATHER_MEANS, ids=[s.name for s in GATHER_MEANS])
def test_gather_mean_kernel_matches_plain(card, sc):
    table, idx = sc.tensors(card)
    before = native.LAUNCHES["gather_mean"]
    got = ops.gather_mean(table, idx)
    want = ref.gather_mean(table, idx)
    torch.cuda.synchronize()
    assert native.LAUNCHES["gather_mean"] == before + (1 if sc.idx.shape[0] else 0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same_bits(got, want)


@pytest.mark.parametrize("sc", SEGMENT_SUMS, ids=[s.name for s in SEGMENT_SUMS])
def test_segment_sum_kernel_matches_plain(card, sc):
    data = sc.tensor(card)
    before = native.LAUNCHES["segment_sum_equal"]
    got = ops.segment_sum_equal(data, sc.k)
    want = ref.segment_sum_equal(data, sc.k)
    torch.cuda.synchronize()
    assert native.LAUNCHES["segment_sum_equal"] == before + (1 if sc.data.shape[0] else 0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same_bits(got, want)


@pytest.mark.parametrize("sc", SEGMENT_SUMS, ids=[s.name for s in SEGMENT_SUMS])
def test_segment_sum_scaled_kernel_matches_plain(card, sc):
    """The scaled form (the fanout mean's ``1 / k``, and a scale that is no
    reciprocal) bit for bit against its plain version, which states the
    roundings of both dtypes."""
    data = sc.tensor(card)
    for scale in (1.0 / sc.k, 0.3):
        got = ops.segment_sum_equal(data, sc.k, scale=scale)
        want = ref.segment_sum_equal(data, sc.k, scale)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _same_bits(got, want)


def test_fanout_mean_is_one_device_op(card, tmp_path):
    """``fanout_mean`` on the card: one device operation a call, the
    segment-sum kernel with the scale in its epilogue; no host-to-device
    copy of ``1 / k`` (which waited on the stream) and no second launch
    for the multiply. Its float32 mean equals the plain version's."""
    from repro_torch.gnn.sage import fanout_mean

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2000, 10, 100)).astype(np.float32)).to(card)
    want = ref.segment_sum_equal(x.reshape(-1, 100), 10, 0.1).reshape(2000, 100)
    got = fanout_mean(x)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    per_call = _device_ops_per_call(lambda: fanout_mean(x), 5, tmp_path / "trace.json")
    assert all(len(names) <= 1 for names in per_call), per_call
    assert any(names for names in per_call), per_call
    assert all("segment_sum_kernel" in n for names in per_call for n in names), per_call


def test_telemetry_session_on_the_card(card):
    """The GraphSAGE step runs both aggregation kernels on the card under a
    telemetry session: every dispatcher call is counted as the kernel
    counts its launches, and the digest equals the CPU run's."""
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    parts = partition_graph(generate("products", seed=0, scale=0.15), 4)
    kw = dict(variant="fixed", epochs=2, batch_size=16, trace=True)
    on_card = DistributedTrainer(parts, device="cuda", telemetry=True, **kw)
    on_cpu = DistributedTrainer(parts, device="cpu", **kw)
    native.reset_launches()
    a = on_card.run()
    launches = dict(native.LAUNCHES)
    b = on_cpu.run()
    assert on_card.last_trace.exact_digest() == on_cpu.last_trace.exact_digest()
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-5)
    counters = a.telemetry["metrics"]["counters"]
    calls = 4 * on_card.epochs * on_card.mb_per_epoch + 1
    for name in ("gather_mean", "segment_sum_equal"):
        assert launches[name] == calls
        assert counters[f"kernel.{name}.calls"]["total"] == calls


MLA_SHAPES = [(1, 4, 32, 8, 64), (2, 8, 64, 16, 700), (1, 16, 128, 64, 512),
              (4, 128, 512, 64, 289),
              (2, 72, 128, 64, 300),  # H not a multiple of the 64-head block
              (2, 8, 32, 4, 100),     # r 32 (a 64-wide box), rr 4 (no TMA: 8-byte rows)
              (1, 8, 512, 128, 200),  # r 512, rr 128: a one-stage ring in bf16
              (1, 8, 512, 672, 200),  # r + rr = 1184, the widest row: queries streamed
              (2, 8, 32, 1152, 130)]
MLA_REL = 1e-2  # bfloat16 on peaked scores: max |diff| <= MLA_REL * max |plain|


def _mla_inputs(card, shape, dtype, seed=0, spread=None):
    return [torch.from_numpy(a).to(card).to(dtype)
            for a in scenarios.mla_inputs(*shape, seed=seed, spread=spread)]


def _assert_mla_close(got, want, dtype, peaked):
    """The reference's bars (1e-4 / 3e-2); on peaked scores bfloat16 also
    within MLA_REL of the plain output's largest value."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if peaked and dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= MLA_REL * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=[str(s) for s in MLA_SHAPES])
def test_mla_flash_decode_kernel_matches_plain(card, shape, dtype):
    """The kernel against its plain version at pos 0, mid-tile, the tile
    and split edges and S - 1, allclose at the reference's bars (1e-4 /
    3e-2)."""
    b, h, r, rr, s = shape
    q_lat, q_rope, c, kr = _mla_inputs(card, shape, dtype)
    scale = 1.0 / (r + rr) ** 0.5
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for pos in sorted({0, 17, 31, 32, 63, 64, 100, s // 2, s - 2, s - 1}):
        if pos >= s:
            continue
        before = native.LAUNCHES["mla_flash_decode"]
        got = ops.mla_flash_decode(q_lat, q_rope, c, kr, pos, scale=scale)
        want = ref.mla_latent_attention(q_lat, q_rope, c, kr, pos, scale)
        torch.cuda.synchronize()
        assert native.LAUNCHES["mla_flash_decode"] == before + 1
        assert got.dtype == dtype and got.shape == (b, h, r)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=[str(s) for s in MLA_SHAPES])
def test_mla_flash_decode_peaked_scores(card, shape, dtype):
    """The same positions on queries scaled so that the scores spread by
    scenarios.PEAKED: a softmax far from uniform, which a wrong score term,
    a dropped row or uniform weights visibly move."""
    b, h, r, rr, s = shape
    q_lat, q_rope, c, kr = _mla_inputs(card, shape, dtype, spread=scenarios.PEAKED)
    scale = 1.0 / (r + rr) ** 0.5
    for pos in sorted({0, 17, 31, 32, 63, 64, 100, s // 2, s - 2, s - 1}):
        if pos >= s:
            continue
        got = ops.mla_flash_decode(q_lat, q_rope, c, kr, pos, scale=scale)
        want = ref.mla_latent_attention(q_lat, q_rope, c, kr, pos, scale)
        torch.cuda.synchronize()
        _assert_mla_close(got, want, dtype, peaked=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128, 512, 64, 289), (2, 8, 32, 4, 100)],
                         ids=["serve", "r32-rr4"])
def test_mla_flash_decode_ignores_nan_past_pos(card, shape, dtype):
    """Cache rows past pos hold NaN: the output is finite and equals the
    plain version on a zeroed tail (a masked row must contribute exact
    zeros, and 0 times NaN is NaN on the tensor cores), on near-uniform and
    on peaked scores."""
    b, h, r, rr, s = shape
    scale = 1.0 / (r + rr) ** 0.5
    for spread, pos in itertools.product((None, scenarios.PEAKED), (0, 37, s // 2)):
        q_lat, q_rope, c, kr = _mla_inputs(card, shape, dtype, seed=4, spread=spread)
        c_nan, kr_nan = c.clone(), kr.clone()
        c_nan[:, pos + 1 :] = float("nan")
        kr_nan[:, pos + 1 :] = float("nan")
        c_zero, kr_zero = c.clone(), kr.clone()
        c_zero[:, pos + 1 :] = 0
        kr_zero[:, pos + 1 :] = 0
        got = ops.mla_flash_decode(q_lat, q_rope, c_nan, kr_nan, pos, scale=scale)
        want = ref.mla_latent_attention(q_lat, q_rope, c_zero, kr_zero, pos, scale)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got.float()).all())
        _assert_mla_close(got, want, dtype, peaked=spread is not None)


def _mla_sweep(n=16, seed=11):
    """Seeded shapes over every R, RR from 0 to 1000 (8-byte rows, a
    one-stage ring and streamed queries among them), H on and off the
    64-head block, and pos inside, at the end of and past the cache."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        r = (32, 64, 128, 256, 512)[i % 5]
        rr = (0, 4, 8, 12, 20, 64, 72, 1000)[i % 8]
        h = (1, 3, 64, 65, 128, 130)[i % 6]
        s = int(rng.integers(1, 1500))
        pos = int(rng.choice([0, rng.integers(0, s), s - 1, s + 5]))
        cases.append((int(rng.integers(1, 4)), h, r, rr, s, pos))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _mla_sweep(), ids=[str(c) for c in _mla_sweep()])
def test_mla_flash_decode_sweep(card, case, dtype):
    """A seeded sweep of shapes against the plain version, on near-uniform
    and on peaked scores."""
    b, h, r, rr, s, pos = case
    scale = 1.0 / (r + rr) ** 0.5
    for spread in (None, scenarios.PEAKED):
        args = _mla_inputs(card, (b, h, r, rr, s), dtype, seed=sum(case), spread=spread)
        got = ops.mla_flash_decode(*args, pos, scale=scale)
        want = ref.mla_latent_attention(*args, pos, scale)
        torch.cuda.synchronize()
        _assert_mla_close(got, want, dtype, peaked=spread is not None)


def test_mla_flash_decode_kernel_by_dtype(card):
    """bfloat16 calls run the tensor-core kernel, float32 calls the
    CUDA-core kernel; each call counts once in LAUNCHES either way."""
    from repro_torch.kernels import mla_decode as md

    for dtype, kernel in ((torch.bfloat16, "tensor_cores"), (torch.float32, "cuda_cores")):
        args = _mla_inputs(card, (2, 128, 512, 64, 130), dtype)
        before = dict(md.KERNEL_LAUNCHES)
        launches = native.LAUNCHES["mla_flash_decode"]
        for pos in (5, 129):
            ops.mla_flash_decode(*args, pos)
        torch.cuda.synchronize()
        assert native.LAUNCHES["mla_flash_decode"] == launches + 2
        assert {k: v - before[k] for k, v in md.KERNEL_LAUNCHES.items()} == {
            name: 2 if name == kernel else 0 for name in md.KERNEL_LAUNCHES
        }


# --------------------------------------------------------------------------- #
# The legacy runtime, the classifier plane and the sweep on the card.
def test_legacy_on_the_card_matches_cpu(card):
    """The scale-1 legacy run, GraphSAGE on the card (``gather_mean`` and
    ``segment_sum_equal`` once per PE, step and mean, plus the accuracy
    pass), against the same run on the CPU and the vectorized run."""
    from dataclasses import asdict

    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    parts = partition_graph(generate("products", seed=0, scale=1), 4)
    kw = dict(variant="rudder", deciders=["gemma3-4b"], epochs=2, batch_size=256,
              runtime="legacy")
    on_card = DistributedTrainer(parts, device="cuda", **kw)
    before = dict(native.LAUNCHES)
    a = on_card.run()
    torch.cuda.synchronize()
    calls = 4 * on_card.epochs * on_card.mb_per_epoch + 1
    assert native.LAUNCHES["gather_mean"] == before["gather_mean"] + calls
    assert native.LAUNCHES["segment_sum_equal"] == before["segment_sum_equal"] + calls
    assert native.LAUNCHES["fused_frontier_step"] == before["fused_frontier_step"]
    b = DistributedTrainer(parts, device="cpu", **kw).run()
    c = DistributedTrainer(parts, device="cuda", **dict(kw, runtime="vectorized")).run()
    for run in (b, c):
        assert [asdict(x) for x in a.logs] == [asdict(y) for y in run.logs]
        assert a.epoch_times == run.epoch_times
        np.testing.assert_allclose(a.losses, run.losses, rtol=1e-4, atol=1e-5)


def test_classifier_fits_on_the_card_match_cpu(card):
    """Every model fitted on the card and on the CPU from the same
    initial arrays: equal decisions on every row; the card's fitted model
    gives its own logits on the CPU to 1e-5; the two fits' logits agree
    to 1e-3 (200 SGD steps amplify the card's summation order where a
    ReLU or hinge kink switches: 9.9e-4 on ``mlp``, at most 3.3e-6 on the
    others, NVIDIA H100 80GB HBM3, 700 W)."""
    from repro_torch.core import make_classifier

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(400, 8)).astype(np.float32)
    y = ((X[:, 0] < 0.5) & (X[:, 2] > 0.3)).astype(np.float32)
    for name in ("lr", "mlp", "svm", "tabnet", "rf", "xgb"):
        fitted = []
        for dev in ("cuda", "cpu"):
            clf = make_classifier(name, device=dev)
            if hasattr(clf, "init_params"):
                init = {k: v.numpy() for k, v in clf.init_params().items()}
                clf.fit(X[:300], y[:300], init=init)
            else:
                clf.fit(X[:300], y[:300])
            fitted.append(clf)
        on_card, on_cpu = fitted
        if hasattr(on_card, "params"):
            xs = torch.from_numpy(X)
            with torch.no_grad():
                za = on_card.logits(on_card.params, xs.cuda()).cpu().numpy()
                zc = on_card.logits({k: v.cpu() for k, v in on_card.params.items()}, xs)
                zb = on_cpu.logits(on_cpu.params, xs).numpy()
            np.testing.assert_allclose(za, zc.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(za, zb, rtol=1e-3, atol=1e-3)
        else:
            assert on_card.stumps == on_cpu.stumps
        assert [on_card.decide(x) for x in X] == [on_cpu.decide(x) for x in X]


def test_sweep_on_the_card_matches_cpu(card):
    from repro_torch.runtime import default_grid, run_sweep, validate_rows

    grid = default_grid(num_parts=(2,), batch_sizes=(16,), fanouts=((5, 10),),
                        variants=("fixed", "massivegnn"), epochs=2)
    assert len(grid) == 2
    rows = run_sweep(grid, device="cuda")
    assert rows == run_sweep(grid, device="cpu")
    assert validate_rows(rows) == []


# --------------------------------------------------------------------------- #
# The zoo's serving path on the card: MoE layers, GQA attention, prefill.
def _zoo_params(arch, devices):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    cpu = M.init_params(cfg, 7, device="cpu")
    return cfg, [_to(cpu, dev) for dev in devices]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"])
def test_moe_forward_on_the_card_matches_cpu(card, arch):
    """One MoE layer of the smoke config in float32: the card's output
    allclose 1e-5 to the CPU's, and two card runs bit-identical (the
    combine sums each token's copies in a fixed order, no atomics)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg, (p_cpu, p_card) = _zoo_params(arch, ("cpu", card))
    layer = next(i for i, k in enumerate(M.layer_kinds(cfg)) if k == "moe")
    group = M._layers(p_cpu["groups"][0], 1)[0]  # a unit of every layer
    unit = M._layers(p_card["groups"][0], 1)[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32))
    want, _ = moe.moe_forward(cfg, group[f"b{layer}"]["ffn"], x)
    a, _ = moe.moe_forward(cfg, unit[f"b{layer}"]["ffn"], x.to(card))
    b, _ = moe.moe_forward(cfg, unit[f"b{layer}"]["ffn"], x.to(card))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-8b", "xlstm-350m", "zamba2-1.2b",
                                  "whisper-large-v3", "phi-3-vision-4.2b"])
def test_gqa_serve_on_the_card_matches_cpu(card, arch):
    """``serve_batch`` on the smoke config in float32 from the same
    weights: greedy tokens equal, no native kernel launched (GQA, the
    recurrences and Whisper's encoder and cross attention are plain
    PyTorch); Gemma2 decodes past its window of 8."""
    from repro_torch.launch import serve

    cfg, (p_cpu, p_card) = _zoo_params(arch, ("cpu", card))
    kw = dict(requests=3, prompt_len=8, gen_len=10, seed=1)
    want = serve.serve_batch(arch, cfg=cfg, params=p_cpu, device="cpu", **kw)
    before = dict(native.LAUNCHES)
    got = serve.serve_batch(arch, cfg=cfg, params=p_card, device="cuda", **kw)
    assert native.LAUNCHES == before
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "gemma2-2b",
                                  "xlstm-350m", "zamba2-1.2b", "phi-3-vision-4.2b"])
def test_prefill_matches_decode_on_the_card(card, arch):
    """``forward`` against token-by-token decode on the card (float32,
    1e-3 x max(|logits|, 1)), 14 positions (past Gemma2's window), and
    ``make_prefill_step`` equal to the forward's last position."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg, (params,) = _zoo_params(arch, (card,))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 14)).astype(np.int32)).to(card)
    with torch.no_grad():
        full, _ = M.forward(cfg, params, toks)
        last = make_prefill_step(cfg)(params, {"tokens": toks})
        cache = M.init_cache(cfg, 2, 16, device=card)
        dec = []
        for t in range(14):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t : t + 1], t)
            dec.append(lg[:, 0])
    err = (torch.stack(dec, dim=1) - full).abs().max().item()
    assert err < 1e-3 * max(full.abs().max().item(), 1.0)
    assert torch.equal(last, full[:, -1])


def test_whisper_on_the_card_matches_cpu(card):
    """Whisper's smoke config in float32 from the same weights and frames:
    ``encode``, ``forward`` and the cross cache of ``prefill_cross_cache``
    allclose 1e-4 to the CPU's; on the card, ``forward`` against
    token-by-token decode within 1e-3 x max(|logits|, 1) and
    ``make_prefill_step`` equal to the forward's last position; no native
    kernel launched."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg, trees = _zoo_params("whisper-large-v3", ("cpu", card))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32))
    frames = torch.from_numpy(rng.normal(0, 0.02, size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32))
    before = dict(native.LAUNCHES)
    runs = []
    with torch.no_grad():
        for p, dev in zip(trees, ("cpu", card)):
            t, f = toks.to(dev), frames.to(dev)
            memory = M.encode(cfg, p, f)
            full, _ = M.forward(cfg, p, t, frames=f)
            last = make_prefill_step(cfg)(p, {"tokens": t, "frames": f})
            cache = M.prefill_cross_cache(cfg, p, M.init_cache(cfg, 2, 12, device=dev), f)
            cross = (cache[0]["b0"]["ck"].clone(), cache[0]["b0"]["cv"].clone())
            dec = []
            for i in range(10):
                lg, cache = M.decode_step(cfg, p, cache, t[:, i : i + 1], i)
                dec.append(lg[:, 0])
            runs.append((memory, full, last, *cross, torch.stack(dec, dim=1)))
    assert native.LAUNCHES == before
    for a, b in zip(runs[1], runs[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    _, full, last, _, _, dec = runs[1]
    assert (dec - full).abs().max().item() < 1e-3 * max(full.abs().max().item(), 1.0)
    assert torch.equal(last, full[:, -1])


def test_vision_prefix_on_the_card_matches_cpu(card):
    """Phi-3-vision's smoke config in bf16 from the same weights and
    float32 patches: the prefix goes through the projector in float32 on
    both devices; logits allclose 3e-2, and the loss over the text
    positions within 1e-2 relative."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config("phi-3-vision-4.2b")
    p_cpu = M.init_params(cfg, 7, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(
        np.int32)), "patches": torch.from_numpy(rng.normal(0, 0.02, size=(
            2, cfg.num_patches, M.VISION_EMBED_DIM)).astype(np.float32))}
    out = []
    with torch.no_grad():
        for dev in ("cpu", card):
            p = _to(p_cpu, dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            logits, _ = M.forward(cfg, p, b["tokens"], patches=b["patches"])
            loss, _ = M.lm_loss(cfg, p, b)
            out.append((logits.cpu(), float(loss)))
    assert tuple(out[1][0].shape) == (2, cfg.num_patches + 10, cfg.vocab_size)
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-2)


def test_embedding_backward_sums_in_float32_on_the_card(card):
    """``common.embed_tokens``' backward on bf16: every row the float64 sum
    of its gradients rounded once to bf16, and two runs bit-identical."""
    from repro_torch.models.common import embed_tokens

    gen = torch.Generator(device=card).manual_seed(0)
    table = torch.randn((5000, 96), generator=gen, device=card).to(torch.bfloat16)
    tokens = torch.randint(0, 50, (4, 300), generator=gen, device=card)  # many repeats
    up = torch.randn((4, 300, 96), generator=gen, device=card).to(torch.bfloat16)

    def grad():
        e = table.detach().requires_grad_()
        return torch.autograd.grad(embed_tokens(e, tokens), e, up)[0]

    a, b = grad(), grad()
    want = torch.zeros((5000, 96), dtype=torch.float64, device=card)
    want.index_add_(0, tokens.reshape(-1), up.reshape(-1, 96).double())
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(a, want.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "gemma2-2b",
                                  "xlstm-350m", "zamba2-1.2b", "whisper-large-v3",
                                  "phi-3-vision-4.2b"])
def test_train_steps_on_the_card_match_cpu(card, arch):
    """The smoke config in float32 from the same weights and batches: the
    first batch's gradients within 1e-4 x each leaf's largest, and three
    ``make_train_step`` steps' losses within 1e-4 relative (the
    parameters after them are not compared: AdamW's first steps move an
    element by about lr whatever its gradient's size, so a gradient near
    0 that differs in its last bits moves it by up to 2 lr); then on the
    card ``remat=True`` against ``remat=False``, bit-identical."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten, tree_map

    cfg, trees = _zoo_params(arch, ("cpu", card))
    pipe = TokenPipeline(cfg, 2, 16, seed=4)
    batches = [pipe.next_batch() for _ in range(3)]
    runs = []
    for p, dev in zip(trees, ("cpu", card)):
        p = tree_map(torch.clone, p)  # the steps write in place
        first = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        grads = [g.cpu() for g in flatten(loss_and_grads(cfg, p, first, remat=False)[2])[0]]
        opt = adamw_init(p, cfg.opt_dtype)
        step = make_train_step(cfg, lr=3e-3, remat=False)
        losses = []
        for b in batches:
            p, opt, m = step(p, opt, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs.append((grads, losses, p))
    (g_cpu, l_cpu, _), (g_card, l_card, tree_card) = runs
    for a, b in zip(g_card, g_cpu):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4, atol=0)
    batch = {k: torch.from_numpy(v).to(card) for k, v in batches[0].items()}
    plain, remat = (loss_and_grads(cfg, tree_card, batch, remat=r) for r in (False, True))
    assert torch.equal(plain[0], remat[0])
    assert all(torch.equal(a, b) for a, b in zip(flatten(plain[2])[0], flatten(remat[2])[0]))


# --------------------------------------------------------------------------- #
# The recurrent mixers on the card.
_MIXERS = {"mamba2": ("zamba2-1.2b", 0), "mlstm": ("xlstm-350m", 0), "slstm": ("xlstm-350m", 1)}


def _mixer(name, devices):
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    arch, index = _MIXERS[name]
    cfg, trees = _zoo_params(arch, devices)
    assert M.layer_kinds(cfg)[index] == name
    fns = tuple(getattr(ssm, f"{name}_{what}") for what in ("forward", "init_state", "decode"))
    return cfg, [M._layers(t["groups"][0], 1)[0][f"b{index}"]["mixer"] for t in trees], fns


@pytest.mark.parametrize("name", list(_MIXERS))
def test_ssm_mixers_on_the_card_match_cpu(card, name):
    """Each mixer of the smoke configs in float32 from the same weights:
    the sequence form (S = 12), six decode steps with every state leaf
    after each, and the gradients of ``sum(forward(x) * w)`` with respect
    to the parameters and ``x``, card against CPU within 1e-4 (gradients
    within 1e-4 x each one's largest); the card's state written in place."""
    cfg, (p_cpu, p_card), (fwd, init_state, decode) = _mixer(name, ("cpu", card))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    runs = []
    for p, dev in ((p_cpu, "cpu"), (p_card, card)):
        with torch.no_grad():
            out = fwd(cfg, p, x.to(dev)).cpu()
            state = init_state(cfg, 2, device=dev)
            held = dict(state)
            steps = []
            for t in range(6):
                y, state = decode(cfg, p, x[:, t : t + 1].to(dev), state)
                assert all(state[k] is held[k] for k in held)
                # copies: on the CPU ``.cpu()`` would alias the state,
                # which the next step overwrites in place
                steps.append((y.cpu(), {k: v.to("cpu", copy=True) for k, v in state.items()}))
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        xl = x.to(dev).requires_grad_()
        grads = torch.autograd.grad((fwd(cfg, live, xl) * w.to(dev)).sum(),
                                    [*live.values(), xl], allow_unused=True)
        runs.append((out, steps, [None if g is None else g.cpu() for g in grads]))
    (o_cpu, s_cpu, g_cpu), (o_card, s_card, g_card) = runs
    torch.testing.assert_close(o_card, o_cpu, rtol=1e-4, atol=1e-4)
    for (ya, sa), (yb, sb) in zip(s_card, s_cpu):
        torch.testing.assert_close(ya, yb, rtol=1e-4, atol=1e-4)
        for k in sb:
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-4, atol=1e-4)
    for a, b in zip(g_card, g_cpu):
        assert (a is None) == (b is None)
        if b is not None:
            assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


def test_mlstm_chunk_checkpoint_is_bit_identical_on_the_card(card, monkeypatch):
    """S = 128 (two checkpointed chunks of 64 steps): the gradients equal
    the plain loop's (the checkpoint replaced by a plain call) bit for bit
    on the card."""
    from repro_torch.models import ssm

    cfg, (p,), _ = _mixer("mlstm", (card,))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 2 * ssm.MLSTM_CHUNK, cfg.d_model)).astype(np.float32)).to(card)

    def grads():
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        xl = x.clone().requires_grad_()
        out = ssm.mlstm_forward(cfg, live, xl)
        return torch.autograd.grad(out.square().sum(), [*live.values(), xl], allow_unused=True)

    checkpointed = grads()
    monkeypatch.setattr(ssm, "checkpoint", lambda fn, *args, **kw: fn(*args))
    for a, b in zip(checkpointed, grads()):
        assert (a is None and b is None) or torch.equal(a, b)
