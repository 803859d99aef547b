"""The port's kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an NVIDIA card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels are built from ``src/repro_torch/kernels/csrc`` at first use.
Every kernel is held bit for bit against its plain PyTorch version on the
same CUDA tensors (``fused_frontier_step``, ``fused_step``,
``gather_rows_batch`` and ``gather_rows`` over their seeded scenario
sets), a short trainer run on the card against the same run on the CPU,
and one committed golden trace re-recorded on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import native, ops, ref, scenarios

pytestmark = pytest.mark.cuda

SCENARIOS = scenarios.frontier_scenarios()
STEP_SCENARIOS = scenarios.fused_step_scenarios()
GATHERS = scenarios.gather_scenarios()


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
