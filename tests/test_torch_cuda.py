"""The port's kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an NVIDIA card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels are built from ``src/repro_torch/kernels/csrc`` at first use.
Every kernel is held bit for bit against its plain PyTorch version on the
same CUDA tensors, and a short trainer run on the card against the same
run on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import native, ops, ref, scenarios

pytestmark = pytest.mark.cuda

SCENARIOS = scenarios.frontier_scenarios()


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
