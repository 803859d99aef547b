"""The control: the reference put in the program's place and computed in
TF32 (the precision below the configurations' float32 with TF32 off)
comes out not correct under each cell's limits, while the program comes
out correct. On the CPU TF32's products are stood in for by operands
rounded to its 10-bit mantissa; on a card (``-m cuda``) the card's own
TF32 runs."""

import pytest
import torch
from tiny import CELLS, SEED, tiny

from benchlib import check
from benchlib.runner import run_cell

TRAINING = ("loss_gap", "grad_gap_median", "change_gap_median")


def control_fails(name, device):
    cell = tiny(name)
    out = run_cell(cell, SEED + 4, 0, False, device=device, window=False, controls=True)
    assert out.correct, out.checks
    limits = {k: cell.limits[k] for k in TRAINING}
    ok, checks = check.judge(out.controls["tf32"], limits)
    assert not ok, checks
    for fault in ("half_batch", "no_exchange"):
        assert not check.judge(out.controls[fault], limits)[0], fault


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    control_fails(name, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    control_fails(name, "cuda")
