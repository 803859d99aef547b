"""The card's peaks and the least time of a launch.

Frozen copies: the peaks of ``src/repro_torch/launch/mesh.py``
(``HBM_BW``, ``PEAK_FLOPS_FP32``, ``PEAK_FLOPS_BF16``; NVIDIA H100 80GB
HBM3 SXM spec sheet, dense, at its 700 W limit) and ``tensor_bytes``,
``bound`` and ``frontier_ops`` of ``chip_smoke.py``. ``bound`` here
returns seconds, not milliseconds.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores (TF32 off)
BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense


def tensor_bytes(*groups) -> int:
    """Bytes of every tensor in ``groups``: each input read once, each
    output written once."""
    return sum(
        t.numel() * t.element_size()
        for g in groups
        for t in g
        if t is not None and hasattr(t, "numel")
    )


def bound(nbytes: int, nops: int, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least seconds a launch can take: the larger of its bytes over
    the HBM bandwidth and its operations over ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


def frontier_ops(args) -> int:
    """Operations of the frontier step on these inputs: the row sort (Mt
    log2 Mt compares per PE) and some ten integer operations per frontier
    position and per slot and candidate (masks, ranks, probe)."""
    ids, touched_aug, cand = args[0], args[6], args[8]
    P, C = ids.shape
    Mt = touched_aug.shape[1] - 1
    K = cand.shape[1]
    return int(P * (Mt * (math.log2(max(Mt, 2)) + 10) + 10 * (C + K)))
