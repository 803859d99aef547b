"""Public dispatchers of the port's kernels.

A dispatcher routes by the device of the tensors it is given: CPU
tensors go to the plain PyTorch version in :mod:`repro_torch.kernels.ref`,
CUDA tensors to the hand-written kernel, which either launches or
raises. There is no fallback from the card to the plain version, and no
other device. :data:`LAUNCHES` counts the kernel launches on the card.

The id-range constants and the host-side wide-id codec are copied from
the reference's ``kernels/ops.py`` so both packages share one
eligibility contract.
"""

from __future__ import annotations

import numpy as np

from .. import telemetry
from . import ref
from .native import LAUNCHES, reset_launches

__all__ = [
    "fused_frontier_step_batch",
    "LAUNCHES",
    "reset_launches",
    "INT32_SENTINEL",
    "INT32_ID_MAX",
    "WIDE_ID_MAX",
    "WIDE_SHIFT",
    "WIDE_MASK",
    "int32_id_eligible",
    "wide_id_eligible",
    "split_ids",
    "join_ids",
]

#: Two-word id encoding of the reference (``kernels/ref.py``): a 64-bit
#: id splits into ``hi = id >> WIDE_SHIFT`` / ``lo = id & WIDE_MASK``.
WIDE_SHIFT = 30
WIDE_MASK = (1 << WIDE_SHIFT) - 1

#: The device kernels' padding sentinel (``frontier_pack``'s miss
#: compaction sorts empty positions to ``int32.max``). A *legitimate* id
#: equal to the sentinel would alias empty slots, so the narrow-id
#: eligibility bound strictly excludes it.
INT32_SENTINEL = int(np.iinfo(np.int32).max)

#: Largest node id the narrow (single-word int32) device path may carry:
#: ``2**31 - 2`` — one below ``INT32_SENTINEL``, see above.
INT32_ID_MAX = INT32_SENTINEL - 1

#: Largest node id the wide (two-word ``(hi, lo)``) device path may
#: carry: ``hi`` must stay below ``INT32_SENTINEL`` so the wide sentinel
#: pair ``(int32.max, int32.max)`` never aliases a real id, and
#: ``lo < 2**WIDE_SHIFT`` by construction.
WIDE_ID_MAX = (INT32_ID_MAX << WIDE_SHIFT) | WIDE_MASK


def int32_id_eligible(max_id) -> bool:
    """True when ids up to ``max_id`` fit the narrow int32 device path
    (``max_id <= 2**31 - 2``, strictly excluding the sentinel)."""
    return int(max_id) <= INT32_ID_MAX


def wide_id_eligible(max_id) -> bool:
    """True when ids up to ``max_id`` fit the two-word wide device path
    (``max_id <= WIDE_ID_MAX``, about 2^61)."""
    return int(max_id) <= WIDE_ID_MAX


def split_ids(ids):
    """Split an int64 id array into ``(hi, lo)`` int32 word planes.

    Non-negative ids split base-``2**WIDE_SHIFT``; negative sentinels
    (-1 empty, -2 masked) map to the equal pair ``(v, v)`` so pair
    equality is id equality and ``hi >= 0`` is validity."""
    ids = np.asarray(ids, dtype=np.int64)
    neg = ids < 0
    v32 = ids.astype(np.int32)  # only read where negative (small values)
    hi = np.where(neg, v32, (ids >> WIDE_SHIFT).astype(np.int32))
    lo = np.where(neg, v32, (ids & WIDE_MASK).astype(np.int32))
    return hi, lo


def join_ids(hi, lo):
    """Inverse of :func:`split_ids`: rebuild int64 ids on host
    (``hi < 0`` rows are sentinels and pass through as ``hi``)."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    return np.where(
        hi < 0,
        hi.astype(np.int64),
        (hi.astype(np.int64) << WIDE_SHIFT) | lo.astype(np.int64),
    )


@telemetry.profiled("fused_frontier_step_batch")
def fused_frontier_step_batch(
    ids,
    scores,
    valid,
    accessed,
    in_capacity,
    weights,
    touched_aug,
    part_of,
    cand,
    node_weights,
    *,
    cand_cap: int,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = 1.0,
):
    """Single-launch device step: dedup → score → replace → probe, one
    launch per minibatch.

    ``touched_aug`` is the raw ``(P, Mt + 1)`` int32 frontier block
    (unsorted, duplicated) with the per-PE gate bits in its last column
    — the step's one host→device transfer. ``cand`` is the previous
    launch's on-device miss compaction; ``part_of`` and ``node_weights``
    are persistent device tensors. Returns ``(ids2, scores2, valid2,
    accessed3, weights2, cand_next, packed, counters)``; only ``packed``
    crosses back to host.

    Routed by ``ids.device``: the CPU runs the plain version
    (:func:`repro_torch.kernels.ref.fused_frontier_step`), CUDA the
    Hopper kernel (:mod:`repro_torch.kernels.fused_step`), which handles
    every shape itself (the drained ``Mt == 1`` launch, the initial
    ``(P, 1)`` all -1 candidate block, capacity-masked slots).
    """
    constants = dict(
        cand_cap=int(cand_cap),
        increment=float(increment),
        decay=float(decay),
        threshold=float(threshold),
        score_cap=float(score_cap),
        mode=mode,
        initial_score=float(initial_score),
    )
    args = (
        ids, scores, valid, accessed, in_capacity, weights,
        touched_aug, part_of, cand, node_weights,
    )
    kind = ids.device.type
    if kind == "cpu":
        return ref.fused_frontier_step(*args, **constants)
    if kind == "cuda":
        from .fused_step import fused_frontier_step_cuda

        return fused_frontier_step_cuda(*args, **constants)
    raise ValueError(f"no fused_frontier_step kernel for device {ids.device}")
