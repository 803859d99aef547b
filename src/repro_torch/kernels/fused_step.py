"""The single-launch prefetch step on the card: the Hopper kernel
``csrc/fused_frontier_step.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``fused_frontier_step_pallas``. The
wrapper keeps the reference's split between framework ops and the
kernel: the frontier row sort before it and the miss compaction and
packed readback after it (:func:`repro_torch.kernels.ref.frontier_pack`)
stay PyTorch ops, as they were XLA ops around the ``pallas_call``; the
dedup → score → replace → probe → code core is the CUDA kernel. Its
plain version is :func:`repro_torch.kernels.ref.fused_frontier_step`,
which it matches bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .ref import frontier_pack

_MODES = {"accumulate": 0, "reset": 1, "capped": 2}
_NAME = "fused_frontier_step"


def _bind() -> ctypes.CDLL:
    lib = native.library(_NAME)
    fn = lib.rudder_fused_frontier_step
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = (
            [ctypes.c_int] * 5        # P, C, K, Mt, N
            + [P] * 11                # aug .. node_weights
            + [P] * 8                 # ids2 .. slot_pos
            + [P] * 3                 # slot_of, cand_first, rank_slot
            + [ctypes.c_float] * 5    # increment .. initial_score
            + [ctypes.c_int, P]       # mode, stream
        )
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def fused_frontier_step_cuda(
    ids: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    accessed: torch.Tensor,
    in_capacity: torch.Tensor,
    weights: torch.Tensor | None,
    touched_aug: torch.Tensor,
    part_of: torch.Tensor,
    cand: torch.Tensor,
    node_weights: torch.Tensor | None,
    *,
    cand_cap: int,
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """One launch of the Hopper frontier-step kernel; same arguments and
    outputs as :func:`repro_torch.kernels.ref.fused_frontier_step`.

    Takes int32 ids (``touched_aug``, ``ids``, ``cand``, ``part_of``),
    float32 scores and weights, bool masks, all contiguous on one CUDA
    device; ids must lie in ``[0, len(part_of))`` or be negative
    padding. Raises on anything else — there is no other route on the
    card."""
    P, C = ids.shape
    K = cand.shape[1]
    Mt = touched_aug.shape[1] - 1
    N = part_of.shape[0]
    if C == 0 or Mt < 0:
        raise ValueError(f"need C >= 1 slots and a gate column, got C={C}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    for name, t, dt, shape in (
        ("ids", ids, torch.int32, (P, C)),
        ("scores", scores, torch.float32, (P, C)),
        ("valid", valid, torch.bool, (P, C)),
        ("accessed", accessed, torch.bool, (P, C)),
        ("in_capacity", in_capacity, torch.bool, (P, C)),
        ("touched_aug", touched_aug, torch.int32, (P, Mt + 1)),
        ("part_of", part_of, torch.int32, (N,)),
        ("cand", cand, torch.int32, (P, K)),
    ):
        _check(t, name, dt, shape)
    if weights is not None:
        _check(weights, "weights", torch.float32, (P, C))
    if node_weights is not None:
        _check(node_weights, "node_weights", torch.float32, (N,))
    dev = ids.device
    lib = _bind()

    with torch.cuda.device(dev):
        sk = torch.sort(touched_aug[:, :Mt], dim=1).values.contiguous()
        ids2 = torch.empty_like(ids)
        s2 = torch.empty_like(scores)
        valid2 = torch.empty_like(valid)
        acc3 = torch.empty_like(accessed)
        w2 = torch.empty_like(weights) if weights is not None else None
        code = torch.empty((P, Mt), dtype=torch.int32, device=dev)
        placed = torch.empty((P, K), dtype=torch.bool, device=dev)
        slot_pos = torch.empty((P, C), dtype=torch.int32, device=dev)
        slot_of = torch.full((P, N), -1, dtype=torch.int32, device=dev)
        cand_first = torch.full(
            (P, N), int(np.iinfo(np.int32).max), dtype=torch.int32, device=dev
        )
        rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rudder_fused_frontier_step(
            P, C, K, Mt, N,
            _ptr(touched_aug), _ptr(sk), _ptr(ids), _ptr(scores), _ptr(valid),
            _ptr(accessed), _ptr(in_capacity), _ptr(weights), _ptr(part_of),
            _ptr(cand), _ptr(node_weights),
            _ptr(ids2), _ptr(s2), _ptr(valid2), _ptr(acc3), _ptr(w2),
            _ptr(code), _ptr(placed), _ptr(slot_pos),
            _ptr(slot_of), _ptr(cand_first), _ptr(rank_slot),
            float(increment), float(decay), float(threshold), float(score_cap),
            float(initial_score), _MODES[mode], stream,
        )
        native.check(err, _NAME)
        native.LAUNCHES[_NAME] += 1
        n_place = placed.sum(dim=1, dtype=torch.int32)
        n_valid = valid2.sum(dim=1, dtype=torch.int32)
        cand_next, packed, counters = frontier_pack(
            sk, code, placed, slot_pos, n_place, n_valid, cand_cap=cand_cap
        )
    return ids2, s2, valid2, acc3, w2, cand_next, packed, counters
