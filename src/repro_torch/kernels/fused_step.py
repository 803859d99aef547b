"""The prefetch steps on the card: the Hopper kernels
``csrc/fused_frontier_step.cu`` and ``csrc/fused_step.cu`` behind
PyTorch wrappers.

Ports of the reference's Pallas ``fused_frontier_step_pallas`` (the
single-launch raw path) and ``fused_step_pallas`` (the ragged-seed-block
path), and of their wide-id twins ``fused_frontier_step_wide_pallas``
and ``fused_step_wide_pallas``, which take int64 ids here where the
reference splits them into ``(hi, lo)`` int32 word planes. The wrappers
keep the reference's split between framework ops and the kernel: the
frontier row sort before it and the miss compaction, packed readback and
payload scatter after it (:func:`repro_torch.kernels.ref.frontier_pack`)
stay PyTorch ops, as they were XLA ops around the ``pallas_call``; the
score → replace → probe core is CUDA. Their plain versions are
:func:`repro_torch.kernels.ref.fused_frontier_step`,
:func:`repro_torch.kernels.ref.fused_step` and their ``_wide`` twins,
which they match bit for bit.

The kernels look ids up in per-PE direct-mapped ``(P, span)`` maps keyed
by ``id - lo`` (``prefetch_state.cuh``). A wide launch whose maps would
pass :data:`MAP_BUDGET_BYTES` (a sparse id set spread over a span of
2^40, say) takes the kernels' sorted mode instead: the wrapper sorts the
resident ids and the candidates once per launch and the kernel
binary-searches them. Both modes give the same outputs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .native import check_tensor, ptr
from .ref import frontier_pack, frontier_pack_wide

_MODES = {"accumulate": 0, "reset": 1, "capped": 2}
_INT32_MAX = int(np.iinfo(np.int32).max)
#: The sorted mode's padding for invalid resident slots: no id the wide
#: path accepts (``<= WIDE_ID_MAX``, about 2^61) can equal it.
_INT64_MAX = int(np.iinfo(np.int64).max)

#: Most bytes a wide launch spends on its two ``(P, span)`` int32 maps;
#: past it the launch takes the sorted mode. (The checks on the card set it
#: to 0 for a while to hold the sorted mode on dense scenario sets too.)
MAP_BUDGET_BYTES = 256 << 20

_PTR = ctypes.c_void_p
_FRONTIER_ARGS = (
    [ctypes.c_int] * 5        # P, C, K, Mt, N
    + [_PTR] * 11             # aug .. node_weights
    + [_PTR] * 8              # ids2 .. slot_pos
    + [_PTR] * 3              # slot_of, cand_first, rank_slot
    + [ctypes.c_float] * 5    # increment .. initial_score
    + [ctypes.c_int, _PTR]    # mode, stream
)
_STEP_ARGS = (
    [ctypes.c_int] * 5        # P, C, M, K, N
    + [_PTR] * 12             # ids .. active_probe
    + [_PTR] * 9              # ids2 .. slot_pos
    + [_PTR] * 3              # slot_of, cand_first, rank_slot
    + [ctypes.c_float] * 5    # increment .. initial_score
    + [ctypes.c_int, _PTR]    # mode, stream
)
_SORTED_ARGS = [_PTR] * 5     # res_sorted, res_order, cand_sorted, cand_order, cand_slot
_FRONTIER_WIDE_ARGS = (
    [ctypes.c_int] * 5        # P, C, K, Mt, N
    + [ctypes.c_int64, ctypes.c_int]  # id_base, sorted
    + [_PTR] * 11             # aug .. node_weights
    + [_PTR] * 8              # ids2 .. slot_pos
    + [_PTR] * 3              # slot_of, cand_first, rank_slot
    + _SORTED_ARGS
    + [ctypes.c_float] * 5    # increment .. initial_score
    + [ctypes.c_int, _PTR]    # mode, stream
)
_STEP_WIDE_ARGS = (
    [ctypes.c_int] * 4        # P, C, M, K
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]  # lo, span, sorted
    + [_PTR] * 12             # ids .. active_probe
    + [_PTR] * 9              # ids2 .. slot_pos
    + [_PTR] * 3              # slot_of, cand_first, rank_slot
    + _SORTED_ARGS
    + [ctypes.c_float] * 5    # increment .. initial_score
    + [ctypes.c_int, _PTR]    # mode, stream
)


def _check_state(
    ids, scores, valid, accessed, in_capacity, weights, mode, id_dtype=torch.int32
):
    P, C = ids.shape
    if C == 0:
        raise ValueError("the kernel needs C >= 1 buffer slots")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    for name, t, dt in (
        ("ids", ids, id_dtype),
        ("scores", scores, torch.float32),
        ("valid", valid, torch.bool),
        ("accessed", accessed, torch.bool),
        ("in_capacity", in_capacity, torch.bool),
    ):
        check_tensor(t, name, dt, (P, C))
    if weights is not None:
        check_tensor(weights, "weights", torch.float32, (P, C))


def _maps(P: int, N: int, dev):
    """The per-PE direct-mapped scratch of ``prefetch_state.cuh``."""
    slot_of = torch.full((P, N), -1, dtype=torch.int32, device=dev)
    cand_first = torch.full((P, N), _INT32_MAX, dtype=torch.int32, device=dev)
    return slot_of, cand_first


def _wide_index(ids, valid, cand, span: int):
    """The IdIndex scratch of a wide launch: ``(sorted, slot_of,
    cand_first, res_sorted, res_order, cand_sorted, cand_order,
    cand_slot)``, the tensors of the other mode None. The sorted mode
    when the two maps would pass :data:`MAP_BUDGET_BYTES`."""
    P, K = cand.shape
    dev = ids.device
    if 8 * P * span <= MAP_BUDGET_BYTES:
        return (False, *_maps(P, span, dev), None, None, None, None, None)
    res = torch.where(valid, ids, torch.full_like(ids, _INT64_MAX))
    res_sorted, res_order = torch.sort(res, dim=1)
    cand_sorted, cand_order = torch.sort(cand, dim=1, stable=True)
    cand_slot = torch.empty((P, K), dtype=torch.int32, device=dev)
    return (
        True, None, None, res_sorted.contiguous(), res_order.contiguous(),
        cand_sorted.contiguous(), cand_order.contiguous(), cand_slot,
    )


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
    payload: torch.Tensor | None = None,
    table: torch.Tensor | None = None,
    loc: torch.Tensor | None = None,
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
    if Mt < 0:
        raise ValueError("touched_aug needs its gate column")
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode)
    for name, t, dt, shape in (
        ("touched_aug", touched_aug, torch.int32, (P, Mt + 1)),
        ("part_of", part_of, torch.int32, (N,)),
        ("cand", cand, torch.int32, (P, K)),
    ):
        check_tensor(t, name, dt, shape)
    if node_weights is not None:
        check_tensor(node_weights, "node_weights", torch.float32, (N,))
    dev = ids.device
    fn = native.bind(
        "fused_frontier_step", "rudder_fused_frontier_step", _FRONTIER_ARGS
    )

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
        slot_of, cand_first = _maps(P, N, dev)
        rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            P, C, K, Mt, N,
            ptr(touched_aug), ptr(sk), ptr(ids), ptr(scores), ptr(valid),
            ptr(accessed), ptr(in_capacity), ptr(weights), ptr(part_of),
            ptr(cand), ptr(node_weights),
            ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2),
            ptr(code), ptr(placed), ptr(slot_pos),
            ptr(slot_of), ptr(cand_first), ptr(rank_slot),
            float(increment), float(decay), float(threshold), float(score_cap),
            float(initial_score), _MODES[mode], stream,
        )
        native.check(err, "fused_frontier_step")
        native.LAUNCHES["fused_frontier_step"] += 1
        n_place = placed.sum(dim=1, dtype=torch.int32)
        n_valid = valid2.sum(dim=1, dtype=torch.int32)
        cand_next, packed, counters, payload2 = frontier_pack(
            sk, code, placed, slot_pos, n_place, n_valid, ids2, payload, table,
            loc, cand_cap=cand_cap,
        )
    return ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters


def fused_step_cuda(
    ids: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    accessed: torch.Tensor,
    in_capacity: torch.Tensor,
    weights: torch.Tensor | None,
    queries: torch.Tensor,
    cand: torch.Tensor,
    cand_weights: torch.Tensor | None,
    active_score: torch.Tensor,
    do_replace: torch.Tensor,
    active_probe: torch.Tensor,
    *,
    num_ids: int,
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """One launch of the Hopper fused-step kernel; same arguments and
    outputs as :func:`repro_torch.kernels.ref.fused_step`, plus
    ``num_ids``: every id (state, queries, candidates) must lie in
    ``[0, num_ids)`` or be negative padding, the id space of the
    kernel's direct-mapped maps. Takes int32 ids, float32 scores and
    weights, bool masks and ``(P,)`` bool gates, all contiguous on one
    CUDA device; with ``weights`` it needs ``cand_weights``. Raises on
    anything else — there is no other route on the card."""
    P, C = ids.shape
    M = queries.shape[1]
    K = cand.shape[1]
    N = int(num_ids)
    if N < 0:
        raise ValueError(f"num_ids must be >= 0, got {N}")
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode)
    check_tensor(queries, "queries", torch.int32, (P, M))
    check_tensor(cand, "cand", torch.int32, (P, K))
    for name, t in (
        ("active_score", active_score),
        ("do_replace", do_replace),
        ("active_probe", active_probe),
    ):
        check_tensor(t, name, torch.bool, (P,))
    if weights is not None:
        if cand_weights is None:
            raise ValueError("weights need cand_weights on the card")
        check_tensor(cand_weights, "cand_weights", torch.float32, (P, K))
    dev = ids.device
    fn = native.bind("fused_step", "rudder_fused_step", _STEP_ARGS)

    with torch.cuda.device(dev):
        ids2 = torch.empty_like(ids)
        s2 = torch.empty_like(scores)
        valid2 = torch.empty_like(valid)
        acc3 = torch.empty_like(accessed)
        w2 = torch.empty_like(weights) if weights is not None else None
        hit = torch.empty((P, M), dtype=torch.bool, device=dev)
        hit_slot = torch.empty((P, M), dtype=torch.int32, device=dev)
        placed = torch.empty((P, K), dtype=torch.bool, device=dev)
        slot_pos = torch.empty((P, C), dtype=torch.int32, device=dev)
        slot_of, cand_first = _maps(P, N, dev)
        rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
        cw = cand_weights if weights is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            P, C, M, K, N,
            ptr(ids), ptr(scores), ptr(valid), ptr(accessed), ptr(in_capacity),
            ptr(weights), ptr(queries), ptr(cand), ptr(cw),
            ptr(active_score), ptr(do_replace), ptr(active_probe),
            ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2),
            ptr(hit), ptr(hit_slot), ptr(placed), ptr(slot_pos),
            ptr(slot_of), ptr(cand_first), ptr(rank_slot),
            float(increment), float(decay), float(threshold), float(score_cap),
            float(initial_score), _MODES[mode], stream,
        )
        native.check(err, "fused_step")
        native.LAUNCHES["fused_step"] += 1
        n_placed = placed.sum(dim=1, dtype=torch.int32)
        n_valid = valid2.sum(dim=1, dtype=torch.int32)
    return (
        ids2, s2, valid2, acc3, w2, hit, hit_slot, placed, slot_pos,
        n_placed, n_valid,
    )


def fused_frontier_step_wide_cuda(
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
    payload: torch.Tensor | None = None,
    table: torch.Tensor | None = None,
    loc: torch.Tensor | None = None,
    *,
    cand_cap: int,
    id_base: int,
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """One launch of the Hopper frontier-step kernel on int64 ids; same
    arguments and outputs as
    :func:`repro_torch.kernels.ref.fused_frontier_step_wide`.

    Takes int64 ids (``touched_aug`` with the gate bits in its last
    column, ``ids``, ``cand``), an int32 ``part_of`` indexed by the local
    id ``id - id_base``, float32 scores and weights and bool masks, all
    contiguous on one CUDA device; frontier ids must lie in ``[id_base,
    id_base + len(part_of))`` or be negative padding. Reads nothing back
    to the host. Raises on anything else — there is no other route on
    the card."""
    P, C = ids.shape
    K = cand.shape[1]
    Mt = touched_aug.shape[1] - 1
    N = part_of.shape[0]
    if Mt < 0:
        raise ValueError("touched_aug needs its gate column")
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode, torch.int64)
    for name, t, dt, shape in (
        ("touched_aug", touched_aug, torch.int64, (P, Mt + 1)),
        ("part_of", part_of, torch.int32, (N,)),
        ("cand", cand, torch.int64, (P, K)),
    ):
        check_tensor(t, name, dt, shape)
    if node_weights is not None:
        check_tensor(node_weights, "node_weights", torch.float32, (N,))
    dev = ids.device
    fn = native.bind(
        "fused_frontier_step", "rudder_fused_frontier_step_wide", _FRONTIER_WIDE_ARGS
    )

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
        rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
        srt, slot_of, cand_first, *rows = _wide_index(ids, valid, cand, N)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            P, C, K, Mt, N, int(id_base), int(srt),
            ptr(touched_aug), ptr(sk), ptr(ids), ptr(scores), ptr(valid),
            ptr(accessed), ptr(in_capacity), ptr(weights), ptr(part_of),
            ptr(cand), ptr(node_weights),
            ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2),
            ptr(code), ptr(placed), ptr(slot_pos),
            ptr(slot_of), ptr(cand_first), ptr(rank_slot),
            *(ptr(t) for t in rows),
            float(increment), float(decay), float(threshold), float(score_cap),
            float(initial_score), _MODES[mode], stream,
        )
        native.check(err, "fused_frontier_step_wide")
        native.LAUNCHES["fused_frontier_step_wide"] += 1
        n_place = placed.sum(dim=1, dtype=torch.int32)
        n_valid = valid2.sum(dim=1, dtype=torch.int32)
        cand_next, packed, counters, payload2 = frontier_pack_wide(
            sk, code, placed, slot_pos, n_place, n_valid, ids2, payload, table,
            loc, cand_cap=cand_cap, id_base=id_base,
        )
    return ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters


def wide_id_range(*id_tensors) -> tuple[int, int]:
    """``(lo, span)`` of the non-negative ids in ``id_tensors`` (``(0, 1)``
    when there are none): the id range a wide launch's maps must cover.
    Reads two scalars back from the device."""
    lo, hi = _INT64_MAX, -1
    for t in id_tensors:
        live = t[t >= 0]
        if live.numel():
            lo = min(lo, int(live.min()))
            hi = max(hi, int(live.max()))
    return (0, 1) if hi < 0 else (lo, hi - lo + 1)


def fused_step_wide_cuda(
    ids: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    accessed: torch.Tensor,
    in_capacity: torch.Tensor,
    weights: torch.Tensor | None,
    queries: torch.Tensor,
    cand: torch.Tensor,
    cand_weights: torch.Tensor | None,
    active_score: torch.Tensor,
    do_replace: torch.Tensor,
    active_probe: torch.Tensor,
    *,
    id_lo: int | None = None,
    num_ids: int | None = None,
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """One launch of the Hopper fused-step kernel on int64 ids; same
    arguments and outputs as :func:`repro_torch.kernels.ref.fused_step_wide`,
    plus the id range of the kernel's direct maps: every id (state,
    queries, candidates) lies in ``[id_lo, id_lo + num_ids)`` or is
    negative padding. Without them the wrapper reads the range off the
    tensors (:func:`wide_id_range`, one device sync). Raises on anything
    else — there is no other route on the card."""
    P, C = ids.shape
    M = queries.shape[1]
    K = cand.shape[1]
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode, torch.int64)
    check_tensor(queries, "queries", torch.int64, (P, M))
    check_tensor(cand, "cand", torch.int64, (P, K))
    for name, t in (
        ("active_score", active_score),
        ("do_replace", do_replace),
        ("active_probe", active_probe),
    ):
        check_tensor(t, name, torch.bool, (P,))
    if weights is not None:
        if cand_weights is None:
            raise ValueError("weights need cand_weights on the card")
        check_tensor(cand_weights, "cand_weights", torch.float32, (P, K))
    if id_lo is None or num_ids is None:
        id_lo, num_ids = wide_id_range(
            torch.where(valid, ids, torch.full_like(ids, -1)), queries, cand
        )
    lo, span = int(id_lo), int(num_ids)
    if lo < 0 or span < 1:
        raise ValueError(f"id range [{lo}, {lo} + {span}) is empty or negative")
    dev = ids.device
    fn = native.bind("fused_step", "rudder_fused_step_wide", _STEP_WIDE_ARGS)

    with torch.cuda.device(dev):
        ids2 = torch.empty_like(ids)
        s2 = torch.empty_like(scores)
        valid2 = torch.empty_like(valid)
        acc3 = torch.empty_like(accessed)
        w2 = torch.empty_like(weights) if weights is not None else None
        hit = torch.empty((P, M), dtype=torch.bool, device=dev)
        hit_slot = torch.empty((P, M), dtype=torch.int32, device=dev)
        placed = torch.empty((P, K), dtype=torch.bool, device=dev)
        slot_pos = torch.empty((P, C), dtype=torch.int32, device=dev)
        rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
        srt, slot_of, cand_first, *rows = _wide_index(ids, valid, cand, span)
        cw = cand_weights if weights is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            P, C, M, K, lo, span, int(srt),
            ptr(ids), ptr(scores), ptr(valid), ptr(accessed), ptr(in_capacity),
            ptr(weights), ptr(queries), ptr(cand), ptr(cw),
            ptr(active_score), ptr(do_replace), ptr(active_probe),
            ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2),
            ptr(hit), ptr(hit_slot), ptr(placed), ptr(slot_pos),
            ptr(slot_of), ptr(cand_first), ptr(rank_slot),
            *(ptr(t) for t in rows),
            float(increment), float(decay), float(threshold), float(score_cap),
            float(initial_score), _MODES[mode], stream,
        )
        native.check(err, "fused_step_wide")
        native.LAUNCHES["fused_step_wide"] += 1
        n_placed = placed.sum(dim=1, dtype=torch.int32)
        n_valid = valid2.sum(dim=1, dtype=torch.int32)
    return (
        ids2, s2, valid2, acc3, w2, hit, hit_slot, placed, slot_pos,
        n_placed, n_valid,
    )
