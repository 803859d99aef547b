"""The prefetch steps on the card: the Hopper kernels
``csrc/fused_frontier_step.cu`` and ``csrc/fused_step.cu`` behind
PyTorch wrappers.

Ports of the reference's Pallas ``fused_frontier_step_pallas`` (the
single-launch raw path) and ``fused_step_pallas`` (the ragged-seed-block
path), and of their wide-id twins ``fused_frontier_step_wide_pallas``
and ``fused_step_wide_pallas``, which take int64 ids here where the
reference splits them into ``(hi, lo)`` int32 word planes. Their plain
versions are :func:`repro_torch.kernels.ref.fused_frontier_step`,
:func:`repro_torch.kernels.ref.fused_step` and their ``_wide`` twins,
which they match bit for bit.

The frontier step's direct route (every narrow launch, and every wide
launch whose scratch fits :data:`MAP_BUDGET_BYTES`) is the whole step on
the card: the wrapper checks, allocates the outputs and one scratch
block, and makes one C call, which clears the scratch (two memsets) and
launches three kernels — a count sort's histogram over the local ids
``id - id_base``, the state round, and a look-back scan that probes,
codes, compacts the misses and writes the packed readback. No PyTorch op
runs between the checks and the return. The row sort and
:func:`repro_torch.kernels.ref.frontier_pack` are not called on this
route. The scratch block is kept from one launch to the next on the same
device and stream (``_SCRATCH``): allocating it anew cost in-run
launches a ``cudaMalloc``. With a feature store's table attached, the
admission rows are still copied into the payload by PyTorch ops after
the launch (:func:`repro_torch.kernels.ref.payload_scatter`).

The kernels look ids up in per-PE direct-mapped ``(P, span)`` maps keyed
by ``id - lo`` (``prefetch_state.cuh``). A wide launch whose scratch
would pass :data:`MAP_BUDGET_BYTES` (a sparse id set spread over a span
of 2^40, say) takes the sorted route instead, which stays as it was: the
wrapper row-sorts the frontier, the resident ids and the candidates with
``torch.sort``, the state round binary-searches them, and the miss
compaction and packing are :func:`repro_torch.kernels.ref.frontier_pack_wide`.

The fused step's direct route (every narrow launch, and every wide
launch whose two ``(P, span)`` maps fit :data:`MAP_BUDGET_BYTES`) is one
allocation and one kernel launch: the wrapper checks, carves every
output from one byte block and makes one C call, which launches
``fused_step_kernel`` — the state round, the probe, and the restore of
every map entry the launch wrote. The maps themselves are kept from one
launch to the next on the same device and stream (``_MAPS``), clean
between launches, and filled only when they are allocated or grown. Two
forms share the kernel: the reference's eleven outputs
(:func:`fused_step_cuda`, :func:`fused_step_wide_cuda`) and the engine's
(:func:`fused_step_readback_cuda`), which reads the ``(P,)`` gate words
the engine uploads and writes the packed readback
``[hit | hit_slot | placed | slot_pos | n_valid]`` itself. Past the
budget a wide launch takes the sorted mode, whose rows ``torch.sort``
builds first. Every route gives the same outputs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import native
from .native import check_tensor, ptr
from .ref import frontier_pack_wide, payload_scatter

_MODES = {"accumulate": 0, "reset": 1, "capped": 2}
#: The sorted mode's padding for invalid resident slots: no id the wide
#: path accepts (``<= WIDE_ID_MAX``, about 2^61) can equal it.
_INT64_MAX = int(np.iinfo(np.int64).max)
#: Local ids a tile of the frontier step's scan covers (``kTile`` of
#: ``csrc/fused_frontier_step.cu``).
_EXPAND_TILE = 512

#: Most bytes a wide launch spends on its direct-mapped scratch (the
#: frontier step's whole scratch block, the fused step's two ``(P, span)``
#: int32 maps); past it the launch takes the sorted mode. (The checks on
#: the card set it to 0 for a while to hold the sorted mode on dense
#: scenario sets too.)
MAP_BUDGET_BYTES = 256 << 20

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_CONSTS = [ctypes.c_float] * 5 + [ctypes.c_int, _PTR]  # increment .. initial_score, mode, stream
_DIRECT_ARGS = (
    [_PTR] * 10               # aug, ids .. node_weights
    + [_PTR] * 6              # ids2, s2, valid2, acc3, w2, packed
    + [_PTR, _I64, _PTR, _I64]  # zero region, 0xFF region
    + [_PTR] * 10             # counters .. others
    + _CONSTS
)
_FRONTIER_ARGS = [ctypes.c_int] * 7 + _DIRECT_ARGS  # P, C, K, Mt, N, kc, n_tiles
_FRONTIER_WIDE_ARGS = [ctypes.c_int] * 7 + [_I64] + _DIRECT_ARGS  # + id_base
_SORTED_ARGS = [_PTR] * 5     # res_sorted, res_order, cand_sorted, cand_order, cand_slot
_FRONTIER_SORTED_ARGS = (
    [ctypes.c_int] * 5 + [_I64]  # P, C, K, Mt, N, id_base
    + [_PTR] * 11             # aug, sk, ids .. node_weights
    + [_PTR] * 11             # ids2 .. w2, code, placed, slot_pos, n_place, n_valid, rank_slot
    + _SORTED_ARGS
    + _CONSTS
)


def _step_args(wide: bool, gates: int, outs: int) -> list:
    """Argument types of a fused-step entry: the shape (and, wide, ``lo``,
    ``span``, ``sorted``), nine inputs (``ids`` .. ``cand_w``), ``gates``
    gate pointers, the five state outputs and ``outs`` more, ``slot_of``,
    ``cand_first`` and ``rank_slot``, (wide) the sorted rows, the
    constants."""
    head = [ctypes.c_int] * 4 + ([_I64, _I64, ctypes.c_int] if wide else [ctypes.c_int])
    return (
        head + [_PTR] * (9 + gates + 5 + outs + 3)
        + (_SORTED_ARGS if wide else []) + _CONSTS
    )


#: (wide, packed) -> the fused step's C entry and its argument types: the
#: reference's form (three gate vectors, six more outputs) and the engine's
#: (the gate words, the packed readback).
_STEP_ENTRIES = {
    (False, False): ("rudder_fused_step", _step_args(False, 3, 6)),
    (False, True): ("rudder_fused_step_packed", _step_args(False, 1, 1)),
    (True, False): ("rudder_fused_step_wide", _step_args(True, 3, 6)),
    (True, True): ("rudder_fused_step_wide_packed", _step_args(True, 1, 1)),
}


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


def _check_frontier(touched_aug, part_of, cand, node_weights, P, idt):
    Mt = touched_aug.shape[1] - 1
    if Mt < 0:
        raise ValueError("touched_aug needs its gate column")
    N = part_of.shape[0]
    for name, t, dt, shape in (
        ("touched_aug", touched_aug, idt, (P, Mt + 1)),
        ("part_of", part_of, torch.int32, (N,)),
        ("cand", cand, idt, (P, cand.shape[-1])),
    ):
        check_tensor(t, name, dt, shape)
    if node_weights is not None:
        check_tensor(node_weights, "node_weights", torch.float32, (N,))
    return Mt, N


def _constants(increment, decay, threshold, score_cap, initial_score, mode, dev):
    return (
        float(increment), float(decay), float(threshold), float(score_cap),
        float(initial_score), _MODES[mode], torch.cuda.current_stream(dev).cuda_stream,
    )


def _sorted_index(ids, valid, cand):
    """The sorted mode's rows: ``(res_sorted, res_order, cand_sorted,
    cand_order, cand_slot)``."""
    P, K = cand.shape
    res = torch.where(valid, ids, torch.full_like(ids, _INT64_MAX))
    res_sorted, res_order = torch.sort(res, dim=1)
    cand_sorted, cand_order = torch.sort(cand, dim=1, stable=True)
    cand_slot = torch.empty((P, K), dtype=torch.int32, device=ids.device)
    return (
        res_sorted.contiguous(), res_order.contiguous(),
        cand_sorted.contiguous(), cand_order.contiguous(), cand_slot,
    )


#: The frontier step's scratch block of each (device, stream), kept from one
#: direct-route launch to the next on that stream (stream order keeps a
#: launch's memsets behind the previous launch's kernels). A fresh block of
#: tens of MB each launch cost the in-run launch a ``cudaMalloc`` of 0.5–3
#: ms whenever the training step had split the cached one.
_SCRATCH: dict = {}


def frontier_scratch(P: int, C: int, N: int, Mt: int, id_bytes: int):
    """Layout of the frontier step's scratch block on its direct route:
    ``({name: (byte offset, bytes)}, total bytes, n_tiles)``. The zero
    region runs from 0 to ``slot_of``'s offset (the per-row counts of -1
    and other negative keys, the scan's ticket and ``(P, n_tiles)`` tile
    states, ``cand_first`` and the count sort's ``counts``, both ``(P,
    N)``); the 0xFF region is ``slot_of``; ``rank_slot`` and the gathered
    negative keys (``others``) are not cleared. Every part starts on a
    16-byte boundary."""
    n_tiles = -(-N // _EXPAND_TILE)
    parts = (
        ("neg", P * 2 * 4),
        ("ticket", 4),
        ("tiles", P * n_tiles * 8),
        ("cand_first", P * N * 4),
        ("counts", P * N * 4),
        ("slot_of", P * N * 4),
        ("rank_slot", P * C * 4),
        ("others", P * Mt * id_bytes),
    )
    layout, at = {}, 0
    for name, nbytes in parts:
        layout[name] = (at, nbytes)
        at += -(-nbytes // 16) * 16
    return layout, at, n_tiles


def _scratch_block(nbytes: int, dev, stream: int) -> torch.Tensor:
    """At least ``nbytes`` of the (device, stream)'s kept scratch."""
    key = (dev.index, stream)
    block = _SCRATCH.get(key)
    if block is None or block.numel() < nbytes:
        block = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return block


#: The fused step's direct-mapped maps of each (device, stream): flat
#: int32 ``slot_of`` at -1 and ``cand_first`` at 0, filled once when they
#: are allocated or grown. Every launch's kernel puts back the entries it
#: wrote, so they are clean from one launch to the next, and a launch of
#: any ``(P, span)`` and ``lo`` may use a pair large enough; a launch that
#: fails drops them. Allocating and filling a fresh ``(P, span)`` pair a
#: launch cost two fills of 8.8 MB each at the ragged loop's shape.
_MAPS: dict = {}


def step_maps(n: int, dev, stream: int):
    """The (device, stream)'s kept ``(slot_of, cand_first)``, at least
    ``n`` entries each: grown (to at least twice the old size, within
    :data:`MAP_BUDGET_BYTES`) and filled when too small."""
    key = (dev.index, stream)
    maps = _MAPS.get(key)
    if maps is None or maps[0].numel() < n:
        old = 0 if maps is None else maps[0].numel()
        cap = max(n, 1, min(2 * old, MAP_BUDGET_BYTES // 8))
        maps = _MAPS[key] = (
            torch.full((cap,), -1, dtype=torch.int32, device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev),
        )
    return maps


@functools.lru_cache(maxsize=64)
def _layout(parts: tuple):
    """:func:`_carve`'s plan for ``parts``: the block's bytes, its dtypes,
    and per part ``(dtype, shape, stride, offset in elements)`` or None;
    each part on a 16-byte boundary."""
    plan, at = [], 0
    for part in parts:
        if part is None:
            plan.append(None)
            continue
        dtype, shape = part
        stride = (shape[1], 1) if len(shape) == 2 else (1,)
        plan.append((dtype, shape, stride, at // dtype.itemsize))
        at += -(-dtype.itemsize * math.prod(shape) // 16) * 16
    dtypes = tuple({p[0] for p in plan if p is not None})
    return max(at, 16), dtypes, tuple(plan)


def _carve(dev, parts: tuple):
    """One ``torch.empty`` byte block for every ``(dtype, shape)`` of
    ``parts``: the parts' views (None where a part is None), one view of
    the block per dtype and one strided view per part, so that carving
    costs few host operations."""
    total, dtypes, plan = _layout(parts)
    block = torch.empty(total, dtype=torch.uint8, device=dev)
    typed = {dt: block.view(dt) for dt in dtypes}
    return [
        None if e is None else typed[e[0]].as_strided(e[1], e[2], e[3]) for e in plan
    ]


def _frontier_direct(
    entry, wide_args, state, touched_aug, part_of, cand, node_weights, payload,
    table, loc, *, cand_cap, id_base, consts,
):
    """The direct route of both frontier entries: allocations and one C
    call (two memsets, three kernels), then, with a store table, the
    payload scatter."""
    ids, scores, valid, accessed, in_capacity, weights = state
    P, C = ids.shape
    K = cand.shape[1]
    Mt = touched_aug.shape[1] - 1
    N = part_of.shape[0]
    kc = min(int(cand_cap), Mt)
    dev = ids.device
    layout, total, n_tiles = frontier_scratch(P, C, N, Mt, ids.element_size())
    ids2 = torch.empty_like(ids)
    s2 = torch.empty_like(scores)
    valid2 = torch.empty_like(valid)
    acc3 = torch.empty_like(accessed)
    w2 = torch.empty_like(weights) if weights is not None else None
    words = 3 if ids.dtype == torch.int64 else 2
    packed = torch.empty((P, words * Mt + K + C + 1), dtype=torch.int32, device=dev)
    cand_next = torch.empty((P, kc), dtype=ids.dtype, device=dev)
    counters = torch.empty((P, 4), dtype=torch.int32, device=dev)
    base = _scratch_block(max(total, 16), dev, consts[-1]).data_ptr()
    at = {name: base + off for name, (off, _) in layout.items()}
    err = entry(
        P, C, K, Mt, N, kc, n_tiles, *wide_args,
        ptr(touched_aug), ptr(ids), ptr(scores), ptr(valid), ptr(accessed),
        ptr(in_capacity), ptr(weights), ptr(part_of), ptr(cand), ptr(node_weights),
        ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2), ptr(packed),
        base, layout["slot_of"][0], at["slot_of"], layout["slot_of"][1],
        ptr(counters), at["neg"], at["ticket"], at["tiles"], at["cand_first"],
        at["counts"], ptr(cand_next), at["slot_of"], at["rank_slot"], at["others"],
        *consts,
    )
    native.check(err, entry.__name__)
    payload2 = payload
    if table is not None:
        col = words * Mt + K
        payload2 = payload_scatter(
            ids2, packed[:, col : col + C], counters[:, 2], payload, table, loc,
            id_base=id_base,
        )
    return ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters


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
    """One launch of the Hopper frontier step (the direct route); same
    arguments and outputs as
    :func:`repro_torch.kernels.ref.fused_frontier_step`.

    Takes int32 ids (``touched_aug``, ``ids``, ``cand``, ``part_of``),
    float32 scores and weights, bool masks, all contiguous on one CUDA
    device; ids must lie in ``[0, len(part_of))`` or be negative
    padding. Raises on anything else — there is no other route on the
    card."""
    P = ids.shape[0]
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode)
    _check_frontier(touched_aug, part_of, cand, node_weights, P, torch.int32)
    fn = native.bind(
        "fused_frontier_step", "rudder_fused_frontier_step", _FRONTIER_ARGS
    )
    with torch.cuda.device(ids.device):
        consts = _constants(
            increment, decay, threshold, score_cap, initial_score, mode, ids.device
        )
        outs = _frontier_direct(
            fn, (), (ids, scores, valid, accessed, in_capacity, weights),
            touched_aug, part_of, cand, node_weights, payload, table, loc,
            cand_cap=cand_cap, id_base=None, consts=consts,
        )
        native.LAUNCHES["fused_frontier_step"] += 1
    return outs


def _check_step(state, queries, cand, cand_weights, mode, idt) -> int:
    """Raise unless the fused step's inputs are what its kernel takes;
    returns ``P``."""
    ids, scores, valid, accessed, in_capacity, weights = state
    P = ids.shape[0]
    K = cand.shape[1]
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode, idt)
    check_tensor(queries, "queries", idt, (P, queries.shape[1]))
    check_tensor(cand, "cand", idt, (P, K))
    if weights is not None:
        if cand_weights is None:
            raise ValueError("weights need cand_weights on the card")
        check_tensor(cand_weights, "cand_weights", torch.float32, (P, K))
    return P


def _fused_step(packed, state, queries, cand, cand_weights, gates, lo, span, consts):
    """One launch of the fused step: carve the outputs from one block and
    make one C call (direct mode: the kept maps; a wide launch whose maps
    would pass :data:`MAP_BUDGET_BYTES`: the sorted rows of
    :func:`_sorted_index`). Returns the state outputs and then the packed
    readback (``packed``) or the reference's six more outputs."""
    ids, scores, valid, accessed, in_capacity, weights = state
    P, C = ids.shape
    M = queries.shape[1]
    K = cand.shape[1]
    dev, stream = ids.device, consts[-1]
    wide = ids.dtype == torch.int64
    srt = wide and 8 * P * span > MAP_BUDGET_BYTES
    i32 = torch.int32
    parts = (
        (ids.dtype, (P, C)), (torch.float32, (P, C)), (torch.bool, (P, C)),
        (torch.bool, (P, C)), None if weights is None else (torch.float32, (P, C)),
    )
    if packed:
        parts += ((i32, (P, 2 * M + K + C + 1)),)
    else:
        parts += (
            (torch.bool, (P, M)), (i32, (P, M)), (torch.bool, (P, K)), (i32, (P, C)),
            (i32, (P,)), (i32, (P,)),
        )
    outs = _carve(dev, parts)
    rank_slot = _scratch_block(4 * P * C, dev, stream)
    if srt:
        maps, rows = (None, None), _sorted_index(ids, valid, cand)
    else:
        maps, rows = step_maps(P * span, dev, stream), (None,) * 5
    name, argtypes = _STEP_ENTRIES[(wide, packed)]
    fn = native.bind("fused_step", name, argtypes)
    head = (P, C, M, K, lo, span, int(srt)) if wide else (P, C, M, K, span)
    cw = cand_weights if weights is not None else None
    err = fn(
        *head, *(ptr(t) for t in (*state, queries, cand, cw)),
        *(ptr(g) for g in gates), *(ptr(t) for t in outs),
        *(ptr(m) for m in maps), rank_slot.data_ptr(),
        *((ptr(t) for t in rows) if wide else ()), *consts,
    )
    if err:
        _MAPS.pop((dev.index, stream), None)
    native.check(err, name)
    return outs


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
    state = (ids, scores, valid, accessed, in_capacity, weights)
    P = _check_step(state, queries, cand, cand_weights, mode, torch.int32)
    gates = (active_score, do_replace, active_probe)
    for name, t in zip(("active_score", "do_replace", "active_probe"), gates):
        check_tensor(t, name, torch.bool, (P,))
    lo, span = _id_range(False, state, queries, cand, None, num_ids)
    dev = ids.device
    with torch.cuda.device(dev):
        consts = _constants(increment, decay, threshold, score_cap, initial_score, mode, dev)
        outs = _fused_step(False, state, queries, cand, cand_weights, gates, lo, span, consts)
        native.LAUNCHES["fused_step"] += 1
    return tuple(outs)


def fused_step_readback_cuda(
    ids: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    accessed: torch.Tensor,
    in_capacity: torch.Tensor,
    weights: torch.Tensor | None,
    queries: torch.Tensor,
    cand: torch.Tensor,
    cand_weights: torch.Tensor | None,
    gates: torch.Tensor,
    *,
    num_ids: int | None,
    id_lo: int | None = None,
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """The engine's form of the Hopper fused step: ``gates`` is ``(P,)``
    int32, the bits ``active_score | do_replace << 1 | active_probe << 2``
    of each PE, and the outputs are ``(ids, scores, valid, accessed,
    weights, packed)``, ``packed`` the ``(P, 2 M + K + C + 1)`` int32 block
    ``[hit | hit_slot | placed | slot_pos | n_valid]`` of
    :func:`repro_torch.kernels.ref.pack_readback`, written by the kernel.

    int32 ids run :func:`fused_step_cuda`'s kernel (ids in ``[0,
    num_ids)``), int64 ids :func:`fused_step_wide_cuda`'s (ids in
    ``[id_lo, id_lo + num_ids)``, read off the tensors when either is
    None). The direct route is one allocation and one kernel launch; the
    sorted mode of a wide launch past :data:`MAP_BUDGET_BYTES` sorts its
    rows first. Raises on anything else — there is no other route on the
    card."""
    wide = ids.dtype == torch.int64
    state = (ids, scores, valid, accessed, in_capacity, weights)
    idt = torch.int64 if wide else torch.int32
    P = _check_step(state, queries, cand, cand_weights, mode, idt)
    check_tensor(gates, "gates", torch.int32, (P,))
    lo, span = _id_range(wide, state, queries, cand, id_lo, num_ids)
    dev = ids.device
    with torch.cuda.device(dev):
        consts = _constants(increment, decay, threshold, score_cap, initial_score, mode, dev)
        outs = _fused_step(True, state, queries, cand, cand_weights, (gates,), lo, span, consts)
        native.LAUNCHES["fused_step_wide" if wide else "fused_step"] += 1
    return tuple(outs)


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
    """One launch of the Hopper frontier step on int64 ids; same
    arguments and outputs as
    :func:`repro_torch.kernels.ref.fused_frontier_step_wide`.

    Takes int64 ids (``touched_aug`` with the gate bits in its last
    column, ``ids``, ``cand``), an int32 ``part_of`` indexed by the local
    id ``id - id_base``, float32 scores and weights and bool masks, all
    contiguous on one CUDA device; frontier ids must lie in ``[id_base,
    id_base + len(part_of))`` or be negative padding. The direct route
    when its scratch (:func:`frontier_scratch`) fits
    :data:`MAP_BUDGET_BYTES`, else the sorted route. Reads nothing back
    to the host. Raises on anything else — there is no other route on
    the card."""
    P, C = ids.shape
    K = cand.shape[1]
    _check_state(ids, scores, valid, accessed, in_capacity, weights, mode, torch.int64)
    Mt, N = _check_frontier(touched_aug, part_of, cand, node_weights, P, torch.int64)
    dev = ids.device
    state = (ids, scores, valid, accessed, in_capacity, weights)
    _, total, _ = frontier_scratch(P, C, N, Mt, 8)
    with torch.cuda.device(dev):
        consts = _constants(increment, decay, threshold, score_cap, initial_score, mode, dev)
        if total <= MAP_BUDGET_BYTES:
            fn = native.bind(
                "fused_frontier_step", "rudder_fused_frontier_step_wide",
                _FRONTIER_WIDE_ARGS,
            )
            outs = _frontier_direct(
                fn, (int(id_base),), state, touched_aug, part_of, cand,
                node_weights, payload, table, loc, cand_cap=cand_cap,
                id_base=int(id_base), consts=consts,
            )
        else:
            fn = native.bind(
                "fused_frontier_step", "rudder_fused_frontier_step_wide_sorted",
                _FRONTIER_SORTED_ARGS,
            )
            sk = torch.sort(touched_aug[:, :Mt], dim=1).values.contiguous()
            ids2 = torch.empty_like(ids)
            s2 = torch.empty_like(scores)
            valid2 = torch.empty_like(valid)
            acc3 = torch.empty_like(accessed)
            w2 = torch.empty_like(weights) if weights is not None else None
            code = torch.empty((P, Mt), dtype=torch.int32, device=dev)
            placed = torch.empty((P, K), dtype=torch.bool, device=dev)
            slot_pos = torch.empty((P, C), dtype=torch.int32, device=dev)
            n_place = torch.empty((P,), dtype=torch.int32, device=dev)
            n_valid = torch.empty((P,), dtype=torch.int32, device=dev)
            rank_slot = torch.empty((P, C), dtype=torch.int32, device=dev)
            rows = _sorted_index(ids, valid, cand)
            err = fn(
                P, C, K, Mt, N, int(id_base),
                ptr(touched_aug), ptr(sk), ptr(ids), ptr(scores), ptr(valid),
                ptr(accessed), ptr(in_capacity), ptr(weights), ptr(part_of),
                ptr(cand), ptr(node_weights),
                ptr(ids2), ptr(s2), ptr(valid2), ptr(acc3), ptr(w2),
                ptr(code), ptr(placed), ptr(slot_pos), ptr(n_place), ptr(n_valid),
                ptr(rank_slot), *(ptr(t) for t in rows), *consts,
            )
            native.check(err, "fused_frontier_step_wide (sorted)")
            cand_next, packed, counters, payload2 = frontier_pack_wide(
                sk, code, placed, slot_pos, n_place, n_valid, ids2, payload,
                table, loc, cand_cap=cand_cap, id_base=id_base,
            )
            outs = (ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters)
        native.LAUNCHES["fused_frontier_step_wide"] += 1
    return outs


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


def _id_range(wide, state, queries, cand, id_lo, num_ids) -> tuple[int, int]:
    """``(lo, span)`` of a launch's maps: ``(0, num_ids)`` narrow; wide,
    ``(id_lo, num_ids)``, or :func:`wide_id_range` when either is None."""
    if not wide:
        if num_ids is None or int(num_ids) < 0 or (id_lo or 0) != 0:
            raise ValueError(
                f"narrow ids need num_ids >= 0 and id_lo 0, got {num_ids} and {id_lo}"
            )
        return 0, int(num_ids)
    if id_lo is None or num_ids is None:
        ids, valid = state[0], state[2]
        id_lo, num_ids = wide_id_range(
            torch.where(valid, ids, torch.full_like(ids, -1)), queries, cand
        )
    lo, span = int(id_lo), int(num_ids)
    if lo < 0 or span < 1:
        raise ValueError(f"id range [{lo}, {lo} + {span}) is empty or negative")
    return lo, span


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
    state = (ids, scores, valid, accessed, in_capacity, weights)
    P = _check_step(state, queries, cand, cand_weights, mode, torch.int64)
    gates = (active_score, do_replace, active_probe)
    for name, t in zip(("active_score", "do_replace", "active_probe"), gates):
        check_tensor(t, name, torch.bool, (P,))
    lo, span = _id_range(True, state, queries, cand, id_lo, num_ids)
    dev = ids.device
    with torch.cuda.device(dev):
        consts = _constants(increment, decay, threshold, score_cap, initial_score, mode, dev)
        outs = _fused_step(False, state, queries, cand, cand_weights, gates, lo, span, consts)
        native.LAUNCHES["fused_step_wide"] += 1
    return tuple(outs)
