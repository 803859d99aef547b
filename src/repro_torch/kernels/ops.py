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
import torch

from .. import telemetry
from ..core import scoring
from . import ref
from .native import LAUNCHES, reset_launches

__all__ = [
    "fused_frontier_step_batch",
    "fused_frontier_step_wide_batch",
    "fused_step_batch",
    "fused_step_wide_batch",
    "fused_step_readback_batch",
    "pack_readback",
    "gather_rows",
    "gather_rows_batch",
    "frontier_unique_batch",
    "score_update",
    "score_update_batch",
    "score_policy_update_batch",
    "gather_mean",
    "segment_sum_equal",
    "mla_flash_decode",
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


def _route(kind: str, tensor) -> str:
    """``"cpu"`` or ``"cuda"`` by the tensor's device; raise otherwise."""
    dev = tensor.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no {kind} kernel for device {tensor.device}")
    return dev


def _constants(increment, decay, threshold, score_cap, mode, initial_score):
    return dict(
        increment=float(increment),
        decay=float(decay),
        threshold=float(threshold),
        score_cap=float(score_cap),
        mode=mode,
        initial_score=float(initial_score),
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
    payload=None,
    table=None,
    loc=None,
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
    are persistent device tensors. With a feature store's ``(table,
    loc)`` device view, admission rows land in the ``(P*C, F)``
    ``payload`` inside the step. Returns ``(ids2, scores2, valid2,
    accessed3, weights2, payload2, cand_next, packed, counters)``; only
    ``packed`` crosses back to host.

    Routed by ``ids.device``: the CPU runs the plain version
    (:func:`repro_torch.kernels.ref.fused_frontier_step`), CUDA the
    Hopper kernel (:mod:`repro_torch.kernels.fused_step`), which handles
    every shape itself (the drained ``Mt == 1`` launch, the initial
    ``(P, 1)`` all -1 candidate block, capacity-masked slots).
    """
    constants = dict(
        cand_cap=int(cand_cap),
        **_constants(increment, decay, threshold, score_cap, mode, initial_score),
    )
    args = (
        ids, scores, valid, accessed, in_capacity, weights,
        touched_aug, part_of, cand, node_weights, payload, table, loc,
    )
    if _route("fused_frontier_step", ids) == "cpu":
        return ref.fused_frontier_step(*args, **constants)
    from .fused_step import fused_frontier_step_cuda

    return fused_frontier_step_cuda(*args, **constants)


@telemetry.profiled("fused_frontier_step_wide_batch")
def fused_frontier_step_wide_batch(
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
    payload=None,
    table=None,
    loc=None,
    *,
    cand_cap: int,
    id_base: int = 0,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = 1.0,
):
    """Wide-id twin of :func:`fused_frontier_step_batch`: ``touched_aug``
    is the int64 ``(P, Mt + 1)`` block of global frontier ids (gates in
    the last column; still the step's one host→device transfer),
    ``ids`` and ``cand`` are int64, and ``id_base`` is the graph's
    global-id offset for the local-indexed ``part_of``,
    ``node_weights`` and ``loc``. Returns the nine outputs of
    :func:`repro_torch.kernels.ref.fused_frontier_step_wide` (the
    reference returns eleven: its ids ride as ``(hi, lo)`` planes); only
    ``packed`` (width ``3*Mt + K + C + 1``) or, on the readback cadence,
    ``counters`` crosses back to host.

    Routed by ``ids.device``: the CPU runs the plain version, CUDA the
    Hopper kernel
    (:func:`repro_torch.kernels.fused_step.fused_frontier_step_wide_cuda`).
    """
    constants = dict(
        cand_cap=int(cand_cap),
        id_base=int(id_base),
        **_constants(increment, decay, threshold, score_cap, mode, initial_score),
    )
    args = (
        ids, scores, valid, accessed, in_capacity, weights,
        touched_aug, part_of, cand, node_weights, payload, table, loc,
    )
    if _route("fused_frontier_step_wide", ids) == "cpu":
        return ref.fused_frontier_step_wide(*args, **constants)
    from .fused_step import fused_frontier_step_wide_cuda

    return fused_frontier_step_wide_cuda(*args, **constants)


def _max_id(t) -> int:
    return int(t.max()) if t.numel() else -1


@telemetry.profiled("fused_step_batch")
def fused_step_batch(
    ids,
    scores,
    valid,
    accessed,
    in_capacity,
    weights,
    queries,
    cand,
    cand_weights,
    active_score,
    do_replace,
    active_probe,
    *,
    num_ids: int,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = 1.0,
):
    """Fused per-minibatch step of the ragged-seed-block loop: score →
    replace → probe over the ``(P, C)`` state, one launch.

    ``queries`` ``(P, M)`` (host-deduped remote sets) and ``cand``
    ``(P, K)`` (raw candidate lists; first-occurrence dedup happens in
    the step) are -1 padded; the gates are ``(P,)`` bool. Every id lies
    in ``[0, num_ids)`` — the id space of the kernel's direct-mapped
    maps. Returns ``(ids, scores, valid, accessed, weights, hit,
    hit_slot, placed, slot_pos, n_placed, n_valid)``.

    Ids are int32, or int64 as the reference takes them: int64 ids up to
    :data:`INT32_ID_MAX` run the narrow step (``ids`` comes back
    int32), larger ones the wide step (:func:`fused_step_wide_batch`,
    ``ids`` int64), and ids past :data:`WIDE_ID_MAX` raise
    ``ValueError``. ``C == 0`` cannot reach a launch: the engine's state
    always has a slot (``PrefetchEngine`` pads ``C`` to at least 1), and
    both routes raise on it. Routed by ``ids.device``: the CPU runs
    :func:`repro_torch.kernels.ref.fused_step`, CUDA the Hopper kernel
    (:func:`repro_torch.kernels.fused_step.fused_step_cuda`).
    """
    if ids.shape[1] == 0:
        raise ValueError("fused_step_batch needs C >= 1 buffer slots")
    constants = _constants(increment, decay, threshold, score_cap, mode, initial_score)
    id_args = (ids, queries, cand)
    if any(t.dtype == torch.int64 for t in id_args):
        top = [_max_id(t) for t in id_args]
        if not int32_id_eligible(max(top)):
            for m in top:
                if not wide_id_eligible(m):
                    raise ValueError(
                        "node ids exceed the wide-id device bound "
                        f"(max {m} > {WIDE_ID_MAX})"
                    )
            return fused_step_wide_batch(
                ids, scores, valid, accessed, in_capacity, weights, queries, cand,
                cand_weights, active_score, do_replace, active_probe, **constants,
            )
        ids, queries, cand = (t.to(torch.int32) for t in id_args)
    args = (
        ids, scores, valid, accessed, in_capacity, weights, queries, cand,
        cand_weights, active_score, do_replace, active_probe,
    )
    if _route("fused_step", ids) == "cpu":
        return ref.fused_step(*args, **constants)
    from .fused_step import fused_step_cuda

    return fused_step_cuda(*args, num_ids=num_ids, **constants)


@telemetry.profiled("fused_step_wide_batch")
def fused_step_wide_batch(
    ids,
    scores,
    valid,
    accessed,
    in_capacity,
    weights,
    queries,
    cand,
    cand_weights,
    active_score,
    do_replace,
    active_probe,
    *,
    id_lo: int | None = None,
    num_ids: int | None = None,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = 1.0,
):
    """Wide-id twin of :func:`fused_step_batch`: ``ids``, ``queries`` and
    ``cand`` are int64 (the reference's ``(hi, lo)`` word planes), and
    the outputs are :func:`fused_step_batch`'s with ``ids`` int64 (the
    reference returns the ``hi`` plane as a twelfth output). Every id
    lies in ``[id_lo, id_lo + num_ids)``, the kernel's map range; without
    them the kernel reads the range off the tensors. Routed by
    ``ids.device``: the CPU runs
    :func:`repro_torch.kernels.ref.fused_step_wide`, CUDA the Hopper
    kernel (:func:`repro_torch.kernels.fused_step.fused_step_wide_cuda`)."""
    if ids.shape[1] == 0:
        raise ValueError("fused_step_wide_batch needs C >= 1 buffer slots")
    constants = _constants(increment, decay, threshold, score_cap, mode, initial_score)
    args = (
        ids, scores, valid, accessed, in_capacity, weights, queries, cand,
        cand_weights, active_score, do_replace, active_probe,
    )
    if _route("fused_step_wide", ids) == "cpu":
        return ref.fused_step_wide(*args, **constants)
    from .fused_step import fused_step_wide_cuda

    return fused_step_wide_cuda(*args, id_lo=id_lo, num_ids=num_ids, **constants)


@telemetry.profiled("fused_step_readback_batch")
def fused_step_readback_batch(
    ids,
    scores,
    valid,
    accessed,
    in_capacity,
    weights,
    queries,
    cand,
    cand_weights,
    gates,
    *,
    num_ids: int,
    id_lo: int | None = None,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = 1.0,
):
    """The engine's form of the fused step (:func:`fused_step_batch` and
    its wide twin): ``gates`` is the ``(P,)`` int32 word of each PE's gate
    bits, ``active_score | do_replace << 1 | active_probe << 2``, as the
    engine uploads it, and the five host-facing outputs come back as the
    one :func:`pack_readback` block. Returns ``(ids, scores, valid,
    accessed, weights, packed)``.

    int32 ids run the narrow step (ids in ``[0, num_ids)``), int64 ids
    the wide one (ids in ``[id_lo, id_lo + num_ids)``; with ``id_lo``
    None the kernel reads the range off the tensors). Routed by
    ``ids.device``: the CPU unpacks the bits and runs
    :func:`repro_torch.kernels.ref.fused_step` and
    :func:`repro_torch.kernels.ref.pack_readback`; CUDA launches the Hopper
    kernel, which writes ``packed`` itself
    (:func:`repro_torch.kernels.fused_step.fused_step_readback_cuda`)."""
    if ids.shape[1] == 0:
        raise ValueError("fused_step_readback_batch needs C >= 1 buffer slots")
    constants = _constants(increment, decay, threshold, score_cap, mode, initial_score)
    if _route("fused_step_readback", ids) == "cpu":
        bits = [(gates & bit) != 0 for bit in (1, 2, 4)]
        out = ref.fused_step(
            ids, scores, valid, accessed, in_capacity, weights, queries, cand,
            cand_weights, *bits, **constants,
        )
        return (*out[:5], ref.pack_readback(*out[5:9], out[10]))
    from .fused_step import fused_step_readback_cuda

    return fused_step_readback_cuda(
        ids, scores, valid, accessed, in_capacity, weights, queries, cand,
        cand_weights, gates, num_ids=num_ids, id_lo=id_lo, **constants,
    )


@telemetry.profiled("pack_readback")
def pack_readback(hit, hit_slot, placed, slot_pos, n_valid):
    """The staged step's five host-facing outputs as one int32 block
    ``[hit | hit_slot | placed | slot_pos | n_valid]`` (one device→host
    transfer); PyTorch ops on either device
    (:func:`repro_torch.kernels.ref.pack_readback`)."""
    return ref.pack_readback(hit, hit_slot, placed, slot_pos, n_valid)


@telemetry.profiled("gather_rows")
def gather_rows(table, indices, loc=None):
    """``table (N, F)``, ``indices (M,)`` int32 → ``(M, F)``; with an int32
    node -> row map ``loc``, rows ``table[loc[indices]]`` (the map read in
    the launch). CPU tensors: :func:`repro_torch.kernels.ref.gather_rows`;
    CUDA: the Hopper gather
    (:func:`repro_torch.kernels.gather_rows.gather_rows_cuda`)."""
    if _route("gather_rows", table) == "cpu":
        return ref.gather_rows(table, indices, loc)
    from .gather_rows import gather_rows_cuda

    return gather_rows_cuda(table, indices, loc)


@telemetry.profiled("gather_rows_batch")
def gather_rows_batch(tables, indices):
    """``tables (P, N, F)``, ``indices (P, M)`` int32 → ``(P, M, F)``, the
    feature store's per-home gather. CPU tensors:
    :func:`repro_torch.kernels.ref.gather_rows_batch`; CUDA: the Hopper
    gather (:func:`repro_torch.kernels.gather_rows.gather_rows_batch_cuda`)."""
    if _route("gather_rows_batch", tables) == "cpu":
        return ref.gather_rows_batch(tables, indices)
    from .gather_rows import gather_rows_batch_cuda

    return gather_rows_batch_cuda(tables, indices)


@telemetry.profiled("frontier_unique_batch")
def frontier_unique_batch(sorted_keys, is_remote=None, *, part_of=None, compact=False):
    """Fused frontier dedup of the sampler plane: row-sorted keys ``(P,
    M)`` (int32 or int64, keys >= 0) and remote flags ``(P, M)`` (bool or
    int) → ``(first (P, M) bool, remote (P, M) bool, unique_count (P,)
    int32, remote_count (P,) int32)``.

    With ``compact=True``, the sampler's form: no flags; the remote test
    is ``part_of[key] != row`` (``part_of`` a 1-D tensor indexed by the
    keys, or None: nothing remote), and the masks give way to the
    compacted ids in flat row order → ``(uniq, rem, unique_count,
    remote_count)``, where the first ``unique_count.sum()`` entries of
    ``uniq`` are ``keys.ravel()[first.ravel()]`` and the first
    ``remote_count.sum()`` of ``rem`` are ``keys.ravel()[remote.ravel()]``
    (``rem`` None without ``part_of``), in the keys' route dtype. The
    plain version returns exactly those entries, the kernel buffers of
    ``P * M`` (it cannot know the counts before it runs).

    The reference's contract on ids: int64 keys up to
    :data:`INT32_ID_MAX` run the narrow kernel as int32, larger ones the
    int64 kernel (``frontier_unique_batch_wide``; the reference's
    ``(hi, lo)`` word-plane twin), and keys past :data:`WIDE_ID_MAX`
    raise ``ValueError``; the outputs' types are the same on every route.
    CPU tensors: :func:`repro_torch.kernels.ref.frontier_unique_batch`
    (:func:`~repro_torch.kernels.ref.frontier_unique_compact`); CUDA: the
    Hopper kernel (:mod:`repro_torch.kernels.frontier_unique`)."""
    if compact and is_remote is not None:
        raise ValueError("the compact form takes part_of, not remote flags")
    if not compact and (is_remote is None or part_of is not None):
        raise ValueError("the mask form takes remote flags, not part_of")
    wide = False
    if sorted_keys.dtype != torch.int32:
        top = _max_id(sorted_keys)
        if not int32_id_eligible(top):
            if not wide_id_eligible(top):
                raise ValueError(
                    "frontier keys exceed the wide-id device bound "
                    f"(max {top} > {WIDE_ID_MAX})"
                )
            wide = True
        sorted_keys = sorted_keys.to(torch.int64 if wide else torch.int32)
    cpu = _route("frontier_unique_batch", sorted_keys) == "cpu"
    if compact:
        if part_of is not None:
            part_of = part_of.to(torch.int32).contiguous()
        if cpu:
            return ref.frontier_unique_compact(sorted_keys, part_of)
        from .frontier_unique import frontier_unique_compact_cuda

        return frontier_unique_compact_cuda(sorted_keys.contiguous(), part_of)
    if is_remote.dtype != torch.bool:
        is_remote = is_remote != 0
    if cpu:
        return ref.frontier_unique_batch(sorted_keys, is_remote)
    from .frontier_unique import (
        frontier_unique_batch_cuda,
        frontier_unique_batch_wide_cuda,
    )

    launch = frontier_unique_batch_wide_cuda if wide else frontier_unique_batch_cuda
    return launch(sorted_keys.contiguous(), is_remote.contiguous())


def _score_inputs(scores, accessed, weights=None):
    scores = scores.to(torch.float32).contiguous()
    accessed = (accessed if accessed.dtype == torch.bool else accessed != 0).contiguous()
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    return scores, accessed, weights


@telemetry.profiled("score_update")
def score_update(scores, accessed):
    """The paper's scoring round on one buffer: scores ``(N,)`` float32,
    accessed ``(N,)`` bool → ``(new (N,), stale_count)`` (a 0-dim int32
    tensor). CPU tensors: :func:`repro_torch.kernels.ref.score_update`;
    CUDA: the Hopper kernel's ``P = 1`` view
    (:func:`repro_torch.kernels.score_update.score_update_cuda`)."""
    scores, accessed, _ = _score_inputs(scores, accessed)
    if _route("score_update", scores) == "cpu":
        return ref.score_update(scores, accessed)
    from .score_update import score_update_cuda

    return score_update_cuda(scores, accessed)


@telemetry.profiled("score_update_batch")
def score_update_batch(scores, accessed):
    """The paper's scoring round per PE: ``(P, N)`` in → ``(new (P, N),
    stale_count (P,))`` out. CPU tensors:
    :func:`repro_torch.kernels.ref.score_update_batch`; CUDA: the Hopper
    kernel (:func:`repro_torch.kernels.score_update.score_update_batch_cuda`)."""
    scores, accessed, _ = _score_inputs(scores, accessed)
    if _route("score_update_batch", scores) == "cpu":
        return ref.score_update_batch(scores, accessed)
    from .score_update import score_update_batch_cuda

    return score_update_batch_cuda(scores, accessed)


@telemetry.profiled("score_policy_update_batch")
def score_policy_update_batch(
    scores,
    accessed,
    weights=None,
    *,
    increment: float = 1.0,
    decay: float = 0.95,
    threshold: float = 0.95,
    mode: str = "accumulate",
    score_cap: float = 4.0,
):
    """The policy zoo's scoring round: scores ``(P, N)`` float32, accessed
    ``(P, N)`` bool [, weights ``(P, N)`` float32] → ``(new (P, N),
    stale_count (P,) int32)``; ``mode`` and the constants follow
    :class:`repro_torch.core.scoring.ScoringPolicy`.

    Refuses, as the reference does, a policy whose post-update value of a
    padding lane (score 1, accessed, weight 1) would fall below
    ``threshold``: the reference's Pallas kernel pads rows with such
    lanes and would count them stale. The Hopper kernel pads nothing, but
    the contract is the reference's on every device. CPU tensors:
    :func:`repro_torch.kernels.ref.score_policy_update_batch`; CUDA: the
    Hopper kernel
    (:func:`repro_torch.kernels.score_update.score_policy_update_batch_cuda`)."""
    if mode not in scoring.MODES:
        raise ValueError(f"mode must be one of {scoring.MODES}, got {mode!r}")
    if mode == "accumulate":
        pad_value = 1.0 + increment
    elif mode == "reset":
        pad_value = increment
    else:
        pad_value = min(1.0 + increment, score_cap)
    if pad_value < threshold:
        raise ValueError(
            f"policy (mode={mode!r}, increment={increment}, "
            f"score_cap={score_cap}) would mark padding lanes stale "
            f"(post-update {pad_value} < threshold {threshold})"
        )
    scores, accessed, weights = _score_inputs(scores, accessed, weights)
    constants = dict(
        increment=float(increment),
        decay=float(decay),
        threshold=float(threshold),
        mode=mode,
        score_cap=float(score_cap),
    )
    if _route("score_policy_update_batch", scores) == "cpu":
        return ref.score_policy_update_batch(scores, accessed, weights, **constants)
    from .score_update import score_policy_update_batch_cuda

    return score_policy_update_batch_cuda(scores, accessed, weights, **constants)


def _no_grad_input(name: str, tensor) -> None:
    """The neighbour-mean kernels are forward-only, as the reference's
    (no VJP): refuse an input that would need a gradient rather than cut
    the graph silently."""
    if tensor.requires_grad:
        raise ValueError(
            f"{name} is forward-only: its input must not require a gradient"
        )


@telemetry.profiled("gather_mean")
def gather_mean(table, indices):
    """GraphSAGE neighbour mean: ``table (N, F)`` float32 or bfloat16,
    ``indices (B, K)`` int32 or int64 → ``(B, F)``, the mean of each
    destination's K gathered rows, in the table's dtype. Forward-only
    (``ValueError`` on a table that requires a gradient). CPU tensors:
    :func:`repro_torch.kernels.ref.gather_mean`; CUDA: the Hopper kernel
    (:func:`repro_torch.kernels.gather_mean.gather_mean_cuda`)."""
    _no_grad_input("gather_mean", table)
    if _route("gather_mean", table) == "cpu":
        return ref.gather_mean(table, indices)
    from .gather_mean import gather_mean_cuda

    return gather_mean_cuda(table.contiguous(), indices.contiguous())


@telemetry.profiled("segment_sum_equal")
def segment_sum_equal(data, k: int, *, scale: float | None = None):
    """Sum of every ``k`` consecutive rows: ``data (S*k, F)`` float32 or
    bfloat16 → ``(S, F)`` in the data's dtype; with ``scale``, each
    rounded sum times the float32 ``scale`` in the same launch (the fanout
    mean; roundings as :func:`repro_torch.kernels.ref.segment_sum_equal`
    states). Forward-only (``ValueError`` on data that requires a
    gradient). CPU tensors: :func:`repro_torch.kernels.ref.segment_sum_equal`;
    CUDA: the Hopper kernel
    (:func:`repro_torch.kernels.segment_sum.segment_sum_equal_cuda`)."""
    _no_grad_input("segment_sum_equal", data)
    if _route("segment_sum_equal", data) == "cpu":
        return ref.segment_sum_equal(data, int(k), scale)
    from .segment_sum import segment_sum_equal_cuda

    return segment_sum_equal_cuda(data.contiguous(), int(k), scale)


@telemetry.profiled("mla_flash_decode")
def mla_flash_decode(q_lat, q_rope, cache_c, cache_kr, pos, *, scale=None):
    """MLA latent flash-decode: ``q_lat (B, H, r)``, ``q_rope (B, H, rr)``,
    ``cache_c (B, S, r)``, ``cache_kr (B, S, rr)`` (one dtype, float32 or
    bfloat16) and ``pos`` (rows ``0..pos`` attend; a host int on the card,
    so reading it needs no sync) → the latent context ``(B, H, r)`` in the
    cache's dtype. ``scale`` defaults to ``1/sqrt(r + rr)``. CPU tensors:
    :func:`repro_torch.kernels.ref.mla_latent_attention`; CUDA: the Hopper
    kernel (:func:`repro_torch.kernels.mla_decode.mla_flash_decode_cuda`);
    ``meta`` tensors (the dry-run's, which compute nothing and are only
    counted): the plain version too, whose operations the count reads, as
    the reference's plain ``jnp`` decode is counted."""
    if scale is None:
        scale = 1.0 / (q_lat.shape[-1] + q_rope.shape[-1]) ** 0.5
    if cache_c.device.type == "meta" or _route("mla_flash_decode", cache_c) == "cpu":
        return ref.mla_latent_attention(q_lat, q_rope, cache_c, cache_kr, pos, scale)
    from .mla_decode import mla_flash_decode_cuda

    return mla_flash_decode_cuda(
        q_lat.contiguous(), q_rope.contiguous(), cache_c.contiguous(),
        cache_kr.contiguous(), int(pos), float(scale),
    )
