"""Plain PyTorch versions of the kernels on the port's main path.

Each function here is the spec of one hand-written CUDA kernel and runs
on tensors of any device: the CPU tests hold it bit-exact against the
reference package's jnp oracle, and ``chip_smoke.py`` holds the CUDA
kernel bit-exact against it on the card.

Unlike the reference oracle, the replace and probe rounds here use no
dense ``(K, C)`` / ``(M, C)`` / ``(K, K)`` comparison tiles: membership
and the probe are a per-PE sort + ``torch.searchsorted``, candidate
dedup is a stable sort, and the candidate-to-slot matching is a
rank-table gather. At the main path's shape (Mt = 522,000 frontier
positions, C ≈ 12.6k slots per PE) the dense tiles would need billions
of compares; these stay O((Mt + K + C) log) per PE.

Also home of the numpy :func:`frontier_dedup` the sampler imports.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scoring

#: Sentinel of the miss compaction (``int32.max``); the narrow id bound
#: ``kernels.ops.INT32_ID_MAX`` strictly excludes it.
_SENTINEL = int(np.iinfo(np.int32).max)


def frontier_dedup(
    sorted_keys: np.ndarray, is_remote: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray | None]:
    """First-occurrence mask over row-sorted frontiers (numpy reference).

    ``sorted_keys`` is ``(P, M)``, each row sorted ascending; the mask
    selects each row's sorted-unique elements. With ``is_remote`` the
    remote extraction fuses into the same pass:
    ``remote_mask = first & is_remote``.
    """
    first = np.ones(sorted_keys.shape, dtype=bool)
    if sorted_keys.shape[1] > 1:
        first[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    remote = (first & is_remote) if is_remote is not None else None
    return first, remote


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: every constant of the
    score arithmetic is rounded to float32 first, as in the reference."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def frontier_prologue(touched_aug: torch.Tensor, part_of: torch.Tensor):
    """Frontier ingest: unpack the gate column and row-sort the frontier.

    ``touched_aug`` is the raw ``(P, Mt + 1)`` int32 block — the sampled
    frontier, unsorted and with duplicates — whose last column packs the
    per-PE gates ``active_score | do_replace << 1 | active_probe << 2``.
    Returns the three gate vectors, the row-sorted keys ``sk``, their
    left-shifted predecessors ``prev``, the per-position remoteness
    ``rem`` (``part_of[sk] != own``) and the unique-remote mask
    ``remote = first & rem``.
    """
    P = touched_aug.shape[0]
    touched = touched_aug[:, :-1].to(torch.int32)
    gates = touched_aug[:, -1].to(torch.int32)
    active_score = (gates & 1) != 0
    do_replace = (gates & 2) != 0
    active_probe = (gates & 4) != 0
    sk = torch.sort(touched, dim=1).values
    prev = torch.cat(
        [torch.full((P, 1), -1, dtype=torch.int32, device=sk.device), sk[:, :-1]],
        dim=1,
    )
    first = (sk != prev) & (sk >= 0)
    own = torch.arange(P, dtype=torch.int32, device=sk.device)[:, None]
    rem = part_of[sk.clamp(min=0).long()].to(torch.int32) != own
    remote = first & rem
    return active_score, do_replace, active_probe, sk, prev, rem, remote


def cand_weights_of(cand: torch.Tensor, node_weights: torch.Tensor | None):
    """Per-candidate degree weights (1.0 for padding or without weights)."""
    if node_weights is None:
        return torch.ones(cand.shape, dtype=torch.float32, device=cand.device)
    return torch.where(
        cand >= 0,
        node_weights[cand.clamp(min=0).long()].to(torch.float32),
        _f32(1.0, cand),
    )


def _row_lookup(table: torch.Tensor, keys: torch.Tensor):
    """Per-row membership: ``(found, index)`` of each ``keys[p, j]`` in
    ``table[p]``, whose entries are unique among the non-negative ones
    (negative entries never match a non-negative key). One row sort plus
    ``searchsorted``; ``index`` is the position in ``table`` (garbage
    where not found)."""
    srt, order = torch.sort(table, dim=1)
    pos = torch.searchsorted(srt.contiguous(), keys.contiguous())
    pos = pos.clamp(max=table.shape[1] - 1)
    found = (srt.gather(1, pos) == keys) & (keys >= 0)
    return found, order.gather(1, pos)


def fused_step_core(
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
    increment: float,
    decay: float,
    threshold: float,
    score_cap: float,
    mode: str,
    initial_score: float,
):
    """score → replace → probe over the ``(P, C)`` buffer state.

    The semantics of the reference's ``_fused_step_impl`` (narrow ids)
    and of the Pallas ``_fused_body``: score closes the round for
    ``active_score`` PEs; replace places fresh candidates (valid, not
    resident, first occurrence) into free slots, then stale ones, both
    in ascending slot order, in candidate order, at ``initial_score``;
    probe answers ``queries`` against the post-replace ids and marks hit
    slots accessed. Resident ids must be unique per PE (the engine
    guarantees it). Returns ``(ids2, s2, valid2, acc3, w2, hit,
    hit_slot, placed, slot_pos, n_place, n_valid)``.
    """
    P, C = ids.shape
    K = cand.shape[1]
    if C == 0:
        raise ValueError("fused_step_core needs C >= 1 buffer slots")
    dev = ids.device
    ids = ids.to(torch.int32)
    cand = cand.to(torch.int32)
    queries = queries.to(torch.int32)
    scores = scores.to(torch.float32)
    a_score = active_score[:, None]

    # -- 1. scoring round ------------------------------------------------ #
    gain = _f32(increment, scores)
    if weights is not None:
        gain = gain * weights.to(torch.float32)
    if mode == "accumulate":
        touched = scores + gain
    elif mode == "reset":
        touched = gain + torch.zeros_like(scores)
    elif mode == "capped":
        touched = torch.minimum(scores + gain, _f32(score_cap, scores))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    new_s = torch.where(accessed, touched, scores * _f32(decay, scores))
    s1 = torch.where(a_score & valid, new_s, scores)
    acc1 = accessed & ~a_score

    # -- 2. replacement round -------------------------------------------- #
    ids_pre = torch.where(valid, ids, torch.full_like(ids, -2))
    member, _ = _row_lookup(ids_pre, cand)
    # First occurrence: a stable sort keeps equal candidates in position
    # order, so each run's head is its earliest position.
    srt, order = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    fresh = (cand >= 0) & ~member & ~dup & do_replace[:, None]
    free = ~valid & in_capacity
    stale = valid & (s1 < _f32(threshold, s1))
    n_free = free.sum(dim=1, dtype=torch.int32)
    free_rank = torch.cumsum(free, dim=1, dtype=torch.int32) - 1
    stale_rank = n_free[:, None] + torch.cumsum(stale, dim=1, dtype=torch.int32) - 1
    big = C + K + 1
    slot_pos = torch.where(
        free,
        free_rank,
        torch.where(stale, stale_rank, torch.full_like(free_rank, big)),
    )
    fresh_rank = torch.cumsum(fresh, dim=1, dtype=torch.int32) - 1
    n_fresh = fresh.sum(dim=1, dtype=torch.int32)
    n_stale = stale.sum(dim=1, dtype=torch.int32)
    n_place = torch.where(
        do_replace, torch.minimum(n_free + n_stale, n_fresh), torch.zeros_like(n_free)
    )
    placed = fresh & (fresh_rank < n_place[:, None])
    filled = slot_pos < n_place[:, None]
    # Rank meeting: the candidate of fresh rank r fills the slot of fill
    # rank r. A (P, K + 1) rank table (column K collects the unplaced)
    # resolves each filled slot's candidate with one gather.
    rank_cand = torch.zeros((P, K + 1), dtype=torch.int64, device=dev)
    k_iota = torch.arange(K, dtype=torch.int64, device=dev).expand(P, K)
    rank_cand.scatter_(
        1, torch.where(placed, fresh_rank.long(), K), k_iota
    )
    cand_idx = rank_cand.gather(1, torch.where(filled, slot_pos.long(), K))
    cand_idx = cand_idx.clamp(max=max(K - 1, 0))
    if K:
        ids2 = torch.where(filled, cand.gather(1, cand_idx), ids)
    else:
        ids2 = ids
    s2 = torch.where(filled, _f32(initial_score, s1), s1)
    valid2 = valid | filled
    if weights is not None and cand_weights is not None and K:
        w2 = torch.where(
            filled, cand_weights.to(torch.float32).gather(1, cand_idx), weights
        )
    else:
        w2 = weights
    acc2 = acc1 & ~filled

    # -- 3. membership probe of the next round --------------------------- #
    ids_post = torch.where(valid2, ids2, torch.full_like(ids2, -2))
    found, slot = _row_lookup(ids_post, queries)
    hit = found & active_probe[:, None]
    hit_slot = torch.where(hit, slot.to(torch.int32), torch.full_like(queries, -1))
    marks = torch.zeros((P, C), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, torch.where(hit, slot, 0), hit.to(torch.int32))
    acc3 = acc2 | (marks > 0)
    n_valid = valid2.sum(dim=1, dtype=torch.int32)
    return (
        ids2,
        s2,
        valid2,
        acc3,
        w2,
        hit,
        hit_slot,
        placed,
        slot_pos,
        n_place,
        n_valid,
    )


def frontier_pack(
    sk: torch.Tensor,
    code: torch.Tensor,
    placed: torch.Tensor,
    slot_pos: torch.Tensor,
    n_place: torch.Tensor,
    n_valid: torch.Tensor,
    *,
    cand_cap: int,
):
    """Epilogue of the frontier step: miss compaction and the packed
    readback.

    * ``cand_next`` — the next launch's candidates: this probe's misses
      (``code == 1``) compacted to the first ``min(cand_cap, Mt)``
      ascending ids, -1 padded. With ``cand_cap = 2 * C`` the cut keeps
      every candidate a replacement round could admit.
    * ``packed`` — the step's host readback as one int32 block
      ``[sk | code | placed | slot_pos | n_valid]``.
    * ``counters`` — ``(P, 4)`` ``[n_remote, hits, n_place, n_valid]``.
    """
    Mt = sk.shape[1]
    kc = min(int(cand_cap), Mt)
    sent = torch.full_like(sk, _SENTINEL)
    miss_keys = torch.where(code == 1, sk, sent)
    cand_next = torch.sort(miss_keys, dim=1).values[:, :kc]
    cand_next = torch.where(
        cand_next == _SENTINEL, torch.full_like(cand_next, -1), cand_next
    )
    n_remote = (code > 0).sum(dim=1, dtype=torch.int32)
    hits = (code >= 2).sum(dim=1, dtype=torch.int32)
    counters = torch.stack(
        [n_remote, hits, n_place.to(torch.int32), n_valid.to(torch.int32)], dim=1
    )
    packed = torch.cat(
        [
            sk,
            code,
            placed.to(torch.int32),
            slot_pos.to(torch.int32),
            n_valid[:, None].to(torch.int32),
        ],
        dim=1,
    )
    return cand_next, packed, counters


def fused_frontier_step(
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
    increment: float = float(scoring.ACCESS_INCREMENT),
    decay: float = float(scoring.DECAY_FACTOR),
    threshold: float = float(scoring.STALE_THRESHOLD),
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = float(scoring.INITIAL_SCORE),
):
    """Plain version of the single-launch device step: dedup → score →
    replace → probe over the raw frontier, then the miss compaction and
    the packed readback.

    Probe results come back as a per-sorted-position ``code`` stream:
    ``0`` = local or duplicate, ``1`` = remote miss, ``2 + slot`` =
    remote hit at ``slot``. Ids must lie in ``[0, len(part_of))`` (or be
    negative padding). Returns ``(ids2, scores2, valid2, accessed3,
    weights2, cand_next, packed, counters)``.
    """
    (
        active_score,
        do_replace,
        active_probe,
        sk,
        _prev,
        _rem,
        remote,
    ) = frontier_prologue(touched_aug, part_of)
    queries = torch.where(remote, sk, torch.full_like(sk, -1))
    cand = cand.to(torch.int32)
    cw = cand_weights_of(cand, node_weights) if weights is not None else None
    (
        ids2,
        s2,
        valid2,
        acc3,
        w2,
        hit,
        hit_slot,
        placed,
        slot_pos,
        n_place,
        n_valid,
    ) = fused_step_core(
        ids,
        scores,
        valid,
        accessed,
        in_capacity,
        weights,
        queries,
        cand,
        cw,
        active_score,
        do_replace,
        active_probe,
        increment=increment,
        decay=decay,
        threshold=threshold,
        score_cap=score_cap,
        mode=mode,
        initial_score=initial_score,
    )
    code = torch.where(
        remote,
        torch.where(hit, hit_slot + 2, torch.ones_like(hit_slot)),
        torch.zeros_like(hit_slot),
    )
    cand_next, packed, counters = frontier_pack(
        sk, code, placed, slot_pos, n_place, n_valid, cand_cap=cand_cap
    )
    return ids2, s2, valid2, acc3, w2, cand_next, packed, counters
