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

The ``_wide`` functions are the same steps on int64 ids, for graphs whose
global ids sit at an ``id_base`` or pass ``2**31 - 2``: the reference
carries such ids as ``(hi, lo)`` int32 word planes because its device
math is int32; here they are int64 tensors, and the per-node arrays
(``part_of``, ``node_weights``, the store's ``loc``) are indexed by the
local id ``id - id_base`` (:func:`wide_local_index`). On int32 ids every
function computes exactly what it did before.

The staged pipeline's two kernels have their specs here too:
:func:`frontier_unique_batch` (the sampler plane's dedup, int32 or int64
keys) and :func:`score_policy_update_batch` with its fixed-policy forms
:func:`score_update_batch` and :func:`score_update` (the engine's
scoring round).

The model zoo's MLA decode has one: :func:`mla_latent_attention` (the
masked softmax over the latent cache and the context in latent
coordinates), which ``csrc/mla_decode.cu`` matches to allclose.

The GraphSAGE step's two neighbour means have theirs too:
:func:`gather_mean` (gather K table rows per destination and average
them) and :func:`segment_sum_equal` (sum every k consecutive rows), each
added in a fixed order into a float32 accumulator, so that the kernels
match them bit for bit.

Also home of the numpy :func:`frontier_dedup` the sampler imports.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scoring

#: Sentinel of the miss compaction (``int32.max``); the narrow id bound
#: ``kernels.ops.INT32_ID_MAX`` strictly excludes it.
_SENTINEL = int(np.iinfo(np.int32).max)
#: The wide miss compaction's sentinel (``int64.max``): the wide id bound
#: ``kernels.ops.WIDE_ID_MAX`` (about 2^61) lies far below it.
_SENTINEL64 = int(np.iinfo(np.int64).max)


def wide_local_index(ids: torch.Tensor, id_base: int, num_nodes: int) -> torch.Tensor:
    """Local index ``id - id_base`` of global ids, clamped to ``[0,
    num_nodes)`` so it is always safe to gather with (padding and other
    out-of-range lanes give garbage the caller masks), as the reference's
    ``wide_local_index`` over ``(hi, lo)`` planes."""
    return (ids.to(torch.int64) - int(id_base)).clamp(0, max(int(num_nodes) - 1, 0))


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


def frontier_prologue(
    touched_aug: torch.Tensor, part_of: torch.Tensor, id_base: int | None = None
):
    """Frontier ingest: unpack the gate column and row-sort the frontier.

    ``touched_aug`` is the raw ``(P, Mt + 1)`` int32 block — the sampled
    frontier, unsorted and with duplicates — whose last column packs the
    per-PE gates ``active_score | do_replace << 1 | active_probe << 2``.
    Returns the three gate vectors, the row-sorted keys ``sk``, their
    left-shifted predecessors ``prev``, the per-position remoteness
    ``rem`` (``part_of[sk] != own``) and the unique-remote mask
    ``remote = first & rem``. With ``id_base`` the block is int64 global
    ids (:func:`frontier_prologue_wide`).
    """
    P = touched_aug.shape[0]
    idt = torch.int32 if id_base is None else torch.int64
    touched = touched_aug[:, :-1].to(idt)
    gates = touched_aug[:, -1].to(torch.int32)
    active_score = (gates & 1) != 0
    do_replace = (gates & 2) != 0
    active_probe = (gates & 4) != 0
    sk = torch.sort(touched, dim=1).values
    prev = torch.cat(
        [torch.full((P, 1), -1, dtype=idt, device=sk.device), sk[:, :-1]],
        dim=1,
    )
    first = (sk != prev) & (sk >= 0)
    own = torch.arange(P, dtype=torch.int32, device=sk.device)[:, None]
    if id_base is None:
        local = sk.clamp(min=0).long()
    else:
        local = wide_local_index(sk, id_base, part_of.shape[0])
    rem = part_of[local].to(torch.int32) != own
    remote = first & rem
    return active_score, do_replace, active_probe, sk, prev, rem, remote


def frontier_prologue_wide(
    touched_aug: torch.Tensor, part_of: torch.Tensor, *, id_base: int
):
    """:func:`frontier_prologue` over the int64 ``(P, Mt + 1)`` block of
    global ids (gates in the last column): numeric int64 order is the
    reference's lexicographic ``(hi, lo)`` order, and ``part_of`` is read
    at the local id (:func:`wide_local_index`)."""
    return frontier_prologue(touched_aug, part_of, id_base=int(id_base))


def frontier_count_sort(
    touched_aug: torch.Tensor, part_of: torch.Tensor, id_base: int | None = None
):
    """The row sort of :func:`frontier_prologue` as the kernels do it:
    a count sort over the local ids ``id - id_base`` (``bincount`` →
    ``cumsum`` → ``repeat_interleave``) behind each row's negative keys,
    which are sorted among themselves. Every non-negative key must lie in
    ``[id_base, id_base + len(part_of))``. Returns ``(sk, remote)``,
    equal to :func:`frontier_prologue`'s: the row-sorted keys and the
    unique-remote mask (the first position of each remote id's run).
    Used by the tests only."""
    P = touched_aug.shape[0]
    N = part_of.shape[0]
    base = 0 if id_base is None else int(id_base)
    touched = touched_aug[:, :-1]
    rows, remotes = [], []
    for p in range(P):
        keys = touched[p]
        neg = torch.sort(keys[keys < 0]).values
        local = (keys[keys >= 0].to(torch.int64) - base)
        counts = torch.bincount(local, minlength=N)
        ids = torch.repeat_interleave(torch.arange(N, dtype=torch.int64), counts)
        rows.append(torch.cat([neg, (ids + base).to(keys.dtype)]))
        first = torch.zeros(keys.shape[0], dtype=torch.bool)
        starts = neg.shape[0] + torch.cumsum(counts, 0) - counts
        present = counts > 0
        first[starts[present]] = part_of[present].to(torch.int32) != p
        remotes.append(first)
    return torch.stack(rows), torch.stack(remotes)


def compact_misses(
    sk: torch.Tensor, code: torch.Tensor, *, cand_cap: int, id_base: int | None = None
) -> torch.Tensor:
    """:func:`frontier_pack`'s ``cand_next`` as the kernels build it: a
    miss (``code == 1``) is the first position of its id's run and ``sk``
    ascends, so each miss's rank is a ``cumsum`` of the miss flags, and no
    second sort is needed. Used by the tests only."""
    kc = min(int(cand_cap), sk.shape[1])
    miss = code == 1
    rank = torch.cumsum(miss, dim=1) - 1
    out = torch.full((sk.shape[0], kc + 1), -1, dtype=sk.dtype)
    out.scatter_(1, torch.where(miss & (rank < kc), rank, kc), sk)
    return out[:, :kc]


def cand_weights_of(cand: torch.Tensor, node_weights: torch.Tensor | None):
    """Per-candidate degree weights (1.0 for padding or without weights)."""
    if node_weights is None:
        return torch.ones(cand.shape, dtype=torch.float32, device=cand.device)
    return torch.where(
        cand >= 0,
        node_weights[cand.clamp(min=0).long()].to(torch.float32),
        _f32(1.0, cand),
    )


def cand_weights_of_wide(
    cand: torch.Tensor, node_weights: torch.Tensor | None, *, id_base: int
):
    """:func:`cand_weights_of` for int64 global ids: ``node_weights`` is
    local-indexed, so the gather goes through :func:`wide_local_index`."""
    if node_weights is None:
        return torch.ones(cand.shape, dtype=torch.float32, device=cand.device)
    local = wide_local_index(cand, id_base, node_weights.shape[0])
    return torch.where(cand >= 0, node_weights[local].to(torch.float32), _f32(1.0, cand))


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
    guarantees it). Ids are int32, or int64 when ``ids`` is (the wide
    path); ``ids2`` keeps that type. Returns ``(ids2, s2, valid2, acc3,
    w2, hit, hit_slot, placed, slot_pos, n_place, n_valid)``.
    """
    P, C = ids.shape
    K = cand.shape[1]
    if C == 0:
        raise ValueError("fused_step_core needs C >= 1 buffer slots")
    dev = ids.device
    idt = torch.int64 if ids.dtype == torch.int64 else torch.int32
    ids = ids.to(idt)
    cand = cand.to(idt)
    queries = queries.to(idt)
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
    hit_slot = torch.where(
        hit, slot.to(torch.int32), torch.full_like(queries, -1, dtype=torch.int32)
    )
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


def fused_step(
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
    increment: float = float(scoring.ACCESS_INCREMENT),
    decay: float = float(scoring.DECAY_FACTOR),
    threshold: float = float(scoring.STALE_THRESHOLD),
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = float(scoring.INITIAL_SCORE),
):
    """Plain version of the staged fused step (score → replace → probe
    over host-deduped ``queries`` and raw ``cand`` lists), the spec of
    ``csrc/fused_step.cu``. Returns ``(ids, scores, valid, accessed,
    weights, hit, hit_slot, placed, slot_pos, n_placed, n_valid)``, as
    the reference's ``fused_step``. ``slot_pos`` of a slot that is
    neither free nor stale is the unpadded sentinel ``C + K + 1``. Needs
    ``C >= 1``: the engine's state always has a slot (``PrefetchEngine``
    pads ``C`` to at least 1)."""
    return fused_step_core(
        ids,
        scores,
        valid.to(torch.bool),
        accessed.to(torch.bool),
        in_capacity.to(torch.bool),
        weights,
        queries,
        cand,
        cand_weights,
        active_score.to(torch.bool),
        do_replace.to(torch.bool),
        active_probe.to(torch.bool),
        increment=increment,
        decay=decay,
        threshold=threshold,
        score_cap=score_cap,
        mode=mode,
        initial_score=initial_score,
    )


def fused_step_wide(
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
    **constants,
):
    """:func:`fused_step` on int64 ids (state, queries, candidates): the
    spec of ``csrc/fused_step.cu``'s wide entry and the counterpart of the
    reference's ``fused_step_wide``, which takes ``(hi, lo)`` planes and
    returns the ``hi`` plane of ``ids2`` as a second output. Here
    ``ids2`` is one int64 tensor; the other ten outputs are those of
    :func:`fused_step`."""
    return fused_step(
        ids.to(torch.int64), scores, valid, accessed, in_capacity, weights,
        queries.to(torch.int64), cand.to(torch.int64), cand_weights,
        active_score, do_replace, active_probe, **constants,
    )


def gather_rows(table: torch.Tensor, idx: torch.Tensor, loc: torch.Tensor | None = None) -> torch.Tensor:
    """``table (N, F)``, ``idx (M,)`` → ``(M, F)``: the spec of
    ``csrc/gather_rows.cu``'s single-table entry; with a node -> row map
    ``loc (L,)``, row ``i`` is ``table[loc[idx[i]]]``."""
    rows = idx.long() if loc is None else loc[idx.long()].long()
    return table[rows]


def gather_rows_batch(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tables (P, N, F)``, ``idx (P, M)`` → ``(P, M, F)`` with
    ``out[p, i] = tables[p, idx[p, i]]``."""
    P = tables.shape[0]
    rows = torch.arange(P, device=tables.device)[:, None]
    return tables[rows, idx.long()]


def pack_readback(hit, hit_slot, placed, slot_pos, n_valid) -> torch.Tensor:
    """The staged fused step's five host-facing outputs as one int32
    block ``[hit | hit_slot | placed | slot_pos | n_valid]`` of width
    ``2*M + K + C + 1``: one device→host transfer per step."""
    return torch.cat(
        [
            hit.to(torch.int32),
            hit_slot.to(torch.int32),
            placed.to(torch.int32),
            slot_pos.to(torch.int32),
            n_valid[:, None].to(torch.int32),
        ],
        dim=1,
    )


def payload_scatter(
    ids2: torch.Tensor,
    slot_pos: torch.Tensor,
    n_place: torch.Tensor,
    payload: torch.Tensor,
    table: torch.Tensor,
    loc: torch.Tensor,
    id_base: int | None = None,
) -> torch.Tensor:
    """Admission rows (``slot_pos < n_place``) copied verbatim from the
    store's flat ``(R, F)`` table into the ``(P*C, F)`` payload; every
    other slot keeps its row. ``loc`` is indexed by the node id, or with
    ``id_base`` by the local id (:func:`wide_local_index`). Returns the
    new payload."""
    P, C = ids2.shape
    F = table.shape[1]
    filled = slot_pos < n_place[:, None]
    if id_base is None:
        local = ids2.clamp(min=0).long()
    else:
        local = wide_local_index(ids2, id_base, loc.shape[0])
    rows = table[loc[local].long()]
    return torch.where(
        filled[:, :, None], rows, payload.reshape(P, C, F)
    ).reshape(P * C, F)


def frontier_pack(
    sk: torch.Tensor,
    code: torch.Tensor,
    placed: torch.Tensor,
    slot_pos: torch.Tensor,
    n_place: torch.Tensor,
    n_valid: torch.Tensor,
    ids2: torch.Tensor,
    payload: torch.Tensor | None,
    table: torch.Tensor | None,
    loc: torch.Tensor | None,
    *,
    cand_cap: int,
    id_base: int | None = None,
):
    """Epilogue of the frontier step: miss compaction, the packed
    readback and the in-launch payload scatter.

    * ``cand_next`` — the next launch's candidates: this probe's misses
      (``code == 1``) compacted to the first ``min(cand_cap, Mt)``
      ascending ids, -1 padded. With ``cand_cap = 2 * C`` the cut keeps
      every candidate a replacement round could admit.
    * ``packed`` — the step's host readback as one int32 block
      ``[sk | code | placed | slot_pos | n_valid]``.
    * ``counters`` — ``(P, 4)`` ``[n_remote, hits, n_place, n_valid]``.
    * ``payload2`` — with a store table attached, :func:`payload_scatter`
      of the admissions; else ``payload`` unchanged.

    With ``id_base`` the ids are int64 (:func:`frontier_pack_wide`).
    """
    Mt = sk.shape[1]
    kc = min(int(cand_cap), Mt)
    sentinel = _SENTINEL if id_base is None else _SENTINEL64
    sent = torch.full_like(sk, sentinel)
    miss_keys = torch.where(code == 1, sk, sent)
    cand_next = torch.sort(miss_keys, dim=1).values[:, :kc]
    cand_next = torch.where(
        cand_next == sentinel, torch.full_like(cand_next, -1), cand_next
    )
    n_remote = (code > 0).sum(dim=1, dtype=torch.int32)
    hits = (code >= 2).sum(dim=1, dtype=torch.int32)
    counters = torch.stack(
        [n_remote, hits, n_place.to(torch.int32), n_valid.to(torch.int32)], dim=1
    )
    packed = torch.cat(
        [
            sk if id_base is None else sk.contiguous().view(torch.int32),
            code,
            placed.to(torch.int32),
            slot_pos.to(torch.int32),
            n_valid[:, None].to(torch.int32),
        ],
        dim=1,
    )
    payload2 = payload
    if table is not None:
        payload2 = payload_scatter(
            ids2, slot_pos, n_place, payload, table, loc, id_base=id_base
        )
    return cand_next, packed, counters, payload2


def frontier_pack_wide(
    sk: torch.Tensor,
    code: torch.Tensor,
    placed: torch.Tensor,
    slot_pos: torch.Tensor,
    n_place: torch.Tensor,
    n_valid: torch.Tensor,
    ids2: torch.Tensor,
    payload: torch.Tensor | None,
    table: torch.Tensor | None,
    loc: torch.Tensor | None,
    *,
    cand_cap: int,
    id_base: int,
):
    """:func:`frontier_pack` on int64 ids. The miss compaction pads with
    ``int64.max``, which sorts after every id the wide path accepts
    (``<= WIDE_ID_MAX``); ``cand_next`` is int64. The packed readback is
    still one int32 block, ``[sk as int32 pairs | code | placed |
    slot_pos | n_valid]`` of width ``3*Mt + K + C + 1`` (the reference's
    wide width): the host views its first ``2*Mt`` columns as int64. The
    payload scatter reads ``loc`` at the local id."""
    return frontier_pack(
        sk, code, placed, slot_pos, n_place, n_valid, ids2, payload, table, loc,
        cand_cap=cand_cap, id_base=int(id_base),
    )


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
    payload: torch.Tensor | None = None,
    table: torch.Tensor | None = None,
    loc: torch.Tensor | None = None,
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
    replace → probe over the raw frontier, then the miss compaction, the
    packed readback and (with a store ``table``) the payload scatter.

    Probe results come back as a per-sorted-position ``code`` stream:
    ``0`` = local or duplicate, ``1`` = remote miss, ``2 + slot`` =
    remote hit at ``slot``. Ids must lie in ``[0, len(part_of))`` (or be
    negative padding). Returns ``(ids2, scores2, valid2, accessed3,
    weights2, payload2, cand_next, packed, counters)``, as the
    reference's ``fused_frontier_step``.
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
    cand_next, packed, counters, payload2 = frontier_pack(
        sk, code, placed, slot_pos, n_place, n_valid, ids2, payload, table, loc,
        cand_cap=cand_cap,
    )
    return ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters


def fused_frontier_step_wide(
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
    increment: float = float(scoring.ACCESS_INCREMENT),
    decay: float = float(scoring.DECAY_FACTOR),
    threshold: float = float(scoring.STALE_THRESHOLD),
    score_cap: float = 4.0,
    mode: str = "accumulate",
    initial_score: float = float(scoring.INITIAL_SCORE),
):
    """:func:`fused_frontier_step` on int64 global ids, the spec of
    ``csrc/fused_frontier_step.cu``'s wide entry and the counterpart of
    the reference's ``fused_frontier_step_wide``: ``touched_aug`` is the
    int64 ``(P, Mt + 1)`` block (gates in the last column), ``ids`` and
    ``cand`` are int64, and ``part_of``, ``node_weights`` and ``loc`` are
    read at the local id ``id - id_base``. Returns the nine outputs of
    :func:`fused_frontier_step`, with ``ids2`` and ``cand_next`` int64
    and ``packed`` as :func:`frontier_pack_wide` lays it out."""
    id_base = int(id_base)
    (
        active_score,
        do_replace,
        active_probe,
        sk,
        _prev,
        _rem,
        remote,
    ) = frontier_prologue_wide(touched_aug, part_of, id_base=id_base)
    queries = torch.where(remote, sk, torch.full_like(sk, -1))
    cand = cand.to(torch.int64)
    cw = (
        cand_weights_of_wide(cand, node_weights, id_base=id_base)
        if weights is not None
        else None
    )
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
        ids.to(torch.int64),
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
    cand_next, packed, counters, payload2 = frontier_pack_wide(
        sk, code, placed, slot_pos, n_place, n_valid, ids2, payload, table, loc,
        cand_cap=cand_cap, id_base=id_base,
    )
    return ids2, s2, valid2, acc3, w2, payload2, cand_next, packed, counters


# --------------------------------------------------------------------------- #
# The staged pipeline's two kernels: the frontier dedup of the sampler
# plane and the scoring round of the numpy engine.
def frontier_unique_batch(sorted_keys: torch.Tensor, is_remote: torch.Tensor):
    """Fused frontier dedup: row-sorted keys ``(P, M)`` (int32, or int64
    for the wide twin; keys >= 0) and remote flags ``(P, M)`` →
    ``(first (P, M) bool, remote (P, M) bool, unique_count (P,) int32,
    remote_count (P,) int32)``. ``first`` marks each row's sorted-unique
    elements (the first column's predecessor is -1); ``remote = first &
    is_remote``. The spec of ``csrc/frontier_unique.cu`` in both its
    instantiations; mirrors the reference's jnp oracle, which the wide
    twin runs over ``(hi, lo)`` word planes."""
    P, M = sorted_keys.shape
    if M == 0:
        empty = torch.zeros((P, 0), dtype=torch.bool, device=sorted_keys.device)
        zeros = torch.zeros((P,), dtype=torch.int32, device=sorted_keys.device)
        return empty, empty, zeros, zeros
    idt = torch.int64 if sorted_keys.dtype == torch.int64 else torch.int32
    k = sorted_keys.to(idt)
    prev = torch.cat(
        [torch.full((P, 1), -1, dtype=idt, device=k.device), k[:, :-1]], dim=1
    )
    first = k != prev
    remote = first & (is_remote.to(torch.int32) != 0)
    return (
        first,
        remote,
        first.sum(dim=1, dtype=torch.int32),
        remote.sum(dim=1, dtype=torch.int32),
    )


def frontier_unique_compact(sorted_keys: torch.Tensor, part_of: torch.Tensor | None = None):
    """The sampler's form of the frontier dedup: row-sorted keys ``(P, M)``
    (int32 or int64, each an index of ``part_of``) and ``part_of`` (or
    None) → ``(uniq, rem, unique_count (P,) int32, remote_count (P,)
    int32)``: :func:`frontier_unique_batch` with ``is_remote[p, i] =
    part_of[key[p, i]] != p`` (nothing remote without ``part_of``), then
    the two mask selections in flat row order, ``uniq =
    keys.ravel()[first.ravel()]`` and ``rem = keys.ravel()[remote.ravel()]``
    (None without ``part_of``), in the keys' dtype. The spec of the
    compact entries of ``csrc/frontier_unique.cu``, whose buffers hold
    these ids in their first ``count.sum()`` entries."""
    P, M = sorted_keys.shape
    if part_of is None:
        is_remote = torch.zeros((P, M), dtype=torch.bool, device=sorted_keys.device)
    else:
        rows = torch.arange(P, device=sorted_keys.device)[:, None]
        is_remote = part_of[sorted_keys.long()] != rows
    first, remote, ucount, rcount = frontier_unique_batch(sorted_keys, is_remote)
    flat = sorted_keys.reshape(-1)
    uniq = flat[first.reshape(-1)]
    rem = None if part_of is None else flat[remote.reshape(-1)]
    return uniq, rem, ucount, rcount


def score_policy_update_batch(
    scores: torch.Tensor,
    accessed: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    increment: float = float(scoring.ACCESS_INCREMENT),
    decay: float = float(scoring.DECAY_FACTOR),
    threshold: float = float(scoring.STALE_THRESHOLD),
    mode: str = "accumulate",
    score_cap: float = 4.0,
):
    """Policy-zoo scoring round: scores ``(P, N)`` float32, accessed
    ``(P, N)`` bool [, weights ``(P, N)`` float32] → ``(new (P, N)
    float32, stale_count (P,) int32)``, ``stale = new < threshold``. The
    spec of ``csrc/score_update.cu``; every constant is rounded to
    float32 first, as in the reference's jnp oracle."""
    s = scores.to(torch.float32)
    gain = _f32(increment, s)
    if weights is not None:
        gain = gain * weights.to(torch.float32)
    if mode == "accumulate":
        touched = s + gain
    elif mode == "reset":
        touched = gain + torch.zeros_like(s)
    elif mode == "capped":
        touched = torch.minimum(s + gain, _f32(score_cap, s))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    new = torch.where(accessed, touched, s * _f32(decay, s))
    stale = (new < _f32(threshold, new)).sum(dim=1, dtype=torch.int32)
    return new, stale


def score_update_batch(scores: torch.Tensor, accessed: torch.Tensor):
    """The paper's scoring round per PE: ``(P, N)`` in → ``((P, N),
    (P,))`` out (+1 on access, x0.95 idle, stale below 0.95)."""
    return score_policy_update_batch(scores, accessed)


def score_update(scores: torch.Tensor, accessed: torch.Tensor):
    """The paper's scoring round on one buffer: ``(N,)`` in → ``(new
    (N,), stale_count)``, the count a 0-dim int32 tensor."""
    new, stale = score_update_batch(scores[None], accessed[None])
    return new[0], stale[0]


def gather_mean(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table (N, F)`` float32 or bfloat16, ``indices (B, K)`` → ``(B,
    F)`` in the table's dtype: each destination's K gathered rows
    averaged, the GraphSAGE neighbour mean. The spec of
    ``csrc/gather_mean.cu``, in the reference Pallas body's order: the
    rows added one by one into a float32 accumulator (``acc = r0; acc =
    acc + rj``), then multiplied by the float32 value of ``1 / K`` and
    rounded to the table's dtype."""
    B, K = indices.shape
    if K == 0:
        raise ValueError("gather_mean needs K >= 1 neighbours per row")
    idx = indices.long()
    acc = table[idx[:, 0]].to(torch.float32)
    for j in range(1, K):
        acc = acc + table[idx[:, j]].to(torch.float32)
    return (acc * _f32(1.0 / K, acc)).to(table.dtype)


def segment_sum_equal(
    data: torch.Tensor, k: int, scale: float | None = None
) -> torch.Tensor:
    """``data (S*k, F)`` float32 or bfloat16, ``k`` rows per segment →
    ``(S, F)`` in the data's dtype: every k consecutive rows summed, in
    row order, into a float32 accumulator, rounded to the data's dtype.
    The spec of ``csrc/segment_sum.cu``.

    With ``scale`` (the fanout mean's ``1 / k``): that rounded sum times
    the float32 value of ``scale``, the product taken in float32 and
    rounded to the data's dtype. In float32 that is one rounding after the
    float32 sum; in bfloat16 it is ``bf16(fl32(float(bf16(sum)) *
    fl32(scale)))``, on every device (the scale is never rounded to
    bfloat16 first)."""
    E, F = data.shape
    if k < 1 or E % k:
        raise ValueError(f"segment_sum_equal needs k >= 1 dividing {E} rows, got {k}")
    seg = data.reshape(E // k, k, F)
    acc = seg[:, 0].to(torch.float32)
    for j in range(1, k):
        acc = acc + seg[:, j].to(torch.float32)
    sums = acc.to(data.dtype)
    if scale is None:
        return sums
    return (sums.to(torch.float32) * _f32(scale, sums)).to(data.dtype)


#: The mask value of the reference's attention (XLA's ``-inf`` stand-in).
MLA_NEG_INF = -2.3819763e38


def mla_latent_attention(q_lat, q_rope, cache_c, cache_kr, pos, scale):
    """``q_lat (B, H, r)``, ``q_rope (B, H, rr)``, ``cache_c (B, S, r)``,
    ``cache_kr (B, S, rr)`` and ``pos`` (an int or a 0-dim tensor) → the
    latent context ``(B, H, r)`` in the cache's dtype. Scores
    ``(q_lat·c + q_rope·kr)·scale`` in float32, rows ``s > pos`` masked
    with :data:`MLA_NEG_INF`, softmax, and the float32 context
    ``probs @ c``. The spec of ``csrc/mla_decode.cu``."""
    f32 = torch.float32
    c = cache_c.to(f32)
    scores = (
        torch.einsum("bhr,bsr->bhs", q_lat.to(f32), c)
        + torch.einsum("bhk,bsk->bhs", q_rope.to(f32), cache_kr.to(f32))
    ) * scale
    valid = torch.arange(cache_c.shape[1], device=cache_c.device) <= pos
    scores = torch.where(
        valid[None, None, :], scores, torch.tensor(MLA_NEG_INF, dtype=f32, device=c.device)
    )
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, c).to(cache_c.dtype)
