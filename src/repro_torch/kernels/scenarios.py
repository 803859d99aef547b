"""Seeded input scenarios for the port's kernels.

One set per kernel serves both checks of it: the CPU tests run each
scenario through the port's plain version and the reference's oracle
and Pallas kernel, and ``chip_smoke.py`` runs each through the CUDA
kernel and the plain version on the card. Inputs are numpy arrays made
from a seed; the constants are those of the scoring policy.

* :func:`frontier_scenarios` (``fused_frontier_step``): every scoring
  policy, weighted and unweighted, scores sitting on the stale
  threshold, capacity-masked slots, empty and all-duplicate frontier
  rows, the drained ``Mt == 1`` launch, the initial all -1 ``(P, 1)``
  candidate block, padding at -2 and -7 mixed with -1, and a hub row
  (one id 4500 times in a row of 5000).
* :func:`fused_step_scenarios` (``fused_step``): every policy, weighted
  and unweighted, empty query and candidate rows, all-duplicate
  candidates, candidates already resident, every gate off,
  capacity-masked slots and scores on the threshold.
* :func:`gather_scenarios` (``gather_rows_batch`` / ``gather_rows``):
  ``F`` in {1, 3, 100, 128, 602}, ``M == 0`` and repeated indices.
* :func:`wide_frontier_scenarios` (``fused_frontier_step_wide``) and
  :func:`wide_fused_step_scenarios` (``fused_step_wide``): int64 ids.
  Every narrow scenario shifted by :data:`BASE` (``2**31 + 1000``, the
  smallest interesting wide base); a base past ``2**32`` whose ids cross
  a ``2**30`` word boundary of the reference's ``(hi, lo)`` split; ids
  ending at ``WIDE_ID_MAX``; a frontier set whose packed row
  (``3 Mt + K + C + 1`` words) is odd and larger than the others; and,
  for the fused step, a sparse set whose
  ids spread over ``[BASE, BASE + 2**40]``, far past any direct map (the
  kernel's sorted mode). Each wide scenario keeps its narrow source, so
  the tests can hold wide against narrow under the id map.
* :func:`frontier_unique_scenarios` (``frontier_unique_batch`` and its
  int64 twin): ``M == 0``, all-duplicate and all-unique rows, remote
  shares of 0, 0.5 and 1, ragged lengths, int64 keys up to
  ``WIDE_ID_MAX``.
* :func:`score_scenarios` (``score_policy_update_batch``,
  ``score_update_batch``, ``score_update``): every policy, weighted and
  unweighted, scores on the stale threshold after the round, ``N`` off
  the kernel's block.
* :func:`gather_mean_scenarios` (``gather_mean``) and
  :func:`segment_sum_scenarios` (``segment_sum_equal``): float32 and
  bfloat16 data, ``K`` in {1, 3, 10, 25} and at the loops' unroll
  factors :data:`UNROLL_EDGES` and one either side, ``F`` in {1, 3, 64,
  100, 128, 600}, int32 and int64 indices, repeated indices and an index
  on the table's last row, ``B == 0`` and ``S == 0``, partial last blocks,
  a gather past one pass of its grid, every lane-group width of the
  gather, the 16-byte and the one-element paths of both dtypes, and views
  whose base pointer is off the 16-byte grid.
* :func:`mla_inputs` (``mla_flash_decode``): queries and caches of any
  shape, N(0, 0.3²) as the reference's test draws them (scores spread by
  about 0.1: a near-uniform softmax), or with the queries scaled so that
  the scores spread by :data:`PEAKED` (a softmax that a wrong score term
  or a dropped row visibly moves).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import scoring
from .ops import WIDE_ID_MAX

POLICIES = ("rudder", "degree", "recency", "frequency", "hybrid")

#: The wide sets' base: just past int32 (the reference's own test base).
BASE = 2**31 + 1000


def lift(a: np.ndarray, ids_of: np.ndarray) -> np.ndarray:
    """``a`` as int64 with every non-negative entry ``v`` replaced by
    ``ids_of[v]`` (padding and masked entries stay as they are)."""
    a = np.asarray(a)
    out = a.astype(np.int64)
    live = a >= 0
    out[live] = ids_of[a[live]]
    return out


@dataclass
class Scenario:
    name: str
    ids: np.ndarray           # (P, C) int32, -1 empty; resident ids unique
    scores: np.ndarray        # (P, C) float32
    valid: np.ndarray         # (P, C) bool
    accessed: np.ndarray      # (P, C) bool
    in_capacity: np.ndarray   # (P, C) bool
    weights: np.ndarray | None      # (P, C) float32
    touched_aug: np.ndarray   # (P, Mt + 1) int32, gates in the last column
    part_of: np.ndarray       # (N,) int32
    cand: np.ndarray          # (P, K) int32, -1 padded, duplicates allowed
    node_weights: np.ndarray | None  # (N,) float32
    cand_cap: int
    constants: dict
    #: Wide sets: the global id of local node 0 (ids int64 in
    #: ``[id_base, id_base + N)``), and the narrow scenario lifted.
    id_base: int = 0
    narrow: "Scenario | None" = None

    def arrays(self) -> dict:
        return {
            k: getattr(self, k)
            for k in (
                "ids", "scores", "valid", "accessed", "in_capacity", "weights",
                "touched_aug", "part_of", "cand", "node_weights",
            )
        }

    def kwargs(self) -> dict:
        """The keyword arguments of the step: ``cand_cap``, the policy's
        constants and, on a wide set, ``id_base``."""
        kw = dict(cand_cap=self.cand_cap, **self.constants)
        if self.narrow is not None:
            kw["id_base"] = self.id_base
        return kw


def make_scenario(
    name: str,
    seed: int,
    policy: str = "rudder",
    weighted: bool = False,
    P: int = 3,
    C: int = 16,
    K: int = 24,
    Mt: int = 40,
    N: int = 64,
    empty_row: bool = False,
    dup_row: bool = False,
    drained: bool = False,
    initial_cand: bool = False,
    pads: tuple = (),
    hub: int = 0,
) -> Scenario:
    rng = np.random.default_rng(seed)
    pol = scoring.make_policy(policy)
    caps = rng.integers(C // 2, C + 1, size=P)
    in_cap = np.arange(C)[None, :] < caps[:, None]
    valid = in_cap & (rng.random((P, C)) < 0.7)
    ids = np.full((P, C), -1, dtype=np.int32)
    for p in range(P):
        n = int(valid[p].sum())
        ids[p, valid[p]] = rng.choice(N, size=n, replace=False)
    # Scores: a mix of random values and values on or next to the stale
    # threshold after one decay (1.0 * 0.95 == 0.95 exactly in float32).
    special = np.array(
        [pol.stale_threshold, 1.0, pol.stale_threshold / pol.decay,
         np.nextafter(np.float32(1.0), np.float32(0.0)), pol.initial_score],
        dtype=np.float32,
    )
    scores = np.where(
        rng.random((P, C)) < 0.5,
        special[rng.integers(0, len(special), (P, C))],
        (rng.random((P, C)) * 3.0).astype(np.float32),
    ).astype(np.float32)
    accessed = valid & (rng.random((P, C)) < 0.4)
    node_weights = (1.0 + 2.0 * rng.random(N)).astype(np.float32) if weighted else None
    weights = None
    if weighted:
        weights = np.where(
            valid, node_weights[np.maximum(ids, 0)], np.float32(1.0)
        ).astype(np.float32)
    part_of = rng.integers(0, P, size=N).astype(np.int32)
    if drained:
        touched = np.full((P, 1), -1, dtype=np.int32)
    else:
        touched = rng.integers(-1, N, size=(P, Mt)).astype(np.int32)
        if empty_row:
            touched[0] = -1
        if dup_row:
            touched[-1] = touched[-1, 0] if touched[-1, 0] >= 0 else 7
        if pads:  # padding other than -1, mixed with it
            pad = touched == -1
            touched[pad] = rng.choice(np.array((-1, *pads), np.int32), size=int(pad.sum()))
        if hub:  # one id, remote to row 1, `hub` times in that row
            hub_id = int(np.flatnonzero(part_of != 1)[0])
            touched[1, rng.permutation(Mt)[:hub]] = hub_id
    gates = rng.integers(0, 8, size=P).astype(np.int32)
    gates[0] = 7  # at least one PE with every phase on
    touched_aug = np.concatenate([touched, gates[:, None]], axis=1)
    if initial_cand:
        cand = np.full((P, 1), -1, dtype=np.int32)
    else:
        cand = rng.integers(-1, N, size=(P, K)).astype(np.int32)
    return Scenario(
        name=name,
        ids=ids,
        scores=scores,
        valid=valid,
        accessed=accessed,
        in_capacity=in_cap,
        weights=weights,
        touched_aug=touched_aug.astype(np.int32),
        part_of=part_of,
        cand=cand,
        node_weights=node_weights,
        cand_cap=2 * C,
        constants=pol.kernel_constants(),
    )


def frontier_scenarios() -> list[Scenario]:
    """The seeded scenario set (small shapes; see the module note)."""
    out = []
    seed = 0
    for policy in POLICIES:
        for weighted in (False, True):
            out.append(
                make_scenario(
                    f"{policy}-{'w' if weighted else 'u'}",
                    seed, policy=policy, weighted=weighted,
                )
            )
            seed += 1
    out.append(make_scenario("empty-and-dup-rows", 100, empty_row=True, dup_row=True))
    out.append(make_scenario("drained-Mt1", 101, policy="degree", weighted=True, drained=True))
    out.append(make_scenario("initial-cand", 102, initial_cand=True))
    out.append(make_scenario("drained-initial", 103, drained=True, initial_cand=True))
    out.append(make_scenario("one-pe", 104, policy="hybrid", P=1, C=5, K=7, Mt=9, N=20))
    out.append(make_scenario("neg-padding", 105, pads=(-2, -7)))
    out.append(make_scenario("hub-row", 106, policy="degree", weighted=True, C=40,
                             K=60, Mt=5000, N=3000, hub=4500))
    return out


# --------------------------------------------------------------------------- #
@dataclass
class FusedStepScenario:
    name: str
    ids: np.ndarray           # (P, C) int32, -1 empty; resident ids unique
    scores: np.ndarray        # (P, C) float32
    valid: np.ndarray         # (P, C) bool
    accessed: np.ndarray      # (P, C) bool
    in_capacity: np.ndarray   # (P, C) bool
    weights: np.ndarray | None       # (P, C) float32
    queries: np.ndarray       # (P, M) int32, unique per row, -1 padded
    cand: np.ndarray          # (P, K) int32, -1 padded, duplicates allowed
    cand_weights: np.ndarray | None  # (P, K) float32
    active_score: np.ndarray  # (P,) bool
    do_replace: np.ndarray    # (P,) bool
    active_probe: np.ndarray  # (P,) bool
    num_ids: int | None       # span of the ids from id_lo (None: unknown)
    constants: dict
    #: Wide sets: the smallest id (None: unknown), the narrow scenario
    #: lifted, and the map from its local ids to these.
    id_lo: int | None = 0
    narrow: "FusedStepScenario | None" = None
    ids_of: np.ndarray | None = None

    def arrays(self) -> dict:
        return {
            k: getattr(self, k)
            for k in (
                "ids", "scores", "valid", "accessed", "in_capacity", "weights",
                "queries", "cand", "cand_weights", "active_score", "do_replace",
                "active_probe",
            )
        }


def make_fused_step_scenario(
    name: str,
    seed: int,
    policy: str = "rudder",
    weighted: bool = False,
    P: int = 3,
    C: int = 16,
    M: int = 20,
    K: int = 24,
    N: int = 64,
    empty_rows: bool = False,
    dup_cand: bool = False,
    resident_cand: bool = False,
    gates_off: bool = False,
) -> FusedStepScenario:
    base = make_scenario(name, seed, policy=policy, weighted=weighted, P=P, C=C,
                         K=K, N=N)
    rng = np.random.default_rng(seed + 1000)
    queries = np.full((P, M), -1, dtype=np.int32)
    for p in range(P):
        n = int(rng.integers(0, M + 1))
        queries[p, :n] = np.sort(rng.choice(N, size=n, replace=False))
    cand = base.cand.copy()
    if empty_rows:
        queries[0] = -1
        cand[0] = -1
    if dup_cand:
        cand[-1] = cand[-1, 0] if cand[-1, 0] >= 0 else 5
    if resident_cand:
        for p in range(P):
            live = base.ids[p][base.valid[p]]
            cand[p, : min(len(live), K)] = live[:K]
    gates = base.touched_aug[:, -1]
    if gates_off:
        gates = np.zeros(P, dtype=np.int32)
    cand_weights = None
    if weighted:
        cand_weights = np.where(
            cand >= 0, base.node_weights[np.maximum(cand, 0)], np.float32(1.0)
        ).astype(np.float32)
    return FusedStepScenario(
        name=name,
        ids=base.ids,
        scores=base.scores,
        valid=base.valid,
        accessed=base.accessed,
        in_capacity=base.in_capacity,
        weights=base.weights,
        queries=queries,
        cand=cand.astype(np.int32),
        cand_weights=cand_weights,
        active_score=(gates & 1) != 0,
        do_replace=(gates & 2) != 0,
        active_probe=(gates & 4) != 0,
        num_ids=N,
        constants=base.constants,
    )


def fused_step_scenarios() -> list[FusedStepScenario]:
    """The seeded ``fused_step`` set (small shapes; see the module note)."""
    out = []
    seed = 200
    for policy in POLICIES:
        for weighted in (False, True):
            out.append(
                make_fused_step_scenario(
                    f"{policy}-{'w' if weighted else 'u'}",
                    seed, policy=policy, weighted=weighted,
                )
            )
            seed += 1
    out.append(make_fused_step_scenario("empty-rows", 300, empty_rows=True))
    out.append(make_fused_step_scenario("dup-cand", 301, policy="degree",
                                        weighted=True, dup_cand=True))
    out.append(make_fused_step_scenario("resident-cand", 302, resident_cand=True))
    out.append(make_fused_step_scenario("gates-off", 303, policy="hybrid",
                                        weighted=True, gates_off=True))
    out.append(make_fused_step_scenario("one-wide", 304, P=2, C=1, M=1, K=1, N=8))
    return out


# --------------------------------------------------------------------------- #
@dataclass
class GatherScenario:
    name: str
    tables: np.ndarray  # (P, N, F) float32
    idx: np.ndarray     # (P, M) int32 in [0, N)


def gather_scenarios() -> list[GatherScenario]:
    """The seeded gather set: ``F`` in {1, 3, 100, 128, 602} (odd widths
    take the kernel's 4-byte path, ``F % 4 == 0`` its 16-byte one),
    ``M == 0``, and repeated indices."""
    out = []
    for i, (F, M, repeat) in enumerate(
        [(1, 37, False), (3, 50, True), (100, 64, False), (128, 33, True),
         (602, 17, False), (128, 0, False)]
    ):
        rng = np.random.default_rng(400 + i)
        P, N = 3, 90
        tables = rng.standard_normal((P, N, F)).astype(np.float32)
        idx = rng.integers(0, N, size=(P, M)).astype(np.int32)
        if repeat and M:
            idx[:, M // 2 :] = idx[:, :1]
        out.append(GatherScenario(f"F{F}-M{M}{'-rep' if repeat else ''}", tables, idx))
    return out


# --------------------------------------------------------------------------- #
def widen(sc: Scenario, id_base: int) -> Scenario:
    """The frontier scenario ``sc`` on int64 global ids ``id_base + v``."""
    N = sc.part_of.shape[0]
    ids_of = np.int64(id_base) + np.arange(N, dtype=np.int64)
    aug = sc.touched_aug.astype(np.int64)
    aug[:, :-1] = lift(sc.touched_aug[:, :-1], ids_of)
    return replace(
        sc,
        name=f"{sc.name}@{id_base}",
        ids=lift(sc.ids, ids_of),
        touched_aug=aug,
        cand=lift(sc.cand, ids_of),
        id_base=int(id_base),
        narrow=sc,
    )


def wide_frontier_scenarios() -> list[Scenario]:
    """The wide frontier set (see the module note)."""
    narrow = frontier_scenarios()
    out = [widen(sc, BASE) for sc in narrow]
    by = {sc.name: sc for sc in narrow}
    # Local ids 0..63 cross the 2**30 boundary 20 ids in.
    out.append(widen(by["rudder-u"], 2**32 + 2**30 - 20))
    out.append(widen(by["degree-w"], WIDE_ID_MAX - by["degree-w"].part_of.shape[0] + 1))
    out.append(widen(by["hybrid-w"], 2**40 + 3))
    # A packed row of 3 Mt + K + C + 1 = 1057 int32 words: an odd stride,
    # so every other row's int64 keys sit off an 8-byte boundary.
    out.append(widen(make_scenario("odd-stride", 107, P=2, C=20, K=37, Mt=333, N=500), BASE))
    return out


def widen_step(sc: FusedStepScenario, ids_of: np.ndarray, name: str, known: bool):
    """The fused-step scenario ``sc`` on int64 ids ``ids_of[v]``
    (ascending, so the id order is kept). ``known``: the scenario states
    the id range of the kernel's maps, as the engine does; else the
    kernel reads it off the tensors."""
    return replace(
        sc,
        name=name,
        ids=lift(sc.ids, ids_of),
        queries=lift(sc.queries, ids_of),
        cand=lift(sc.cand, ids_of),
        id_lo=int(ids_of[0]) if known else None,
        num_ids=int(ids_of[-1] - ids_of[0] + 1) if known else None,
        narrow=sc,
        ids_of=ids_of,
    )


def wide_fused_step_scenarios() -> list[FusedStepScenario]:
    """The wide fused-step set (see the module note)."""
    narrow = fused_step_scenarios()
    out = []
    for sc in narrow:
        ids_of = np.int64(BASE) + np.arange(sc.num_ids, dtype=np.int64)
        out.append(widen_step(sc, ids_of, f"{sc.name}@base", known=True))
    by = {sc.name: sc for sc in narrow}
    top = by["degree-w"]
    ids_of = np.int64(WIDE_ID_MAX - top.num_ids + 1) + np.arange(top.num_ids, dtype=np.int64)
    out.append(widen_step(top, ids_of, "degree-w@top", known=False))
    for name in ("rudder-u", "hybrid-w", "resident-cand", "dup-cand"):
        sc = by[name]
        rng = np.random.default_rng(500 + len(out))
        spread = np.unique(rng.integers(0, 2**40 + 1, size=4 * sc.num_ids))
        spread = np.sort(rng.choice(spread, size=sc.num_ids, replace=False))
        spread[0], spread[-1] = 0, 2**40  # the span is the whole 2**40
        out.append(widen_step(sc, np.int64(BASE) + spread, f"{name}@sparse", known=False))
    return out


# --------------------------------------------------------------------------- #
@dataclass
class FrontierUniqueScenario:
    name: str
    keys: np.ndarray       # (P, M) int32 or int64, each row ascending, >= 0
    is_remote: np.ndarray  # (P, M) bool
    #: The sampler's form's partition map (int32, indexed by the keys,
    #: values in [0, P]), or None where the keys are too large to index one.
    part_of: np.ndarray | None = None


def frontier_unique_scenarios() -> list[FrontierUniqueScenario]:
    """The seeded set of ``frontier_unique_batch``: ``M == 0``, rows all
    duplicates, rows all unique, random sorted rows with duplicates at a
    remote share of 0, 0.5 and 1, lengths that are not a multiple of the
    kernel's block (1, 257, 1000), and int64 keys within ``INT32_ID_MAX``
    (which the dispatcher narrows), past it, across a ``2**32`` word
    boundary of the reference's ``(hi, lo)`` split, and up to
    ``WIDE_ID_MAX`` (which take the int64 kernel). Added with the
    kernel's 16 positions a thread and 4,096 a block: rows shorter than
    16 (5, so a thread's positions cross several rows), of exactly 16 and
    of 17, and a block of 40 tiles whose rows end inside tiles (the
    sampler's form's look-back past one step of 32 tiles). Sets whose keys
    stay below 2^17 carry a seeded ``part_of`` for the sampler's form."""
    out = []
    rng = np.random.default_rng(600)

    def add(name, keys, p_remote=0.5):
        keys = np.sort(keys, axis=1)
        flags = rng.random(keys.shape) < p_remote
        part_of = None
        if keys.max(initial=0) < 2**17:
            part_of = rng.integers(
                0, keys.shape[0] + 1, size=int(keys.max(initial=0)) + 1
            ).astype(np.int32)
        out.append(FrontierUniqueScenario(name, keys, flags, part_of))

    add("M0", np.zeros((3, 0), dtype=np.int32))
    add("all-dup", np.full((3, 300), 7, dtype=np.int32))
    add("all-unique", np.stack(
        [rng.permutation(5000)[:700] for _ in range(3)]).astype(np.int32))
    for p_remote in (0.0, 0.5, 1.0):
        add(f"random-remote{p_remote}",
            rng.integers(0, 400, size=(4, 1000)).astype(np.int32), p_remote)
    add("M1", rng.integers(0, 9, size=(2, 1)).astype(np.int32))
    add("M257", rng.integers(0, 100, size=(3, 257)).astype(np.int32))
    add("one-pe", rng.integers(0, 60, size=(1, 513)).astype(np.int32))
    add("M5", rng.integers(0, 6, size=(9, 5)).astype(np.int32))
    add("M16", rng.integers(0, 20, size=(3, 16)).astype(np.int32))
    add("M17", rng.integers(0, 30, size=(5, 17)).astype(np.int32))
    add("tiles", rng.integers(0, 60_000, size=(4, 40_000)).astype(np.int32))
    add("int64-narrow", rng.integers(0, 2**31 - 1, size=(3, 400)).astype(np.int64))
    for name, base in (
        ("int64-base", BASE),
        ("int64-2^32", 2**32 + 2**30 - 150),
        ("int64-top", WIDE_ID_MAX - 299),
    ):
        add(name, np.int64(base) + rng.integers(0, 300, size=(3, 600)))
    return out


@dataclass
class ScoreScenario:
    name: str
    scores: np.ndarray           # (P, N) float32
    accessed: np.ndarray         # (P, N) bool
    weights: np.ndarray | None   # (P, N) float32
    constants: dict              # increment, decay, threshold, mode, score_cap


def make_score_scenario(
    name: str, seed: int, policy: str = "rudder", weighted: bool = False,
    P: int = 3, N: int = 1000,
) -> ScoreScenario:
    rng = np.random.default_rng(seed)
    pol = scoring.make_policy(policy)
    kc = pol.kernel_constants()
    kc.pop("initial_score")
    # Scores on or next to the values where a round decides staleness:
    # the threshold itself, 1.0 (decays to 0.95 exactly in float32: not
    # stale), threshold / decay, one ulp below 1.0, the initial score and
    # the cap.
    special = np.array(
        [pol.stale_threshold, 1.0, pol.stale_threshold / pol.decay,
         np.nextafter(np.float32(1.0), np.float32(0.0)), pol.initial_score,
         pol.score_cap, pol.score_cap - pol.access_increment, 0.0],
        dtype=np.float32,
    )
    scores = np.where(
        rng.random((P, N)) < 0.5,
        special[rng.integers(0, len(special), (P, N))],
        (rng.random((P, N)) * 5.0).astype(np.float32),
    ).astype(np.float32)
    accessed = rng.random((P, N)) < 0.4
    weights = (1.0 + 2.0 * rng.random((P, N))).astype(np.float32) if weighted else None
    return ScoreScenario(name, scores, accessed, weights, kc)


def score_scenarios() -> list[ScoreScenario]:
    """The seeded set of the scoring round: every policy of
    ``core.scoring.POLICIES`` (so every mode), weighted and unweighted,
    at ``N`` that is not a multiple of the kernel's block, plus one slot,
    one PE and a row longer than the kernel's grid-stride span."""
    out = []
    seed = 700
    for policy in POLICIES:
        for weighted in (False, True):
            out.append(make_score_scenario(
                f"{policy}-{'w' if weighted else 'u'}", seed, policy, weighted))
            seed += 1
    out.append(make_score_scenario("N1", seed, "hybrid", True, P=2, N=1))
    out.append(make_score_scenario("one-pe", seed + 1, "recency", False, P=1, N=257))
    out.append(make_score_scenario("long-row", seed + 2, "rudder", False, P=2, N=300_001))
    return out


# --------------------------------------------------------------------------- #
#: Unroll factors of the aggregation kernels' neighbour loops: the 4 that
#: nvcc gives a loop of runtime length, and the 8 of
#: ``scripts/aggregation_ab.py``'s batched variants. The sets hold ``K``
#: at each and one either side.
UNROLL_EDGES = (4, 8)
#: Thread slots of one pass of ``gather_mean.cu``'s grid (its ``kMaxBlocks
#: * kThreads``): a group of G lanes per destination covers ``GATHER_SPAN
#: / G`` destinations a pass.
GATHER_SPAN = 132 * 16 * 256


def typed(a: np.ndarray, dtype: str, device="cpu", offset: int = 0) -> torch.Tensor:
    """``a`` as a contiguous tensor of ``dtype`` ("float32" or "bfloat16")
    on ``device``; with ``offset``, a view that starts ``offset`` elements
    into a larger buffer, so that its base pointer is off the 16-byte grid
    (what a row or element slice of a larger tensor hands a kernel)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    if offset:
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
        buf[offset:] = t.reshape(-1)
        t = buf[offset:].view(t.shape)
    return t


@dataclass
class GatherMeanScenario:
    name: str
    table: np.ndarray  # (N, F) float32; cast to ``dtype`` at use
    idx: np.ndarray    # (B, K) int32 or int64 in [0, N)
    dtype: str         # "float32" or "bfloat16"
    offset: int = 0    # the table's elements into its buffer (see typed)

    def tensors(self, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
        """``(table, indices)`` on ``device``."""
        return (typed(self.table, self.dtype, device, self.offset),
                torch.from_numpy(self.idx).to(device))


def gather_mean_scenarios() -> list[GatherMeanScenario]:
    """The seeded set of ``gather_mean``: every ``K`` of {1, 3, 10, 25} and
    of :data:`UNROLL_EDGES` and one either side, ``F`` of {1, 3, 64, 100,
    128, 600} (float32 with ``F % 4 == 0`` and bfloat16 with ``F % 8 ==
    0`` take the kernel's 16-byte path, other widths and misaligned tables
    its one-element path), float32 and bfloat16 tables, int32 and int64
    indices, repeated indices, the table's last row in every set, and
    ``B == 0``. The kernel's edges: groups of 1, 4, 8, 16 and 32 lanes a
    destination (the row's 16-byte columns, or elements, rounded up to a
    power of two) and rows wider than 32 of them (``F = 600``); ``B`` not
    a multiple of a block's destinations (``B = 103`` at 8 a block), and
    past one pass of the grid (``B = 17,000`` at 32 lanes a destination:
    ``GATHER_SPAN / 32`` = 16,896 a pass); tables of 2,000 and 5,000
    rows; and tables whose base pointer is off the 16-byte grid (offsets
    1 and 3)."""
    out = []
    u4, u8 = UNROLL_EDGES
    for i, (F, K, B, N, idx64, bf16, repeat, offset) in enumerate([
        (1, 3, 37, 90, False, False, False, 0),
        (3, 10, 20, 90, True, False, True, 0),
        (64, 25, 16, 90, False, True, False, 0),
        (100, 10, 50, 90, True, False, False, 0),
        (128, 25, 9, 90, False, False, True, 0),
        (600, 1, 7, 90, True, True, False, 0),
        (128, 1, 5, 90, False, True, True, 0),
        (3, 25, 11, 90, True, True, False, 0),
        (600, 3, 4, 90, False, False, False, 0),
        (100, 25, 0, 90, False, False, False, 0),
        (100, 25, 103, 2000, False, False, False, 0),
        (64, u4 + 1, 300, 5000, True, True, False, 0),
        (64, u4, 41, 500, True, False, True, 0),
        (128, u4 - 1, 17000, 90, False, False, False, 0),
        (600, u8, 40, 90, True, False, False, 0),
        (100, u8 - 1, 60, 90, True, True, False, 0),
        (100, u8 + 1, 33, 90, False, False, False, 1),
        (64, 25, 20, 90, True, True, False, 3),
        (1, 3, 1500, 90, True, False, False, 0),
        (3, 25, 700, 90, False, True, False, 0),
    ]):
        rng = np.random.default_rng(800 + i)
        table = rng.standard_normal((N, F)).astype(np.float32)
        idx = rng.integers(0, N, size=(B, K)).astype(np.int64 if idx64 else np.int32)
        if B:
            idx[0, 0] = N - 1
            if repeat:
                idx[:, K // 2 :] = idx[:, :1]
        dtype = "bfloat16" if bf16 else "float32"
        name = (f"F{F}-K{K}-B{B}-N{N}-{'i64' if idx64 else 'i32'}-{dtype}"
                f"{'-rep' if repeat else ''}{f'-off{offset}' if offset else ''}")
        out.append(GatherMeanScenario(name, table, idx, dtype, offset))
    return out


@dataclass
class SegmentSumScenario:
    name: str
    data: np.ndarray  # (S * k, F) float32; cast to ``dtype`` at use
    k: int
    dtype: str        # "float32" or "bfloat16"
    offset: int = 0   # the data's elements into its buffer (see typed)

    def tensor(self, device="cpu") -> torch.Tensor:
        return typed(self.data, self.dtype, device, self.offset)


def segment_sum_scenarios() -> list[SegmentSumScenario]:
    """The seeded set of ``segment_sum_equal``: every ``k`` of {1, 3, 10,
    25} and of :data:`UNROLL_EDGES` and one either side, ``F`` of {1, 3,
    64, 100, 128, 600}, float32 and bfloat16 data (the kernel's 16-byte
    path at float32 ``F % 4 == 0`` and bfloat16 ``F % 8 == 0``, its
    one-element path otherwise), repeated rows, ``S == 0``, launches of
    many blocks whose last block is partial (``S * F / V`` threads, not a
    multiple of the kernel's 256), and data views whose base pointer is
    off the 16-byte grid (offsets 1 and 3)."""
    out = []
    u4, u8 = UNROLL_EDGES
    for i, (F, k, S, bf16, offset) in enumerate([
        (1, 3, 37, False, 0),
        (3, 10, 20, False, 0),
        (64, 25, 16, True, 0),
        (100, 10, 50, False, 0),
        (128, 25, 9, False, 0),
        (600, 1, 7, True, 0),
        (100, 1, 5, False, 0),
        (3, 3, 11, True, 0),
        (600, 25, 4, False, 0),
        (128, 25, 0, False, 0),
        (100, u4 - 1, 103, False, 0),
        (100, u4, 103, False, 0),
        (100, u4 + 1, 517, False, 0),
        (64, u8 + 1, 300, True, 0),
        (128, u8, 41, True, 0),
        (100, u8 - 1, 60, True, 0),
        (100, 10, 33, False, 1),
        (64, 25, 20, True, 3),
        (1, u8, 1500, False, 0),
    ]):
        rng = np.random.default_rng(900 + i)
        data = rng.standard_normal((S * k, F)).astype(np.float32)
        if S > 1:
            data[k : 2 * k] = data[:k]  # a repeated segment
        dtype = "bfloat16" if bf16 else "float32"
        name = f"F{F}-k{k}-S{S}-{dtype}{f'-off{offset}' if offset else ''}"
        out.append(SegmentSumScenario(name, data, k, dtype, offset))
    return out


#: Standard deviation of the "peaked" MLA scores ``(q_lat·c + q_rope·kr)·
#: scale``, half of its variance from each term.
PEAKED = 3.0


def mla_query_gains(r: int, rr: int, scale: float, spread: float) -> tuple[float, float]:
    """Factors for ``q_lat`` and ``q_rope`` drawn like the caches,
    N(0, 0.3²), that make each term of the scores spread by
    ``spread / sqrt(2)`` at ``scale``."""
    part = spread / 2**0.5
    return tuple(part / (scale * 0.09 * max(n, 1) ** 0.5) for n in (r, rr))


def mla_inputs(b, h, r, rr, s, seed=0, spread=None, scale=None) -> list[np.ndarray]:
    """``[q_lat (b, h, r), q_rope (b, h, rr), cache_c (b, s, r), cache_kr
    (b, s, rr)]`` float32 from ``seed``: N(0, 0.3²), the queries scaled by
    :func:`mla_query_gains` when ``spread`` is given (``scale`` defaults to
    ``1 / sqrt(r + rr)``)."""
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal(sh) * 0.3).astype(np.float32)
           for sh in ((b, h, r), (b, h, rr), (b, s, r), (b, s, rr))]
    if spread is not None:
        g_lat, g_rope = mla_query_gains(r, rr, scale or 1.0 / (r + rr) ** 0.5, spread)
        out[0] *= np.float32(g_lat)
        out[1] *= np.float32(g_rope)
    return out
