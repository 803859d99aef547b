"""Seeded input scenarios for the frontier-step kernel.

One set serves both checks of the kernel: the CPU tests run each
scenario through the port's plain version and the reference's oracle
and Pallas kernel, and ``chip_smoke.py`` runs each through the CUDA
kernel and the plain version on the card. Inputs are numpy arrays made
from a seed; the constants are those of the scoring policy.

The set covers every scoring policy, weighted and unweighted, scores
sitting on the stale threshold, capacity-masked slots, empty and
all-duplicate frontier rows, the drained ``Mt == 1`` launch and the
initial all -1 ``(P, 1)`` candidate block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import scoring

POLICIES = ("rudder", "degree", "recency", "frequency", "hybrid")


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

    def arrays(self) -> dict:
        return {
            k: getattr(self, k)
            for k in (
                "ids", "scores", "valid", "accessed", "in_capacity", "weights",
                "touched_aug", "part_of", "cand", "node_weights",
            )
        }


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
    return out
