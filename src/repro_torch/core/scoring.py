"""Rudder's scoring policies (paper §2.1, Fig. 4) — the *what* to replace.

The paper's default policy is frequency tracking, more aggressive than
LFU:

* when a buffered item is **accessed** during the current
  minibatch-sampling round its score is incremented by ``+1``;
* items **not accessed** during the round are penalised by ``×0.95``;
* items whose score falls **below 0.95** are "stale" and are candidates
  for replacement with recently sampled remote nodes;
* if there are no stale items, replacement is skipped.

Every policy here is a pure function over ``(scores, accessed_mask[,
weights])`` so it has a numpy implementation (host control plane — this
is how it runs inside the prefetcher thread in the paper) and a
JAX/Pallas twin used by the ``kernels/score_update`` hot path for very
large buffers (``repro_torch.kernels.ops.score_policy_update_batch``).

Beyond the paper's policy, a small **policy zoo** parameterizes the same
update kernel (one elementwise pass, three modes) so eviction behaviour
becomes a sweep axis next to the controller variant:

| name        | mode       | on access        | idle   | character        |
| ----------- | ---------- | ---------------- | ------ | ---------------- |
| ``rudder``    | accumulate | ``s + 1``          | ``×0.95`` | paper default    |
| ``degree``    | accumulate | ``s + w(deg)``     | ``×0.95`` | hub nodes sticky |
| ``recency``   | reset      | ``s = 2``          | ``×0.85`` | LRU-style decay  |
| ``frequency`` | accumulate | ``s + 1``          | ``×0.99`` | LFU-leaning      |
| ``hybrid``    | capped     | ``min(s + 1, 4)``  | ``×0.90`` | bounded LFU+LRU  |

All policies share the 0.95 staleness threshold so the controller-facing
contract ("are there victims?") is unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Constants from the paper (§2.1).
ACCESS_INCREMENT = 1.0
DECAY_FACTOR = 0.95
STALE_THRESHOLD = 0.95
# Score given to a freshly inserted node (first access counts as one hit).
INITIAL_SCORE = 1.0


def update_scores(scores: np.ndarray, accessed: np.ndarray) -> np.ndarray:
    """One scoring round: ``+1`` where accessed, ``×0.95`` elsewhere."""
    scores = np.asarray(scores, dtype=np.float32)
    accessed = np.asarray(accessed, dtype=bool)
    return np.where(accessed, scores + ACCESS_INCREMENT, scores * DECAY_FACTOR)


def stale_mask(scores: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """Boolean mask of stale items (score < 0.95)."""
    mask = np.asarray(scores, dtype=np.float32) < STALE_THRESHOLD
    if valid is not None:
        mask = mask & np.asarray(valid, dtype=bool)
    return mask


# --------------------------------------------------------------------- #
# Policy zoo
# --------------------------------------------------------------------- #
#: Update-rule shapes the one elementwise kernel supports.
MODES = ("accumulate", "reset", "capped")


@dataclass(frozen=True)
class ScoringPolicy:
    """One eviction-scoring policy: a parameterization of the update kernel.

    ``mode`` selects what an access does to a slot's score:

    * ``accumulate`` — ``s + increment * w`` (the paper's rule);
    * ``reset``      — ``increment * w`` (recency: age restarts on touch);
    * ``capped``     — ``min(s + increment * w, score_cap)`` (bounded
      frequency, so a once-hot node can still age out).

    Idle slots always decay by ``×decay``; slots below ``stale_threshold``
    are replacement victims. ``w`` is an optional per-slot weight (the
    degree policy sets it from the node's degree; every other policy uses
    1.0). Freshly inserted slots start at ``initial_score``.
    """

    name: str
    mode: str = "accumulate"
    access_increment: float = ACCESS_INCREMENT
    decay: float = DECAY_FACTOR
    stale_threshold: float = STALE_THRESHOLD
    initial_score: float = INITIAL_SCORE
    score_cap: float = 4.0
    use_weights: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def update(
        self,
        scores: np.ndarray,
        accessed: np.ndarray,
        weights: np.ndarray | None = None,
    ) -> np.ndarray:
        """One scoring round (numpy host path). Pure; float32 throughout."""
        scores = np.asarray(scores, dtype=np.float32)
        accessed = np.asarray(accessed, dtype=bool)
        if weights is None:
            gain = np.float32(self.access_increment)
        else:
            gain = np.float32(self.access_increment) * np.asarray(
                weights, dtype=np.float32
            )
        if self.mode == "accumulate":
            touched = scores + gain
        elif self.mode == "reset":
            touched = np.broadcast_to(np.asarray(gain, dtype=np.float32), scores.shape)
        else:  # capped
            touched = np.minimum(scores + gain, np.float32(self.score_cap))
        return np.where(accessed, touched, scores * np.float32(self.decay))

    def stale(self, scores: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
        """Boolean mask of replacement victims under this policy."""
        mask = np.asarray(scores, dtype=np.float32) < np.float32(self.stale_threshold)
        if valid is not None:
            mask = mask & np.asarray(valid, dtype=bool)
        return mask

    def kernel_constants(self) -> dict:
        """The policy as compile-time kernel parameters.

        Single source for every place this policy is lowered into a jit'd
        or Pallas pass — the scoring-round kernel
        (:func:`repro_torch.kernels.ops.score_policy_update_batch`) and the
        fused device hot path
        (:func:`repro_torch.kernels.ops.fused_step_batch`). The keys match
        those kernels' static keyword arguments, so a policy change can
        never drift between the numpy host path and the device path
        (``docs/KERNELS.md``).
        """
        return dict(
            increment=float(self.access_increment),
            decay=float(self.decay),
            threshold=float(self.stale_threshold),
            score_cap=float(self.score_cap),
            mode=self.mode,
            initial_score=float(self.initial_score),
        )


def degree_weights(degrees: np.ndarray) -> np.ndarray:
    """Per-node access weight for the ``degree`` policy.

    Log-compressed so hubs are sticky without becoming unevictable:
    degree 0 → 1.0, degree 1000 → ≈2.7. Float32 to match the score
    arithmetic on both the numpy and the Pallas path.
    """
    return (1.0 + np.log1p(np.asarray(degrees, dtype=np.float64)) / 4.0).astype(
        np.float32
    )


#: The paper's policy — the default everywhere; bit-identical to the
#: original module-level ``update_scores`` / ``stale_mask`` pair.
DEFAULT_POLICY = ScoringPolicy(name="rudder")

POLICIES: dict[str, ScoringPolicy] = {
    "rudder": DEFAULT_POLICY,
    "degree": ScoringPolicy(name="degree", use_weights=True),
    "recency": ScoringPolicy(
        name="recency",
        mode="reset",
        access_increment=2.0,
        decay=0.85,
        initial_score=2.0,
    ),
    "frequency": ScoringPolicy(name="frequency", decay=0.99),
    "hybrid": ScoringPolicy(name="hybrid", mode="capped", decay=0.90, score_cap=4.0),
}


def make_policy(policy: str | ScoringPolicy) -> ScoringPolicy:
    """Resolve a policy by name (the sweep axis) or pass one through."""
    if isinstance(policy, ScoringPolicy):
        return policy
    if policy not in POLICIES:
        raise KeyError(f"unknown policy {policy!r}; options: {sorted(POLICIES)}")
    return POLICIES[policy]


def rounds_until_stale(score: float) -> int:
    """How many unaccessed rounds until an item with ``score`` goes stale.

    Useful for napkin math: a node accessed once (score 1.0) survives
    exactly one idle round (1.0 * 0.95 = 0.95, not < 0.95 ... boundary),
    then goes stale on the second. LFU would keep it indefinitely.
    """
    score = float(score)
    n = 0
    while score >= STALE_THRESHOLD:
        score *= DECAY_FACTOR
        n += 1
        if n > 10_000:  # pragma: no cover - defensive
            break
    return n
