"""Reference-free functional-correctness evaluation (paper §4.6).

A copy of the reference's ``core/evaluate.py`` (numpy only).

Pass@1 on %-Hits: after the agent takes action a_t predicting the next
state (direction of %-Hits), compare the realised state s_{t+1} against
the prediction ŝ_{t+1}. Alignment = pass, deviation = fail. The 95%
confidence interval is the chi-square (Wilson score) inversion the paper
reports in Tables 4/5.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .agent import LLMAgent
from .metrics import HistoryEntry

Z95 = 1.959963984540054  # sqrt(chi2_{1,0.95})


@dataclass
class Pass1Result:
    pass_rate: float            # percent
    ci_lo: float                # percent-points below pass_rate
    ci_hi: float                # percent-points above pass_rate
    n: int

    def __str__(self) -> str:
        return f"{self.pass_rate:.0f} (-{self.ci_lo:.0f}/{self.ci_hi:.0f})"


def wilson_interval(successes: int, n: int, z: float = Z95) -> tuple[float, float]:
    """Wilson score interval — the chi-square (1 dof) CI for a proportion."""
    if n == 0:
        return 0.0, 0.0
    p = successes / n
    denom = 1 + z**2 / n
    center = (p + z**2 / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z**2 / (4 * n**2)) / denom
    return max(center - half, 0.0), min(center + half, 1.0)


def pass_at_1(history: list[HistoryEntry], tol: float = 2.5) -> Pass1Result:
    """Fraction of *evaluated* decisions whose predicted %-Hits direction
    matched the realised one.

    ``tol`` (in %-points) separates "flat" from "up"/"down". Our scaled
    graphs have ~100x fewer sampled remote nodes per minibatch than the
    paper's runs, so per-observation %-Hits noise is ~10x larger; the
    default 2.5 corresponds to the paper's sub-point noise floor at
    batch 2000. Sensitivity to tol is reported in EXPERIMENTS.md."""
    evaluated = [h for h in history if h.evaluated]
    if not evaluated:
        return Pass1Result(0.0, 0.0, 0.0, 0)
    passes = sum(
        1
        for h in evaluated
        if h.observed_direction(tol) == h.predicted_hits_direction
    )
    n = len(evaluated)
    p = passes / n
    lo, hi = wilson_interval(passes, n)
    return Pass1Result(
        pass_rate=100.0 * p,
        ci_lo=100.0 * (p - lo),
        ci_hi=100.0 * (hi - p),
        n=n,
    )


def classifier_accuracy(
    decisions: list[bool], labels: list[bool]
) -> Pass1Result:
    """For classifiers the paper reports supervised accuracy instead."""
    if not decisions:
        return Pass1Result(0.0, 0.0, 0.0, 0)
    n = min(len(decisions), len(labels))
    correct = sum(1 for d, l in zip(decisions[:n], labels[:n]) if d == l)
    p = correct / n
    lo, hi = wilson_interval(correct, n)
    return Pass1Result(100 * p, 100 * (p - lo), 100 * (hi - p), n)


def agent_report(agent: LLMAgent) -> dict:
    """Table-2-style row: Pass@1, r, valid/invalid, +ve/-ve decisions."""
    p1 = pass_at_1(agent.context.history)
    valid, invalid = agent.response_validity()
    pos, neg = agent.decision_split()
    return {
        "model": agent.name,
        "pass@1": p1.pass_rate,
        "pass@1_ci": (p1.ci_lo, p1.ci_hi),
        "valid_pct": valid,
        "invalid_pct": invalid,
        "positive_pct": pos,
        "negative_pct": neg,
        "n_decisions": p1.n,
    }
