"""Rules of the ``gemma3-4b`` decider, worked out again from the rules the
program states (``core/backends.py``'s ``ICLSurrogateBackend``, the
surrogate of the paper's Gemma3-4B agent), importing nothing of the
program. A rule-based decider: it gives no margin.

``recent`` holds the hit shares the agent was asked with (the last 16,
this request's last); ``history`` its decisions (the last 64), each
``[replace, hits before, hits after]``, closed by this request's hit
share (see ``decisions/rudder.py``).
"""

from __future__ import annotations

LOW_HITS = 50.0   # a hit share (%) below this asks for a refresh
TOL = 1.0         # %-points: a trend within this is flat
ENDGAME = 0.92    # no replacement past this share of the call


def rule(m: dict, recent: list, history: list) -> bool:
    if m["progress"] >= ENDGAME:
        return False
    if m["occupancy"] < 0.5:
        return True
    done = [h for h in history if h[0] and h[2] is not None]
    if done and done[-1][2] - done[-1][1] <= 0.0:
        # The last replacement did not raise the hit share: back off
        # once, while it is among the last three decisions.
        last = [h for h in history[-3:] if h[0]]
        if last and last[-1] is done[-1]:
            return False
    trend = 0.0
    r = recent
    if len(r) >= 4:
        k = min(4, len(r) // 2)
        trend = sum(r[-k:]) / k - sum(r[-2 * k : -k]) / k
    if m["pct_hits"] < LOW_HITS:
        return True
    if abs(trend) <= TOL and m["replaced_pct"] < 1.0:
        if m["comm"] > max(m["capacity"], 1) * 0.5:
            return True
    return trend < -TOL


class Rules:
    def ask(self, m: dict, recent: list, history: list) -> tuple[bool, None]:
        return rule(m, recent, history), None


def make(traffic: dict, num_pes: int, agent: dict | None, seed: int):
    return [Rules() for _ in range(num_pes)]
