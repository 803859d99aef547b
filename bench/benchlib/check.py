"""The comparison that decides ``correct``.

Exact numbers (limit 0): how many nodes' partitions and PEs' capacities,
how many (step, PE) seed blocks and sampled frontiers, how many (step,
PE) replacement decisions, how many (step, PE) buffer outcomes (remote set, hits, misses, admissions, replaced,
fetched rows) and final buffer slots, and how many (step, PE) delivered
remote blocks' float64 sums differ from the reference, over the warm-up
call and the first steps of the call after it.

Training numbers, over the warm-up call's first steps: the largest
relative gap of a step's loss; and, leaf by leaf, the gap between the
program's norm and the reference's of the first gradient as the
optimizer applied it (``(p0 - p1) / lr``) and of the parameters' change
over the steps, against the larger of the reference's norm of that leaf
and of the median leaf, for the median leaf (``*_gap_median``) and the
worst (``*_gap_worst``). Leaves whose reference gradient is under a
thousandth of the median leaf's are left out. Over the next call's first
steps, after the reference has trained through the whole warm-up call:
the largest relative gap of a step's loss (``loss_gap_next``).

Where the cell's decider gives margins (its rules module has
``numbers``): ``decision_ties``, how many answers the reference took
from the program because their margin lay within ``agent_margin_gap``
of a tie, and the decider's own numbers, such as ``agent_margin_gap``.
"""

from __future__ import annotations

import numpy as np

#: A reference gradient under this share of the median leaf's counts as
#: nought: such a leaf moves by round-off alone.
NOUGHT = 1e-3


def _norms(leaves) -> np.ndarray:
    return np.array([float(np.linalg.norm(np.asarray(x, dtype=np.float64))) for x in leaves])


def leaf_gaps(prog, ref, keep) -> np.ndarray:
    """Per leaf in ``keep``: ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    np_, nr = _norms(prog), _norms(ref)
    med = float(np.median(nr))
    return np.array([abs(a - b) / max(b, med) for a, b, k in zip(np_, nr, keep) if k])


def training_numbers(prog_losses, prog_snaps, ref_losses, ref_snaps, lr) -> dict:
    """``prog_snaps`` / ``ref_snaps``: parameters after 0, 1 and the last
    of the compared steps, as float64 numpy leaves."""
    steps = len(ref_losses)
    loss_gap = max(
        abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(prog_losses[:steps], ref_losses)
    )
    g_prog = [(a - b) / lr for a, b in zip(prog_snaps[0], prog_snaps[1])]
    g_ref = [(a - b) / lr for a, b in zip(ref_snaps[0], ref_snaps[1])]
    ng = _norms(g_ref)
    keep = ng >= NOUGHT * float(np.median(ng))
    d_prog = [b - a for a, b in zip(prog_snaps[0], prog_snaps[-1])]
    d_ref = [b - a for a, b in zip(ref_snaps[0], ref_snaps[-1])]
    out = {"loss_gap": loss_gap}
    for name, gaps in (("grad_gap", leaf_gaps(g_prog, g_ref, keep)),
                       ("change_gap", leaf_gaps(d_prog, d_ref, keep))):
        out[name + "_median"] = float(np.median(gaps))
        out[name + "_worst"] = float(gaps.max())
    return out


def next_call_numbers(prog_losses, ref_losses) -> dict:
    """The largest relative gap of the next call's first losses; a call
    that gives fewer losses than the reference reads infinite."""
    if not ref_losses:
        return {}
    if len(prog_losses) < len(ref_losses):
        return {"loss_gap_next": float("inf")}
    return {"loss_gap_next": max(abs(float(a) - float(b)) / abs(float(b))
                                 for a, b in zip(prog_losses, ref_losses))}


def leaf_detail(prog, ref_snaps, ref_grads, lr) -> dict:
    """Per leaf, for the calibration's look at a number: the norms of the
    first gradient worked out from the parameters (program, reference),
    taken as the optimizer got it (the program's per-PE gradients
    averaged, the reference's), and of the change over the steps."""
    direct = [sum(g) / len(prog.first_grads) for g in zip(*prog.first_grads)]
    rows = {
        "grad_from_params": [_norms([(a - b) / lr for a, b in zip(s[0], s[1])])
                             for s in (prog.snaps, ref_snaps)],
        "grad_direct": [_norms(direct), _norms(ref_grads)],
        "change": [_norms([b - a for a, b in zip(s[0], s[-1])]) for s in (prog.snaps, ref_snaps)],
    }
    out = {k: [[float(a), float(b)] for a, b in zip(*v)] for k, v in rows.items()}
    out["param_norms"] = [float(x) for x in _norms(ref_snaps[0])]
    return out


def _differs(a, b) -> bool:
    return not np.array_equal(np.asarray(a), np.asarray(b))


def _stream_mismatches(prog, ref_steps, store: bool) -> tuple[int, int, int, int]:
    """``(sample, decision, engine, store)`` counts of (step, PE) pairs of
    one call that differ; a call whose streams are short counts every
    pair."""
    P = len(ref_steps[0].seeds) if ref_steps else 0
    if len(prog.steps) < len(ref_steps) or len(prog.touched) < len(ref_steps):
        n = len(ref_steps) * P
        return n, n, n, n if store else 0
    n_sample = n_decision = n_engine = n_store = 0
    for t, rs in enumerate(ref_steps):
        ps = prog.steps[t]
        for p in range(P):
            if _differs(ps["seeds"][p], rs.seeds[p]) or _differs(prog.touched[t][p], rs.touched[p]):
                n_sample += 1
            if bool(ps["decisions"][p]) != bool(rs.decisions[p]):
                n_decision += 1
            if (
                _differs(ps["remote"][p], rs.remote[p])
                or int(ps["hits"][p]) != int(rs.hits[p])
                or _differs(ps["missed"][p], rs.missed[p])
                or _differs(ps["placed"][p], rs.placed[p])
                or int(ps["replaced"][p]) != int(rs.replaced[p])
                or int(ps["total_comm"][p]) != int(rs.total_comm[p])
            ):
                n_engine += 1
            if store and float(ps["feat_sums"][p]) != float(rs.feat_sums[p]):
                n_store += 1
    return n_sample, n_decision, n_engine, n_store


def exact_numbers(prog, nxt, ref_setup, ref_steps, ref_next, ref_bufs, store: bool) -> dict:
    """``prog`` and ``nxt`` are the runner's :class:`Captured` of the
    warm-up call and of the next call's first steps."""
    out = {
        "partition_mismatch": int((prog.part_of != ref_setup.part_of).sum())
        + int((prog.capacity != ref_setup.capacity).sum()),
    }
    counts = [_stream_mismatches(c, r, store) for c, r in ((prog, ref_steps), (nxt, ref_next))]
    n_sample, n_decision, n_engine, n_store = (sum(x) for x in zip(*counts))
    if len(prog.steps) != len(ref_steps):
        n_engine += 1
    for p, buf in enumerate(ref_bufs):
        c = buf.capacity
        ids, valid, scores = prog.buf_ids[p], prog.buf_valid[p], prog.buf_scores[p]
        if (
            _differs(valid[:c], buf.valid)
            or valid[c:].any()
            or _differs(ids[:c][buf.valid], buf.ids[buf.valid])
            or _differs(scores[:c][buf.valid], buf.scores[buf.valid])
        ):
            n_engine += 1
    out["sample_mismatch"] = n_sample
    out["decision_mismatch"] = n_decision
    out["engine_mismatch"] = n_engine
    if store:
        out["store_mismatch"] = n_store
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every limited number at or under its limit;
    a limit without a number is not correct."""
    checks = {}
    ok = True
    for name in sorted(limits):
        value = numbers.get(name)
        limit = limits.get(name)
        good = value is not None and limit is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
