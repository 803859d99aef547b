"""Trace comparison: structured first-divergence reports.

``diff_traces(a, b)`` compares two traces field by field and reports,
for every diverging field, the **first** diverging element located in
run coordinates — ``(field, step, pe, value_a, value_b)`` — plus any
structural problems (missing fields, shape mismatches). This is what
turns "the parity contract broke" from a failing assert into an
actionable artifact: the CI golden gate uploads the JSON rendering next
to the bench artifacts, and ``python -m repro_torch.trace diff`` prints the
human rendering.

Equality is **bit-exact** (NaN == NaN, so a NaN-on-empty aggregate does
not read as drift). Manifest config differences are reported separately
and do not affect :attr:`DiffReport.identical` — the same physical run
recorded under two configs (legacy vs vectorized runtime) must diff
clean; that *is* the cross-runtime contract.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .schema import RAGGED_FIELDS, Trace


@dataclass(frozen=True)
class Divergence:
    """First diverging element of one field, in run coordinates."""

    field: str
    step: int       # minibatch step (-1 for non-step arrays)
    pe: int         # trainer PE (-1 when not PE-indexed)
    index: int      # flat index within the field
    a: object
    b: object

    def render(self) -> str:
        where = f"step={self.step} pe={self.pe}" if self.step >= 0 else f"i={self.index}"
        return f"{self.field} [{where}]: {self.a!r} != {self.b!r}"


@dataclass
class DiffReport:
    """Outcome of one trace comparison."""

    divergences: list[Divergence] = field(default_factory=list)
    problems: list[str] = field(default_factory=list)
    config_mismatches: list[str] = field(default_factory=list)

    @property
    def identical(self) -> bool:
        return not self.divergences and not self.problems

    @property
    def first(self) -> Divergence | None:
        return self.divergences[0] if self.divergences else None

    def render(self) -> str:
        if self.identical:
            return "identical"
        lines = [f"PROBLEM: {p}" for p in self.problems]
        lines += [d.render() for d in self.divergences]
        return "\n".join(lines)

    def to_json(self) -> dict:
        def plain(v):
            if isinstance(v, (np.integer,)):
                return int(v)
            if isinstance(v, (np.floating,)):
                return float(v)
            if isinstance(v, (np.bool_,)):
                return bool(v)
            return v

        return {
            "identical": self.identical,
            "problems": list(self.problems),
            "config_mismatches": list(self.config_mismatches),
            "divergences": [
                {
                    "field": d.field,
                    "step": d.step,
                    "pe": d.pe,
                    "index": d.index,
                    "a": plain(d.a),
                    "b": plain(d.b),
                }
                for d in self.divergences
            ],
        }


def _exact_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise bit-exact equality with NaN == NaN."""
    eq = a == b
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        eq = eq | (np.isnan(a) & np.isnan(b))
    return eq


def _first_divergence(
    name: str, a: np.ndarray, b: np.ndarray, num_pes: int
) -> Divergence | None:
    eq = _exact_equal(a, b)
    if eq.all():
        return None
    flat = int(np.argmin(eq.ravel()))
    step, pe = -1, -1
    if a.ndim >= 2 and a.shape[1] == num_pes and not name.startswith("ev_"):
        per_step = int(np.prod(a.shape[1:]))
        step = flat // per_step
        pe = (flat % per_step) // (per_step // num_pes)
    elif name.startswith("ev_"):
        step = -1
    return Divergence(
        field=name, step=step, pe=pe, index=flat,
        a=a.ravel()[flat], b=b.ravel()[flat],
    )


def _canonical_segments(flat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat stream with every (step, pe) segment sorted ascending."""
    seg = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    return flat[np.lexsort((flat, seg))]


def _diff_ragged(
    name: str, a: Trace, b: Trace, report: DiffReport
) -> None:
    """Compare one ragged stream; locate divergence as (step, pe).

    Id sets inside a segment are compared **canonically** (each segment
    sorted) before element positions are blamed: two streams holding the
    same ids in different orders used to report the first positional
    mismatch as a content divergence — misleading, since the first
    *genuinely different id* may sit steps later (or nowhere). Now an
    order-only difference reports as ``<name>.order`` at the first
    raw-mismatching segment, and a content difference is located in the
    canonical stream, naming an id actually present in only one trace.
    """
    P = a.num_pes
    off_a, off_b = a.arrays[f"{name}_offsets"], b.arrays[f"{name}_offsets"]
    flat_a, flat_b = a.arrays[f"{name}_flat"], b.arrays[f"{name}_flat"]
    if off_a.shape != off_b.shape:
        report.problems.append(
            f"{name}: segment count {off_a.shape[0] - 1} != {off_b.shape[0] - 1}"
        )
        return
    lens_a, lens_b = np.diff(off_a), np.diff(off_b)
    if not np.array_equal(lens_a, lens_b):
        k = int(np.argmin(lens_a == lens_b))
        report.divergences.append(Divergence(
            field=f"{name}.len", step=k // P, pe=k % P, index=k,
            a=int(lens_a[k]), b=int(lens_b[k]),
        ))
        return
    eq = _exact_equal(flat_a, flat_b)
    if eq.all():
        return
    can_a = _canonical_segments(flat_a, lens_a)
    can_b = _canonical_segments(flat_b, lens_b)
    can_eq = _exact_equal(can_a, can_b)
    if can_eq.all():
        # Same id sets everywhere — ordering drift only. Blame the first
        # segment whose raw layout differs.
        flat = int(np.argmin(eq))
        k = int(np.searchsorted(off_a, flat, side="right")) - 1
        report.divergences.append(Divergence(
            field=f"{name}.order", step=k // P, pe=k % P, index=flat,
            a=flat_a[flat], b=flat_b[flat],
        ))
        return
    flat = int(np.argmin(can_eq))
    k = int(np.searchsorted(off_a, flat, side="right")) - 1
    report.divergences.append(Divergence(
        field=name, step=k // P, pe=k % P, index=flat,
        a=can_a[flat], b=can_b[flat],
    ))


def diff_traces(a: Trace, b: Trace, fields=None) -> DiffReport:
    """Compare two traces; returns the structured report.

    ``fields`` restricts the comparison (used by the replay adapters to
    check only the streams a single plane reproduces). Divergences are
    ordered by (step, field) so the report leads with the earliest drift.
    """
    report = DiffReport()
    # lanes/kinds decode the ev_lane/ev_kind code arrays: a table
    # mismatch means equal codes name different events, so it is a
    # structural problem, not a config note.
    for key in ("schema_version", "num_steps", "num_pes", "lanes", "kinds"):
        if a.manifest.get(key) != b.manifest.get(key):
            report.problems.append(
                f"manifest.{key}: {a.manifest.get(key)!r} != {b.manifest.get(key)!r}"
            )
    if report.problems:
        return report
    ca, cb = a.config, b.config
    for key in sorted(set(ca) | set(cb)):
        if ca.get(key) != cb.get(key):
            report.config_mismatches.append(
                f"config.{key}: {ca.get(key)!r} != {cb.get(key)!r}"
            )

    ragged_wanted = [
        n for n in RAGGED_FIELDS
        if fields is None or n in fields
    ]
    ragged_keys = {
        f"{n}_{suffix}" for n in RAGGED_FIELDS for suffix in ("flat", "offsets")
    }
    names_a = set(a.arrays) - ragged_keys
    names_b = set(b.arrays) - ragged_keys
    if fields is not None:
        names_a &= set(fields)
        names_b &= set(fields)
    for name in sorted(names_a ^ names_b):
        report.problems.append(
            f"{name}: present only in {'a' if name in names_a else 'b'}"
        )
    for name in sorted(names_a & names_b):
        arr_a, arr_b = np.asarray(a.arrays[name]), np.asarray(b.arrays[name])
        if arr_a.shape != arr_b.shape:
            report.problems.append(
                f"{name}: shape {arr_a.shape} != {arr_b.shape}"
            )
            continue
        div = _first_divergence(name, arr_a, arr_b, a.num_pes)
        if div is not None:
            report.divergences.append(div)
    for name in ragged_wanted:
        in_a = f"{name}_flat" in a.arrays
        in_b = f"{name}_flat" in b.arrays
        if in_a and in_b:
            _diff_ragged(name, a, b, report)
        elif in_a != in_b:
            report.problems.append(
                f"{name}: ragged stream present only in {'a' if in_a else 'b'}"
            )
    report.divergences.sort(key=lambda d: (d.step if d.step >= 0 else 1 << 60, d.field))
    return report


def write_report_json(report: DiffReport, path: str, extra: dict | None = None):
    """Write the JSON rendering (the CI gate's uploaded artifact)."""
    payload = report.to_json()
    if extra:
        payload.update(extra)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return payload
