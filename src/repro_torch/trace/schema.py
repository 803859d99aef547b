"""Versioned schema of one recorded run — the trace plane's contract.

A :class:`Trace` is the canonical per-minibatch record of everything the
exact planes produce and the simulation plane prices: seeds, sampled
remote frontiers, miss sets (with their home-partition split), decisions
with validity/stall accounting, replacement admissions, byte counts and
per-PE step times — plus the event timeline when the run was priced by
the event engine. Two runs are "the same run" exactly when their traces
are bit-identical; every parity contract in the repo (legacy vs
vectorized, closed-form vs event, record vs replay) reduces to a trace
diff.

Layout: a dict of numpy arrays (the npz payload) plus a JSON manifest
(config, schema version, array specs, payload digest). All dtypes are
**normalized** so a trace recorded on one platform replays bit-identically
on another: node ids are always int64 (whatever dtype the producing
plane used — the int32 fast path of :class:`repro_torch.graph.sampler.
SamplerPlane` and the int64 scalar path record identically), counters are
int64, times/fractions are float64, flags are bool.

Array families (S = steps, P = trainer PEs, E = epochs):

* dense per-step fields — ``(S, P)``, one value per (minibatch, PE):
  ``decisions, stalls, pct_hits, hits, n_remote, miss, replaced,
  total_comm, occupancy_pre, occupancy_post, step_time,
  valid_responses, invalid_responses`` (the last two are the cumulative
  Table-2 response counters of adaptive PEs);
* home-split matrices — ``(S, P, P)`` ``miss_pairs`` / ``repl_pairs``:
  ``[s, p, q]`` = nodes trainer p pulled from partition q at step s;
* feature-store measurements — optional ``(S, P)`` family present only
  when the run served real features (``--feature-store``):
  ``bytes_measured`` (bytes actually gathered), ``bytes_modeled`` (the
  time model's byte estimate for the same streams), ``feat_sums``
  (float64 content checksum of each PE's assembled remote feature
  block — makes shard corruption trace-visible), and
  ``fetch_time_measured`` (wall-clock gather seconds; the one
  nondeterministic field, excluded from exact comparisons);
* ragged id streams — ``<name>_flat`` int64 + ``<name>_offsets``
  ``(S * P + 1,)`` int64, segment ``(s, p)`` at flat offset
  ``s * P + p``: ``seeds, remote, miss_ids, placed_ids``;
* event timeline — parallel ``ev_*`` arrays mirroring
  :class:`repro_torch.sim.events.SimEvent` tuples, with lane/kind interned
  against the manifest's code tables (present only for event-engine runs
  that collected events);
* run aggregates — ``epoch_times`` ``(E,)``.

The payload digest (sha256 over every array's name/dtype/shape/bytes) is
stored in the manifest: it makes "byte-stable" a one-line assert and
lets :func:`repro_torch.trace.store.load_trace` detect corrupted or hand-edited
golden artifacts. The manifest ``config`` is carried for replay and
reporting but deliberately excluded from the digest — the same physical
run recorded under two configs (e.g. ``runtime=legacy`` vs
``vectorized``) must hash identically, that *is* the parity contract.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

#: Bump on any incompatible change to the array families or manifest
#: layout; ``load_trace`` refuses newer schemas and golden regeneration
#: is required after a bump (see docs/TESTING.md).
SCHEMA_VERSION = 1

#: Canonical dtype for node ids in every ragged stream.
ID_DTYPE = np.int64

#: Dense per-step fields: name -> canonical dtype.
STEP_FIELDS: dict[str, np.dtype] = {
    "decisions": np.dtype(bool),
    "stalls": np.dtype(np.float64),
    "pct_hits": np.dtype(np.float64),
    "hits": np.dtype(np.int64),
    "n_remote": np.dtype(np.int64),
    "miss": np.dtype(np.int64),
    "replaced": np.dtype(np.int64),
    "total_comm": np.dtype(np.int64),
    "occupancy_pre": np.dtype(np.float64),
    "occupancy_post": np.dtype(np.float64),
    "step_time": np.dtype(np.float64),
    "valid_responses": np.dtype(np.int64),
    "invalid_responses": np.dtype(np.int64),
}

#: Home-partition split matrices, (S, P, P) int64.
PAIR_FIELDS = ("miss_pairs", "repl_pairs")

#: Ragged per-(step, PE) id streams, stored as <name>_flat/<name>_offsets.
RAGGED_FIELDS = ("seeds", "remote", "miss_ids", "placed_ids")

#: Feature-store measurement fields, (S, P), present all-or-nothing and
#: only for store-enabled runs (schema stays v1 — the family is optional).
STORE_FIELDS: dict[str, np.dtype] = {
    "bytes_measured": np.dtype(np.int64),
    "bytes_modeled": np.dtype(np.int64),
    "feat_sums": np.dtype(np.float64),
    "fetch_time_measured": np.dtype(np.float64),
}

#: The deterministic "exact streams" a store-enabled run must reproduce
#: bit-identically against the modeled path: every dense step field
#: except the priced ``step_time``, the home-split matrices, and all
#: ragged id streams. ``Trace.exact_digest`` hashes exactly these.
EXACT_FIELDS: tuple[str, ...] = (
    tuple(n for n in STEP_FIELDS if n != "step_time")
    + PAIR_FIELDS
    + tuple(f"{n}_flat" for n in RAGGED_FIELDS)
    + tuple(f"{n}_offsets" for n in RAGGED_FIELDS)
)

#: Canonical event code tables (the ``repro_torch.sim.events`` taxonomy).
#: ``ev_lane`` / ``ev_kind`` codes index into these, so the code arrays
#: are semantically stable across runs regardless of which event kinds a
#: particular run happens to emit first; unknown values are appended
#: after the canonical entries and the final tables land in the
#: manifest, where ``diff_traces`` compares them structurally.
LANES = ("compute", "net", "agent", "cluster")
KINDS = ("ddp", "fetch", "replace", "infer", "barrier")

#: Event-timeline arrays (parallel columns of SimEvent tuples).
EVENT_FIELDS: dict[str, np.dtype] = {
    "ev_step": np.dtype(np.int64),
    "ev_lane": np.dtype(np.int64),   # code into manifest["lanes"]
    "ev_kind": np.dtype(np.int64),   # code into manifest["kinds"]
    "ev_pe": np.dtype(np.int64),
    "ev_t0": np.dtype(np.float64),
    "ev_t1": np.dtype(np.float64),
    "ev_src": np.dtype(np.int64),
    "ev_nbytes": np.dtype(np.int64),
}


def normalize_ids(ids) -> np.ndarray:
    """One-dimensional int64 view of a node-id segment (any int dtype)."""
    arr = np.asarray(ids)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    return arr.astype(ID_DTYPE, copy=False)


@dataclass
class Trace:
    """One recorded run: JSON-able manifest + dict of numpy arrays."""

    manifest: dict
    arrays: dict[str, np.ndarray] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    @property
    def num_steps(self) -> int:
        return int(self.manifest["num_steps"])

    @property
    def num_pes(self) -> int:
        return int(self.manifest["num_pes"])

    @property
    def config(self) -> dict:
        return self.manifest.get("config", {})

    def ragged(self, name: str, step: int, pe: int) -> np.ndarray:
        """The ``(step, pe)`` segment of a ragged id stream."""
        offsets = self.arrays[f"{name}_offsets"]
        flat = self.arrays[f"{name}_flat"]
        k = step * self.num_pes + pe
        return flat[offsets[k] : offsets[k + 1]]

    # ------------------------------------------------------------------ #
    def digest(self, names=None) -> str:
        """sha256 over the array payload (name, dtype, shape, bytes).

        Deliberately config-independent: two traces with equal payloads
        hash equally even if recorded under different manifests — the
        cross-runtime byte-stability contract of ``tests/test_sim.py``.
        ``names`` restricts the hash to a field subset (sorted; missing
        names raise — a digest over absent fields is meaningless).
        """
        h = hashlib.sha256()
        for name in sorted(self.arrays) if names is None else sorted(names):
            arr = np.ascontiguousarray(self.arrays[name])
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    def exact_digest(self) -> str:
        """Digest of the deterministic exact streams (:data:`EXACT_FIELDS`).

        This is the measured-vs-modeled parity contract: a store-enabled
        run and the modeled-path golden of the same cell must agree here
        bit-exactly, while their full ``digest()`` differs (the store run
        carries the extra measurement family).
        """
        return self.digest(EXACT_FIELDS)

    def array_specs(self) -> dict[str, dict]:
        """Manifest rendering of the payload layout."""
        return {
            name: {"dtype": str(a.dtype), "shape": list(a.shape)}
            for name, a in sorted(self.arrays.items())
        }

    def validate(self) -> list[str]:
        """Schema conformance problems (empty list = sound trace)."""
        problems: list[str] = []
        m = self.manifest
        if m.get("schema_version") != SCHEMA_VERSION:
            problems.append(
                f"schema_version {m.get('schema_version')!r} != {SCHEMA_VERSION}"
            )
        S, P = self.num_steps, self.num_pes
        for name, dtype in STEP_FIELDS.items():
            arr = self.arrays.get(name)
            if arr is None:
                problems.append(f"missing field {name}")
            elif arr.shape != (S, P):
                problems.append(f"{name}: shape {arr.shape} != {(S, P)}")
            elif arr.dtype != dtype:
                problems.append(f"{name}: dtype {arr.dtype} != {dtype}")
        for name in PAIR_FIELDS:
            arr = self.arrays.get(name)
            if arr is not None and arr.shape != (S, P, P):
                problems.append(f"{name}: shape {arr.shape} != {(S, P, P)}")
        store_present = [n for n in STORE_FIELDS if n in self.arrays]
        if store_present and len(store_present) != len(STORE_FIELDS):
            missing = sorted(set(STORE_FIELDS) - set(store_present))
            problems.append(f"partial store family: missing {missing}")
        for name in store_present:
            arr = self.arrays[name]
            if arr.shape != (S, P):
                problems.append(f"{name}: shape {arr.shape} != {(S, P)}")
            elif arr.dtype != STORE_FIELDS[name]:
                problems.append(
                    f"{name}: dtype {arr.dtype} != {STORE_FIELDS[name]}"
                )
        for name in RAGGED_FIELDS:
            offsets = self.arrays.get(f"{name}_offsets")
            flat = self.arrays.get(f"{name}_flat")
            if offsets is None or flat is None:
                problems.append(f"missing ragged stream {name}")
                continue
            if offsets.shape != (S * P + 1,):
                problems.append(
                    f"{name}_offsets: shape {offsets.shape} != {(S * P + 1,)}"
                )
            elif offsets[0] != 0 or offsets[-1] != len(flat):
                problems.append(f"{name}: offsets do not span the flat array")
            elif (np.diff(offsets) < 0).any():
                problems.append(f"{name}: offsets not monotone")
            if flat is not None and flat.dtype != ID_DTYPE:
                problems.append(f"{name}_flat: dtype {flat.dtype} != {ID_DTYPE}")
        return problems


def canonical_manifest_json(manifest: dict) -> str:
    """Deterministic JSON rendering (sorted keys, no whitespace drift)."""
    return json.dumps(manifest, sort_keys=True, indent=1) + "\n"
