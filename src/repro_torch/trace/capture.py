"""Trace capture — the recorder both runtimes feed per minibatch.

One :class:`TraceRecorder` records one run. The runtimes call
:meth:`record_step` once per minibatch with the exact streams they just
produced (guarded by ``if recorder is not None`` — zero work when
tracing is off) and :meth:`finalize` once at the end; the result is a
schema-conformant :class:`repro_torch.trace.schema.Trace`.

The recorder never *computes* anything the run didn't — it normalizes
dtypes (ids to int64, counters to int64, times to float64) and derives
only the home-partition split matrices (one bincount per stream, the
same arithmetic as :func:`repro_torch.sim.build_step_comm`), so recording with
either runtime yields bit-identical payloads — the contract
``tests/test_trace.py`` asserts for all four controller variants in
both queue modes.
"""

from __future__ import annotations

import numpy as np

from .schema import (
    ID_DTYPE,
    RAGGED_FIELDS,
    SCHEMA_VERSION,
    STEP_FIELDS,
    STORE_FIELDS,
    Trace,
    normalize_ids,
)


def controller_validity(controllers) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative (valid, invalid) response counters per PE (Table 2).

    Adaptive PEs report their agent's ``DecisionMaker`` counters;
    heuristic controllers (and classifier deciders, which never produce
    malformed responses) report zeros.
    """
    P = len(controllers)
    valid = np.zeros(P, dtype=np.int64)
    invalid = np.zeros(P, dtype=np.int64)
    for p, ctrl in enumerate(controllers):
        agent = getattr(ctrl, "agent", None)
        maker = getattr(agent, "maker", None)
        if maker is not None:
            valid[p] = int(maker.valid_responses)
            invalid[p] = int(maker.invalid_responses)
    return valid, invalid


def _pairs_of(node_lists, part_of: np.ndarray, P: int, id_base: int = 0) -> np.ndarray:
    """(P, P) home-partition split of per-PE node-id lists (one bincount,
    keyed ``trainer_row * P + home`` — mirrors ``sim.build_step_comm``).
    Ids are global; ``part_of`` is local-indexed, hence the ``id_base``
    rebase before the home lookup."""
    lengths = [len(x) for x in node_lists]
    rows = np.repeat(np.arange(P, dtype=np.int64), lengths)
    nodes = (
        np.concatenate([normalize_ids(x) for x in node_lists])
        if sum(lengths)
        else np.array([], dtype=ID_DTYPE)
    )
    return np.bincount(
        rows * P + part_of[nodes - id_base], minlength=P * P
    ).reshape(P, P)


class TraceRecorder:
    """Accumulates one run's per-step streams; finalize() -> Trace."""

    def __init__(
        self,
        num_pes: int,
        part_of: np.ndarray | None = None,
        config: dict | None = None,
        capacities=None,
        feature_dim: int = 0,
        feature_bytes: int = 4,
        mb_per_epoch: int = 0,
        epochs: int = 0,
        mode: str = "async",
        variant: str = "",
        id_base: int = 0,
    ):
        self.num_pes = int(num_pes)
        self.part_of = part_of
        self.id_base = int(id_base)
        self.config = dict(config) if config else {}
        self.capacities = [int(c) for c in capacities] if capacities is not None else []
        self.feature_dim = int(feature_dim)
        self.feature_bytes = int(feature_bytes)
        self.mb_per_epoch = int(mb_per_epoch)
        self.epochs = int(epochs)
        self.mode = mode
        self.variant = variant
        self._steps: list[dict] = []
        self._ragged: dict[str, list[np.ndarray]] = {n: [] for n in RAGGED_FIELDS}
        self._has_store: bool | None = None  # set by the first record_step
        self._finalized = False

    # ------------------------------------------------------------------ #
    @classmethod
    def for_trainer(cls, trainer, config: dict | None = None) -> "TraceRecorder":
        """Build a recorder wired to a :class:`DistributedTrainer`.

        ``config`` is the manifest config; when the trainer was built by
        the trace CLI / sweep runner this is the full replayable cell
        config. Otherwise (``DistributedTrainer(trace=True)``) it is a
        best-effort summary of the trainer's axes marked
        ``replayable: False`` — the graph's generation scale/seed and
        the deciders are not recoverable from a live trainer, so CLI
        ``replay`` refuses to rebuild from it (the in-process replay
        adapters, which take the trainer's own objects, are unaffected).
        """
        if config is None:
            config = {
                "dataset": trainer.graph.name,
                "variant": trainer.variant,
                "num_parts": int(trainer.parts.num_parts),
                "batch_size": int(trainer.batch_size),
                "fanouts": [int(f) for f in trainer.sampler.fanouts],
                "buffer_frac": float(trainer.buffer_frac),
                "mode": trainer.mode,
                "epochs": int(trainer.epochs),
                "policy": trainer.policy.name,
                "time_engine": trainer.time_engine,
                "replayable": False,
            }
        return cls(
            num_pes=trainer.parts.num_parts,
            part_of=trainer.parts.part_of,
            config=config,
            capacities=[int(c) for c in trainer.engine.capacity],
            feature_dim=int(trainer.graph.features.shape[1]),
            feature_bytes=int(trainer.tm.feature_bytes),
            mb_per_epoch=trainer.mb_per_epoch,
            epochs=trainer.epochs,
            mode=trainer.mode,
            variant=trainer.variant,
            id_base=int(trainer.graph.id_base),
        )

    # ------------------------------------------------------------------ #
    def record_step(
        self,
        *,
        seeds,
        remote,
        missed,
        placed,
        decisions,
        stalls,
        pct_hits,
        hits,
        n_remote,
        replaced,
        total_comm,
        occupancy_pre,
        occupancy_post,
        step_times,
        controllers=None,
        feat_sums=None,
        bytes_measured=None,
        bytes_modeled=None,
        fetch_time_measured=None,
    ) -> None:
        """Record one minibatch: per-PE id lists + dense per-PE streams.

        The feature-store measurement family (``feat_sums``,
        ``bytes_measured``, ``bytes_modeled``, ``fetch_time_measured``)
        is all-or-nothing — pass all four ``(P,)`` streams on every step
        of a store-enabled run, or none on any step.

        Validates *every* argument before mutating any recorder state,
        so a rejected call leaves the recorder unchanged (a caller that
        catches the error and retries does not corrupt the step/segment
        alignment).
        """
        if self._finalized:
            raise RuntimeError("recorder already finalized")
        P = self.num_pes
        store_in = {
            "feat_sums": feat_sums,
            "bytes_measured": bytes_measured,
            "bytes_modeled": bytes_modeled,
            "fetch_time_measured": fetch_time_measured,
        }
        given = [n for n, v in store_in.items() if v is not None]
        if given and len(given) != len(store_in):
            missing = sorted(set(store_in) - set(given))
            raise ValueError(f"partial store family: missing {missing}")
        has_store = bool(given)
        if self._has_store is not None and has_store != self._has_store:
            raise ValueError(
                "store fields must be recorded on every step or none"
            )
        ragged_in = {
            "seeds": seeds,
            "remote": remote,
            "miss_ids": missed,
            "placed_ids": placed,
        }
        for name, lists in ragged_in.items():
            if len(lists) != P:
                raise ValueError(f"{name}: expected {P} per-PE lists, got {len(lists)}")
        valid, invalid = (
            controller_validity(controllers)
            if controllers is not None
            else (np.zeros(P, dtype=np.int64), np.zeros(P, dtype=np.int64))
        )
        row = {
            "decisions": np.asarray(decisions, dtype=bool),
            "stalls": np.asarray(stalls, dtype=np.float64),
            "pct_hits": np.asarray(pct_hits, dtype=np.float64),
            "hits": np.asarray(hits, dtype=np.int64),
            "n_remote": np.asarray(n_remote, dtype=np.int64),
            "miss": np.array([len(m) for m in missed], dtype=np.int64),
            "replaced": np.asarray(replaced, dtype=np.int64),
            "total_comm": np.asarray(total_comm, dtype=np.int64),
            "occupancy_pre": np.asarray(occupancy_pre, dtype=np.float64),
            "occupancy_post": np.asarray(occupancy_post, dtype=np.float64),
            "step_time": np.asarray(step_times, dtype=np.float64),
            "valid_responses": valid,
            "invalid_responses": invalid,
        }
        if has_store:
            for name, value in store_in.items():
                row[name] = np.asarray(value, dtype=STORE_FIELDS[name])
        for name, arr in row.items():
            if arr.shape != (P,):
                raise ValueError(f"{name}: shape {arr.shape} != ({P},)")
        if self.part_of is not None:
            row["miss_pairs"] = _pairs_of(missed, self.part_of, P, self.id_base)
            row["repl_pairs"] = _pairs_of(placed, self.part_of, P, self.id_base)
        # Everything validated — mutate atomically.
        self._has_store = has_store
        for name, lists in ragged_in.items():
            self._ragged[name].extend(normalize_ids(x) for x in lists)
        self._steps.append(row)

    # ------------------------------------------------------------------ #
    def finalize(self, epoch_times, events=None) -> Trace:
        """Close the run: stack streams, intern events, build the manifest."""
        if self._finalized:
            raise RuntimeError("recorder already finalized")
        self._finalized = True
        S, P = len(self._steps), self.num_pes
        arrays: dict[str, np.ndarray] = {}
        for name, dtype in STEP_FIELDS.items():
            arrays[name] = (
                np.stack([row[name] for row in self._steps])
                if S
                else np.zeros((0, P), dtype=dtype)
            ).astype(dtype)
        if self.part_of is not None:
            for name in ("miss_pairs", "repl_pairs"):
                arrays[name] = (
                    np.stack([row[name] for row in self._steps])
                    if S
                    else np.zeros((0, P, P), dtype=np.int64)
                ).astype(np.int64)
        if self._has_store:
            for name, dtype in STORE_FIELDS.items():
                arrays[name] = np.stack(
                    [row[name] for row in self._steps]
                ).astype(dtype)
        for name, segments in self._ragged.items():
            lengths = np.array([len(s) for s in segments], dtype=np.int64)
            arrays[f"{name}_offsets"] = np.concatenate(
                [[0], np.cumsum(lengths)]
            ).astype(np.int64)
            arrays[f"{name}_flat"] = (
                np.concatenate(segments) if segments else np.array([], dtype=ID_DTYPE)
            ).astype(ID_DTYPE)
        arrays["epoch_times"] = np.asarray(list(epoch_times), dtype=np.float64)

        from .schema import KINDS, LANES

        lanes: list[str] = list(LANES)
        kinds: list[str] = list(KINDS)
        if events is not None and len(events):
            rows = events.as_tuples()

            def intern(table: list[str], value: str) -> int:
                if value not in table:
                    table.append(value)
                return table.index(value)

            arrays["ev_step"] = np.array([r[0] for r in rows], dtype=np.int64)
            arrays["ev_lane"] = np.array(
                [intern(lanes, r[1]) for r in rows], dtype=np.int64
            )
            arrays["ev_kind"] = np.array(
                [intern(kinds, r[2]) for r in rows], dtype=np.int64
            )
            arrays["ev_pe"] = np.array([r[3] for r in rows], dtype=np.int64)
            arrays["ev_t0"] = np.array([r[4] for r in rows], dtype=np.float64)
            arrays["ev_t1"] = np.array([r[5] for r in rows], dtype=np.float64)
            arrays["ev_src"] = np.array([r[6] for r in rows], dtype=np.int64)
            arrays["ev_nbytes"] = np.array([r[7] for r in rows], dtype=np.int64)

        manifest = {
            "schema_version": SCHEMA_VERSION,
            "config": self.config,
            "num_steps": S,
            "num_pes": P,
            "mb_per_epoch": self.mb_per_epoch,
            "epochs": self.epochs,
            "mode": self.mode,
            "variant": self.variant,
            "capacities": self.capacities,
            "feature_dim": self.feature_dim,
            "feature_bytes": self.feature_bytes,
            "id_dtype": str(np.dtype(ID_DTYPE)),
            "has_pairs": self.part_of is not None,
            "feature_store": bool(self._has_store),
            "lanes": lanes,
            "kinds": kinds,
        }
        trace = Trace(manifest=manifest, arrays=arrays)
        manifest["arrays"] = trace.array_specs()
        manifest["digest"] = trace.digest()
        return trace
