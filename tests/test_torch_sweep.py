"""The paper's presets and the one-process sweep, through the port.

Mirrors the reference's ``tests/test_presets.py`` (every preset well
formed, one preset run, an unknown name raising) and its sweep tests:
``test_runtime_parity.py``'s ``TestSweep`` (the stock grid in process,
the graph and topology axes), ``test_policies.py``'s ``TestSweepPolicyAxis``
(the policy axis, order determinism and sorting, the artifact, the
``validate_rows`` gate) and ``test_telemetry.py``'s
``test_sweep_rows_carry_telemetry_brief``. The port's rows on
``device="cpu"`` (the device-resident loop) and ``device=False`` (the
staged loop) equal the reference's rows, and its presets' streams equal
the reference's presets'.

Tolerance: none; rows and streams are compared with ``==`` (every field
of a row without the feature store is built from exact streams).
"""

import copy
from dataclasses import asdict

import pytest

import repro.configs.rudder_gnn as jpresets
import repro.runtime.sweep as jsweep
from repro_torch import telemetry as tel
from repro_torch.configs import ARCHITECTURES
from repro_torch.configs.rudder_gnn import EXPERIMENTS, build_trainer
from repro_torch.core.scoring import POLICIES
from repro_torch.runtime import sweep as sweep_mod
from repro_torch.runtime import (
    SweepConfig,
    default_grid,
    run_sweep,
    sweep_artifact,
    validate_rows,
    write_sweep_json,
)

POLICY_NAMES = sorted(POLICIES)


def test_all_presets_well_formed():
    for name, exp in EXPERIMENTS.items():
        assert exp.variant in ("distdgl", "fixed", "massivegnn", "rudder"), name
        assert 0 < exp.buffer_frac <= 1
    assert EXPERIMENTS == {
        k: type(EXPERIMENTS[k])(**asdict(v)) for k, v in jpresets.EXPERIMENTS.items()
    }
    assert "rudder_gnn" not in ARCHITECTURES


@pytest.mark.parametrize("name", ["products_25pct_fixed", "products_massivegnn"])
def test_preset_roundtrip(name):
    """A preset's streams equal the reference's preset's, on the device
    loop and the staged loop."""
    want = jpresets.build_trainer(name).run()
    assert want.mean_pct_hits > 0
    for device in ("cpu", False):
        got = build_trainer(name, device=device).run()
        assert [asdict(a) for a in got.logs] == [asdict(b) for b in want.logs]
        assert got.epoch_times == want.epoch_times


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        build_trainer("nope", device="cpu")


# --------------------------------------------------------------------------- #
def _grid(**kw):
    base = dict(num_parts=(2,), batch_sizes=(16,), fanouts=((5, 10),),
                variants=("fixed",), epochs=2)
    base.update(kw)
    return default_grid(**base), jsweep.default_grid(**base)


def test_default_grid_matches_the_reference():
    grid, ref = default_grid(), jsweep.default_grid()
    assert len(grid) == 16
    assert [asdict(c) for c in grid] == [asdict(c) for c in ref]
    assert [c.label() for c in grid] == [c.label() for c in ref]


@pytest.mark.parametrize("device", ["cpu", False], ids=["device-loop", "staged"])
def test_rows_equal_the_reference(device):
    """``TestSweep.test_default_grid_runs_in_process``'s grid: all four
    controllers on two fanouts."""
    grid, ref_grid = _grid(fanouts=((5, 10), (10, 25)),
                           variants=("fixed", "massivegnn", "distdgl", "rudder"))
    assert len(grid) == 8
    rows = run_sweep(grid, device=device)
    assert rows == jsweep.run_sweep(ref_grid)
    by_variant = {r["variant"]: r for r in rows if r["fanouts"] == (5, 10)}
    assert by_variant["distdgl"]["mean_pct_hits"] == 0.0
    assert by_variant["fixed"]["mean_pct_hits"] > 0.0
    assert by_variant["massivegnn"]["mean_pct_hits"] > 0.0
    assert validate_rows(rows) == []


def test_graph_and_topology_axes():
    grid, ref_grid = _grid(datasets=("products", "rmat"), topologies=("none", "rack"))
    assert len(grid) == 4
    rows = run_sweep(grid, device="cpu")
    assert rows == jsweep.run_sweep(ref_grid)
    by_key = {(r["dataset"], r["topology"]): r for r in rows}
    for d in ("products", "rmat"):
        none_row, rack_row = by_key[(d, "none")], by_key[(d, "rack")]
        assert none_row["comm_per_minibatch"] == rack_row["comm_per_minibatch"]
        assert none_row["mean_epoch_time"] != rack_row["mean_epoch_time"]
        assert rack_row["label"].endswith("/t-rack")


def test_grid_multiplies_along_policy_axis():
    grid = default_grid(policies=tuple(POLICY_NAMES))
    assert len(grid) == 16 * len(POLICY_NAMES)
    assert {c.policy for c in grid} == set(POLICY_NAMES)
    assert all(c.policy in c.label() for c in grid)


def test_rows_deterministic_and_sorted():
    grid, ref_grid = _grid(policies=("rudder", "recency"))
    rows_a = run_sweep(grid, device="cpu")
    rows_b = run_sweep(list(reversed(grid)), device="cpu")
    assert rows_a == rows_b  # input order must not matter
    assert rows_a == sorted(rows_a, key=sweep_mod._cell_key)
    assert rows_a == jsweep.run_sweep(ref_grid)
    assert {r["policy"] for r in rows_a} == {"rudder", "recency"}
    art = sweep_artifact(rows_a)
    assert art["grid"]["cells"] == len(rows_a)
    assert art["grid"]["policies"] == ["recency", "rudder"]
    assert art["grid"] == jsweep.sweep_artifact(rows_a)["grid"]
    assert art["provenance"]["device"] and "jax" not in art["provenance"]


def test_gate_accepts_sound_and_rejects_poisoned():
    grid, _ = _grid()
    rows = run_sweep(grid, device="cpu")
    assert validate_rows(rows) == []
    assert validate_rows([]) != []
    poisoned = copy.deepcopy(rows)
    poisoned[0]["steady_pct_hits"] = float("nan")
    assert any("not finite" in p for p in validate_rows(poisoned))
    missing = copy.deepcopy(rows)
    del missing[0]["mean_epoch_time"]
    assert any("missing metric" in p for p in validate_rows(missing))
    dup = rows + rows[:1]
    assert any("duplicate" in p for p in validate_rows(dup))
    # Same label but a different off-label axis is NOT a duplicate.
    twin = copy.deepcopy(rows[:1])
    twin[0]["interval"] = rows[0]["interval"] + 32
    assert validate_rows(rows[:1] + twin) == []
    for bad in (poisoned, missing, dup, []):
        assert validate_rows(bad) == jsweep.validate_rows(bad)


def test_store_cells_and_written_artifact(tmp_path):
    """A feature-store cell measures the modeled bytes; the written
    artifact is deterministic JSON."""
    grid, ref_grid = _grid(feature_store=True)
    rows = run_sweep(grid, device="cpu")
    ref_rows = jsweep.run_sweep(ref_grid)
    wall = "fetch_seconds_measured"
    assert [{k: v for k, v in r.items() if k != wall} for r in rows] == [
        {k: v for k, v in r.items() if k != wall} for r in ref_rows
    ]
    assert rows[0]["bytes_measured"] == rows[0]["bytes_modeled"] > 0
    a = write_sweep_json(rows, str(tmp_path / "a.json"))
    b = write_sweep_json(list(reversed(rows)), str(tmp_path / "b.json"))
    assert a == b
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_trace_dir_cells_replay_through_the_cli(tmp_path):
    from repro_torch.trace import cli as tcli

    grid, _ = _grid()
    rows = run_sweep(grid, trace_dir=str(tmp_path), device="cpu")
    path = tmp_path / rows[0]["trace"]
    assert path.exists()
    assert tcli.main(["replay", str(path), "--device", "cpu"]) == 0


def test_sweep_rows_carry_telemetry_brief():
    cfg = SweepConfig(num_parts=2, batch_size=8, fanouts=(3, 5), epochs=1)
    rows = run_sweep([cfg], scale=0.05, telemetry=True, device="cpu")
    assert len(rows) == 1
    brief = rows[0]["telemetry"]
    assert brief["span_count"] > 0
    assert "engine" in brief["by_plane"]
    assert not tel.enabled()
    payload = sweep_artifact(rows)
    assert payload["provenance"]["schema"] == 1
    ref_rows = jsweep.run_sweep([jsweep.SweepConfig(**asdict(cfg))], scale=0.05)
    assert {k: v for k, v in rows[0].items() if k != "telemetry"} == ref_rows[0]
