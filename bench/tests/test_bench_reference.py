"""The reference against the port at a tiny size, on the CPU: every
cell's check comes out correct, every exact count 0."""

import pytest
from tiny import CELLS, SEED, tiny

from benchlib.runner import run_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    out = run_cell(tiny(name), SEED, 0, False, device="cpu", window=False)
    assert out.correct, out.checks
    for key, value in out.numbers.items():
        if key.endswith("_mismatch"):
            assert value == 0, key
        else:
            assert value < 1e-6, key


def test_a_short_window_reports_the_cell_metrics():
    out = run_cell(tiny("products-rudder"), SEED + 1, 0.5, False, device="cpu")
    assert out.correct
    assert set(out.metrics) == {"seeds_per_s", "device_peak_gib", "setup_s"}
    assert out.metrics["seeds_per_s"]["value"] > 0
    assert out.attempted > 0


def test_a_traced_window_reports_the_span_metrics():
    out = run_cell(tiny("papers-store-rudder"), SEED + 2, 0.5, True, device="cpu")
    assert out.correct
    for name in ("seeds_per_s.store", "sample_ms.store", "fetch_host_ms.store",
                 "train_ms.store", "store_serve_ms", "store_gather_ms"):
        assert out.metrics[name]["value"] > 0, name
    assert list(out.breakdown) == ["device_ops", "idle_gaps"]
    # The metrics the store's cell no longer reads, where they are read.
    out = run_cell(tiny("products-rudder"), SEED + 2, 0.5, True, device="cpu")
    assert out.correct
    for name in ("step_ms_p95", "sample_ms", "decision_ms", "readback_ms",
                 "fetched_rows_per_seed", "train_ms", "mfu.sage"):
        assert out.metrics[name]["value"] > 0, name
    assert list(out.breakdown) == ["device_ops", "idle_gaps"]
