"""The per-layer readers of the program's phase spans and copy counters,
on hand-made runs."""

import pytest
from tiny import cells


def spans(name, durations, t=0.0):
    out = []
    for d in durations:
        out.append((name, t, t + d))
        t += d + 1.0
    return out


def read(metric, run):
    return cells.metric_reader(metric).read(run)


@pytest.mark.parametrize("metric, names", [
    ("sample_draw_ms", ("sample.draw",)),
    ("sample_expand_ms", ("sample.expand",)),
    ("fetch_host_ms", ("fetch.pack", "fetch.unpack", "fetch.account")),
    ("readback_wait_ms", ("device.wait",)),
    ("store_gather_ms", ("fetch.gather",)),
    ("train_features_ms", ("train.features",)),
    ("train_wait_ms", ("train.wait",)),
    ("call_ms", ("call.engine", "fused.prime", "call.accuracy", "call.sync")),
])
def test_span_readers_sum_their_spans_over_steps(metric, names):
    durations = [0.002, 0.004]
    run = {"spans": [s for n in names for s in spans(n, durations)]
           + spans("step", [0.5, 0.5]) + spans("sample", [0.25]), "steps": 4}
    assert read(metric, run) == pytest.approx(1e3 * len(names) * sum(durations) / 4)
    # Other spans only, or no step: nothing to read.
    assert read(metric, {"spans": spans("step", [0.5]), "steps": 4}) is None
    assert read(metric, {"spans": run["spans"], "steps": 0}) is None


def test_call_ms_needs_the_call_spans():
    """A program that records ``fused.prime`` but no ``call.*`` span (one
    before the phase spans) reads nothing, not the prime alone."""
    run = {"spans": spans("fused.prime", [0.1]), "steps": 2}
    assert read("call_ms", run) is None
    run["spans"] += spans("call.sync", [0.1])
    assert read("call_ms", run) == pytest.approx(100.0)


def test_copied_bytes_per_seed():
    counters = {"device.h2d_bytes": 600.0, "device.d2h_bytes": 1400.0,
                "device.h2d_bytes.engine.frontier": 600.0,
                "device.d2h_bytes.engine.packed": 1400.0}
    assert read("copied_bytes_per_seed", {"counters": counters, "seeds": 8}) == 250.0
    # Totals without the by-site counters: a program that does not count
    # every site, so nothing to read.
    older = {"device.h2d_bytes": 600.0, "device.d2h_bytes": 1400.0}
    assert read("copied_bytes_per_seed", {"counters": older, "seeds": 8}) is None
    assert read("copied_bytes_per_seed", {"counters": counters, "seeds": 0}) is None


def test_the_new_metrics_are_the_cells_own():
    """Every cell reads the new metrics, the store's gather on papers only."""
    new = ("sample_draw_ms", "sample_expand_ms", "fetch_host_ms", "readback_wait_ms",
           "train_features_ms", "train_wait_ms", "call_ms", "copied_bytes_per_seed")
    for name in ("products-rudder", "products-distdgl", "papers-store-rudder"):
        metrics = {m["name"] for m in cells.find_cell(name).per_layer}
        assert set(new) <= metrics
        assert ("store_gather_ms" in metrics) == (name == "papers-store-rudder")


@pytest.mark.parametrize("name", ["products-rudder", "papers-store-rudder"])
def test_a_traced_window_reads_the_phase_metrics(name):
    """A traced CPU window of a tiny cell reads every new metric, and the
    phases account for the step: ``sample`` splits into draws and
    expansion."""
    from tiny import SEED, tiny

    from benchlib.runner import run_cell

    out = run_cell(tiny(name), SEED + 3, 0.5, True, device="cpu")
    assert out.correct
    new = ["sample_draw_ms", "sample_expand_ms", "fetch_host_ms", "readback_wait_ms",
           "train_features_ms", "train_wait_ms", "call_ms", "copied_bytes_per_seed"]
    if name == "papers-store-rudder":
        new.append("store_gather_ms")
    for metric in new:
        assert out.metrics[metric]["value"] > 0, metric
    m = {k: v["value"] for k, v in out.metrics.items()}
    assert m["sample_draw_ms"] + m["sample_expand_ms"] <= m["sample_ms"]
    assert m["readback_wait_ms"] <= m["readback_ms"]
    assert m["train_features_ms"] + m["train_wait_ms"] <= m["train_ms"]
