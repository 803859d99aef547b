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


def test_a_split_metric_reads_with_its_base():
    """``<base>.<part>`` without a file of its own reads as ``<base>``;
    ``mfu.sage`` keeps its own file."""
    run = {"spans": spans("fetch.pack", [0.1, 0.3]), "steps": 2}
    assert read("fetch_host_ms.store", run) == read("fetch_host_ms", run) == pytest.approx(200.0)
    assert cells.metric_reader("mfu.sage").__name__ == "bench_metric_mfu_sage"


def test_the_store_cells_rate_needs_its_window():
    run = {"window_steps": 0, "window_s": 0.0, "num_pes": 4, "batch": 2000}
    assert read("seeds_per_s.store", run) is None
    run.update(window_steps=24, window_s=4.0)
    assert read("seeds_per_s.store", run) == 48000.0


def test_the_new_metrics_are_the_cells_own():
    """Every cell that reports ``seeds_per_s`` reads the new metrics; the
    store's cell, which does not, reads its phases split off
    (``<metric>.store``) and the store's gather, which no other cell reads."""
    new = ("sample_draw_ms", "sample_expand_ms", "fetch_host_ms", "readback_wait_ms",
           "train_features_ms", "train_wait_ms", "call_ms", "copied_bytes_per_seed")
    store = ("seeds_per_s.store", "sample_ms.store", "fetch_host_ms.store", "train_ms.store",
             "store_serve_ms", "store_gather_ms")
    for name in ("products-rudder", "products-distdgl", "products-fixed", "papers-store-rudder"):
        metrics = {m["name"] for m in cells.find_cell(name).per_layer}
        if name == "papers-store-rudder":
            assert metrics == set(store)
        else:
            assert set(new) <= metrics and not metrics & set(store)


@pytest.mark.parametrize("name", ["products-rudder", "papers-store-rudder"])
def test_a_traced_window_reads_the_phase_metrics(name):
    """A traced CPU window of a tiny cell reads every new metric, and the
    phases account for the step: ``sample`` splits into draws and
    expansion."""
    from tiny import SEED, tiny

    from benchlib.runner import run_cell

    out = run_cell(tiny(name), SEED + 3, 0.5, True, device="cpu")
    assert out.correct
    m = {k: v["value"] for k, v in out.metrics.items()}
    if name == "papers-store-rudder":
        # The store's cell reads its phases split off: the same readers.
        for metric in ("sample_ms", "fetch_host_ms", "train_ms", "seeds_per_s"):
            assert m[f"{metric}.store"] > 0, metric
        assert m["store_gather_ms"] > 0 and m["store_serve_ms"] > 0
        assert set(m) == {m_["name"] for m_ in cells.find_cell(name).per_layer}
        return
    new = ["sample_draw_ms", "sample_expand_ms", "fetch_host_ms", "readback_wait_ms",
           "train_features_ms", "train_wait_ms", "call_ms", "copied_bytes_per_seed"]
    for metric in new:
        assert m[metric] > 0, metric
    assert m["sample_draw_ms"] + m["sample_expand_ms"] <= m["sample_ms"]
    assert m["readback_wait_ms"] <= m["readback_ms"]
    assert m["train_features_ms"] + m["train_wait_ms"] <= m["train_ms"]
