"""The port's telemetry plane against the reference's, on the CPU.

Mirrors the reference's ``tests/test_telemetry.py`` where it applies on
``device="cpu"``: registry and span semantics, the zero-overhead-off
helpers, the kernel-profiling hook (now on the GraphSAGE step's
``gather_mean`` and ``segment_sum_equal`` dispatchers too), the
digest-parity pair (telemetry off and on give the same
``Trace.exact_digest()`` as each other and as the reference, on the
device loop and on the staged loop), the exporters, the CLI and the
TimeModel calibration. Artifacts load across the two packages both ways:
the reference's ``load_jsonl`` and CLI read the port's JSONL, and the
port's read the reference's.

The legacy runtime (``runtime="legacy"``) records per-PE tracks
(``test_legacy_runtime_emits_per_pe_tracks``) and its session goes
through the exporters as the reference's ``TestExport`` does
(:class:`TestLegacyExport`); the device loop's session, which records no
per-PE span, checks the Chrome tracks on spans opened per PE by hand.
The sweep's rows carry the telemetry brief
(``tests/test_torch_sweep.py::test_sweep_rows_carry_telemetry_brief``).

Tolerances: none; every comparison is exact (digests, streams, counts),
except the calibration fits, held as in the reference.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.telemetry.cli import main as ref_tel_main
from repro.telemetry.export import load_jsonl as ref_load_jsonl
from repro.telemetry.export import write_jsonl as ref_write_jsonl
from repro_torch import telemetry as tel
from repro_torch.gnn.train import DistributedTrainer
from repro_torch.graph import generate, partition_graph
from repro_torch.telemetry import (
    Calibration,
    MetricsRegistry,
    TelemetrySession,
    calibrate_from_session,
    calibrate_from_trace,
    fit_alpha_bw,
    provenance,
)
from repro_torch.telemetry.cli import main as tel_main
from repro_torch.telemetry.export import (
    breakdown_rows,
    chrome_trace,
    load_jsonl,
    render_table,
    write_jsonl,
)


@pytest.fixture(autouse=True)
def _no_leaked_session():
    """A test that dies mid-run must not poison the global session."""
    yield
    tel.deactivate()


@pytest.fixture(scope="module")
def parts():
    g = generate("products", seed=0, scale=0.1)
    return partition_graph(g, 4)


@pytest.fixture(scope="module")
def ref_parts():
    return jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.1), 4)


COMMON = dict(
    variant="fixed", epochs=2, batch_size=16, fanouts=(3, 5),
    train_model=False, buffer_frac=0.25, interval=4, trace=True,
)
DEVICE = dict(COMMON, device="cpu")


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #
class TestRegistry:
    def test_counter_scalar_and_vector(self):
        reg = MetricsRegistry()
        reg.counter("a").add(2)
        reg.counter("a").add(3)
        assert reg["a"].total == 5.0
        reg.counter("b").add(np.arange(4))
        reg.counter("b").add(np.ones(4))
        np.testing.assert_array_equal(reg["b"].values, [1, 2, 3, 4])
        assert reg["b"].total == 10.0

    def test_counter_shape_fixed_by_first_add(self):
        reg = MetricsRegistry()
        reg.counter("c").add(np.ones(4))
        with pytest.raises(ValueError, match="shape"):
            reg.counter("c").add(np.ones(3))

    def test_counter_preshaped(self):
        reg = MetricsRegistry()
        c = reg.counter("pairwise", shape=(3, 3))
        assert c.values.shape == (3, 3)
        c.add(np.eye(3))
        assert c.total == 3.0

    def test_kind_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("x").add(1)
        with pytest.raises(ValueError, match="counter"):
            reg.gauge("x")

    def test_gauge_last_write_wins(self):
        reg = MetricsRegistry()
        reg.gauge("g").set(1.0)
        reg.gauge("g").set(7.0)
        assert reg["g"].total == 7.0

    def test_histogram_moments_and_percentiles(self):
        reg = MetricsRegistry()
        h = reg.histogram("h")
        h.observe([1.0, 2.0, 3.0, 4.0])
        h.observe(10.0)
        assert h.count == 5
        assert h.sum == 20.0
        assert h.min == 1.0 and h.max == 10.0
        assert h.mean == 4.0
        assert h.percentile(50) == 3.0

    def test_histogram_sample_is_bounded(self):
        reg = MetricsRegistry()
        h = reg.histogram("h")
        h.cap = 8
        h.observe(np.arange(100, dtype=float))
        assert h.count == 100
        assert len(h._sample) == 8

    def test_summary_shape(self):
        reg = MetricsRegistry()
        reg.counter("a").add(1)
        reg.gauge("b").set(2)
        reg.histogram("c").observe(3)
        s = reg.summary()
        assert set(s) == {"counters", "gauges", "histograms"}
        assert "a" in s["counters"] and "b" in s["gauges"]
        json.dumps(s)  # JSON-safe


# ---------------------------------------------------------------------- #
# spans
# ---------------------------------------------------------------------- #
class TestSpans:
    def test_nesting_depth_and_exclusive_time(self):
        session = TelemetrySession()
        tr = session.tracer
        with tr.span("outer", plane="runtime"):
            with tr.span("inner", plane="engine"):
                pass
        outer = next(s for s in tr.spans if s.name == "outer")
        inner = next(s for s in tr.spans if s.name == "inner")
        assert outer.depth == 0 and inner.depth == 1
        assert outer.child_s == pytest.approx(inner.duration)
        assert outer.self_s == pytest.approx(outer.duration - inner.duration)
        by_plane = tr.by_plane()
        assert by_plane["runtime"] + by_plane["engine"] == pytest.approx(
            tr.total_s()
        )

    def test_per_pe_tracks_nest_independently(self):
        tr = TelemetrySession().tracer
        a = tr.begin("step", pe=0)
        b = tr.begin("step", pe=1)
        tr.end(b)
        tr.end(a)
        assert all(s.depth == 0 for s in tr.spans)

    def test_plane_defaults_to_first_dotted_segment(self):
        tr = TelemetrySession().tracer
        with tr.span("fetch.commit"):
            pass
        assert tr.spans[0].plane == "fetch"

    def test_misnested_exit_recovers(self):
        tr = TelemetrySession().tracer
        outer = tr.begin("outer")
        tr.begin("leaked")  # never ended (exception unwound past it)
        tr.end(outer)
        with tr.span("next"):
            pass
        assert tr.spans[-1].depth == 0

    def test_by_name_counts(self):
        tr = TelemetrySession().tracer
        for _ in range(3):
            with tr.span("step"):
                pass
        assert tr.by_name()["step"]["count"] == 3


# ---------------------------------------------------------------------- #
# module helpers: off = no-ops, activation is exclusive
# ---------------------------------------------------------------------- #
class TestHelpers:
    def test_off_helpers_are_noops(self):
        assert not tel.enabled()
        assert tel.current() is None
        sp = tel.span("anything")
        sp.nbytes = 123  # instrumented code writes attributes freely
        with sp:
            pass
        assert tel.begin("x") is None
        tel.end(None)
        tel.count("c", 5)
        tel.gauge("g", 1.0)
        tel.observe("h", 2.0)

    def test_activate_twice_raises(self):
        with tel.active(TelemetrySession()):
            with pytest.raises(RuntimeError, match="already active"):
                tel.activate(TelemetrySession())
        assert not tel.enabled()

    def test_active_context_restores_on_error(self):
        with pytest.raises(KeyError):
            with tel.active(TelemetrySession()):
                raise KeyError("boom")
        assert not tel.enabled()

    def test_spanned_decorator(self):
        @tel.spanned("work.unit", plane="engine")
        def work():
            return 42

        assert work() == 42  # off: direct call
        with tel.active(TelemetrySession()) as session:
            assert work() == 42
        names = [s.name for s in session.tracer.spans]
        assert names == ["work.unit"]
        assert session.tracer.spans[0].plane == "engine"

    def test_count_routes_to_active_registry(self):
        with tel.active(TelemetrySession()) as session:
            tel.count("fetch.bytes", np.array([1.0, 2.0]))
            tel.count("fetch.bytes", np.array([3.0, 4.0]))
            tel.gauge("g", 5.0)
            tel.observe("h", 6.0)
        np.testing.assert_array_equal(
            session.registry["fetch.bytes"].values, [4.0, 6.0]
        )
        assert session.registry["g"].total == 5.0
        assert session.registry["h"].count == 1


# ---------------------------------------------------------------------- #
# kernel profiling hooks
# ---------------------------------------------------------------------- #
class TestKernelProfiling:
    def test_profiled_dispatcher_records_calls(self):
        from repro_torch.kernels import ops

        table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        idx = torch.tensor([0, 2], dtype=torch.int32)
        baseline = ops.gather_rows(table, idx)  # off: direct
        with tel.active(TelemetrySession()) as session:
            out = ops.gather_rows(table, idx)
        assert torch.equal(out, baseline)
        assert session.registry["kernel.gather_rows.calls"].total == 1.0
        hist = session.registry["kernel.gather_rows.seconds"]
        assert hist.count == 1 and hist.sum > 0

    def test_profile_kernels_false_skips_hook(self):
        from repro_torch.kernels import ops

        table = torch.ones((4, 3))
        idx = torch.tensor([1], dtype=torch.int32)
        with tel.active(TelemetrySession(profile_kernels=False)) as session:
            ops.gather_rows(table, idx)
        assert "kernel.gather_rows.calls" not in session.registry

    @pytest.mark.parametrize("profiler", [False, True])
    def test_aggregation_dispatchers_are_profiled(self, profiler, monkeypatch):
        """The reference's names for the two new dispatchers, timed the
        same way. Under ``torch.profiler`` each call runs inside one
        ``record_function("repro.<name>")`` range; with the profiler off
        no range is ever entered (``record_function`` made to raise)."""
        from repro_torch.kernels import ops

        table = torch.arange(20, dtype=torch.float32).reshape(5, 4)
        idx = torch.tensor([[0, 4], [1, 1]], dtype=torch.int64)

        def calls():
            with tel.active(TelemetrySession()) as session:
                mean = ops.gather_mean(table, idx)
                sums = ops.segment_sum_equal(table[:4], 2)
            return session, mean, sums

        if profiler:
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                session, mean, sums = calls()
            names = [e.name for e in prof.events()]
            for name in ("gather_mean", "segment_sum_equal"):
                assert names.count(f"repro.{name}") == 1
        else:
            def refuse(*a, **k):
                raise AssertionError("record_function entered with the profiler off")

            monkeypatch.setattr(torch.profiler, "record_function", refuse)
            session, mean, sums = calls()
        assert torch.equal(mean, (table[[0, 1]] + table[[4, 1]]) * 0.5)
        assert torch.equal(sums, table[[0, 2]] + table[[1, 3]])
        for name in ("gather_mean", "segment_sum_equal"):
            assert session.registry[f"kernel.{name}.calls"].total == 1.0
            assert session.registry[f"kernel.{name}.seconds"].count == 1


# ---------------------------------------------------------------------- #
# the contract: off is bit-identical, on never perturbs
# ---------------------------------------------------------------------- #
class TestContract:
    @pytest.fixture(scope="class")
    def ref_digest(self, ref_parts):
        t = jgnn.DistributedTrainer(ref_parts, **COMMON)
        t.run()
        return t.last_trace.exact_digest()

    @pytest.fixture(scope="class")
    def off_run(self, parts):
        t = DistributedTrainer(parts, **DEVICE)
        return t, t.run()

    @pytest.mark.parametrize("device", ["cpu", False], ids=["device-loop", "staged"])
    def test_telemetry_on_keeps_exact_digest(self, parts, off_run, ref_digest, device):
        t_off, r_off = off_run
        t_on = DistributedTrainer(parts, telemetry=True, **dict(COMMON, device=device))
        r_on = t_on.run()
        assert t_off.last_trace.exact_digest() == ref_digest
        assert t_on.last_trace.exact_digest() == ref_digest
        assert r_on.epoch_times == r_off.epoch_times
        assert r_off.telemetry is None and t_off.last_telemetry is None
        assert r_on.telemetry is not None
        planes = r_on.telemetry["spans"]["by_plane"]
        for plane in ("runtime", "engine", "sampling", "decision"):
            assert plane in planes
        counters = r_on.telemetry["metrics"]["counters"]
        assert counters["fetch.bytes_modeled"]["total"] > 0

    def test_device_path_digest_and_device_counters(self, parts, off_run):
        t_off, _ = off_run
        t_dev = DistributedTrainer(parts, telemetry=True, **DEVICE)
        r_dev = t_dev.run()
        assert (
            t_dev.last_trace.exact_digest() == t_off.last_trace.exact_digest()
        )
        counters = r_dev.telemetry["metrics"]["counters"]
        assert counters["device.h2d_bytes"]["total"] > 0
        assert counters["device.d2h_bytes"]["total"] > 0
        assert "device" in r_dev.telemetry["spans"]["by_plane"]
        assert any(k.startswith("kernel.") for k in counters)

    def test_training_step_is_timed_per_dispatcher(self, parts, ref_parts):
        """``train_model=True``: the digest with telemetry on equals the
        reference's, and every dispatcher of the GraphSAGE step is timed
        once per PE per step and per mean, plus the accuracy pass, inside
        the ``train`` plane."""
        kw = dict(COMMON, train_model=True)
        ref_tr = jgnn.DistributedTrainer(ref_parts, device="jnp", **kw)
        ref_tr.run()
        t = DistributedTrainer(parts, device="cpu", telemetry=True, **kw)
        r = t.run()
        assert t.last_trace.exact_digest() == ref_tr.last_trace.exact_digest()
        calls = 4 * t.epochs * t.mb_per_epoch + 1
        counters = r.telemetry["metrics"]["counters"]
        hists = r.telemetry["metrics"]["histograms"]
        for name in ("gather_mean", "segment_sum_equal"):
            assert counters[f"kernel.{name}.calls"]["total"] == calls
            assert hists[f"kernel.{name}.seconds"]["count"] == calls
        train = [s for s in t.last_telemetry.tracer.spans if s.name == "train"]
        assert len(train) == t.epochs * t.mb_per_epoch
        assert all(s.plane == "train" for s in train)

    def test_legacy_runtime_emits_per_pe_tracks(self, parts, off_run):
        t_off, _ = off_run
        t_leg = DistributedTrainer(
            parts, runtime="legacy", telemetry=True, **DEVICE
        )
        t_leg.run()
        assert (
            t_leg.last_trace.exact_digest() == t_off.last_trace.exact_digest()
        )
        pes = {s.pe for s in t_leg.last_telemetry.tracer.spans}
        assert pes == {-1, 0, 1, 2, 3}
        pe_steps = [s for s in t_leg.last_telemetry.tracer.spans if s.name == "pe_step"]
        assert len(pe_steps) == 4 * t_leg.epochs * t_leg.mb_per_epoch

    def test_session_passed_through_and_meta_stamped(self, parts):
        session = TelemetrySession(label="custom")
        t = DistributedTrainer(parts, telemetry=session, **DEVICE)
        result = t.run()
        assert t.last_telemetry is session
        assert result.telemetry["label"] == "custom"
        assert session.meta["variant"] == "fixed"
        assert session.meta["num_pes"] == 4
        assert not tel.enabled()  # deactivated after the run

    def test_int64_fallback_counts_and_warns_once(self, parts, monkeypatch):
        from repro_torch.kernels import ops

        t = DistributedTrainer(parts, telemetry=True, **DEVICE)
        # ids past 2^31 run device-resident in wide mode; only a universe
        # beyond WIDE_ID_MAX takes the staged fallback.
        monkeypatch.setattr(
            type(t.graph), "num_nodes",
            property(lambda self: ops.WIDE_ID_MAX + 2),
        )
        with pytest.warns(RuntimeWarning, match="int32"):
            t.run()
        counters = t.last_telemetry.registry
        assert counters["device.fallback_int64"].total == 1.0
        # second run on the same trainer: counted again, not re-warned
        import warnings as _warnings

        with _warnings.catch_warnings():
            _warnings.simplefilter("error", RuntimeWarning)
            t.telemetry = TelemetrySession()
            t.run()
        assert t.last_telemetry.registry["device.fallback_int64"].total == 1.0


# ---------------------------------------------------------------------- #
# exporters: JSONL round-trip + Chrome-trace validation
# ---------------------------------------------------------------------- #
def _check_chrome_tracks(session, tmp_path):
    """The session's Chrome trace: loads, a host track and one per PE,
    every span inside a parent on its own track."""
    path = tmp_path / "trace.json"
    session.write_chrome_trace(path)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    names = {
        e["args"]["name"]: e["tid"]
        for e in events
        if e.get("ph") == "M" and e["name"] == "thread_name"
    }
    assert names["host"] == 0
    for p in range(4):
        assert names[f"PE {p}"] == p + 1
    complete = [e for e in events if e.get("ph") == "X"]
    assert complete
    for e in complete:
        assert e["dur"] >= 0 and e["ts"] >= 0
    eps = 1e-3  # float µs rounding
    for e in complete:
        d = e["args"]["depth"]
        if d == 0:
            continue
        parents = [
            p for p in complete
            if p["tid"] == e["tid"] and p["args"]["depth"] == d - 1
            and p["ts"] - eps <= e["ts"]
            and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + eps
        ]
        assert parents, f"span {e['name']} has no enclosing parent"


class TestExport:
    @pytest.fixture(scope="class")
    def session(self, parts):
        t = DistributedTrainer(parts, telemetry=True, **DEVICE)
        t.run()
        return t.last_telemetry

    def test_jsonl_round_trip(self, session, tmp_path):
        path = write_jsonl(session, tmp_path / "run.jsonl")
        artifact = load_jsonl(path)
        assert artifact["meta"]["label"] == "fixed"
        assert artifact["meta"]["provenance"]["schema"] == 1
        assert len(artifact["spans"]) == len(session.tracer.spans)
        rows = breakdown_rows(artifact)
        assert rows and {"plane", "spans", "self_s", "bytes"} <= set(rows[0])
        table = render_table(rows)
        assert "total" in table

    def test_load_jsonl_rejects_garbage(self, tmp_path):
        bad = tmp_path / "bad.jsonl"
        bad.write_text("this is not json\n")
        with pytest.raises(ValueError, match="not a telemetry JSONL"):
            load_jsonl(bad)
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        with pytest.raises(ValueError, match="no telemetry rows"):
            load_jsonl(empty)

    def test_chrome_trace_validates(self, session, tmp_path):
        """The Chrome-trace JSON loads, every span nests within a parent
        on its track, and each PE's spans get their own thread track (the
        device loop records none: they are opened here by hand)."""
        with tel.active(session):
            for p in range(4):
                with session.tracer.span("pe_step", pe=p, plane="runtime"):
                    with session.tracer.span("fetch.commit", pe=p):
                        pass
        _check_chrome_tracks(session, tmp_path)

    def test_chrome_trace_from_loaded_artifact(self, session, tmp_path):
        jsonl = write_jsonl(session, tmp_path / "run.jsonl")
        doc = chrome_trace(load_jsonl(jsonl))
        n_complete = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        assert n_complete == len(session.tracer.spans)

    def test_port_artifact_loads_in_the_reference(self, session, tmp_path, capsys):
        path = write_jsonl(session, tmp_path / "port.jsonl")
        mine, theirs = load_jsonl(path), ref_load_jsonl(path)
        assert theirs == mine
        assert theirs["meta"]["provenance"]["torch"] == torch.__version__
        assert ref_tel_main(["summary", str(path)]) == 0
        assert "total" in capsys.readouterr().out

    def test_reference_artifact_loads_in_the_port(self, ref_parts, tmp_path, capsys):
        from repro.telemetry import TelemetrySession as RefSession

        ref_session = RefSession(label="reference")
        t = jgnn.DistributedTrainer(ref_parts, telemetry=ref_session, **COMMON)
        t.run()
        path = ref_write_jsonl(ref_session, tmp_path / "ref.jsonl")
        mine, theirs = load_jsonl(path), ref_load_jsonl(path)
        assert mine == theirs
        assert mine["meta"]["label"] == "reference"
        assert len(mine["spans"]) == len(ref_session.tracer.spans)
        assert breakdown_rows(mine)
        assert tel_main(["summary", str(path)]) == 0
        assert "# run: reference" in capsys.readouterr().out
        out = tmp_path / "ref_trace.json"
        assert tel_main(["chrome", str(path), "--out", str(out)]) == 0
        capsys.readouterr()
        assert json.loads(out.read_text())["traceEvents"]


class TestLegacyExport:
    """The exporters on a legacy-runtime session, as the reference's
    ``TestExport``: its per-PE tracks are the run's own."""

    @pytest.fixture(scope="class")
    def session(self, parts):
        t = DistributedTrainer(parts, runtime="legacy", telemetry=True, **DEVICE)
        t.run()
        return t.last_telemetry

    test_jsonl_round_trip = TestExport.test_jsonl_round_trip
    test_chrome_trace_from_loaded_artifact = TestExport.test_chrome_trace_from_loaded_artifact
    test_port_artifact_loads_in_the_reference = (
        TestExport.test_port_artifact_loads_in_the_reference
    )

    def test_chrome_trace_validates(self, session, tmp_path):
        _check_chrome_tracks(session, tmp_path)


# ---------------------------------------------------------------------- #
# CLI
# ---------------------------------------------------------------------- #
class TestCLI:
    @pytest.fixture(scope="class")
    def artifact(self, parts, tmp_path_factory):
        t = DistributedTrainer(parts, telemetry=True, **DEVICE)
        t.run()
        path = tmp_path_factory.mktemp("tel") / "run.jsonl"
        write_jsonl(t.last_telemetry, path)
        return str(path)

    def test_summary(self, artifact, capsys):
        assert tel_main(["summary", artifact]) == 0
        out = capsys.readouterr().out
        assert "plane" in out and "total" in out and "# run:" in out

    def test_summary_json(self, artifact, tmp_path, capsys):
        out_json = str(tmp_path / "rows.json")
        assert tel_main(["summary", artifact, "--json", out_json]) == 0
        rows = json.load(open(out_json))["rows"]
        assert any(r["plane"] == "engine" for r in rows)
        capsys.readouterr()

    def test_chrome(self, artifact, tmp_path, capsys):
        out = str(tmp_path / "trace.json")
        assert tel_main(["chrome", artifact, "--out", out]) == 0
        doc = json.loads(open(out).read())
        assert doc["traceEvents"]
        capsys.readouterr()

    def test_missing_artifact_exits_2(self, capsys):
        assert tel_main(["summary", "/nonexistent/run.jsonl"]) == 2
        assert "error:" in capsys.readouterr().err

    def test_garbage_artifact_exits_2(self, tmp_path, capsys):
        bad = tmp_path / "bad.jsonl"
        bad.write_text("nope\n")
        assert tel_main(["summary", str(bad)]) == 2
        assert "error:" in capsys.readouterr().err

    def test_unknown_subcommand_exits_2(self):
        with pytest.raises(SystemExit) as exc:
            tel_main(["frobnicate"])
        assert exc.value.code == 2


# ---------------------------------------------------------------------- #
# calibration
# ---------------------------------------------------------------------- #
class TestCalibration:
    def test_recovers_known_constants(self):
        rng = np.random.default_rng(0)
        alpha, bw = 5e-4, 1e6
        nbytes = rng.integers(1_000, 500_000, size=64)
        seconds = alpha + nbytes / bw
        cal = fit_alpha_bw(nbytes, seconds)
        assert cal.alpha == pytest.approx(alpha, rel=1e-6)
        assert cal.link_bw == pytest.approx(bw, rel=1e-6)
        assert cal.max_abs_err_s < 1e-9
        np.testing.assert_allclose(cal.predict(nbytes), seconds)

    def test_zero_byte_samples_dropped(self):
        nbytes = [0, 0, 100, 200]
        seconds = [9.0, 9.0, 1e-3, 2e-3]
        cal = fit_alpha_bw(nbytes, seconds)
        assert cal.n_samples == 2

    def test_needs_two_distinct_byte_counts(self):
        with pytest.raises(ValueError, match="distinct"):
            fit_alpha_bw([100, 100], [1.0, 1.0])

    def test_noise_degenerates_gracefully(self):
        from repro_torch.telemetry import calibrate as _cal_mod

        _cal_mod._warned_degenerate_fit = False
        with pytest.warns(RuntimeWarning, match="non-positive slope"):
            cal = fit_alpha_bw([100, 200, 300], [3e-3, 2e-3, 1e-3])
        assert cal.link_bw == float("inf")
        assert cal.alpha == pytest.approx(2e-3)

    def test_degenerate_fit_warns_once(self):
        import warnings as _warnings

        from repro_torch.telemetry import calibrate as _cal_mod

        _cal_mod._warned_degenerate_fit = False
        with pytest.warns(RuntimeWarning, match="non-positive slope"):
            fit_alpha_bw([100, 200, 300], [3e-3, 2e-3, 1e-3])
        with _warnings.catch_warnings():
            _warnings.simplefilter("error", RuntimeWarning)
            cal = fit_alpha_bw([100, 200, 300], [5e-3, 4e-3, 3e-3])
        assert cal.link_bw == float("inf")
        assert cal.alpha == pytest.approx(4e-3)

    def test_healthy_fit_does_not_warn(self):
        import warnings as _warnings

        from repro_torch.telemetry import calibrate as _cal_mod

        _cal_mod._warned_degenerate_fit = False
        with _warnings.catch_warnings():
            _warnings.simplefilter("error", RuntimeWarning)
            cal = fit_alpha_bw([100, 200, 300], [1e-3, 2e-3, 3e-3])
        assert np.isfinite(cal.link_bw)

    def test_to_time_model(self):
        from repro_torch.gnn.train import TimeModel

        cal = Calibration(
            alpha=1e-3, link_bw=2e6, n_samples=10, max_abs_err_s=0.0
        )
        tm = cal.to_time_model(t_ddp=0.1)
        assert isinstance(tm, TimeModel)
        assert tm.alpha == 1e-3 and tm.link_bw == 2e6 and tm.t_ddp == 0.1

    def test_calibrate_from_store_trace(self, parts):
        t = DistributedTrainer(parts, feature_store=True, **DEVICE)
        t.run()
        cal = calibrate_from_trace(t.last_trace)
        assert cal.n_samples >= 2
        assert cal.alpha >= 0.0
        assert np.isfinite(cal.alpha)

    def test_calibrate_from_trace_needs_store_streams(self, parts):
        t = DistributedTrainer(parts, **DEVICE)
        t.run()
        with pytest.raises(ValueError, match="measured store streams"):
            calibrate_from_trace(t.last_trace)

    def test_calibrate_from_session(self, parts):
        t = DistributedTrainer(
            parts, feature_store=True, telemetry=True, **DEVICE
        )
        t.run()
        cal = calibrate_from_session(t.last_telemetry)
        assert cal.n_samples >= 2

    def test_calibrate_from_empty_session_raises(self):
        with pytest.raises(ValueError, match="store.gather"):
            calibrate_from_session(TelemetrySession())


# ---------------------------------------------------------------------- #
# provenance + agent-lane integration
# ---------------------------------------------------------------------- #
class TestIntegration:
    def test_provenance_header(self):
        p = provenance()
        assert p["schema"] == 1
        for key in ("git_sha", "platform", "python", "torch", "cuda", "numpy", "device"):
            assert isinstance(p[key], str) and p[key]
        assert p["torch"] == torch.__version__
        assert p["device"] == (
            torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        )
        assert "jax" not in p
        json.dumps(p)

    def test_agent_lane_spans_and_pipe_counters(self):
        from repro_torch.core import LLMAgent, make_backend

        g = generate("products", seed=0, scale=0.05)
        parts = partition_graph(g, 2)
        deciders = [LLMAgent(make_backend("gemma3-4b"), None) for _ in range(2)]
        t = DistributedTrainer(
            parts, variant="rudder", deciders=deciders, telemetry=True,
            epochs=1, batch_size=8, fanouts=(3, 5), train_model=False,
            buffer_frac=0.25, interval=4, device="cpu",
        )
        t.run()
        summary = t.last_telemetry.summary()
        counters = summary["metrics"]["counters"]
        assert counters["agent.requests"]["total"] > 0
        assert "agent" in summary["spans"]["by_plane"]
        assert counters["pipe.submitted"]["total"] > 0
        assert counters["pipe.ready"]["total"] > 0
        assert len(counters["pipe.submitted"]["values"]) == 2
