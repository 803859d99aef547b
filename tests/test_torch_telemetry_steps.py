"""The port's telemetry inside a training step, on the CPU device loop.

Every phase of a step and of a ``run()`` call is a span: the sampler's
draws and expansion (``sample.draw`` / ``sample.expand``), the fetch
stage's host work around the launch (``fetch.pack`` / ``fetch.unpack`` /
``fetch.account``), the readback's wait (``device.wait``), the store's
miss gather (``fetch.gather``), the train step's inputs and loss wait
(``train.features`` / ``train.wait``) and each call's own work
(``call.engine`` / ``call.accuracy`` / ``call.sync``). Each span carries
its ``step``, ``id`` and ``parent``; under ``torch.profiler`` each span and
each dispatcher call is one ``repro.<name>`` range, and with the profiler
off none is entered. Kernel profiling times by CUDA event pairs and never
synchronises; copies between host and device are counted by site. A
duck-typed session with the older ``begin(name, pe, plane)`` signature
still drives the loop.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.telemetry.export import write_jsonl as ref_write_jsonl
from repro_torch import telemetry as tel
from repro_torch.gnn.train import DistributedTrainer
from repro_torch.graph import generate, partition_graph
from repro_torch.telemetry import SpanTracer, TelemetrySession
from repro_torch.telemetry.cli import main as tel_main
from repro_torch.telemetry.export import chrome_trace, load_jsonl, step_rows, write_jsonl

P = 4
RUN = dict(
    variant="fixed", epochs=2, batch_size=16, fanouts=(3, 5), train_model=True,
    buffer_frac=0.25, interval=4, device="cpu",
)
#: Spans a step holds once each (``device.readback`` once more with a
#: store when the step's probe hit: ``pull_rows``' hit-row copy).
ONCE = ("decision", "fused.step", "fetch.pack", "device.launch", "device.readback",
        "device.wait", "fetch.unpack", "fetch.account", "train")
#: The next step's sample, drawn inside every step but the last.
SAMPLED = ("sample", "sample.draw", "sample.expand")
#: Spans of the call, outside every step.
CALL = ("call.engine", "fused.prime", "call.accuracy", "call.sync")


@pytest.fixture(autouse=True)
def _no_leaked_session():
    yield
    tel.deactivate()


@pytest.fixture(scope="module")
def parts():
    return partition_graph(generate("products", seed=0, scale=0.1), P)


def _store(parts, store: bool):
    """The benchmark's store (its gather on the kernel route), or none."""
    if not store:
        return False
    from repro_torch.store import FeatureStore

    return FeatureStore.for_partitions(parts, device="cpu", use_kernel=True)


def _run(parts, store: bool):
    t = DistributedTrainer(
        parts, feature_store=_store(parts, store), telemetry=TelemetrySession(), **RUN
    )
    result = t.run()
    return t, result


@pytest.fixture(scope="module", params=[False, True], ids=["table", "store"])
def traced(request, parts):
    t, result = _run(parts, request.param)
    return request.param, t, result, t.last_telemetry


def _by_id(session) -> dict:
    return {sp.id: sp for sp in session.tracer.spans}


def _ancestors(sp, by_id):
    while sp.parent >= 0:
        sp = by_id[sp.parent]
        yield sp


# ---------------------------------------------------------------------- #
# the spans of a step and of a call
# ---------------------------------------------------------------------- #
def test_every_new_span_appears_per_step(traced):
    store, t, _, session = traced
    total = t.epochs * t.mb_per_epoch
    spans = session.tracer.spans
    pulls = 0
    for s in range(total):
        inside = [sp.name for sp in spans if sp.step == s]
        assert inside.count("step") == 1
        for name in ONCE:
            n = inside.count(name)
            if store and name == "device.readback":
                assert n in (1, 2), s
                pulls += n - 1
            else:
                assert n == 1, (s, name)
        for name in SAMPLED:
            assert inside.count(name) == (1 if s + 1 < total else 0), (s, name)
        assert inside.count("train.features") == P
        assert inside.count("train.wait") == P
        assert inside.count("fetch.gather") == (1 if store else 0)
    assert pulls > 0 or not store


def test_call_spans_lie_outside_steps(traced):
    _, t, _, session = traced
    spans = session.tracer.spans
    steps = [sp for sp in spans if sp.name == "step"]
    outside = [sp.name for sp in spans if sp.step == -1]
    for name in CALL + ("run",) + SAMPLED:
        assert outside.count(name) == 1, name
    # The prime's launch: packed, waited on and unpacked outside the steps.
    for name in ("fetch.pack", "device.wait", "fetch.unpack"):
        assert outside.count(name) == 1, name
    assert "fetch.account" not in outside and "train.features" not in outside
    for sp in spans:
        if sp.name in CALL:
            assert all(sp.t1 <= st.t0 or sp.t0 >= st.t1 for st in steps), sp.name


def test_spans_carry_step_and_parent(traced):
    _, t, _, session = traced
    by_id = _by_id(session)
    ids = [sp.id for sp in session.tracer.spans]
    assert sorted(ids) == list(range(len(ids)))
    for sp in session.tracer.spans:
        if sp.parent >= 0:
            parent = by_id[sp.parent]
            assert parent.pe == sp.pe and parent.depth == sp.depth - 1
            assert parent.t0 <= sp.t0 and sp.t1 <= parent.t1
        else:
            assert sp.depth == 0
        up = [a for a in _ancestors(sp, by_id) if a.name == "step"]
        if sp.name == "step":
            assert not up and sp.step >= 0
            assert by_id[sp.parent].name == "run"
        elif sp.step >= 0:
            assert [a.step for a in up] == [sp.step]
        else:
            assert not up


def test_train_features_only_in_the_train_step(traced):
    _, t, _, session = traced
    by_id = _by_id(session)
    feats = [sp for sp in session.tracer.spans if sp.name == "train.features"]
    assert len(feats) == P * t.epochs * t.mb_per_epoch
    for sp in feats:
        assert by_id[sp.parent].name == "train"
    (acc,) = [sp for sp in session.tracer.spans if sp.name == "call.accuracy"]
    assert not [sp for sp in session.tracer.spans
                if sp.parent == acc.id and sp.name.startswith("train")]


def test_rows_and_chrome_args_carry_the_ids(traced, tmp_path):
    _, _, _, session = traced
    path = write_jsonl(session, tmp_path / "run.jsonl")
    art = load_jsonl(path)
    rows = {r["id"]: r for r in art["spans"]}
    for sp in session.tracer.spans:
        assert (rows[sp.id]["parent"], rows[sp.id]["step"]) == (sp.parent, sp.step)
    args = [e["args"] for e in chrome_trace(art)["traceEvents"] if e.get("ph") == "X"]
    assert {a["id"] for a in args} == set(rows)
    assert all({"parent", "step", "depth"} <= set(a) for a in args)


# ---------------------------------------------------------------------- #
# copies by site
# ---------------------------------------------------------------------- #
def test_copies_by_site_sum_to_the_totals(traced):
    store, t, _, session = traced
    reg = session.registry
    for way in ("h2d", "d2h"):
        total = reg[f"device.{way}_bytes"].total
        parts_ = [reg[n].total for n in reg.names() if n.startswith(f"device.{way}_bytes.")]
        assert total > 0 and sum(parts_) == total
    sites = {n.split(".", 2)[2] for n in reg.names() if n.startswith("device.h2d_bytes.")}
    sites |= {n.split(".", 2)[2] for n in reg.names() if n.startswith("device.d2h_bytes.")}
    assert {"engine.frontier", "engine.packed", "engine.state"} <= sites
    if store:
        assert {"engine.hit_rows", "engine.hit_index", "store.index", "store.rows",
                "store.ids"} <= sites
    else:
        assert {"train.ids", "train.seeds"} <= sites
    # The engine's audit keeps its own counts; telemetry adds sites to it.
    dev = t.last_device_engine
    audited = reg["device.d2h_bytes.engine.packed"].total
    if store:
        audited += reg["device.d2h_bytes.engine.hit_rows"].total
    assert dev.transfers["d2h_bytes"] == audited
    assert dev.transfers["h2d_bytes"] == reg["device.h2d_bytes.engine.frontier"].total


def test_breakdown_counts_device_bytes_once(traced, tmp_path):
    from repro_torch.telemetry.export import breakdown_rows

    _, _, _, session = traced
    art = load_jsonl(write_jsonl(session, tmp_path / "run.jsonl"))
    (row,) = [r for r in breakdown_rows(art) if r["plane"] == "device"]
    reg = session.registry
    assert row["bytes"] == reg["device.h2d_bytes"].total + reg["device.d2h_bytes"].total


# ---------------------------------------------------------------------- #
# the profiler's clock
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("profiler", [False, True], ids=["profiler-off", "profiler-on"])
def test_profiler_ranges_one_per_span_and_call(parts, profiler, monkeypatch, tmp_path):
    if not profiler:
        def refuse(*a, **k):
            raise AssertionError("record_function entered with the profiler off")

        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        t, _ = _run(parts, True)
        assert t.last_telemetry.tracer.spans
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t, _ = _run(parts, True)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ranges: dict = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("repro."):
            ranges[e["name"]] = ranges.get(e["name"], 0) + 1
    session = t.last_telemetry
    spans: dict = {}
    for sp in session.tracer.spans:
        spans[f"repro.{sp.name}"] = spans.get(f"repro.{sp.name}", 0) + 1
    reg = session.registry
    calls = {
        f"repro.{n[len('kernel.'):-len('.calls')]}": int(reg[n].total)
        for n in reg.names() if n.startswith("kernel.") and n.endswith(".calls")
    }
    assert calls and not set(calls) & set(spans)
    assert ranges == {**spans, **calls}


def test_misnested_exit_closes_the_dropped_ranges():
    tracer = SpanTracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        outer = tracer.begin("outer")
        tracer.begin_step("step", 7)
        tracer.begin("inner")
        tracer.end(outer)  # the step and inner unwound past
        after = tracer.begin("after")
        tracer.end(after)
    names = [e.name for e in prof.events()]
    for name in ("outer", "step", "inner", "after"):
        assert names.count(f"repro.{name}") == 1
    assert after.step == -1 and after.parent == -1


def test_no_session_enters_no_range_event_or_sync(parts, monkeypatch):
    """Telemetry off: the loop runs under a recording profiler without a
    ``record_function``, a CUDA event or a synchronise of its own."""
    def refuse(*a, **k):
        raise AssertionError("called with telemetry off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = DistributedTrainer(parts, feature_store=_store(parts, True), **RUN)
        result = t.run()
    assert result.telemetry is None and len(result.losses) == t.epochs * t.mb_per_epoch


# ---------------------------------------------------------------------- #
# device time without a sync; the readback's wait
# ---------------------------------------------------------------------- #
class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: each record takes the next
    tick of a clock in ms."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None
        self.synced = False

    def record(self, stream=None):
        _FakeEvent.clock[0] += 1.5
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return end.t - self.t


def test_profile_call_never_synchronizes(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.telemetry import session as session_mod

    def refuse(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(session_mod, "_on_cuda", lambda out: True)
    table = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    idx = torch.tensor([[0, 4], [1, 1]], dtype=torch.int64)
    with tel.active(TelemetrySession()) as session:
        for _ in range(3):
            ops.gather_mean(table, idx)
    reg = session.registry
    assert reg["kernel.gather_mean.calls"].total == 3
    assert "kernel.gather_mean.seconds" not in reg  # kept, not resolved yet
    summary = session.summary()
    hist = summary["metrics"]["histograms"]["kernel.gather_mean.seconds"]
    assert hist["count"] == 3 and hist["sum"] == pytest.approx(3 * 1.5e-3)


def test_readback_waits_on_an_event_only_with_a_session(monkeypatch):
    class Device:
        type = "cuda"

    made = []

    class Event(_FakeEvent):
        def __init__(self, *a, **k):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    assert tel.mark(Device()) is None and not made
    tel.wait(None)
    with tel.active(TelemetrySession()) as session:
        assert tel.mark(torch.device("cpu")) is None
        event = tel.mark(Device())
        assert made == [event] and not event.synced
        with session.tracer.span("device.readback"):
            tel.wait(event)
    assert event.synced
    wait, readback = session.tracer.spans
    assert (wait.name, readback.name) == ("device.wait", "device.readback")
    assert wait.parent == readback.id


# ---------------------------------------------------------------------- #
# the steps subcommand
# ---------------------------------------------------------------------- #
def test_steps_subcommand_lists_the_longest_steps(traced, tmp_path, capsys):
    _, t, _, session = traced
    path = write_jsonl(session, tmp_path / "run.jsonl")
    rows = step_rows(load_jsonl(path), top=2)
    steps = sorted((sp for sp in session.tracer.spans if sp.name == "step"),
                   key=lambda sp: sp.duration, reverse=True)
    assert [r["step"] for r in rows] == [sp.step for sp in steps[:2]]
    assert {"decision", "fused.step", "train"} <= set(rows[0]["phases"])
    for r in rows:
        kids = sum(ph["ms"] for ph in r["phases"].values())
        assert r["self_ms"] == pytest.approx(max(r["ms"] - kids, 0.0), abs=1e-9)
    assert tel_main(["steps", str(path), "--top", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    heads = [line for line in out if line.startswith("step ")]
    assert len(heads) == 2 and f"step {rows[0]['step']:>6d}" in heads[0]
    assert any(line.strip().startswith("fused.step") for line in out)


def test_steps_subcommand_refuses_spans_without_ids(tmp_path, capsys):
    ref_parts = jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.05), 2)
    from repro.telemetry import TelemetrySession as RefSession

    session = RefSession(label="reference")
    jgnn.DistributedTrainer(
        ref_parts, variant="fixed", epochs=1, batch_size=8, fanouts=(3, 5),
        train_model=False, telemetry=session,
    ).run()
    path = ref_write_jsonl(session, tmp_path / "ref.jsonl")
    assert tel_main(["steps", str(path)]) == 2
    assert "no ids" in capsys.readouterr().err


# ---------------------------------------------------------------------- #
# a duck-typed session of the older signature
# ---------------------------------------------------------------------- #
class _OldSpans:
    """A session whose tracer takes ``begin(name, pe, plane)`` and no step
    id, as ``chip_smoke.StageClock`` does."""

    profile_kernels = False

    def __init__(self):
        self.tracer = self
        self.registry = self
        self.names: list[str] = []

    def span(self, name, pe=-1, plane="", nbytes=0):
        return _OldSpan(self, name)

    def begin(self, name, pe=-1, plane=""):
        return _OldSpan(self, name).__enter__()

    def counter(self, name, shape=None):
        return self

    def add(self, value):
        pass


class _OldSpan:
    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.owner.names.append(self.name)
        return False


@pytest.mark.parametrize("store", [False, True], ids=["table", "store"])
def test_old_signature_session_drives_the_loop(parts, store):
    t = DistributedTrainer(parts, feature_store=_store(parts, store), **RUN)
    spans = _OldSpans()
    with tel.active(spans):
        result = t.run()
    total = t.epochs * t.mb_per_epoch
    assert len(result.losses) == total and np.isfinite(result.losses).all()
    assert spans.names.count("step") == total
    assert spans.names.count("train.wait") == P * total
