"""The port's legacy runtime against the reference's, on the CPU.

``repro_torch.gnn.DistributedTrainer(runtime="legacy")`` is the
reference's one-PE-at-a-time loop (``run_legacy``): per-PE
``PersistentBuffer`` lookups and replacement rounds on the host, the
store's two batched gathers after the PE loop, the GraphSAGE step on the
trainer's device. Mirrors the reference's ``tests/test_runtime_parity.py``
(all four variants, sync mode, the three topologies, the event engine's
closed-form parity, the engine-vs-buffer stats) and the legacy cases of
``test_feature_store.py``, ``test_gnn_train.py`` (zero epochs),
``test_policies.py`` and ``test_sim.py``. Each case compares four runs:
the reference's legacy, the port's legacy, and the port's vectorized
runtime on ``device="cpu"`` (the device-resident loop through the plain
versions) and on ``device=False`` (the staged host loop).

Tolerance: none on streams, ``epoch_times``, stats and digests (every
comparison is ``==``); with GraphSAGE training on, losses
``rtol=1e-5, atol=1e-6`` against the reference (float32 sums in another
order, compounded over the SGD steps) and equal to the port's vectorized
run (the same ``driver.train_step`` on the same inputs).
"""

from dataclasses import asdict

import jax
import numpy as np
import pytest

import repro.gnn as jgnn
import repro.graph as jgraph
from repro.core import scoring as jscoring
from repro.store import FeatureStore as JStore
from repro_torch import telemetry as tel
from repro_torch.gnn import DistributedTrainer
from repro_torch.graph import generate, partition_graph
from repro_torch.store import FeatureStore

VARIANTS = ["distdgl", "fixed", "massivegnn", "rudder"]
COMMON = dict(epochs=4, batch_size=16, train_model=False, buffer_frac=0.25)
RTOL, ATOL = 1e-5, 1e-6
PORT_RUNS = (("legacy", "cpu"), ("vectorized", "cpu"), ("vectorized", False))


def _pair(dataset, scale, num_parts, seed=0):
    ref = jgraph.partition_graph(jgraph.generate(dataset, seed=seed, scale=scale), num_parts)
    port = partition_graph(generate(dataset, seed=seed, scale=scale), num_parts)
    return ref, port


@pytest.fixture(scope="module")
def parts():
    return _pair("products", 0.15, 4)


def _kw(variant, **extra):
    kw = dict(COMMON, **extra)
    if variant == "rudder":
        kw["deciders"] = ["gemma3-4b"]
    return kw


def _all_runs(pair, variant, **extra):
    """The reference's legacy run, then the port's three (see the module
    note), each a fresh trainer; returns ``[(trainer, result), ...]``."""
    ref_parts, port_parts = pair
    kw = _kw(variant, **extra)
    ref_tr = jgnn.DistributedTrainer(ref_parts, variant=variant, runtime="legacy", **kw)
    out = [(ref_tr, ref_tr.run())]
    for runtime, device in PORT_RUNS:
        tr = DistributedTrainer(
            port_parts, variant=variant, runtime=runtime, device=device, **kw
        )
        out.append((tr, tr.run()))
    return out


def _assert_identical(runs):
    (_, want), *rest = runs
    for _, got in rest:
        assert len(got.logs) == len(want.logs)
        for p, (a, b) in enumerate(zip(got.logs, want.logs)):
            assert asdict(a) == asdict(b), f"PE {p}"
        assert got.epoch_times == want.epoch_times


class TestRuntimeParity:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_bit_identical_logs(self, parts, variant):
        _assert_identical(_all_runs(parts, variant))

    @pytest.mark.parametrize("variant", ["fixed", "rudder"])
    def test_sync_mode_parity(self, parts, variant):
        _assert_identical(_all_runs(parts, variant, mode="sync", epochs=2))

    @pytest.mark.parametrize("topology", ["flat", "rack", "torus"])
    def test_topology_parity(self, parts, topology):
        _assert_identical(_all_runs(parts, "fixed", topology=topology, epochs=3))

    @pytest.mark.parametrize("mode", ["async", "sync"])
    def test_event_engine_parity_legacy_runtime(self, parts, mode):
        """The event engine reproduces the closed form on the legacy loop."""
        _, port = parts
        kw = _kw("rudder", mode=mode, epochs=3)
        cf = DistributedTrainer(port, variant="rudder", runtime="legacy", device="cpu",
                                **kw).run()
        ev = DistributedTrainer(port, variant="rudder", runtime="legacy", device="cpu",
                                time_engine="event", **kw).run()
        for a, b in zip(cf.logs, ev.logs):
            assert a.step_time == b.step_time
        assert cf.epoch_times == ev.epoch_times
        assert cf.sim_events is None and len(ev.sim_events) > 0

    def test_engine_stats_match_buffer_stats(self, parts):
        """The vectorized engine's stats equal the summed legacy buffers'."""
        ref, port = parts
        leg = DistributedTrainer(port, variant="fixed", runtime="legacy", device="cpu",
                                 **COMMON)
        leg.run_legacy()
        ref_leg = jgnn.DistributedTrainer(ref, variant="fixed", runtime="legacy", **COMMON)
        ref_leg.run_legacy()
        vec = DistributedTrainer(port, variant="fixed", device="cpu", **COMMON)
        vec.run()
        for p, (buf, ref_buf) in enumerate(zip(leg.buffers, ref_leg.buffers)):
            assert asdict(buf.stats) == asdict(ref_buf.stats)
            assert vec.engine.stats.lookups[p] == buf.stats.lookups
            assert vec.engine.stats.hits[p] == buf.stats.hits
            assert vec.engine.stats.misses[p] == buf.stats.misses
            assert vec.engine.stats.replaced_total[p] == buf.stats.replaced_total
            np.testing.assert_array_equal(buf.ids_snapshot(), ref_buf.ids_snapshot())
            assert buf.scores_snapshot().tobytes() == ref_buf.scores_snapshot().tobytes()

    def test_legacy_on_the_host_equals_cpu(self, parts):
        """``device=False`` and ``device="cpu"`` run the same host loop."""
        _, port = parts
        a = DistributedTrainer(port, variant="rudder", runtime="legacy", device=False,
                               **_kw("rudder")).run()
        b = DistributedTrainer(port, variant="rudder", runtime="legacy", device="cpu",
                               **_kw("rudder")).run()
        assert [asdict(x) for x in a.logs] == [asdict(x) for x in b.logs]
        assert a.epoch_times == b.epoch_times


@pytest.mark.parametrize("with_store", [False, True], ids=["table", "store"])
def test_training_matches_reference(with_store):
    """``train_model=True``: the reference's weights carried across; the
    losses and accuracy of the port's legacy run against the reference's
    legacy run, and equal to the port's vectorized run; one aggregation
    dispatcher call per PE, step and mean, plus the accuracy pass."""
    ref_parts, port_parts = _pair("arxiv", 0.08, 2, seed=1)
    kw = dict(variant="fixed", epochs=2, batch_size=16, train_model=True,
              buffer_frac=0.25, seed=7)
    store = JStore.for_partitions(ref_parts, backend="numpy") if with_store else None
    ref_tr = jgnn.DistributedTrainer(ref_parts, runtime="legacy", feature_store=store, **kw)
    init = jax.tree_util.tree_map(np.asarray, ref_tr.params)
    ref_run = ref_tr.run()
    runs = {}
    for runtime in ("legacy", "vectorized"):
        port_store = (
            FeatureStore.for_partitions(port_parts, device="cpu") if with_store else None
        )
        tr = DistributedTrainer(port_parts, runtime=runtime, device="cpu", init_params=init,
                                feature_store=port_store, **kw)
        session = tel.TelemetrySession()
        with tel.active(session):
            runs[runtime] = (tr, tr.run(), session.registry)
    leg_tr, leg, reg = runs["legacy"]
    _, vec, _ = runs["vectorized"]
    for p, (a, b) in enumerate(zip(leg.logs, ref_run.logs)):
        for f in ("pct_hits", "comm_volume", "decisions", "feat_sums", "bytes_measured"):
            assert getattr(a, f) == getattr(b, f), f"PE {p} {f}"
    assert len(leg.losses) == len(ref_run.losses) == 2 * leg_tr.mb_per_epoch
    np.testing.assert_allclose(leg.losses, ref_run.losses, rtol=RTOL, atol=ATOL)
    assert leg.accuracy == pytest.approx(ref_run.accuracy, abs=1e-6)
    assert leg.losses == vec.losses and leg.accuracy == vec.accuracy
    calls = 2 * leg_tr.epochs * leg_tr.mb_per_epoch + 1
    gm = reg["kernel.gather_mean.calls"].total if "kernel.gather_mean.calls" in reg else 0
    assert gm == (0 if with_store else calls)
    assert reg["kernel.segment_sum_equal.calls"].total == (2 if with_store else 1) * calls


# --------------------------------------------------------------------------- #
# The legacy cases of the reference's other suites.
@pytest.fixture(scope="module")
def small_parts():
    return _pair("products", 0.05, 2)


def _store_run(parts, runtime, package):
    kw = dict(variant="fixed", mode="async", batch_size=8, fanouts=(3, 5), epochs=2,
              train_model=False, trace=True, runtime=runtime, feature_store=True)
    if package == "ref":
        return jgnn.DistributedTrainer(parts, **kw).run()
    return DistributedTrainer(parts, device="cpu", **kw).run()


def test_legacy_and_vectorized_store_streams_identical(small_parts):
    """``test_feature_store.py:203``: the store's deterministic family and
    the exact digest match across runtimes and packages."""
    ref, port = small_parts
    leg = _store_run(port, "legacy", "port")
    vec = _store_run(port, "vectorized", "port")
    ref_leg = _store_run(ref, "legacy", "ref")
    deterministic = ("feat_sums", "bytes_measured", "bytes_modeled")
    for run in (vec, ref_leg):
        assert leg.trace.exact_digest() == run.trace.exact_digest()
        assert leg.trace.digest(deterministic) == run.trace.digest(deterministic)
    assert leg.total_bytes_measured == leg.total_bytes_modeled > 0
    assert leg.total_fetch_seconds > 0.0


def test_zero_epoch_legacy_matches(parts):
    """``test_gnn_train.py:119``: an empty legacy run's aggregates are NaN."""
    _, port = parts
    r = DistributedTrainer(port, variant="fixed", epochs=0, batch_size=16,
                           train_model=False, runtime="legacy", device="cpu").run()
    assert np.isnan(r.mean_epoch_time)
    assert np.isnan(r.steady_pct_hits)
    assert np.isnan(r.comm_p99())
    assert r.epoch_times == [] and all(log.pct_hits == [] for log in r.logs)


@pytest.fixture(scope="module")
def policy_parts():
    return _pair("products", 0.1, 2, seed=3)


@pytest.mark.parametrize("name", sorted(jscoring.POLICIES))
def test_policy_legacy_vs_vectorized_bit_identical(policy_parts, name):
    """``test_policies.py:130``, every scoring policy."""
    _assert_identical(_all_runs(
        policy_parts, "massivegnn", epochs=2, interval=4, policy=name,
    ))


@pytest.fixture(scope="module")
def sim_parts():
    return _pair("products", 0.12, 4)


def test_vectorized_and_legacy_identical_under_scenarios(sim_parts):
    """``test_sim.py:198``: stragglers and congestion on the event engine."""
    kw = dict(epochs=3, time_engine="event", stragglers="jitter", congestion="hot-home")
    runs = _all_runs(sim_parts, "fixed", **kw)
    _assert_identical(runs)
    want = runs[0][1].sim_events.as_tuples()
    for _, run in runs[1:]:
        assert run.sim_events.as_tuples() == want


@pytest.mark.parametrize(
    "scenario", [dict(stragglers="one-slow"), dict(congestion="hot-home")],
    ids=["one-slow", "hot-home"],
)
def test_sim_events_trace_byte_stable(sim_parts, scenario):
    """``test_sim.py:233``: the whole trace, the serialized event timeline
    included, byte-stable across runtimes and against the reference."""
    from repro_torch.trace import diff_traces

    ref, port = sim_parts
    kw = dict(variant="fixed", time_engine="event", trace=True, epochs=3, batch_size=16,
              train_model=False, buffer_frac=0.25, **scenario)
    traces = []
    for runtime in ("vectorized", "legacy"):
        tr = DistributedTrainer(port, runtime=runtime, device="cpu", **kw)
        assert tr.run().sim_events is not None
        assert "ev_step" in tr.last_trace.arrays
        traces.append(tr.last_trace)
    ref_tr = jgnn.DistributedTrainer(ref, runtime="legacy", **kw)
    ref_tr.run()
    vec, leg = traces
    assert vec.digest() == leg.digest() == ref_tr.last_trace.digest()
    assert diff_traces(vec, leg).identical


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(runtime="legacy", readback_every=2), "readback_every"),
        (dict(runtime="eager"), "runtime must be"),
    ],
    ids=["legacy-cadence", "unknown-runtime"],
)
def test_invalid_legacy_options_raise(parts, kwargs, match):
    _, port = parts
    with pytest.raises(ValueError, match=match):
        DistributedTrainer(port, variant="fixed", device="cpu", **dict(COMMON, **kwargs))
