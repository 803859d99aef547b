"""Trace capture through the port, held to the committed goldens.

* All 8 goldens under ``tests/golden/`` (4 controller variants x async /
  sync) re-recorded by the port's trainer on ``device="cpu"`` and on the
  staged loop (``device=False``), modeled and with
  ``feature_store=True``: each ``exact_digest()`` equals the committed
  golden's, and the store runs measure exactly the modeled bytes
  (``bytes_measured == bytes_modeled``).
* The goldens again on the legacy runtime (``runtime="legacy"``),
  modeled and with the store; the legacy and vectorized runtimes record
  the same whole trace (``digest()``) for every variant and mode, equal
  to the reference's legacy trace; ``replay --runtime legacy`` through
  the CLI.
* A ragged-seed-block trace recorded by the port equals the reference's
  (``device="jnp"``) under ``diff_traces`` on the exact fields.
* Each package's ``load_trace`` reads the other's saved file, and
  ``python -m repro_torch.trace verify`` passes on the goldens.

Tolerance: none; digests and streams are compared exactly.
"""

import glob
import os
from pathlib import Path

import numpy as np
import pytest

import repro.trace as jtrace
import repro_torch.trace as ttrace
from repro.trace.cli import record_trace as jrecord
from repro_torch.trace import cli as tcli
from repro_torch.trace.schema import EXACT_FIELDS

GOLDEN = Path(__file__).resolve().parent / "golden"
GOLDENS = sorted(glob.glob(str(GOLDEN / "*.json")))


@pytest.mark.parametrize("store", [False, True], ids=["modeled", "store"])
@pytest.mark.parametrize("path", GOLDENS, ids=[Path(p).stem for p in GOLDENS])
def test_goldens_re_record_through_the_port(path, store):
    golden = ttrace.load_trace(path)
    fresh = tcli.record_trace(dict(golden.config, feature_store=store), device="cpu")
    assert fresh.exact_digest() == golden.exact_digest()
    assert fresh.num_steps == golden.num_steps == 14
    assert fresh.manifest["feature_store"] is store
    if store:
        np.testing.assert_array_equal(
            fresh.arrays["bytes_measured"], fresh.arrays["bytes_modeled"]
        )
    else:
        assert ttrace.diff_traces(golden, fresh).identical


@pytest.mark.parametrize("store", [False, True], ids=["modeled", "store"])
@pytest.mark.parametrize("path", GOLDENS, ids=[Path(p).stem for p in GOLDENS])
def test_goldens_re_record_on_the_staged_loop(path, store):
    """``device=False``: the reference's default path, the staged loop on
    the host, records each golden's exact streams too."""
    golden = ttrace.load_trace(path)
    fresh = tcli.record_trace(dict(golden.config, feature_store=store), device=False)
    assert fresh.exact_digest() == golden.exact_digest()
    assert fresh.num_steps == golden.num_steps == 14
    if store:
        np.testing.assert_array_equal(
            fresh.arrays["bytes_measured"], fresh.arrays["bytes_modeled"]
        )
    else:
        assert ttrace.diff_traces(golden, fresh).identical


@pytest.mark.parametrize("store", [False, True], ids=["modeled", "store"])
@pytest.mark.parametrize("path", GOLDENS, ids=[Path(p).stem for p in GOLDENS])
def test_goldens_re_record_on_the_legacy_loop(path, store):
    """``runtime="legacy"``: the per-PE host loop records each golden's
    exact streams (mirrors the reference's
    ``test_golden_conformance_both_runtimes``, on all 8)."""
    golden = ttrace.load_trace(path)
    config = dict(golden.config, feature_store=store)
    fresh = tcli.record_trace(config, runtime="legacy", device="cpu")
    assert fresh.config["runtime"] == "legacy"
    assert fresh.exact_digest() == golden.exact_digest()
    assert fresh.num_steps == golden.num_steps == 14
    if store:
        np.testing.assert_array_equal(
            fresh.arrays["bytes_measured"], fresh.arrays["bytes_modeled"]
        )
    else:
        assert ttrace.diff_traces(golden, fresh).identical


RUNTIME_CONFIG = dict(
    dataset="products", scale=0.05, num_parts=2, batch_size=8, fanouts=[3, 5],
    epochs=2, interval=4, seed=0,
)


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("variant", ["distdgl", "fixed", "massivegnn", "rudder"])
def test_bit_identical_across_runtimes(variant, mode):
    """The reference's ``test_trace.py:61``: both runtimes record the same
    whole trace, and it is the reference's legacy trace."""
    config = dict(RUNTIME_CONFIG, variant=variant, mode=mode)
    vec = tcli.record_trace(config, runtime="vectorized", device="cpu")
    leg = tcli.record_trace(config, runtime="legacy", device="cpu")
    ref = jrecord(config, runtime="legacy")
    report = ttrace.diff_traces(vec, leg)
    assert report.identical, report.render()
    assert vec.digest() == leg.digest() == ref.digest()


def test_cli_replay_on_the_legacy_runtime(tmp_path, capsys):
    """The reference's ``test_trace.py:464``: a recorded trace replays
    clean on the legacy runtime, whole and through the time plane."""
    out = str(tmp_path / "cli")
    args = [
        "record", "--out", out, "--scale", "0.05", "--num-parts", "2",
        "--batch-size", "8", "--fanouts", "3,5", "--epochs", "2",
        "--variant", "fixed", "--device", "cpu",
    ]
    assert tcli.main(args) == 0
    assert tcli.main(["replay", out, "--runtime", "legacy", "--device", "cpu"]) == 0
    assert tcli.main(["replay", out, "--plane", "time", "--runtime", "legacy",
                      "--device", "cpu"]) == 0
    assert "identical" in capsys.readouterr().out.lower()


def test_goldens_are_eight():
    assert len(GOLDENS) == 8


def _exact(names):
    ragged = {n.rsplit("_", 1)[0] for n in names if n.endswith(("_flat", "_offsets"))}
    return sorted({n for n in names if not n.endswith(("_flat", "_offsets"))} | ragged)


def test_ragged_trace_matches_reference(tmp_path):
    config = dict(
        dataset="products", scale=0.15, num_parts=4, batch_size=72, epochs=2,
        variant="rudder", mode="sync", fanouts=[5, 10], feature_store=True,
    )
    ref = jrecord(dict(config, device=True))
    port = tcli.record_trace(config, device="cpu")
    assert port.num_steps == ref.num_steps == 4
    assert port.exact_digest() == ref.exact_digest()
    fields = _exact(EXACT_FIELDS) + ["bytes_measured", "bytes_modeled", "feat_sums"]
    report = ttrace.diff_traces(ref, port, fields=fields)
    assert report.identical, report.render()
    # Each package reads the other's files.
    jtrace.save_trace(ref, str(tmp_path / "ref"))
    ttrace.save_trace(port, str(tmp_path / "port"))
    from_ref = ttrace.load_trace(str(tmp_path / "ref"))
    from_port = jtrace.load_trace(str(tmp_path / "port"))
    assert from_ref.digest() == ref.digest()
    assert from_port.digest() == port.digest()
    assert from_port.exact_digest() == ref.exact_digest()


def test_trainer_trace_true_records_onto_last_trace():
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph

    parts = partition_graph(generate("products", seed=0, scale=0.05), 2)
    tr = DistributedTrainer(
        parts, variant="fixed", batch_size=8, fanouts=(3, 5), epochs=1,
        train_model=False, device="cpu", trace=True,
    )
    result = tr.run()
    assert result.trace is tr.last_trace
    assert result.trace.num_steps == tr.mb_per_epoch
    assert result.trace.config["replayable"] is False


def test_cli_verify_passes_on_the_goldens(tmp_path, capsys):
    report = tmp_path / "verify.json"
    rc = tcli.main(["verify", str(GOLDEN), "--device", "cpu", "--json", str(report)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count(" ok") == 8
    assert os.path.exists(report)
