"""The import check: top-level names compared whole."""

import subprocess
import sys

from tiny import BENCH

from benchlib import imports


def test_whole_top_level_names():
    assert imports.forbidden_modules(["repro_torch", "repro_torch.gnn", "numpy"]) == []
    assert imports.forbidden_modules(["repro.gnn", "jax.numpy", "jaxlib", "flax.linen",
                                      "benchmarks.common", "reprox"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r];"
        "from benchlib import runner, imports;"
        "from repro_torch.gnn.train import DistributedTrainer;"
        "from repro_torch.store import FeatureStore;"
        "from repro_torch.telemetry import TelemetrySession;"
        "from repro_torch.trace import TraceRecorder;"
        "print(imports.forbidden_modules())" % (str(BENCH), str(BENCH.parent / "src"))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program(tmp_path):
    """In a directory with BENCHMARK.json and bench/ alone, the run fails
    without printing a result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "products-rudder", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
