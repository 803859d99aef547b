"""The port stands alone: no JAX, nothing of the reference package, and
no silent move from the card to the CPU.

* an AST scan of every module of ``src/repro_torch`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or ``repro``, nor of
  ``msgpack`` (the reference's checkpoint dependency, which the card's
  machine does not have);
* every module of the port imports in a fresh interpreter in which
  ``jax``, ``repro`` and ``msgpack`` cannot be imported;
* asking for ``device="cuda"`` where there is no card raises
  ``RuntimeError``, and ``chip_smoke.py`` exits non-zero with no result,
  both in the checkout and alone in an empty directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_reference():
    sources = _sources()
    assert len(sources) > 20
    bad = {
        str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
        for p in sources
    }
    assert not {k: v for k, v in bad.items() if v}


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_a_card_raises(no_card):
    """Every entry point asks for the card by default and raises without
    one; none carries on on the CPU."""
    from repro_torch.gnn import DistributedTrainer
    from repro_torch.graph import generate, partition_graph
    from repro_torch.runtime.engine import DeviceEngine, PrefetchEngine, resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceEngine(PrefetchEngine([2]), part_of=np.zeros(4, np.int64))
    parts = partition_graph(generate("products", seed=0, scale=0.05), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedTrainer(parts, variant="fixed", train_model=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedTrainer(parts, variant="fixed", train_model=False, runtime="legacy")
    with pytest.raises(ValueError, match="CUDA device or 'cpu'"):
        resolve_device("meta")
    # This slice's entry points default to the card too.
    from repro_torch.configs.rudder_gnn import build_trainer
    from repro_torch.core import make_classifier
    from repro_torch.gnn.train import collect_traces
    from repro_torch.runtime import SweepConfig, run_sweep

    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_traces(parts, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_classifier("mlp").fit(np.zeros((4, 8), np.float32), np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer("products_25pct_fixed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep([SweepConfig(num_parts=2, epochs=1)], scale=0.05)
    # Training, and the modules it brought.
    from repro_torch.launch.train import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("gemma2-2b", steps=1)


def test_the_training_modules_are_scanned():
    names = {str(p.relative_to(PORT)) for p in _sources() if p.is_relative_to(PORT)}
    assert {"optim/adamw.py", "data/pipeline.py", "ckpt/checkpoint.py", "launch/train.py",
            "tree.py"} <= names


def _run_smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )


def test_chip_smoke_refuses_without_a_card(tmp_path):
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
