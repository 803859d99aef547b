"""The port's dry-run counts beside the reference's XLA cost analysis.

Qwen3-8B's smoke config on a (data=2, model=2) mesh at ``prefill_32k``,
``decode_32k`` and ``train_4k``: per device, the reference's compiled
``cost_analysis()`` FLOPs and bytes and ``memory_analysis()`` argument
bytes (``repro.launch.dryrun.build_lowered`` on four of its forced host
devices, in a subprocess; raw, and scan-corrected by its
``measure_corrected``), and the port's ``CostCounter`` counts of the same
steps placed on a fake world of four (``repro_torch.launch.dryrun``).
Counts only: the reference's seconds use TPU peaks. CPU only, no card:

    PYTHONPATH=src python scripts/dryrun_parity.py      # ~30 s
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen3-8b"
SHAPES = ("prefill_32k", "decode_32k", "train_4k")


def reference(out: str) -> None:
    import jax
    import numpy as np

    from repro.configs import get_smoke_config
    from repro.launch import dryrun
    from repro.roofline import measure_corrected

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    result = {}
    for shape in SHAPES:
        cfg = get_smoke_config(ARCH)
        compiled = dryrun.build_lowered(cfg, shape, mesh).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        corr = measure_corrected(cfg, shape, mesh, dryrun.build_lowered)
        result[shape] = {"flops": float(cost.get("flops", 0.0)),
                         "bytes": float(cost.get("bytes accessed", 0.0)),
                         "flops_corrected": corr["flops"], "bytes_corrected": corr["bytes"],
                         "args": compiled.memory_analysis().argument_size_in_bytes}
    Path(out).write_text(json.dumps(result))


def port() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import roofline as rl
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    result = {}
    with dryrun.fake_world(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        for shape in SHAPES:
            step = dryrun.build_step(get_smoke_config(ARCH), shape, mesh)
            vec = rl.count(step)
            result[shape] = {"flops": vec["flops"], "bytes": vec["bytes"],
                             "args": step.arg_bytes,
                             "coll": sum(v for k, v in vec.items() if k.startswith("coll:"))}
    return result


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference(sys.argv[2])
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, __file__, "--reference", out], env=env, check=True)
        ref = json.loads(Path(out).read_text())
    mine = port()
    print(f"{ARCH} smoke config, (data=2, model=2), per device")
    print("| shape | reference FLOPs raw / corrected | port FLOPs | port / corrected | reference "
          "bytes raw / corrected | port bytes | port / corrected | argument bytes | port "
          "collective bytes |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for shape in SHAPES:
        r, p = ref[shape], mine[shape]
        same = "equal" if r["args"] == p["args"] else f"{r['args']} / {p['args']}"
        print(f"| {shape} | {r['flops']:.6g} / {r['flops_corrected']:.6g} | {p['flops']:.6g} | "
              f"{p['flops'] / r['flops_corrected']:.3f} | {r['bytes']:.6g} / "
              f"{r['bytes_corrected']:.6g} | {p['bytes']:.6g} | "
              f"{p['bytes'] / r['bytes_corrected']:.3f} | {p['args']} ({same}) | "
              f"{p['coll']:.6g} |")
    print(json.dumps({"reference": ref, "port": mine}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
