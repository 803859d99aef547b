"""Shared provenance header for bench/telemetry JSON artifacts.

Every ``BENCH_*.json`` writer and ``write_sweep_json`` stamps this
header so trajectory comparisons across PRs are attributable: which
commit, which platform, which torch and CUDA, which card. Deliberately no
wall-clock timestamp — artifacts from the same checkout must stay
byte-identical across reruns so they diff cleanly. The header has the
reference's keys, with ``torch`` and ``cuda`` where the reference
records ``jax``; readers of either package take both headers.
"""

from __future__ import annotations

import platform
import subprocess
import sys

PROVENANCE_SCHEMA = 1

__all__ = ["PROVENANCE_SCHEMA", "git_sha", "provenance"]


def git_sha() -> str:
    """HEAD sha of the enclosing checkout, or ``"unknown"``."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True,
            text=True,
            timeout=10,
            check=False,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"


def provenance() -> dict:
    """The shared artifact header: schema, git sha, platform, versions."""
    import numpy as np
    import torch

    return {
        "schema": PROVENANCE_SCHEMA,
        "git_sha": git_sha(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        # None on a CPU-only build of torch.
        "cuda": torch.version.cuda or "none",
        "numpy": np.__version__,
        # The card the artifact's runs could use ("cpu" without one).
        "device": (
            torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        ),
    }
