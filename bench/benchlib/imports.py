"""The check that no module of JAX or of the JAX package is loaded.

A module's top-level name (the part before the first dot) is compared
whole, so ``repro_torch`` passes and ``repro`` does not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
