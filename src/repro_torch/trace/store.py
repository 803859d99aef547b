"""Trace persistence: compressed npz payload + human-readable JSON manifest.

A trace on disk is two sibling files, ``<base>.npz`` (the arrays) and
``<base>.json`` (the manifest — config, schema version, array specs,
payload digest). The manifest is committed next to the payload under
``tests/golden/`` precisely because it is reviewable: a golden
regeneration shows up in the PR diff as changed digests and array
shapes, not as an opaque binary blob.

``load_trace`` verifies the payload digest by default, so a corrupted,
truncated or hand-edited golden fails loudly at load time rather than
producing a confusing diff downstream.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .schema import SCHEMA_VERSION, Trace, canonical_manifest_json


def _base_path(path: str) -> str:
    for ext in (".npz", ".json"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path


def trace_paths(path: str) -> tuple[str, str]:
    """(npz_path, json_path) for any of base/.npz/.json spellings."""
    base = _base_path(path)
    return base + ".npz", base + ".json"


def save_trace(trace: Trace, path: str) -> tuple[str, str]:
    """Write ``<base>.npz`` + ``<base>.json``; returns both paths."""
    npz_path, json_path = trace_paths(path)
    directory = os.path.dirname(npz_path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    manifest = dict(trace.manifest)
    manifest["arrays"] = trace.array_specs()
    manifest["digest"] = trace.digest()
    np.savez_compressed(npz_path, **trace.arrays)
    with open(json_path, "w") as fh:
        fh.write(canonical_manifest_json(manifest))
    return npz_path, json_path


def load_trace(path: str, verify: bool = True) -> Trace:
    """Load a trace; verifies schema version and payload digest."""
    npz_path, json_path = trace_paths(path)
    with open(json_path) as fh:
        manifest = json.load(fh)
    version = manifest.get("schema_version")
    if not isinstance(version, int) or version > SCHEMA_VERSION:
        raise ValueError(
            f"{json_path}: schema_version {version!r} is newer than this "
            f"reader ({SCHEMA_VERSION}); upgrade repro_torch.trace"
        )
    with np.load(npz_path) as payload:
        arrays = {name: payload[name] for name in payload.files}
    trace = Trace(manifest=manifest, arrays=arrays)
    if verify:
        recorded = manifest.get("digest")
        actual = trace.digest()
        if recorded != actual:
            raise ValueError(
                f"{npz_path}: payload digest mismatch — file corrupted or "
                f"edited (manifest {recorded!r}, payload {actual!r}). "
                "Regenerate with tests/golden/regenerate.py if intentional."
            )
    return trace
