"""Deterministic synthetic LM data pipeline (the port's copy of the
reference's ``repro.data``)."""

from .pipeline import TokenPipeline, make_batch_specs

__all__ = ["TokenPipeline", "make_batch_specs"]
