"""Checkpointing in the reference's msgpack format (the port's
counterpart of ``repro.ckpt``)."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
