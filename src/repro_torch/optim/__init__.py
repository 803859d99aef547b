"""Optimizer substrate: AdamW and a cosine schedule (the port's
counterpart of the reference's ``repro.optim``)."""

from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]
