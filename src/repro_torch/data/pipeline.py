"""Synthetic token pipeline: seeded, deterministic, learnable.

The port's copy of the reference's ``repro.data.pipeline``: numpy only,
so that a seed gives the reference's batches bit for bit. No corpora are
available offline, so batches come from a Zipf-distributed order-2
Markov source — enough structure that a few hundred training steps show
a real loss drop, with exact determinism for tests. Modality extras
(patches/frames) are generated to match each architecture's inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig

VISION_EMBED_DIM = 1024  # CLIP ViT-L/14 output width (the reference model's constant)


@dataclass
class TokenPipeline:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        v = min(self.cfg.vocab_size, 4096)
        # Zipf unigram + deterministic bigram successor table.
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (ranks ** -1.1) / np.sum(ranks ** -1.1)
        succ_rng = np.random.default_rng(1234)
        self._succ = succ_rng.integers(0, v, size=(v, 4))
        self._v = v

    def next_batch(self) -> dict:
        b, s = self.batch_size, self.seq_len
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = self._rng.choice(self._v, size=b, p=self._probs)
        for t in range(1, s):
            # Markov step with 20% resample noise.
            pick = self._succ[toks[:, t - 1], self._rng.integers(0, 4, size=b)]
            noise = self._rng.random(b) < 0.2
            pick[noise] = self._rng.choice(self._v, size=int(noise.sum()), p=self._probs)
            toks[:, t] = pick
        batch = {"tokens": toks}
        if self.cfg.frontend == "vision":
            batch["patches"] = self._rng.normal(
                0, 0.02, size=(b, self.cfg.num_patches, VISION_EMBED_DIM)
            ).astype(np.float32)
        if self.cfg.encoder_layers:
            batch["frames"] = self._rng.normal(
                0, 0.02, size=(b, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32)
        return batch


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Stand-ins (``meta`` tensors, no memory) of the shapes and dtypes of
    ``TokenPipeline.next_batch``."""

    def spec(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {"tokens": spec(batch, seq, dtype=torch.int32)}
    if cfg.frontend == "vision":
        specs["patches"] = spec(batch, cfg.num_patches, VISION_EMBED_DIM, dtype=torch.float32)
    if cfg.encoder_layers:
        specs["frames"] = spec(batch, cfg.encoder_seq, cfg.d_model, dtype=torch.float32)
    return specs
