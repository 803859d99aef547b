"""Modality frontend STUBS (the one sanctioned carve-out, DESIGN.md §8).

Counterpart of the reference's ``repro.models.frontend``. ``[audio]`` and
``[vlm]`` architectures specify the transformer backbone only; the
mel-spectrogram + conv feature extractor (Whisper) and the ViT/CLIP
vision encoder (Phi-3-vision) are stubbed: these functions provide
precomputed frame/patch *embeddings of the right shape* — as ``meta``
tensors (shapes and dtypes, no memory) and as arrays drawn from numpy
exactly as the reference draws them. The learned projector (vision embed
dim -> d_model) IS part of the backbone and lives in
``model.init_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .model import VISION_EMBED_DIM


def audio_frame_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Post-conv mel-frame embeddings: (B, 1500, d_model) for 30 s."""
    return torch.empty((batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
                       device="meta")


def vision_patch_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """CLIP ViT-L/14 patch embeddings: (B, 576, 1024) at 336 px."""
    return torch.empty((batch, cfg.num_patches, VISION_EMBED_DIM), dtype=torch.float32,
                       device="meta")


def synth_audio_frames(cfg: ModelConfig, batch: int, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    return rng.normal(
        0, 0.02, size=(batch, cfg.encoder_seq, cfg.d_model)
    ).astype(np.float32)


def synth_vision_patches(cfg: ModelConfig, batch: int, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    return rng.normal(
        0, 0.02, size=(batch, cfg.num_patches, VISION_EMBED_DIM)
    ).astype(np.float32)
