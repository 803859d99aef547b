"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]:
phi3-mini backbone + CLIP ViT-L/14 vision encoder. The vision encoder is
a STUB — ``input_specs`` provides patch embeddings (B, 576, 1024); the
learned projector (1024 -> d_model) is part of this backbone.

A copy of the reference's ``repro.configs.phi_3_vision_4_2b``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    frontend="vision",
    num_patches=576,             # 336px / 14 -> 24x24 patches
    tie_embeddings=False,
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
