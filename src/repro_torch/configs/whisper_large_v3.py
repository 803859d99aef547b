"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, 32+32 layers,
d_model 1280, 20 heads, GELU MLP, LayerNorm. The mel-spectrogram + conv
frontend is a STUB — ``input_specs`` provides post-conv frame embeddings
(B, 1500, 1280) directly (see DESIGN.md carve-out).

A copy of the reference's ``repro.configs.whisper_large_v3``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,               # decoder layers
    encoder_layers=32,
    encoder_seq=1500,            # 30 s of audio after 2x conv downsample
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    norm_type="layernorm",
    frontend="audio",
    tie_embeddings=True,
    citation="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
