"""Phi-3-mini-3.8B [arXiv:2404.14219]: dense, RoPE, SwiGLU, MHA (32/32).

A copy of the reference's ``repro.configs.phi3_mini_3_8b``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
