"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense, GQA (32q/8kv), qk-norm, SwiGLU.

A copy of the reference's ``repro.configs.qwen3_8b``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
