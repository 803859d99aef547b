"""Zamba2-1.2B [arXiv:2411.15242]: hybrid — Mamba2 blocks with a single
*shared* attention+MLP block interleaved (every 6th position here:
6x(5 mamba + shared) + 2 mamba = 38), ssm_state=64.

A copy of the reference's ``repro.configs.zamba2_1_2b``."""

from repro_torch.models.config import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    shared_attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    mlp_type="gelu",
    tie_embeddings=True,
    citation="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
