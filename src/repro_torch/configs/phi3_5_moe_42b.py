"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
16 experts top-2 (d_ff_expert 6400), GQA 32q/8kv.

A copy of the reference's ``repro.configs.phi3_5_moe_42b``."""

from repro_torch.models.config import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=2,
        d_ff_expert=6400,
    ),
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
