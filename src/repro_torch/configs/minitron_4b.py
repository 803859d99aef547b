"""Minitron-4B [arXiv:2407.14679]: pruned Nemotron — GQA (24q/8kv),
squared-ReLU MLP, large 256k vocab (embedding-heavy).

A copy of the reference's ``repro.configs.minitron_4b``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="relu2",
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="arXiv:2407.14679",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
