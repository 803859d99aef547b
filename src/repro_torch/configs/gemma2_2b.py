"""Gemma2-2B [arXiv:2408.00118]: alternating local(4096-window)/global
attention, attn+final logit softcaps, GeGLU, pre+post RMSNorm, GQA 8q/4kv
(head_dim 256), 256k vocab, tied embeddings (scaled by sqrt(d)).

A copy of the reference's ``repro.configs.gemma2_2b``."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    local_global=True,
    mlp_type="geglu",
    post_norm=True,
    tie_embeddings=True,
    citation="arXiv:2408.00118",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
