"""xLSTM-350M [arXiv:2405.04517]: 24 blocks, mLSTM with sLSTM every 8th
(7:1 ratio), 4 heads, d_ff=0 (blocks carry their own projections).

A copy of the reference's ``repro.configs.xlstm_350m``."""

from repro_torch.models.config import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(
        state_dim=64,
        head_dim=64,
        slstm_every=8,
        proj_factor_mlstm=2.0,
        proj_factor_slstm=1.3333,
    ),
    tie_embeddings=True,
    citation="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
