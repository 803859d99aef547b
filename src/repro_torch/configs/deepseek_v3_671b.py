"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA attention (128 heads,
q_lora 1536 / kv_lora 512, 128 nope + 64 rope, v 128), MoE with 1 shared
+ 256 routed experts (top-8, d_ff_expert 2048), first 3 layers dense
(d_ff 18432), MTP head. Adam moments kept in bf16 so the optimizer state
fits v5e HBM (see EXPERIMENTS.md §Dry-run).

A copy of the reference's ``repro.configs.deepseek_v3_671b``."""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        num_shared_experts=1,
        d_ff_expert=2048,
        first_k_dense=3,
        d_ff_dense=18432,
    ),
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    mtp=True,
    opt_dtype="bfloat16",
    citation="arXiv:2412.19437",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
