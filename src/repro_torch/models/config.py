"""Model configuration for the assigned architecture pool.

One frozen dataclass drives every architecture family: dense GQA,
MLA+MoE (DeepSeek), SSM (xLSTM), hybrid (Zamba2 Mamba2+shared-attn),
enc-dec (Whisper), VLM and audio backbones (frontends stubbed).

A framework-free copy of the reference's ``repro.models.config``, kept
field for field so that both packages read the same configurations.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    experts_per_token: int = 0    # top-k
    num_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert FFN width
    first_k_dense: int = 0        # leading dense layers (DeepSeek: 3)
    d_ff_dense: int = 0           # width of those dense layers
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # per-head SSM state (Mamba2) / mLSTM cell
    head_dim: int = 64            # ssm head width
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4           # depthwise conv (Mamba2)
    # xLSTM: positions (mod pattern length) that use sLSTM blocks
    slstm_every: int = 0          # 0 = all mLSTM; k = every k-th block is sLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense|moe|ssm|hybrid|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    citation: str = ""

    # attention flavour
    attn_type: str = "gqa"        # gqa | mla
    qk_norm: bool = False         # Qwen3
    attn_softcap: float = 0.0     # Gemma2 attention-logit softcap
    logit_softcap: float = 0.0    # Gemma2 final-logit softcap
    sliding_window: int = 0       # window size for local layers
    local_global: bool = False    # Gemma2 alternating local/global
    rope_theta: float = 10_000.0

    # block structure
    block_pattern: tuple[str, ...] = ("attn",)  # cycled over layers
    shared_attn_every: int = 0    # Zamba2: shared attn block interval

    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # mlp flavour
    mlp_type: str = "swiglu"      # swiglu | gelu | relu2 | geglu
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    post_norm: bool = False       # Gemma2 pre+post norm
    tie_embeddings: bool = True

    # enc-dec (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500       # mel frames after conv frontend

    # modality frontend (STUB: input_specs provides embeddings)
    frontend: str = "none"        # none | audio | vision
    num_patches: int = 0          # VLM patch tokens prepended

    # training-time extras
    mtp: bool = False             # DeepSeek multi-token prediction head
    mtp_weight: float = 0.3

    # Roofline probe hook: overrides the per-group layer counts (see
    # roofline.measure_corrected). Eager PyTorch counts every layer, but a
    # full-depth count on meta tensors under DTensor runs every operation
    # of every layer through Python (minutes for the recurrences), so the
    # dry-run counts reduced-depth variants and scales the per-unit costs
    # back up by the true counts.
    scan_counts_override: tuple | None = None
    # The reference's switch to unroll its layer scans for XLA's cost
    # analysis; kept for the config's fields, the port runs every layer
    # as it is.
    unroll_scans: bool = False

    # distribution
    # Expert-parallel axis for MoE layers. None = single-device dropless
    # dispatch; a mesh axis name (or a tuple of them, in the mesh's
    # order) selects the expert-parallel path on the mesh registered with
    # models.moe.set_ep_mesh (experts split over those axes, local
    # capacity-bounded blocks, psum combine). Set by the launcher.
    ep_axis: str | tuple[str, ...] | None = None
    ep_capacity_factor: float = 1.25
    # MoE combine strategy of the expert-parallel path: "psum"
    # (replicated tokens) or "a2a" (all-to-all dispatch).
    ep_combine: str = "psum"
    # FSDP-style weight sharding: large parameter leaves additionally
    # shard over the 'data' axis (XLA inserts per-layer all-gathers).
    # Required for >=40B-param models to fit v5e HBM (§Perf iteration 1).
    fsdp: bool = False

    # numerics
    dtype: str = "bfloat16"
    # Adam moment dtype; huge models (DeepSeek) use bf16 moments so the
    # optimizer state fits v5e HBM (documented in EXPERIMENTS.md).
    opt_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            self.name,
            self.num_heads,
            self.num_kv_heads,
        )

    # ------------------------------------------------------------------ #
    def block_kind(self, layer: int) -> str:
        """Block type of a given layer index."""
        if self.arch_type == "hybrid" and self.shared_attn_every:
            if (layer + 1) % self.shared_attn_every == 0:
                return "shared_attn"
            return "mamba2"
        if self.arch_type == "ssm" and self.ssm.slstm_every:
            if (layer + 1) % self.ssm.slstm_every == 0:
                return "slstm"
            return "mlstm"
        if self.arch_type == "ssm":
            return "mlstm"
        if self.local_global:
            return "attn_local" if layer % 2 == 0 else "attn_global"
        if self.moe.num_experts:
            return "dense" if layer < self.moe.first_k_dense else "moe"
        return "attn"

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid state or sliding window."""
        return self.arch_type in ("ssm", "hybrid") or (
            self.sliding_window > 0
        )

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, l = self.d_model, self.num_layers
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for layer in range(l):
            kind = self.block_kind(layer)
            if kind in ("attn", "attn_local", "attn_global", "dense", "moe"):
                if self.attn_type == "mla":
                    m = self.mla
                    n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.qk_rope_head_dim
                    )
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim
                    )
                    n += self.num_heads * m.v_head_dim * d
                else:
                    n += d * self.num_heads * self.head_dim * 2  # q, o
                    n += d * self.num_kv_heads * self.head_dim * 2  # k, v
            if kind == "moe":
                e = self.moe
                n += d * e.num_experts  # router
                n += (
                    (e.num_experts + e.num_shared_experts)
                    * 3
                    * d
                    * e.d_ff_expert
                )
            elif kind == "dense":
                n += 3 * d * self.moe.d_ff_dense
            elif kind in ("attn", "attn_local", "attn_global"):
                mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            elif kind == "mamba2":
                di = self.ssm.expand * d
                n += d * 2 * di + di * d + di * self.ssm.state_dim * 2
            elif kind == "shared_attn":
                pass  # counted once below
            elif kind == "mlstm":
                di = int(self.ssm.proj_factor_mlstm * d)
                n += d * 3 * di + di * d
            elif kind == "slstm":
                n += 4 * d * d + int(self.ssm.proj_factor_slstm * d) * d * 2
        if self.shared_attn_every:
            n += 4 * d * self.num_heads * self.head_dim + 3 * d * self.d_ff
        if self.encoder_layers:
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_enc = 4 * d * self.num_heads * self.head_dim + mult * d * self.d_ff
            n += self.encoder_layers * per_enc
            # decoder cross-attention
            n += self.num_layers * 4 * d * self.num_heads * self.head_dim
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only)."""
        if not self.moe.num_experts:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        moe_layers = self.num_layers - e.first_k_dense
        all_experts = moe_layers * e.num_experts * 3 * self.d_model * e.d_ff_expert
        active_experts = (
            moe_layers
            * (e.experts_per_token + e.num_shared_experts)
            * 3
            * self.d_model
            * e.d_ff_expert
        )
        return int(total - all_experts + active_experts)

    def with_overrides(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else cfg.encoder_seq,
        num_patches=8 if cfg.num_patches else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
    )
    if cfg.moe.num_experts:
        kw["moe"] = replace(
            cfg.moe,
            num_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=128,
            first_k_dense=1 if cfg.moe.first_k_dense else 0,
            d_ff_dense=256 if cfg.moe.first_k_dense else 0,
        )
    if cfg.attn_type == "mla":
        kw["mla"] = MLAConfig(
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        )
    if cfg.arch_type in ("ssm", "hybrid"):
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=32)
        if cfg.ssm.slstm_every:
            kw["ssm"] = replace(kw["ssm"], slstm_every=2)
    kw.update(extra)
    return cfg.with_overrides(**kw)
