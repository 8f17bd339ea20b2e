"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088]

SWA (window 4096) on every layer makes decode cost O(window) per token per
layer — this arch runs the long_500k shape (DESIGN.md §7). bf16 params:
~141B total / ~39B active."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        arch_type="moe",
        num_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,          # GQA kv=8
        head_dim=128,
        d_ff=16384,            # per-expert
        vocab=32768,
        pattern=("attn_swa",),
        window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
        ffn_type="swiglu",
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        source="arXiv:2401.04088",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab=512,
        pattern=("attn_swa",),
        window=16,
        moe=MoEConfig(num_experts=4, top_k=2),
        ffn_type="swiglu",
        remat=False,
        source="arXiv:2401.04088 (reduced)",
    )
