"""Granite-MoE 3B-a800m — fine-grained MoE, 40 experts top-8, per-expert
d_ff=512. [hf:ibm-granite/granite-3.0-1b-a400m-base]

Note: the assignment line reads "MoE 40e top-8" in the config field and
"32 experts top-8" in the free-text bracket; we implement the explicit config
field (40 experts). Vocab 49155 is not 256-aligned; logits shard via
``vocab_padded`` = 49408 (models/config.py)."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        num_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,          # GQA kv=8
        head_dim=64,
        d_ff=512,              # per-expert
        vocab=49155,
        pattern=("attn_moe",),
        moe=MoEConfig(num_experts=40, top_k=8),
        ffn_type="swiglu",
        rope_theta=10_000.0,
        param_dtype="float32",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab=512,
        pattern=("attn_moe",),
        moe=MoEConfig(num_experts=4, top_k=2),
        ffn_type="swiglu",
        remat=False,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (reduced)",
    )
