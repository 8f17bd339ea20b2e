"""Phi-4-mini 3.8B — dense decoder, RoPE + SwiGLU + GQA.
[arXiv:2412.08905]

Simplification note: phi-4-mini's partial-rotary/LongRoPE scaling is replaced
by full-head RoPE (theta 10k); recorded here because it changes no shape and
no sharding, only the rotary fraction."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        arch_type="dense",
        num_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,          # GQA kv=8
        head_dim=128,
        d_ff=8192,
        vocab=200_064,
        pattern=("attn",),
        ffn_type="swiglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        source="arXiv:2412.08905",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("attn",),
        ffn_type="swiglu",
        tie_embeddings=True,
        remat=False,
        source="arXiv:2412.08905 (reduced)",
    )
