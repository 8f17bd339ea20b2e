"""Granite-20B (code) — dense decoder with MQA (kv=1). [arXiv:2405.04324]

Per the assignment note ("llama-arch, code") this uses RoPE + SwiGLU with the
assigned dims; kv=1 means K/V projections are replicated across the model
axis rather than head-sharded (launch/shardings.py)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        arch_type="dense",
        num_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,          # MQA
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        pattern=("attn",),
        ffn_type="swiglu",
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        source="arXiv:2405.04324",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=1,          # keep the MQA trait
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("attn",),
        ffn_type="swiglu",
        remat=False,
        source="arXiv:2405.04324 (reduced)",
    )
