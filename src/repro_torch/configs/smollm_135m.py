"""SmolLM-135M — llama-architecture small dense LM.
[hf:HuggingFaceTB/SmolLM-135M]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        arch_type="dense",
        num_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,          # GQA kv=3
        head_dim=64,
        d_ff=1536,
        vocab=49152,
        pattern=("attn",),
        ffn_type="swiglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        param_dtype="float32",
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=192,
        n_heads=3,
        n_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("attn",),
        ffn_type="swiglu",
        tie_embeddings=True,
        remat=False,
        source="hf:HuggingFaceTB/SmolLM-135M (reduced)",
    )
