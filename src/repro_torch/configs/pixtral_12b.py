"""Pixtral-12B — VLM: Pixtral-ViT frontend + Mistral-Nemo-style decoder.
[hf:mistralai/Pixtral-12B-2409]

Per the brief, the vision encoder + projector is a STUB: ``input_specs``
supplies pre-projected patch embeddings (B, num_patches, d_model) that occupy
the first ``num_patches`` sequence positions; this module implements the
language decoder that consumes them. Nemo-style: head_dim 128 (attn width
4096 != d_model 5120), large rope theta."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        arch_type="vlm",
        num_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,          # GQA kv=8
        head_dim=128,
        d_ff=14336,
        vocab=131_072,
        pattern=("attn",),
        ffn_type="swiglu",
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        num_patches=256,       # one 1024x1024 image at 16x16 patches, pooled
        param_dtype="bfloat16",
        source="hf:mistralai/Pixtral-12B-2409",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        arch_type="vlm",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("attn",),
        ffn_type="swiglu",
        frontend="vision_stub",
        num_patches=8,
        remat=False,
        source="hf:mistralai/Pixtral-12B-2409 (reduced)",
    )
