"""Gemma-2 2B — local(4096-window)/global alternating attention, GeGLU,
attention & final-logit softcaps, post-norms. [arXiv:2408.00118]

The alternating pattern makes the unit = (local, global) pair; 26 layers =
13 units. Half the layers being windowed is what qualifies gemma2-2b for the
long_500k decode shape (each local layer caches only its 4096-token window;
the global layers hold the full cache — DESIGN.md §7)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        arch_type="dense",
        num_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,          # GQA kv=4
        head_dim=256,
        d_ff=9216,
        vocab=256_000,
        pattern=("attn_local", "attn"),
        window=4096,
        attn_softcap=50.0,
        logits_softcap=30.0,
        post_norm=True,
        ffn_type="geglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        param_dtype="float32",
        source="arXiv:2408.00118",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke",
        arch_type="dense",
        num_layers=2,          # one (local, global) unit
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("attn_local", "attn"),
        window=16,
        attn_softcap=50.0,
        logits_softcap=30.0,
        post_norm=True,
        ffn_type="geglu",
        tie_embeddings=True,
        remat=False,
        source="arXiv:2408.00118 (reduced)",
    )
