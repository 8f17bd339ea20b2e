"""Zamba2-7B — hybrid: Mamba2 backbone + periodic weight-SHARED attention
block. [arXiv:2411.15242]

81 Mamba2 layers organised as 27 scan units of 3; the single shared
attention+FFN block fires after every 2nd unit (i.e. every 6 Mamba layers,
13 applications) with its own KV cache per application but one set of
weights — Zamba2's signature parameter sharing. Mamba state is O(1) per
token, the shared block is periodic, so long_500k runs (DESIGN.md §7)."""

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        num_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,         # shared block is MHA (kv=32)
        head_dim=112,
        d_ff=14336,            # shared block FFN
        vocab=32000,
        pattern=("mamba", "mamba", "mamba"),   # 27 units x 3 = 81 layers
        shared_attn_every=2,                   # after units 2,4,... -> 13 fires
        ssm=SSMConfig(d_state=64, conv_kernel=4, expand=2, head_dim=64,
                      chunk=128),
        ffn_type="swiglu",
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        arch_type="hybrid",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("mamba", "mamba"),
        shared_attn_every=1,
        ssm=SSMConfig(d_state=16, conv_kernel=4, expand=2, head_dim=64,
                      chunk=16),
        ffn_type="swiglu",
        remat=False,
        source="arXiv:2411.15242 (reduced)",
    )
