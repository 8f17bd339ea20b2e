"""RWKV-6 7B "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892]

Every block is a WKV-6 time-mix + channel-mix; O(1) decode state per layer
qualifies this arch for long_500k (DESIGN.md §7). n_heads/n_kv_heads are
nominal (d_model / rwkv.head_dim WKV heads are what matter)."""

from repro_torch.models.config import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        arch_type="ssm",
        num_layers=32,
        d_model=4096,
        n_heads=64,            # 4096 / 64 WKV heads
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab=65536,
        pattern=("rwkv",),
        rwkv=RWKVConfig(head_dim=64, chunk=16, decay_lora=64),
        param_dtype="bfloat16",
        source="arXiv:2404.05892",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        arch_type="ssm",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("rwkv",),
        rwkv=RWKVConfig(head_dim=64, chunk=16, decay_lora=16),
        remat=False,
        source="arXiv:2404.05892 (reduced)",
    )
