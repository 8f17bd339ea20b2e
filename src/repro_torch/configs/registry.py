"""Lookup of assigned architectures by CLI id (``--arch <id>``)."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "pixtral-12b",
    "smollm-135m",
    "zamba2-7b",
    "rwkv6-7b",
    "phi4-mini-3.8b",
    "gemma2-2b",
    "granite-20b",
    "granite-moe-3b-a800m",
    "whisper-large-v3",
    "mixtral-8x22b",
)

_MODULES = {
    "pixtral-12b": "pixtral_12b",
    "smollm-135m": "smollm_135m",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "gemma2-2b": "gemma2_2b",
    "granite-20b": "granite_20b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "whisper-large-v3": "whisper_large_v3",
    "mixtral-8x22b": "mixtral_8x22b",
}


def _module(arch_id: str):
    try:
        name = _MODULES[arch_id]
    except KeyError as e:
        raise ValueError(
            f"unknown arch {arch_id!r}; options: {', '.join(ARCH_IDS)}"
        ) from e
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
