"""Assigned input shapes and their ``meta``-device input specs: the
counterpart of ``repro/launch/shapes.py``.

  train_4k     seq=4096    global_batch=256   the train step
  prefill_32k  seq=32768   global_batch=32    prefill (full forward)
  decode_32k   seq=32768   global_batch=128   one decode step (KV cache)
  long_500k    seq=524288  global_batch=1     one decode step; sub-quadratic
                                              archs only

``input_specs(cfg, shape)`` returns ``meta`` tensors (shape and dtype, no
storage) for every model input, with the JAX package's dtypes: the stand-ins
the dry-run (``launch/dryrun.py``) runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k applicability: SSM/hybrid/linear-attention archs plus dense
# archs with a sliding-window variant.
LONG_OK = {"zamba2-7b", "rwkv6-7b", "gemma2-2b", "mixtral-8x22b"}


def applicable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and arch_id not in LONG_OK:
        return False, "full-attention arch: long_500k skipped (DESIGN.md §7)"
    return True, ""


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def stub_specs(cfg: ModelConfig, batch: int) -> dict:
    out = {}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = _sd((batch, cfg.num_patches, cfg.d_model),
                                  torch.float32)
    if cfg.frontend == "audio_stub":
        out["frames"] = _sd((batch, cfg.encoder.num_frames, cfg.d_model),
                            torch.float32)
    return out


def train_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    batch = {
        "tokens": _sd((spec.global_batch, spec.seq_len), torch.int32),
        "labels": _sd((spec.global_batch, spec.seq_len), torch.int32),
    }
    batch.update(stub_specs(cfg, spec.global_batch))
    return batch


def prefill_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    batch = {"tokens": _sd((spec.global_batch, spec.seq_len), torch.int32)}
    batch.update(stub_specs(cfg, spec.global_batch))
    return batch


def decode_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """token + pos + cache (``LMModel.init_cache`` on ``meta``)."""
    from repro_torch.models.model import LMModel

    cache = LMModel(cfg, device="meta").init_cache(spec.global_batch,
                                                   spec.seq_len)
    return {
        "token": _sd((spec.global_batch, 1), torch.int32),
        "pos": _sd((), torch.int32),
        "cache": cache,
    }


def input_specs_for(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    if spec.kind == "train":
        return train_input_specs(cfg, spec)
    if spec.kind == "prefill":
        return prefill_input_specs(cfg, spec)
    return decode_input_specs(cfg, spec)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    return input_specs_for(cfg, SHAPES[shape_name])
