"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``repro/models/config.py``: the same fields,
defaults and derived properties.  One dataclass describes dense / MoE / SSM /
hybrid / enc-dec / VLM stacks via a repeating *unit pattern* of block types;
the stack is ``num_units`` copies of the pattern (models/model.py runs them
as a loop over per-unit modules).  Supported block types:

  "attn"         causal self-attention (GQA/MQA via n_kv_heads) + FFN
  "attn_local"   sliding-window causal attention + FFN (gemma2 local layers)
  "attn_swa"     sliding-window attention + MoE FFN (mixtral)
  "attn_moe"     full attention + MoE FFN (granite-moe)
  "mamba"        Mamba2 SSD block (zamba2)
  "rwkv"         RWKV-6 time-mix + channel-mix (finch)
  "enc_attn"     bidirectional attention + FFN (whisper encoder)
  "dec_attn"     causal self-attn + cross-attn + FFN (whisper decoder)

``shared_attn_every > 0`` applies a single weight-shared attention block after
every k-th unit (zamba2's shared block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Router aux-loss weight (load balance, Switch-style).
    aux_loss_weight: float = 0.01
    # "ragged": token copies sorted by expert, one matmul per contiguous
    #   group (the JAX package's ragged_dot).
    # "dense": capacity-padded dispatch (E, C, D) + batched matmuls; copies
    #   over capacity are dropped.
    impl: str = "ragged"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    conv_kernel: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128          # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 64           # WKV chunk length
    decay_lora: int = 64      # low-rank dim of the data-dependent decay


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming stubbed frame embeddings."""

    num_layers: int
    num_frames: int           # fixed source length (1500 for whisper-large)
    d_model: int              # == decoder d_model here


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int                     # total block count (pattern * units)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn",)
    head_dim: Optional[int] = None      # default d_model // n_heads

    norm_eps: float = 1e-5
    norm_type: str = "rms"              # rms|layer (whisper uses LayerNorm)
    pos_type: str = "rope"              # rope|abs (whisper uses absolute)
    post_norm: bool = False             # gemma2 adds post-block norms
    rope_theta: float = 10_000.0
    window: int = 0                     # sliding-window size (0 = full)
    attn_softcap: float = 0.0           # gemma2 attention logit softcap
    logits_softcap: float = 0.0         # gemma2 final logit softcap
    ffn_type: str = "swiglu"            # swiglu|geglu|gelu
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    shared_attn_every: int = 0
    encoder: Optional[EncoderConfig] = None

    frontend: str = "none"              # none|vision_stub|audio_stub
    num_patches: int = 0                # VLM stub: first N positions are patches

    seq_shard_attn: bool = True         # query-seq sharding fallback when
    # heads don't divide the model axis (partition.heads_spec).
    param_dtype: str = "float32"        # float32|bfloat16 (big models: bf16)
    compute_dtype: str = "bfloat16"
    remat: bool = True                  # activation checkpoint each unit
    scan_unroll: bool = False           # the JAX dry-run's unrolled unit
    # scan; the port's unit loop is always unrolled, so it reads no flag.
    source: str = ""                    # citation (model card / arXiv)

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def num_units(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: {self.num_layers} layers not a multiple of "
            f"pattern {self.pattern}"
        )
        return self.num_layers // len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 (the JAX package shards logits over it); the
        embedding holds the pad rows and the logits are this wide."""
        return _round_up(self.vocab, 256)

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder is None

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: every block is windowed/SSM/linear except
        at most a periodic shared-attention block (decode cost stays O(1) or
        O(window) per token per block)."""
        full_attn = {"attn", "attn_moe", "enc_attn", "dec_attn"}
        return not any(p in full_attn for p in self.pattern)

    def flops_params(self) -> int:
        """Total parameter count (for 6ND roofline accounting), counted from
        the port's parameter shapes (no allocation)."""
        from repro_torch.models import model as model_mod

        return model_mod.count_params_analytic(self)

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        from repro_torch.models import model as model_mod

        return model_mod.count_params_analytic(self, active_only=True)
