"""Shared neural layers: norms, RoPE, attention (GQA/MQA, sliding window,
softcap, cross-attention, KV cache), FFN variants, embedding and logits.

The port of ``repro/models/layers.py``.  Parameters live in ``nn.Module``s
whose attribute names are the JAX package's dict keys (``wq``, ``w_gate``,
``scale``, ...), each in the JAX ``(in, out)`` layout so that ``x @ w``
matches; the functions keep the JAX names and take the module as ``p``.
Modules are created empty (``torch.empty``) and filled from a JAX
parameter tree (``convert.lm_params_from_numpy``): the one ``init_params``
draws (``models/model.py``, from the ``init_*`` functions here and in
``blocks``, ``moe`` and ``ssm``), or one loaded or converted.

The ``partition.shard_*`` anchors sit at the JAX package's sites; they
only record, inside the dry-run's ``partition.recording`` context.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.models import partition


def dtype_of(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    return getattr(torch, name)


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Init: the JAX ``init_*`` functions, key for key.  A key may carry a leading
# batch (``jax.vmap`` over the units' keys); every leaf then gets that batch
# as its leading axes, constants too.
# ---------------------------------------------------------------------------
def scaled_normal(key: torch.Tensor, shape: tuple, scale: float,
                  dtype: torch.dtype = torch.float32,
                  divide: bool = False) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)`` (``/ scale``
    with ``divide``): the float32 product (quotient) by the float32 scale,
    then the cast."""
    x = prng.normal(key, shape)
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return (x / s if divide else x * s).to(dtype)


def full(key: torch.Tensor, shape: tuple, value,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A constant leaf of ``shape`` behind ``key``'s batch axes."""
    value = torch.as_tensor(value, dtype=dtype, device=key.device)
    return value.expand(tuple(key.shape[:-1]) + tuple(shape)).clone()


def init_norm(cfg, d: int, key: torch.Tensor) -> dict:
    """RMS: ``scale`` zeros (applied as ``1 + scale``); layer: ``scale``
    ones, ``bias`` zeros.  ``key`` draws nothing: it places the leaves
    (its device and batch)."""
    if cfg.norm_type == "layer":
        return {"scale": full(key, (d,), 1.0), "bias": full(key, (d,), 0.0)}
    return {"scale": full(key, (d,), 0.0)}


def init_attention(key: torch.Tensor, cfg, d_model: int, n_heads: int,
                   n_kv: int, hd: int, cross: bool = False) -> dict:
    keys = prng.split(key, 4)
    s = 1.0 / math.sqrt(d_model)
    dt = dtype_of(cfg.param_dtype)
    return {
        "wq": scaled_normal(keys[..., 0, :], (d_model, n_heads * hd), s, dt),
        "wk": scaled_normal(keys[..., 1, :], (d_model, n_kv * hd), s, dt),
        "wv": scaled_normal(keys[..., 2, :], (d_model, n_kv * hd), s, dt),
        "wo": scaled_normal(keys[..., 3, :], (n_heads * hd, d_model),
                            1.0 / math.sqrt(n_heads * hd), dt),
    }


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm (``scale``, applied as ``1 + scale``) or LayerNorm
    (``scale``, ``bias``), by ``cfg.norm_type``."""

    def __init__(self, cfg, d: int, device=None):
        super().__init__()
        self.scale = empty_param((d,), torch.float32, device)
        if cfg.norm_type == "layer":
            self.bias = empty_param((d,), torch.float32, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)    # jnp.var: biased
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def apply_norm(p: Norm, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary / absolute positions
# ---------------------------------------------------------------------------
def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).  The two
    halves of each head rotate together (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at arbitrary positions: (..., S) int ->
    (..., S, d) float32."""
    pos = positions.float()[..., None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d))
    ang = pos * div
    pe = torch.zeros(positions.shape + (d,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(length, device=device), d)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


class Attention(nn.Module):
    """``wq`` (d, H*hd), ``wk``/``wv`` (d, K*hd), ``wo`` (H*hd, d)."""

    def __init__(self, cfg, d_model: int, n_heads: int, n_kv: int, hd: int,
                 device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.wq = empty_param((d_model, n_heads * hd), dt, device)
        self.wk = empty_param((d_model, n_kv * hd), dt, device)
        self.wv = empty_param((d_model, n_kv * hd), dt, device)
        self.wo = empty_param((n_heads * hd, d_model), dt, device)


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*groups, hd), each kv head repeated
    ``groups`` times in place (``jnp.repeat``, not a tiling)."""
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def attention(
    p: Attention,
    x: torch.Tensor,
    cfg,
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    causal: bool = True,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    kv_src: Optional[torch.Tensor] = None,     # cross-attention source
    attn_softcap: float = 0.0,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    src = kv_src if kv_src is not None else x
    S_kv = src.shape[1]
    seq_ok = cfg.seq_shard_attn
    q = partition.shard_heads((x @ p.wq.to(x.dtype)).reshape(
        B, S, n_heads, hd), role="q", seq_ok=seq_ok)
    k = partition.shard_heads((src @ p.wk.to(x.dtype)).reshape(
        B, S_kv, n_kv, hd), role="kv")
    v = partition.shard_heads((src @ p.wv.to(x.dtype)).reshape(
        B, S_kv, n_kv, hd), role="kv")

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope and kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k = partition.shard_heads(_expand_kv(k, n_heads // n_kv), role="kv")
    v = partition.shard_heads(_expand_kv(v, n_heads // n_kv), role="kv")

    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    scores = softcap(scores, attn_softcap)

    if kv_src is None:  # self-attention masks
        qi = torch.arange(S, device=x.device)[:, None]
        ki = torch.arange(S_kv, device=x.device)[None, :]
        mask = torch.ones((S, S_kv), dtype=torch.bool, device=x.device)
        if causal:
            mask &= ki <= qi
        if window > 0:
            mask &= qi - ki < window
        # -1e30 in the compute dtype, as jnp.where casts it
        scores = scores.masked_fill(~mask[None, None], -1e30)

    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, n_heads * hd)
    out = partition.shard_fused_heads(out, n_heads=n_heads, seq_ok=seq_ok)
    return partition.shard_tokens(out @ p.wo.to(x.dtype))


def attention_decode(
    p: Attention,
    x: torch.Tensor,                # (B, 1, D)
    cache: dict,                    # {"k","v": (B, C, n_kv, hd)}
    pos: int,                       # absolute position
    cfg,
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    window: int = 0,
    attn_softcap: float = 0.0,
    use_rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a (ring-buffered when windowed) KV cache.

    The new K/V are written into ``cache`` in place (the JAX function
    returns an updated copy); the same dict is returned."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q = (x @ p.wq.to(x.dtype)).reshape(B, 1, n_heads, hd)
    k_new = (x @ p.wk.to(x.dtype)).reshape(B, 1, n_kv, hd)
    v_new = (x @ p.wv.to(x.dtype)).reshape(B, 1, n_kv, hd)
    if use_rope:
        pvec = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k_new = apply_rope(k_new, pvec, cfg.rope_theta)

    slot = pos % C  # ring buffer (C == window when windowed, else C == S_max)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    kx = _expand_kv(cache["k"], n_heads // n_kv)
    vx = _expand_kv(cache["v"], n_heads // n_kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kx) / math.sqrt(hd)
    scores = softcap(scores, attn_softcap)
    valid = torch.arange(C, device=x.device) <= pos   # unfilled ring slots
    scores = scores.masked_fill(~valid[None, None, None, :], -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx).reshape(B, 1, n_heads * hd)
    return out @ p.wo.to(x.dtype), cache


def init_kv_cache(cfg, batch: int, seq_len: int, n_kv: int, hd: int,
                  window: int = 0, device=None) -> dict:
    C = min(seq_len, window) if window > 0 else seq_len
    dt = dtype_of(cfg.compute_dtype)
    return {
        "k": torch.zeros((batch, C, n_kv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, C, n_kv, hd), dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------
class FFN(nn.Module):
    """swiglu/geglu: ``w_gate``, ``w_up`` (d, d_ff), ``w_down`` (d_ff, d);
    gelu: ``w_in`` (d, d_ff), ``w_out`` (d_ff, d)."""

    def __init__(self, cfg, d_model: int, d_ff: int, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        if cfg.ffn_type in ("swiglu", "geglu"):
            self.w_gate = empty_param((d_model, d_ff), dt, device)
            self.w_up = empty_param((d_model, d_ff), dt, device)
            self.w_down = empty_param((d_ff, d_model), dt, device)
        else:
            self.w_in = empty_param((d_model, d_ff), dt, device)
            self.w_out = empty_param((d_ff, d_model), dt, device)


def init_ffn(key: torch.Tensor, cfg, d_model: int, d_ff: int) -> dict:
    keys = prng.split(key, 3)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    dt = dtype_of(cfg.param_dtype)
    k1, k2, k3 = (keys[..., i, :] for i in range(3))
    if cfg.ffn_type in ("swiglu", "geglu"):
        return {
            "w_gate": scaled_normal(k1, (d_model, d_ff), s_in, dt),
            "w_up": scaled_normal(k2, (d_model, d_ff), s_in, dt),
            "w_down": scaled_normal(k3, (d_ff, d_model), s_out, dt),
        }
    return {
        "w_in": scaled_normal(k1, (d_model, d_ff), s_in, dt),
        "w_out": scaled_normal(k2, (d_ff, d_model), s_out, dt),
    }


def ffn(p: FFN, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    if cfg.ffn_type == "swiglu":
        h = F.silu(partition.shard_ff(x @ p.w_gate.to(dt))) * (
            x @ p.w_up.to(dt))
    elif cfg.ffn_type == "geglu":
        h = F.gelu(partition.shard_ff(x @ p.w_gate.to(dt)),
                   approximate="tanh") * (x @ p.w_up.to(dt))
    else:
        h = F.gelu(partition.shard_ff(x @ p.w_in.to(dt)), approximate="tanh")
        return partition.shard_tokens(h @ p.w_out.to(dt))
    h = partition.shard_ff(h)
    return partition.shard_tokens(h @ p.w_down.to(dt))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    """``tokens`` (vocab_padded, d), and ``lm_head`` (d, vocab_padded)
    unless the embeddings are tied."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.tokens = empty_param((cfg.vocab_padded, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.d_model, cfg.vocab_padded), dt,
                                       device)


def init_embed(key: torch.Tensor, cfg) -> dict:
    dt = dtype_of(cfg.param_dtype)
    keys = prng.split(key)
    p = {"tokens": scaled_normal(keys[..., 0, :],
                                 (cfg.vocab_padded, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = scaled_normal(keys[..., 1, :],
                                     (cfg.d_model, cfg.vocab_padded),
                                     math.sqrt(cfg.d_model), dt, divide=True)
    return p


def embed_tokens(p: Embed, tokens: torch.Tensor, cfg,
                 pos_offset: int = 0) -> torch.Tensor:
    x = F.embedding(tokens, p.tokens).to(dtype_of(cfg.compute_dtype))
    x = partition.shard_tokens(x)
    if cfg.pos_type == "abs":  # whisper-style absolute positions
        positions = torch.arange(tokens.shape[-1], device=tokens.device) \
            + pos_offset
        x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    return x


def lm_logits(p: Embed, x: torch.Tensor, cfg) -> torch.Tensor:
    w = p.tokens.T if cfg.tie_embeddings else p.lm_head
    logits = partition.shard_ff(x @ w.to(x.dtype))  # vocab over "model"
    return softcap(logits, cfg.logits_softcap)
