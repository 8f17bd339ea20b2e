"""Block-level composition: the parameters, full-sequence forward and
single-token decode of every block type.

The port of ``repro/models/blocks.py``.  A block is (x) -> (x, aux).
Pre-norm residual throughout; gemma2 adds post-norms (cfg.post_norm).
Decode threads a per-block cache.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod

ATTN_TYPES = {"attn", "attn_local", "attn_swa", "attn_moe", "enc_attn", "dec_attn"}
MOE_TYPES = ("attn_swa", "attn_moe")
WINDOWED_TYPES = ("attn_local", "attn_swa")


class Block(nn.Module):
    """The parameters of one block of ``block_type``, named as the JAX
    ``init_block`` dict."""

    def __init__(self, block_type: str, cfg, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.block_type = block_type
        if block_type in ATTN_TYPES:
            self.ln_attn = layers.Norm(cfg, d, device)
            self.attn = layers.Attention(cfg, d, cfg.n_heads, cfg.n_kv_heads,
                                         hd, device)
            if cfg.post_norm:
                self.ln_attn_post = layers.Norm(cfg, d, device)
            if block_type == "dec_attn":
                self.ln_cross = layers.Norm(cfg, d, device)
                self.cross = layers.Attention(cfg, d, cfg.n_heads,
                                              cfg.n_heads, hd, device)
            self.ln_ffn = layers.Norm(cfg, d, device)
            if block_type in MOE_TYPES:
                self.moe = moe_mod.MoE(cfg, d, cfg.d_ff, device)
            else:
                self.ffn = layers.FFN(cfg, d, cfg.d_ff, device)
            if cfg.post_norm:
                self.ln_ffn_post = layers.Norm(cfg, d, device)
        elif block_type == "mamba":
            self.ln = layers.Norm(cfg, d, device)
            self.mamba = ssm_mod.Mamba(cfg, d, device)
        elif block_type == "rwkv":
            self.ln_time = layers.Norm(cfg, d, device)
            self.time = ssm_mod.RWKVTime(cfg, d, device)
            self.ln_chan = layers.Norm(cfg, d, device)
            self.chan = ssm_mod.RWKVChannel(cfg, d, cfg.d_ff, device)
        else:
            raise ValueError(f"unknown block type {block_type!r}")


class SharedAttn(nn.Module):
    """Zamba2's weight-shared attention+FFN block (applied periodically)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.ln_attn = layers.Norm(cfg, d, device)
        self.attn = layers.Attention(cfg, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                     device)
        self.ln_ffn = layers.Norm(cfg, d, device)
        self.ffn = layers.FFN(cfg, d, cfg.d_ff, device)


# ---------------------------------------------------------------------------
# Init (the JAX parameter dicts; a batch of keys stacks the leaves)
# ---------------------------------------------------------------------------
def init_block(key: torch.Tensor, block_type: str, cfg) -> dict:
    d, hd = cfg.d_model, cfg.hd
    keys = [k for k in prng.split(key, 8).unbind(-2)]
    p: dict = {}
    if block_type in ATTN_TYPES:
        p["ln_attn"] = layers.init_norm(cfg, d, key)
        p["attn"] = layers.init_attention(keys[0], cfg, d, cfg.n_heads,
                                          cfg.n_kv_heads, hd)
        if cfg.post_norm:
            p["ln_attn_post"] = layers.init_norm(cfg, d, key)
        if block_type == "dec_attn":
            p["ln_cross"] = layers.init_norm(cfg, d, key)
            p["cross"] = layers.init_attention(keys[1], cfg, d, cfg.n_heads,
                                               cfg.n_heads, hd, cross=True)
        p["ln_ffn"] = layers.init_norm(cfg, d, key)
        if block_type in MOE_TYPES:
            p["moe"] = moe_mod.init_moe(keys[2], cfg, d, cfg.d_ff)
        else:
            p["ffn"] = layers.init_ffn(keys[2], cfg, d, cfg.d_ff)
        if cfg.post_norm:
            p["ln_ffn_post"] = layers.init_norm(cfg, d, key)
    elif block_type == "mamba":
        p["ln"] = layers.init_norm(cfg, d, key)
        p["mamba"] = ssm_mod.init_mamba(keys[0], cfg, d)
    elif block_type == "rwkv":
        p["ln_time"] = layers.init_norm(cfg, d, key)
        p["time"] = ssm_mod.init_rwkv(keys[0], cfg, d)
        p["ln_chan"] = layers.init_norm(cfg, d, key)
        p["chan"] = ssm_mod.init_rwkv_channel(keys[1], cfg, d, cfg.d_ff)
    else:
        raise ValueError(f"unknown block type {block_type!r}")
    return p


def init_shared_attn(key: torch.Tensor, cfg) -> dict:
    """Zamba2's weight-shared attention+FFN block (applied periodically)."""
    d, hd = cfg.d_model, cfg.hd
    keys = prng.split(key)
    return {
        "ln_attn": layers.init_norm(cfg, d, key),
        "attn": layers.init_attention(keys[..., 0, :], cfg, d, cfg.n_heads,
                                      cfg.n_kv_heads, hd),
        "ln_ffn": layers.init_norm(cfg, d, key),
        "ffn": layers.init_ffn(keys[..., 1, :], cfg, d, cfg.d_ff),
    }


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------
def _window(block_type: str, cfg) -> int:
    return cfg.window if block_type in WINDOWED_TYPES else 0


def _attn_kwargs(block_type: str, cfg) -> dict:
    return dict(
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        causal=block_type != "enc_attn",
        window=_window(block_type, cfg),
        attn_softcap=cfg.attn_softcap,
        use_rope=cfg.pos_type == "rope",
    )


def _ffn_part(p: Block, x: torch.Tensor, cfg):
    """The FFN (or MoE) half of an attention block: (x, aux)."""
    z = layers.apply_norm(p.ln_ffn, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if p.block_type in MOE_TYPES:
        h, aux = moe_mod.moe_ffn_dispatch(p.moe, z, cfg)
    else:
        h = layers.ffn(p.ffn, z, cfg)
    if cfg.post_norm:
        h = layers.apply_norm(p.ln_ffn_post, h, cfg)
    return x + h, aux


def block_forward(
    p: Block, x: torch.Tensor, cfg,
    enc_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    block_type = p.block_type
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if block_type in ATTN_TYPES:
        h = layers.attention(
            p.attn, layers.apply_norm(p.ln_attn, x, cfg), cfg,
            **_attn_kwargs(block_type, cfg),
        )
        if cfg.post_norm:
            h = layers.apply_norm(p.ln_attn_post, h, cfg)
        x = x + h
        if block_type == "dec_attn":
            h = layers.attention(
                p.cross, layers.apply_norm(p.ln_cross, x, cfg), cfg,
                n_heads=cfg.n_heads, n_kv=cfg.n_heads, hd=cfg.hd,
                causal=False, kv_src=enc_out, use_rope=False,
            )
            x = x + h
        x, aux = _ffn_part(p, x, cfg)
    elif block_type == "mamba":
        x = x + ssm_mod.mamba_forward(
            p.mamba, layers.apply_norm(p.ln, x, cfg), cfg, cfg.d_model
        )
    elif block_type == "rwkv":
        x = x + ssm_mod.rwkv_forward(
            p.time, layers.apply_norm(p.ln_time, x, cfg), cfg, cfg.d_model
        )
        out, _ = ssm_mod.rwkv_channel_mix(
            p.chan, layers.apply_norm(p.ln_chan, x, cfg)
        )
        x = x + out
    else:
        raise ValueError(block_type)
    return x, aux


def shared_attn_forward(p: SharedAttn, x: torch.Tensor, cfg) -> torch.Tensor:
    h = layers.attention(
        p.attn, layers.apply_norm(p.ln_attn, x, cfg), cfg,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        causal=True, use_rope=cfg.pos_type == "rope",
    )
    x = x + h
    x = x + layers.ffn(p.ffn, layers.apply_norm(p.ln_ffn, x, cfg), cfg)
    return x


# ---------------------------------------------------------------------------
# Cache init + decode (single token)
# ---------------------------------------------------------------------------
def init_block_cache(block_type: str, cfg, batch: int, seq_len: int,
                     device=None) -> dict:
    if block_type in ATTN_TYPES:
        return layers.init_kv_cache(
            cfg, batch, seq_len, cfg.n_kv_heads, cfg.hd,
            _window(block_type, cfg), device)
    if block_type == "mamba":
        return ssm_mod.init_mamba_cache(cfg, batch, cfg.d_model, device)
    if block_type == "rwkv":
        c = ssm_mod.init_rwkv_cache(cfg, batch, cfg.d_model, device)
        c["chan_prev"] = torch.zeros((batch, 1, cfg.d_model),
                                     dtype=torch.float32, device=device)
        return c
    raise ValueError(block_type)


def block_decode(
    p: Block, x: torch.Tensor, cache: dict, pos: int, cfg,
    cross_cache: Optional[dict] = None,
) -> tuple[torch.Tensor, dict]:
    block_type = p.block_type
    if block_type in ATTN_TYPES:
        h, new_cache = layers.attention_decode(
            p.attn, layers.apply_norm(p.ln_attn, x, cfg), cache, pos, cfg,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            window=_window(block_type, cfg), attn_softcap=cfg.attn_softcap,
            use_rope=cfg.pos_type == "rope",
        )
        if cfg.post_norm:
            h = layers.apply_norm(p.ln_attn_post, h, cfg)
        x = x + h
        if block_type == "dec_attn":
            # cross-attention against precomputed encoder K/V (cross_cache)
            h = _cross_decode(p.cross, layers.apply_norm(p.ln_cross, x, cfg),
                              cross_cache, cfg)
            x = x + h
        x, _ = _ffn_part(p, x, cfg)
        return x, new_cache
    if block_type == "mamba":
        h, new_cache = ssm_mod.mamba_decode(
            p.mamba, layers.apply_norm(p.ln, x, cfg), cache, cfg, cfg.d_model
        )
        return x + h, new_cache
    if block_type == "rwkv":
        h, time_cache = ssm_mod.rwkv_decode(
            p.time, layers.apply_norm(p.ln_time, x, cfg),
            {"state": cache["state"], "x_prev": cache["x_prev"]}, cfg,
            cfg.d_model,
        )
        x = x + h
        z = layers.apply_norm(p.ln_chan, x, cfg)
        out, _ = ssm_mod.rwkv_channel_mix(
            p.chan, z, x_prev=cache["chan_prev"].to(z.dtype)
        )
        new_cache = dict(time_cache, chan_prev=z.float())
        return x + out, new_cache
    raise ValueError(block_type)


def _cross_decode(p: layers.Attention, x: torch.Tensor, cross_cache: dict,
                  cfg) -> torch.Tensor:
    """Cross-attention with K/V precomputed once from encoder output."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p.wq.to(x.dtype)).reshape(B, 1, H, hd)
    k, v = cross_cache["k"], cross_cache["v"]     # (B, S_enc, H, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, 1, H * hd)
    return out @ p.wo.to(x.dtype)


def shared_attn_decode(p: SharedAttn, x: torch.Tensor, cache: dict, pos: int,
                       cfg):
    h, new_cache = layers.attention_decode(
        p.attn, layers.apply_norm(p.ln_attn, x, cfg), cache, pos, cfg,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        use_rope=cfg.pos_type == "rope",
    )
    x = x + h
    x = x + layers.ffn(p.ffn, layers.apply_norm(p.ln_ffn, x, cfg), cfg)
    return x, new_cache


def make_cross_cache(p_block: Block, enc_out: torch.Tensor, cfg) -> dict:
    """Precompute cross-attention K/V from encoder output for one dec layer."""
    B, S_enc, _ = enc_out.shape
    shape = (B, S_enc, cfg.n_heads, cfg.hd)
    k = (enc_out @ p_block.cross.wk.to(enc_out.dtype)).reshape(shape)
    v = (enc_out @ p_block.cross.wv.to(enc_out.dtype)).reshape(shape)
    return {"k": k, "v": v}
