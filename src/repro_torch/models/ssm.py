"""State-space and linear-recurrence blocks: Mamba2 (SSD) and RWKV-6 (WKV).

The port of ``repro/models/ssm.py``.  Both run in the *chunked*
formulation: quadratic within a chunk, linear state passing between chunks.
The JAX ``lax.scan`` over chunks is a Python loop here.  The per-token
``*_reference`` recurrences are the test oracles and the decode semantics.

Kept exactly as the JAX package writes them: ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (``F.softplus`` turns into the identity above 20); the
Mamba2 decay masks the exponent *before* ``exp`` (a mask after it gives NaN
gradients); RWKV clips the decay logit and exponentiates, and forms
``exp(cls_prev)`` and ``exp(-cls)`` separately.

References: SSD / Mamba-2 (Dao & Gu 2024, arXiv:2405.21060); RWKV-6 "Finch"
(Peng et al. 2024, arXiv:2404.05892).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.models import layers, partition
from repro_torch.models.layers import (dtype_of, empty_param, full,
                                       scaled_normal)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===========================================================================
# Mamba2 / SSD
# ===========================================================================
class Mamba(nn.Module):
    """``in_proj`` emits [z (d_in), x (d_in), B (N), C (N), dt (H)]."""

    def __init__(self, cfg, d_model: int, device=None):
        super().__init__()
        s = cfg.ssm
        d_in = s.d_inner(d_model)
        H = s.n_heads(d_model)
        N = s.d_state
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        self.in_proj = empty_param((d_model, 2 * d_in + 2 * N + H), dt, device)
        self.conv = empty_param((s.conv_kernel, d_in), dt, device)
        self.A_log = empty_param((H,), f32, device)
        self.D = empty_param((H,), f32, device)
        self.dt_bias = empty_param((H,), f32, device)
        self.norm = empty_param((d_in,), f32, device)    # gated RMSNorm scale
        self.out_proj = empty_param((d_in, d_model), dt, device)


def init_mamba(key: torch.Tensor, cfg, d_model: int) -> dict:
    s = cfg.ssm
    d_in = s.d_inner(d_model)
    H = s.n_heads(d_model)
    N = s.d_state
    keys = prng.split(key, 6)
    dt = dtype_of(cfg.param_dtype)
    # jnp.log(jnp.linspace(1, 16, H)): jnp.linspace's float32 formula
    # start * (1 - step) + stop * step, step = iota / (H - 1) (both products
    # exact here), and XLA's log
    step = (torch.arange(H - 1, dtype=torch.float32)
            / torch.tensor(float(max(H - 1, 1)), dtype=torch.float32))
    grid = torch.cat([(1.0 - step) + 16.0 * step, torch.tensor([16.0])])
    if H == 1:
        grid = torch.ones(1)
    return {
        "in_proj": scaled_normal(keys[..., 0, :],
                                 (d_model, 2 * d_in + 2 * N + H),
                                 1.0 / math.sqrt(d_model), dt),
        "conv": scaled_normal(keys[..., 1, :], (s.conv_kernel, d_in),
                              1.0 / math.sqrt(s.conv_kernel), dt),
        "A_log": full(key, (H,), prng.log(grid)),
        "D": full(key, (H,), 1.0),
        "dt_bias": full(key, (H,), 0.0),
        "norm": full(key, (d_in,), 0.0),     # gated RMSNorm scale
        "out_proj": scaled_normal(keys[..., 2, :], (d_in, d_model),
                                  1.0 / math.sqrt(d_in), dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, S, C), w: (K, C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def _split_proj(p: Mamba, u: torch.Tensor, cfg, d_model: int):
    s = cfg.ssm
    d_in = s.d_inner(d_model)
    H = s.n_heads(d_model)
    N = s.d_state
    zxbcdt = partition.shard_ff(u @ p.in_proj.to(u.dtype))
    z, xs, Bm, Cm, dt_raw = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    return z, xs, Bm, Cm, dt_raw, d_in, H, N


def _gate_out(p: Mamba, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    y = y * F.silu(z)
    y = layers.rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.out_proj.to(y.dtype)


def mamba_forward(p: Mamba, u: torch.Tensor, cfg, d_model: int) -> torch.Tensor:
    """Chunked SSD over a full sequence. u: (B, S, D) -> (B, S, D)."""
    s = cfg.ssm
    B_, S, _ = u.shape
    z, xs, Bm, Cm, dt_raw, d_in, H, N = _split_proj(p, u, cfg, d_model)
    xs = F.silu(_causal_conv(xs, p.conv.to(xs.dtype)))

    P = s.head_dim
    L = min(s.chunk, S)
    if S % L:
        raise ValueError(f"seq {S} must be a multiple of ssm chunk {L}")
    nc = S // L

    xh = xs.reshape(B_, nc, L, H, P).float()
    dt = softplus(dt_raw.float() + p.dt_bias)                         # (B,S,H)
    dt = dt.reshape(B_, nc, L, H)
    A = -torch.exp(p.A_log)                                           # (H,)
    dA = dt * A                                                       # (B,nc,L,H)
    Bc = Bm.reshape(B_, nc, L, N).float()
    Cc = Cm.reshape(B_, nc, L, N).float()

    cs = torch.cumsum(dA, dim=2)                                      # (B,nc,L,H)
    # Intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                      # (B,nc,L,L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=u.device))[None, None, :, :, None]
    # Mask the exponent BEFORE exp: the upper triangle holds cs_i - cs_j > 0
    # which overflows, and inf * 0 in the backward of a later mask is NaN.
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]                # (B,nc,L,L,H)
    decay = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = cb[..., None] * decay
    y = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dt, xh)

    # Chunk-final states and the inter-chunk pass.
    seg = torch.exp(cs[:, :, -1:, :] - cs)                            # (B,nc,L,H)
    states = torch.einsum("bcjh,bcjh,bcjn,bcjhp->bchnp", seg, dt, Bc, xh)
    total = torch.exp(cs[:, :, -1, :])                                # (B,nc,H)

    carry = torch.zeros((B_, H, N, P), dtype=torch.float32, device=u.device)
    prev = []                         # the state entering each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * total[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                            # (B,nc,H,N,P)

    y = y + torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cs),
                         prev_states)
    y = y + p.D[None, None, None, :, None] * xh                       # skip
    y = y.reshape(B_, S, d_in).to(u.dtype)
    return _gate_out(p, y, z, cfg)


def mamba_reference(p: Mamba, u: torch.Tensor, cfg,
                    d_model: int) -> torch.Tensor:
    """Per-token recurrence (oracle + decode semantics)."""
    s = cfg.ssm
    B_, S, _ = u.shape
    z, xs, Bm, Cm, dt_raw, d_in, H, N = _split_proj(p, u, cfg, d_model)
    xs = F.silu(_causal_conv(xs, p.conv.to(xs.dtype)))
    P = s.head_dim
    xh = xs.reshape(B_, S, H, P).float()
    dt = softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    Bc = Bm.float()
    Cc = Cm.float()

    state = torch.zeros((B_, H, N, P), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[..., None, None]       # (B,H,1,1)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, t], Bc[:, t], xh[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cc[:, t], state))
    y = torch.stack(ys, dim=1) + p.D[None, None, :, None] * xh
    y = y.reshape(B_, S, d_in).to(u.dtype)
    return _gate_out(p, y, z, cfg)


def init_mamba_cache(cfg, batch: int, d_model: int, device=None) -> dict:
    s = cfg.ssm
    H = s.n_heads(d_model)
    return {
        "state": torch.zeros((batch, H, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, s.d_inner(d_model)),
                            dtype=torch.float32, device=device),
    }


def mamba_decode(p: Mamba, u: torch.Tensor, cache: dict, cfg, d_model: int):
    """One-token step. u: (B, 1, D) -> ((B, 1, D), new_cache)."""
    s = cfg.ssm
    B_ = u.shape[0]
    z, xs, Bm, Cm, dt_raw, d_in, H, N = _split_proj(p, u, cfg, d_model)
    # causal conv over [cached K-1 inputs, current]
    conv_in = torch.cat([cache["conv"], xs.float()], dim=1)
    w = p.conv.float()
    xt = torch.einsum("bkc,kc->bc", conv_in, w)[:, None, :]
    xt = F.silu(xt)
    new_conv = conv_in[:, 1:, :]

    P = s.head_dim
    xh = xt.reshape(B_, H, P).float()
    dt = softplus(dt_raw.float() + p.dt_bias)[:, 0]                  # (B,H)
    A = -torch.exp(p.A_log)
    b_t = Bm[:, 0].float()
    c_t = Cm[:, 0].float()

    decay = torch.exp(dt * A)[..., None, None]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, b_t, xh)
    state = cache["state"] * decay + upd
    y = torch.einsum("bn,bhnp->bhp", c_t, state) + p.D[None, :, None] * xh
    y = y.reshape(B_, 1, d_in).to(u.dtype)
    return _gate_out(p, y, z, cfg), {"state": state, "conv": new_conv}


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================
class RWKVTime(nn.Module):
    """Time mix: token-shift weights ``mu`` (5, d) for r, k, v, w, g; the
    data-dependent decay ``w_t = exp(-exp(w0 + tanh(x wA) wB))``."""

    def __init__(self, cfg, d_model: int, device=None):
        super().__init__()
        lora = cfg.rwkv.decay_lora
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        self.mu = empty_param((5, d_model), f32, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, empty_param((d_model, d_model), dt, device))
        self.w0 = empty_param((d_model,), f32, device)
        self.wA = empty_param((d_model, lora), f32, device)
        self.wB = empty_param((lora, d_model), f32, device)
        self.u = empty_param((d_model,), f32, device)
        self.ln_scale = empty_param((d_model,), f32, device)  # per-head norm
        self.ln_bias = empty_param((d_model,), f32, device)


def init_rwkv(key: torch.Tensor, cfg, d_model: int) -> dict:
    lora = cfg.rwkv.decay_lora
    keys = [k for k in prng.split(key, 10).unbind(-2)]
    dt = dtype_of(cfg.param_dtype)
    s = 1.0 / math.sqrt(d_model)
    sq = (d_model, d_model)
    return {
        "mu": full(key, (5, d_model), 0.5),
        "wr": scaled_normal(keys[0], sq, s, dt),
        "wk": scaled_normal(keys[1], sq, s, dt),
        "wv": scaled_normal(keys[2], sq, s, dt),
        "wg": scaled_normal(keys[3], sq, s, dt),
        "wo": scaled_normal(keys[4], sq, s, dt),
        "w0": full(key, (d_model,), -1.0),
        "wA": scaled_normal(keys[5], (d_model, lora), s),
        "wB": scaled_normal(keys[6], (lora, d_model), 1.0 / math.sqrt(lora)),
        "u": scaled_normal(keys[7], (d_model,), 0.1),
        "ln_scale": full(key, (d_model,), 1.0),
        "ln_bias": full(key, (d_model,), 0.0),
    }


def _shift(x: torch.Tensor, x_prev=None) -> torch.Tensor:
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return torch.cat([x_prev, x[:, :-1, :]], dim=1)


def _rwkv_inputs(p: RWKVTime, x: torch.Tensor, cfg, x_prev=None):
    """Token-shifted projections. x: (B, S, D)."""
    shifted = _shift(x, x_prev)
    mu = p.mu.to(x.dtype)

    def mix(i):
        return x + mu[i] * (shifted - x)

    r = partition.shard_ff(mix(0) @ p.wr.to(x.dtype))
    k = partition.shard_ff(mix(1) @ p.wk.to(x.dtype))
    v = partition.shard_ff(mix(2) @ p.wv.to(x.dtype))
    logw = -torch.exp(torch.clamp(
        p.w0 + torch.tanh(mix(3).float() @ p.wA) @ p.wB, -8.0, 1.0))
    g = F.silu(mix(4) @ p.wg.to(x.dtype))
    return r, k, v, logw, g


def _group_norm(y: torch.Tensor, scale, bias, H: int, eps: float):
    """Per-head LayerNorm (RWKV's GroupNorm over heads)."""
    B_, S, D = y.shape
    yh = y.reshape(B_, S, H, D // H).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(B_, S, D) * scale + bias).to(y.dtype)


def _time_out(p: RWKVTime, y: torch.Tensor, g: torch.Tensor, H: int, cfg):
    y = _group_norm(y, p.ln_scale, p.ln_bias, H, cfg.norm_eps)
    return (y * g) @ p.wo.to(y.dtype)


def rwkv_forward(p: RWKVTime, x: torch.Tensor, cfg, d_model: int) -> torch.Tensor:
    """Chunked WKV-6 over a full sequence. x: (B, S, D)."""
    r_cfg = cfg.rwkv
    B_, S, D = x.shape
    H = D // r_cfg.head_dim
    K = r_cfg.head_dim
    L = min(r_cfg.chunk, S)
    if S % L:
        raise ValueError(f"seq {S} must be a multiple of rwkv chunk {L}")
    nc = S // L

    r, k, v, logw, g = _rwkv_inputs(p, x, cfg)
    shp = (B_, nc, L, H, K)
    rr = r.reshape(shp).float()
    kk = k.reshape(shp).float()
    vv = v.reshape(shp).float()
    lw = logw.reshape(shp)                          # (B,nc,L,H,K), <= 0
    u = p.u.reshape(H, K)

    # cls_i = sum_{t<=i} logw_t (inclusive); decay j->i uses cls_{i-1} - cls_j.
    cls = torch.cumsum(lw, dim=2)
    cls_prev = cls - lw                              # exclusive cumsum
    a = rr * torch.exp(cls_prev)                     # (B,nc,L,H,K)
    b = kk * torch.exp(-cls)
    scores = torch.einsum("bclhk,bcmhk->bchlm", a, b)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device),
                     diagonal=-1)                    # strictly lower: j < i
    scores = torch.where(tri[None, None, None], scores, 0.0)
    y = torch.einsum("bchlm,bcmhk->bclhk", scores, vv)
    # bonus term at j == i: y_i += (r_i . (u * k_i)) v_i
    bonus = torch.einsum("bclhk,hk,bclhk->bclh", rr, u, kk)
    y = y + bonus[..., None] * vv

    # Inter-chunk state passing: S (B,H,K,V)
    seg = torch.exp(cls[:, :, -1:, :, :] - cls)      # decay from j to chunk end
    states = torch.einsum("bcjhk,bcjhk,bcjhv->bchkv", seg, kk, vv)
    total = torch.exp(cls[:, :, -1])                 # (B,nc,H,K)

    carry = torch.zeros((B_, H, K, K), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * total[:, c, ..., None] + states[:, c]
    prev = torch.stack(prev, dim=1)                  # (B,nc,H,K,V)
    y = y + torch.einsum("bclhk,bchkv->bclhv", a, prev)

    y = y.reshape(B_, S, D).to(x.dtype)
    return _time_out(p, y, g, H, cfg)


def rwkv_reference(p: RWKVTime, x: torch.Tensor, cfg,
                   d_model: int) -> torch.Tensor:
    """Naive per-token WKV recurrence (oracle + decode semantics)."""
    r_cfg = cfg.rwkv
    B_, S, D = x.shape
    H = D // r_cfg.head_dim
    K = r_cfg.head_dim
    r, k, v, logw, g = _rwkv_inputs(p, x, cfg)
    rr = r.reshape(B_, S, H, K).float()
    kk = k.reshape(B_, S, H, K).float()
    vv = v.reshape(B_, S, H, K).float()
    lw = logw.reshape(B_, S, H, K)
    u = p.u.reshape(H, K)

    state = torch.zeros((B_, H, K, K), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kk[:, t], vv[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rr[:, t],
                               state + u[None, :, :, None] * kv))
        state = state * torch.exp(lw[:, t])[..., None] + kv
    y = torch.stack(ys, dim=1).reshape(B_, S, D).to(x.dtype)
    return _time_out(p, y, g, H, cfg)


def init_rwkv_cache(cfg, batch: int, d_model: int, device=None) -> dict:
    K = cfg.rwkv.head_dim
    H = d_model // K
    return {
        "state": torch.zeros((batch, H, K, K), dtype=torch.float32,
                             device=device),
        "x_prev": torch.zeros((batch, 1, d_model), dtype=torch.float32,
                              device=device),
    }


def rwkv_decode(p: RWKVTime, x: torch.Tensor, cache: dict, cfg, d_model: int):
    """One-token step. x: (B, 1, D)."""
    r_cfg = cfg.rwkv
    B_, _, D = x.shape
    H = D // r_cfg.head_dim
    K = r_cfg.head_dim
    r, k, v, logw, g = _rwkv_inputs(p, x, cfg,
                                    x_prev=cache["x_prev"].to(x.dtype))
    r_t = r.reshape(B_, H, K).float()
    k_t = k.reshape(B_, H, K).float()
    v_t = v.reshape(B_, H, K).float()
    lw_t = logw.reshape(B_, H, K)
    u = p.u.reshape(H, K)

    kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
    y = torch.einsum("bhk,bhkv->bhv", r_t,
                     cache["state"] + u[None, :, :, None] * kv)
    state = cache["state"] * torch.exp(lw_t)[..., None] + kv

    y = y.reshape(B_, 1, D).to(x.dtype)
    out = _time_out(p, y, g, H, cfg)
    return out, {"state": state, "x_prev": x.float()}


class RWKVChannel(nn.Module):
    """Channel mix: ``mu`` (2, d), ``w_in`` (d, d_ff), ``w_out`` (d_ff, d),
    ``w_recept`` (d, d)."""

    def __init__(self, cfg, d_model: int, d_ff: int, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.mu = empty_param((2, d_model), torch.float32, device)
        self.w_in = empty_param((d_model, d_ff), dt, device)
        self.w_out = empty_param((d_ff, d_model), dt, device)
        self.w_recept = empty_param((d_model, d_model), dt, device)


def init_rwkv_channel(key: torch.Tensor, cfg, d_model: int,
                      d_ff: int) -> dict:
    keys = prng.split(key, 3)
    dt = dtype_of(cfg.param_dtype)
    s = 1.0 / math.sqrt(d_model)
    return {
        "mu": full(key, (2, d_model), 0.5),
        "w_in": scaled_normal(keys[..., 0, :], (d_model, d_ff), s, dt),
        "w_out": scaled_normal(keys[..., 1, :], (d_ff, d_model),
                               1.0 / math.sqrt(d_ff), dt),
        "w_recept": scaled_normal(keys[..., 2, :], (d_model, d_model), s, dt),
    }


def rwkv_channel_mix(p: RWKVChannel, x: torch.Tensor, x_prev=None):
    """RWKV channel mixing (the FFN analogue): relu^2 with receptance gate.
    Returns (out, last_x) so decode can carry the token shift."""
    shifted = _shift(x, x_prev)
    mu = p.mu.to(x.dtype)
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    k = torch.square(torch.relu(partition.shard_ff(xk @ p.w_in.to(x.dtype))))
    out = torch.sigmoid(xr @ p.w_recept.to(x.dtype)) * (k @ p.w_out.to(x.dtype))
    return out, x[:, -1:, :]
