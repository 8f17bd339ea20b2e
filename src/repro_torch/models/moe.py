"""Mixture-of-Experts FFN: top-k routing with grouped (sorted) expert
matmuls, and the capacity-padded dense dispatch.

The port of ``repro/models/moe.py``.  The token copies are sorted by expert
id (a stable sort, as ``jnp.argsort``) and each expert's contiguous group
goes through its own ``torch.matmul``: what ``jax.lax.ragged_dot`` computes.
Routing keeps the JAX tie rules: ``lax.top_k`` prefers the lower index
among equal probabilities, which a stable descending sort gives.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.models import partition
from repro_torch.models.layers import dtype_of, empty_param, scaled_normal


class MoE(nn.Module):
    """``router`` (d, E) float32; ``w_gate``/``w_up`` (E, d, d_ff) and
    ``w_down`` (E, d_ff, d) in the parameter dtype."""

    def __init__(self, cfg, d_model: int, d_ff: int, device=None):
        super().__init__()
        E = cfg.moe.num_experts
        dt = dtype_of(cfg.param_dtype)
        self.router = empty_param((d_model, E), torch.float32, device)
        self.w_gate = empty_param((E, d_model, d_ff), dt, device)
        self.w_up = empty_param((E, d_model, d_ff), dt, device)
        self.w_down = empty_param((E, d_ff, d_model), dt, device)


def init_moe(key: torch.Tensor, cfg, d_model: int, d_ff: int) -> dict:
    E = cfg.moe.num_experts
    keys = prng.split(key, 4)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    dt = dtype_of(cfg.param_dtype)
    return {
        "router": scaled_normal(keys[..., 0, :], (d_model, E), s_in),
        "w_gate": scaled_normal(keys[..., 1, :], (E, d_model, d_ff), s_in, dt),
        "w_up": scaled_normal(keys[..., 2, :], (E, d_model, d_ff), s_in, dt),
        "w_down": scaled_normal(keys[..., 3, :], (E, d_ff, d_model), s_out,
                                dt),
    }


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: MoE, xf: torch.Tensor, cfg):
    """(top_w (T, K) normalised, top_i (T, K), aux loss)."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    router_logits = xf.float() @ p.router                       # (T, E)
    probs = torch.softmax(router_logits, dim=-1)
    top_w, top_i = _top_k(probs, K)                             # (T, K)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    # Switch-style load balance: E * sum_e f_e * p_e
    dispatch_frac = F.one_hot(top_i, E).float().sum(1).mean(0)
    aux = E * (dispatch_frac * probs.mean(0)).sum() * cfg.moe.aux_loss_weight
    return top_w, top_i, aux


def _group_sizes(expert_id: torch.Tensor, E: int) -> list[int]:
    """Token copies per expert.  A ``meta`` tensor holds no ids, so there
    the ``T*K`` copies are spread evenly (``T*K // E`` a group, the
    remainder to the first groups): the grouped products' FLOPs depend only
    on the groups' sum, which the dry-run counts (``launch/costmodel.py``)."""
    if expert_id.device.type == "meta":
        q, r = divmod(expert_id.numel(), E)
        return [q + (e < r) for e in range(E)]
    return torch.bincount(expert_id, minlength=E).tolist()


def _grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                    sizes: list[int]) -> torch.Tensor:
    """``ragged_dot``: rows [start_e, start_e + sizes[e]) of ``xs`` times
    ``w[e]``, for each expert e in order."""
    parts, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            parts.append(xs[start:start + n] @ w[e])
        start += n
    if not parts:
        return xs.new_zeros((0, w.shape[-1]))
    return torch.cat(parts)


def moe_ffn(p: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss); the grouped ("ragged") dispatch."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    xf = x.reshape(T, D)
    top_w, top_i, aux = _route(p, xf, cfg)

    # Token copies sorted by expert: one matmul per contiguous group.
    expert_id = top_i.reshape(T * K)
    order = torch.argsort(expert_id, stable=True)
    inv_order = torch.argsort(order, stable=True)
    xs = xf.repeat_interleave(K, dim=0)[order]                  # (T*K, D)
    sizes = _group_sizes(expert_id, E)

    dt = x.dtype
    hg = partition.shard_ff(_grouped_matmul(xs, p.w_gate.to(dt), sizes))
    hu = partition.shard_ff(_grouped_matmul(xs, p.w_up.to(dt), sizes))
    act = F.silu(hg) * hu
    ys = _grouped_matmul(act, p.w_down.to(dt), sizes)           # (T*K, D)

    y = ys[inv_order].reshape(T, K, D)
    out = (y * top_w[..., None].to(dt)).sum(1)
    return partition.shard_tokens(out.reshape(B, S, D)), aux


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_ffn_dense(p: MoE, x: torch.Tensor,
                  cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-padded dense dispatch: (E, C, D) buckets + batched matmuls;
    token copies past capacity C are dropped."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    TK = T * K
    xf = x.reshape(T, D)
    top_w, top_i, aux = _route(p, xf, cfg)

    # Rank of each token copy within its expert bucket.
    expert_id = top_i.reshape(TK)
    order = torch.argsort(expert_id, stable=True)
    sorted_e = expert_id[order]
    group_sizes = (torch.tensor(_group_sizes(expert_id, E), device=x.device)
                   if x.device.type == "meta"
                   else torch.bincount(expert_id, minlength=E))
    starts = torch.cumsum(group_sizes, 0) - group_sizes         # exclusive
    rank_sorted = torch.arange(TK, device=x.device) - starts[sorted_e]

    C = _round_up(max(1, int(TK / E * cfg.moe.capacity_factor)), 256)
    keep = rank_sorted < C
    slot = torch.where(keep, rank_sorted, 0)

    token_sorted = order // K
    dt = x.dtype
    # a dropped copy adds zero to slot 0 of its expert, as the JAX .at[].add
    xd = torch.zeros((E, C, D), dtype=dt, device=x.device).index_put(
        (sorted_e, slot),
        torch.where(keep[:, None], xf[token_sorted], 0).to(dt),
        accumulate=True)
    xd = partition.shard_ecd(xd)

    h = partition.shard_ecd(torch.einsum("ecd,edf->ecf", xd,
                                         p.w_gate.to(dt)))
    u = torch.einsum("ecd,edf->ecf", xd, p.w_up.to(dt))
    act = F.silu(h) * u
    yd = partition.shard_ecd(torch.einsum("ecf,efd->ecd", act,
                                          p.w_down.to(dt)))     # (E, C, D)

    # Combine back: gather each copy's expert output (dropped copies get 0).
    ys = torch.where(keep[:, None], yd[sorted_e, slot], 0).to(dt)
    inv_order = torch.argsort(order, stable=True)
    y = ys[inv_order].reshape(T, K, D)
    out = (y * top_w[..., None].to(dt)).sum(1)
    return partition.shard_tokens(out.reshape(B, S, D)), aux


def moe_ffn_dispatch(p: MoE, x: torch.Tensor, cfg):
    """Select implementation by cfg.moe.impl."""
    if cfg.moe.impl == "dense":
        return moe_ffn_dense(p, x, cfg)
    return moe_ffn(p, x, cfg)
