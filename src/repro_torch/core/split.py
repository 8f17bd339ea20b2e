"""Split finding: gain evaluation (eq. 1) and the per-node argmax (Alg. 2
step 9) — the counterpart of ``repro/core/split.py``.

Ties decide which of several equal-gain thresholds a node takes, and a
threshold chosen differently routes the training rows the same way but
other rows differently.  Two things make ties come out as in the JAX
package.  ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does.  And the cumulative sums over the bin axis follow
``jnp.cumsum`` on XLA's CPU backend exactly: it scans blocks of 16 bins in
order and adds each block's running total to the blocks after it
(``_cumsum_bins``), so an empty bin (all-zero stats) repeats its left
neighbour's partial sums exactly and every threshold across it has exactly
the same gain — a plateau whose first index wins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import TreeConfig

NEG_INF = float("-inf")
_SCAN_BLOCK = 16  # bins per block of XLA's CPU cumsum


class SplitDecision(NamedTuple):
    feature: torch.Tensor    # (num_nodes,) int32, -1 if no split
    threshold: torch.Tensor  # (num_nodes,) int32; bin <= threshold goes left
    gain: torch.Tensor       # (num_nodes,) float32 (NEG_INF/0 when no split)


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Sequential inclusive sum over the last axis."""
    parts = [x[..., 0]]
    for b in range(1, x.shape[-1]):
        parts.append(parts[-1] + x[..., b])
    return torch.stack(parts, dim=-1)


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in XLA's CPU order: a
    sequential scan inside blocks of 16, each block offset by the running
    total of the blocks before it (computed the same way, recursively)."""
    length = x.shape[-1]
    if length <= _SCAN_BLOCK:
        return _scan(x)
    n_blocks = -(-length // _SCAN_BLOCK)
    padded = torch.nn.functional.pad(x, (0, n_blocks * _SCAN_BLOCK - length))
    local = _scan(padded.reshape(*x.shape[:-1], n_blocks, _SCAN_BLOCK))
    before = _cumsum_bins(local[..., -1])[..., :-1, None]
    out = torch.cat([local[..., :1, :], before + local[..., 1:, :]], dim=-2)
    return out.reshape(*x.shape[:-1], n_blocks * _SCAN_BLOCK)[..., :length]


def _sum_channels(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in order, as XLA's CPU reduction adds it."""
    total = x[..., 0]
    for c in range(1, x.shape[-1]):
        total = total + x[..., c]
    return total


def split_gains(hist: torch.Tensor, cfg: TreeConfig) -> torch.Tensor:
    """Gain of splitting each (node, feature) at each bin threshold.

    Args:
      hist: (..., d, B, 3) histogram — or (..., d, B, 2K+1) for K-channel
        objectives (per-class gains summed, diagonal hessian).
    Returns:
      (..., d, B) float32 gains; invalid candidates are -inf.  Threshold
      semantics: left = {bin <= b}.
    """
    num_bins = hist.shape[-2]
    # (..., S, B): left stats at threshold b, scanned over the bin axis
    cum = _cumsum_bins(hist.transpose(-1, -2))
    total = cum[..., -1:]                                   # (..., S, 1)
    lam = cfg.lambda_
    k = (hist.shape[-1] - 1) // 2
    gl, hl = cum[..., :k, :], cum[..., k:2 * k, :]
    gt, ht = total[..., :k, :], total[..., k:2 * k, :]
    gr, hr = gt - gl, ht - hl
    per_class = (gl * gl / (hl + lam) + gr * gr / (hr + lam)
                 - gt * gt / (ht + lam))                   # (..., K, B)
    if k == 1:  # the scalar-channel path
        gain = 0.5 * per_class[..., 0, :] - cfg.gamma
        hl_sum, hr_sum = hl[..., 0, :], hr[..., 0, :]
    else:
        gain = 0.5 * _sum_channels(per_class.transpose(-1, -2)) - cfg.gamma
        hl_sum = _sum_channels(hl.transpose(-1, -2))
        hr_sum = _sum_channels(hr.transpose(-1, -2))
    valid = ((hl_sum >= cfg.min_child_weight)
             & (hr_sum >= cfg.min_child_weight)
             # threshold == B-1 sends everything left: not a split
             & (torch.arange(num_bins, device=hist.device) < num_bins - 1))
    return torch.where(valid, gain, torch.full_like(gain, NEG_INF))


def choose_splits(hist: torch.Tensor, feature_mask: torch.Tensor,
                  cfg: TreeConfig, feature_offset: int = 0) -> SplitDecision:
    """Pick the best (feature, threshold) per node.

    Args:
      hist: (num_nodes, d, B, 3) — or with a leading tree axis, (T,
        num_nodes, d, B, 3), and then ``feature_mask`` is (T, d).
      feature_mask: (d,) bool — feature subsampling mask (Q_m(j) of eq. 4).
      feature_offset: global index of this histogram's first feature.
    Returns:
      SplitDecision with global feature indices.  Nodes whose best gain is
      not positive get feature = -1 and threshold = B (routes all left).
    """
    *lead, d, num_bins, _ = hist.shape
    gains = split_gains(hist, cfg)                          # (..., d, B)
    mask = feature_mask[..., None, :, None]
    gains = torch.where(mask, gains, torch.full_like(gains, NEG_INF))
    flat = gains.reshape(*lead, d * num_bins)
    best = torch.argmax(flat, dim=-1)                       # first maximum
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    feature = (best // num_bins).to(torch.int32) + feature_offset
    threshold = (best % num_bins).to(torch.int32)
    has_split = best_gain > 0.0
    feature = torch.where(has_split, feature, torch.full_like(feature, -1))
    threshold = torch.where(has_split, threshold,
                            torch.full_like(threshold, num_bins))
    return SplitDecision(feature=feature, threshold=threshold, gain=best_gain)


def choose_splits_round(hist: torch.Tensor, feature_mask: torch.Tensor,
                        cfg: TreeConfig,
                        feature_offset: int = 0) -> SplitDecision:
    """Round-native ``choose_splits``: hist (T, num_nodes, d, B, 3) and
    feature_mask (T, d) -> (T, num_nodes) fields, each tree's argmax the
    per-tree one."""
    return choose_splits(hist, feature_mask, cfg, feature_offset)


def leaf_weights(hist_leaf: torch.Tensor, cfg: TreeConfig) -> torch.Tensor:
    """Optimal leaf weights w = -G / (H + lambda) (Alg. 2 step 14).

    Args:
      hist_leaf: (..., num_leaves, 3) (G, H, count) per leaf — or
        (..., num_leaves, 2K+1) for K-channel objectives.
    Returns:
      (..., num_leaves) float32 — (..., num_leaves, K) at K > 1; empty
      leaves get 0.
    """
    if hist_leaf.shape[-1] == 3:  # K = 1: the scalar path
        g, h, c = hist_leaf[..., 0], hist_leaf[..., 1], hist_leaf[..., 2]
        w = -g / (h + cfg.lambda_)
        return torch.where(c > 0, w, torch.zeros_like(w))
    k = (hist_leaf.shape[-1] - 1) // 2
    g, h = hist_leaf[..., :k], hist_leaf[..., k:2 * k]
    c = hist_leaf[..., -1]
    w = -g / (h + cfg.lambda_)
    return torch.where((c > 0)[..., None], w, torch.zeros_like(w))
