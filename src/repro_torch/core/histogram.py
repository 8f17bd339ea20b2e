"""Gradient/hessian histogram accumulation (Alg. 2 steps 6-8): the
counterpart of ``repro/core/histogram.py``.

Layout: ``hist[node, feature, bin, stat]`` with ``stat = (sum_g, sum_h,
count)`` for K = 1 objectives and ``(g_1..g_K, h_1..h_K, count)`` — ``2K +
1`` channels, count LAST — for K-channel ones; round providers carry a
leading ``(T, ...)`` tree axis.  The providers here are the plain PyTorch
ones (the ``local`` backend, and the oracle the CUDA kernels of
``kernels/histogram`` are held against): every ``jax.ops.segment_sum`` of
the JAX package is a ``segment_sum`` below, with the same out-of-range
semantics — ids outside ``[0, num_segments)`` are dropped, never clamped
or wrapped.

Order of summation: ``segment_sum`` adds each segment's rows in row order,
as XLA's CPU scatter does, so the sums equal the JAX package's bit for bit
on the CPU (``index_add_``, which is sequential there) and on the card
(``index_put_`` with ``accumulate=True``: a stable sort by id, then each
run of equal ids summed in order — deterministic, unlike the atomics of
``index_add_`` on CUDA).
"""

from __future__ import annotations

from typing import Optional

import torch

#: Optional recorder of histogram row-passes: set it to a list, run one
#: build, read it, reset it to None.  Each pass appends ``{"tag", "rows",
#: "trees"}``.  None (the default) records nothing.
PASS_METER: Optional[list] = None


def _record_pass(tag: str, rows: int, trees: int) -> None:
    if PASS_METER is not None:
        PASS_METER.append({"tag": tag, "rows": int(rows), "trees": int(trees)})


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (N, ...) rows summed into ``num_segments``
    rows by ``ids`` (N,), each segment in row order; ids outside
    ``[0, num_segments)`` are dropped."""
    keep = (ids >= 0) & (ids < num_segments)
    # dropped rows go to a trash segment past the end, cut off below
    safe = torch.where(keep, ids, torch.full_like(ids, num_segments)).long()
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if data.device.type == "cpu":
        out.index_add_(0, safe, data)
    else:
        out.index_put_((safe,), data, accumulate=True)
    return out[:num_segments]


def stack_stats(g: torch.Tensor, h: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Per-row stat channels ``[g*w, h*w, w]``: (n, 3) for (n,) gradients,
    (n, 2K+1) for (n, K) ones, the count LAST.  A leading tree axis on
    ``weight`` ((T, n)) gives (T, n, 2K+1)."""
    w = weight[..., None]
    if g.ndim == 1:
        g, h = g[:, None], h[:, None]
    return torch.cat([g * w, h * w, w], dim=-1)


def feature_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Per-feature ``segment_sum``: data (N, S) shared by the d feature
    columns of ids (d, N) -> (d, num_segments, S), in one pass (feature f's
    segments are offset by ``f * num_segments``)."""
    d, count = ids.shape
    s = data.shape[-1]
    offset = (torch.arange(d, device=ids.device, dtype=ids.dtype)[:, None]
              * num_segments)
    valid = (ids >= 0) & (ids < num_segments)
    flat = torch.where(valid, ids + offset, torch.full_like(ids, -1))
    rows = data[None].expand(d, count, s)
    return segment_sum(rows.reshape(d * count, s), flat.reshape(-1),
                       d * num_segments).reshape(d, num_segments, s)


def compute_histogram(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                      weight: torch.Tensor, assign: torch.Tensor,
                      num_nodes: int, num_bins: int) -> torch.Tensor:
    """Accumulate (sum_g, sum_h, count) per (node, feature, bin).

    Args:
      binned: (n, d) int32 bin indices in [0, num_bins).
      g, h: (n,) float32 — or (n, K), widening the stat axis to 2K+1.
      weight: (n,) float32 sample mask/weights (P_m(j) of eq. 4).
      assign: (n,) int32 node assignment in [0, num_nodes).
    Returns:
      (num_nodes, d, num_bins, 2K+1) float32.
    """
    d = binned.shape[1]
    data = stack_stats(g, h, weight)                     # (n, S)
    ids = assign[None, :] * num_bins + binned.T          # (d, n)
    hist = feature_segment_sum(data, ids, num_nodes * num_bins)
    return hist.reshape(d, num_nodes, num_bins, -1).permute(
        1, 0, 2, 3).contiguous()


def compute_round_histogram(binned: torch.Tensor, g: torch.Tensor,
                            h: torch.Tensor, weight: torch.Tensor,
                            assign: torch.Tensor, num_nodes: int,
                            num_bins: int, *, root_delta_rows: int = 0,
                            level: int = 0) -> torch.Tensor:
    """Round-native histogram: all T trees of a round in one segment pass,
    the tree folded into the segment ids as the JAX package folds it
    (``((tree * num_nodes) + node) * B + bin``, so only ids outside the
    whole round's ``T * num_nodes * B`` segments are dropped).

    Args:
      weight / assign: (T, n) per-tree sample weights and node assignment.
      root_delta_rows: > 0 (level 0 only) derives the roots as ``shared −
        delta`` (``root_histogram_via_delta``).
      level: the static tree level of the pass (part of the round-provider
        contract; unused here).
    Returns:
      (T, num_nodes, d, num_bins, 2K+1) float32.
    """
    if root_delta_rows:
        return root_histogram_via_delta(binned, g, h, weight, num_bins,
                                        root_delta_rows)
    n, d = binned.shape
    t = weight.shape[0]
    _record_pass("round", n, t)
    data = stack_stats(g, h, weight)
    data = data.reshape(t * n, data.shape[-1])            # (T*n, S)
    tree_node = (torch.arange(t, dtype=torch.int32, device=assign.device)
                 [:, None] * num_nodes + assign)          # (T, n)
    ids = (tree_node.reshape(1, t * n) * num_bins
           + binned.T.repeat(1, t))                       # (d, T*n)
    hist = feature_segment_sum(data, ids, t * num_nodes * num_bins)
    return hist.reshape(d, t, num_nodes, num_bins, -1).permute(
        1, 2, 0, 3, 4).contiguous()


def root_histogram_via_delta(binned: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor, weight: torch.Tensor,
                             num_bins: int, n_rows: int,
                             base_tree_fn=None) -> torch.Tensor:
    """Shared-root caching: per-tree root histograms as ``shared −
    delta(masked-out rows)``.

    ``hist(w_t) = hist(1) − hist(1 − w_t)``: ONE unmasked pass shared by
    the round, minus each tree's pass over the rows it masked out, gathered
    into a ``(T, n_rows)`` buffer (surplus entries land on kept rows whose
    delta weight ``1 − w`` is 0).  Weights must be 0/1.

    Args:
      weight: (T, n) float32 0/1 per-tree masks.
      n_rows: delta-buffer width (rows per tree).
      base_tree_fn: per-tree provider (``compute_histogram`` signature)
        for the shared pass and the deltas; None = ``compute_histogram``.
    Returns:
      (T, 1, d, B, 2K+1) float32.
    """
    if base_tree_fn is None:
        base_tree_fn = compute_histogram
    t, n = weight.shape
    n_rows = min(n_rows, n)
    _record_pass("round", n, 1)
    shared = base_tree_fn(
        binned, g, h, torch.ones(n, dtype=torch.float32, device=g.device),
        torch.zeros(n, dtype=torch.int32, device=g.device), 1, num_bins,
    )[None]                                               # (1, 1, d, B, S)
    _record_pass("root_delta", n_rows, t)
    # stable sort: masked-out rows (w == 0) first, in ascending row order
    order = torch.sort((weight > 0).to(torch.int8), dim=1,
                       stable=True).indices[:, :n_rows]  # (T, n_rows)
    sub_w = 1.0 - torch.gather(weight, 1, order)
    zeros = torch.zeros(n_rows, dtype=torch.int32, device=g.device)
    delta = torch.stack([
        base_tree_fn(binned[rows], g[rows], h[rows], w_t, zeros, 1, num_bins)
        for rows, w_t in zip(order, sub_w)
    ])                                                    # (T, 1, d, B, S)
    return shared - delta


def as_child_fn(histogram_fn):
    """Adapt a per-tree histogram provider into the subtraction pipeline's
    child-only provider: ``assign`` is the CURRENT level's assignment
    (width ``2 * num_parents``); right children (odd ``assign``) get weight
    0 and the ids halve to the parent, giving each parent's left-child
    histogram at half width."""

    def fn(binned, g, h, weight, assign, num_parents, num_bins):
        left_w = weight * (1 - (assign % 2)).to(weight.dtype)
        return histogram_fn(binned, g, h, left_w,
                            torch.div(assign, 2, rounding_mode="floor"),
                            num_parents, num_bins)

    return fn


def as_round_child_fn(round_histogram_fn):
    """Round-native twin of ``as_child_fn`` over (T, n) weights/assign."""

    def fn(binned, g, h, weight, assign, num_parents, num_bins, *, level=0):
        left_w = weight * (1 - (assign % 2)).to(weight.dtype)
        return round_histogram_fn(binned, g, h, left_w,
                                  torch.div(assign, 2, rounding_mode="floor"),
                                  num_parents, num_bins, level=level)

    return fn


def derive_sibling(parent_hist: torch.Tensor,
                   left_hist: torch.Tensor) -> torch.Tensor:
    """Sibling subtraction: ``right = parent − left``, interleaved back to
    the full frontier.

    Args:
      parent_hist / left_hist: (..., P, d, B, S), left children indexed by
        parent.
    Returns:
      (..., 2P, d, B, S), node ``2p`` the left child and ``2p + 1`` the
      derived right sibling (the routing order ``assign * 2 + go_right``).
    """
    right = parent_hist - left_hist
    *batch, p, d, b, s = left_hist.shape
    return torch.stack([left_hist, right], dim=-4).reshape(
        *batch, 2 * p, d, b, s)


def leaf_stats(g: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
               assign: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """(G, H, count) per leaf: (num_leaves, 2K+1) float32."""
    return segment_sum(stack_stats(g, h, weight), assign, num_leaves)


def round_leaf_stats(g: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                     assign: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Round-native ``leaf_stats``: (T, n) weights/assignment -> (T,
    num_leaves, 2K+1), the tree folded into the segment ids."""
    t, n = weight.shape
    data = stack_stats(g, h, weight)
    data = data.reshape(t * n, data.shape[-1])
    ids = (torch.arange(t, dtype=torch.int32, device=assign.device)[:, None]
           * num_leaves + assign).reshape(t * n)
    return segment_sum(data, ids, t * num_leaves).reshape(
        t, num_leaves, data.shape[-1])


#: ``histogram_dispatch`` names: the JAX package's, with ``cuda`` in place
#: of ``pallas``.
HISTOGRAM_IMPLS = ("segment", "round-segment", "cuda", "cuda-fused",
                   "cuda-fused-child", "cuda-fused-round",
                   "cuda-fused-round-child")


def histogram_dispatch(impl: str = "segment"):
    """Select a histogram provider by name.

    ``"segment"`` / ``"round-segment"`` are the plain providers above;
    ``"cuda"`` is the staged entry point (``ids = assign * B + binned`` and
    ``[g*w, h*w, w]`` staged before the kernel); ``"cuda-fused"`` forms ids
    and stats in the kernel, ``"cuda-fused-child"`` is its child-only form
    for the subtraction pipeline, and ``"cuda-fused-round[-child]"`` take a
    whole round's (T, n) masks in one launch.
    """
    if impl == "segment":
        return compute_histogram
    if impl == "round-segment":
        return compute_round_histogram
    if impl not in HISTOGRAM_IMPLS:
        raise ValueError(f"unknown histogram impl {impl!r}; options: "
                         f"{HISTOGRAM_IMPLS}")
    from repro_torch.kernels.histogram import ops

    return {
        "cuda": ops.compute_histogram_cuda,
        "cuda-fused": ops.compute_histogram_cuda_fused,
        "cuda-fused-child": ops.compute_histogram_cuda_fused_child,
        "cuda-fused-round": ops.compute_round_histogram_cuda_fused,
        "cuda-fused-round-child": ops.compute_round_histogram_cuda_fused_child,
    }[impl]
