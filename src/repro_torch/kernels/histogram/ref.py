"""Plain PyTorch versions of the histogram kernel's entry points, in the
kernel's argument order, and of the sort kernel that each runs first.

Each sums in row order (``core.histogram.segment_sum``), as the kernel
does, so on the CPU the kernel's result equals these bit for bit.  Out-of-
range ids are dropped PER TREE — the Pallas kernels' per-tree one-hot — not
across the round as ``core.histogram.compute_round_histogram`` drops them.
The CPU tests hold these against the Pallas kernels (interpret mode);
``chip_smoke.py`` holds the CUDA kernel against these on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.histogram import compute_histogram, feature_segment_sum


def histogram_round_ref(binned: torch.Tensor, assign: torch.Tensor,
                        g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                        num_nodes: int, num_bins: int,
                        child: bool) -> torch.Tensor:
    """binned (n, d) i32, assign / w (T, n) i32 / f32, g / h (n, K) f32 ->
    (T, num_nodes, d, B, 2K+1) f32.  ``child``: odd ``assign`` rows get
    weight 0 and ids halve to the parent (``num_nodes`` is then the parent
    count)."""
    if child:
        w = w * (1 - (assign % 2)).to(w.dtype)
        assign = torch.div(assign, 2, rounding_mode="floor")
    return torch.stack([
        compute_histogram(binned, g, h, w_t, a_t, num_nodes, num_bins)
        for w_t, a_t in zip(w, assign)
    ])


def histogram_staged_ref(ids: torch.Tensor, data: torch.Tensor,
                         num_nodes: int, num_bins: int) -> torch.Tensor:
    """ids (n, d) i32 = assign * B + binned, data (n, S) f32 ->
    (num_nodes, d, B, S) f32."""
    d = ids.shape[1]
    hist = feature_segment_sum(data, ids.T, num_nodes * num_bins)
    return hist.reshape(d, num_nodes, num_bins, -1).permute(
        1, 0, 2, 3).contiguous()


def slot_ids(keys: torch.Tensor, assign: torch.Tensor | None, num_nodes: int,
             num_bins: int, child: bool = False) -> torch.Tensor:
    """(T, d, n) int32 slot ``node * B + bin`` of every (tree, feature,
    row), -1 where it falls outside ``[0, num_nodes * B)``.  ``keys`` (n, d)
    are bins with ``assign`` (T, n), or staged ids when ``assign`` is None
    (T = 1); ``child`` takes the parent ``assign >> 1``."""
    if assign is None:
        ids = keys.T[None]
    else:
        node = assign >> 1 if child else assign      # floor(assign / 2)
        ids = node[:, None, :] * num_bins + keys.T[None]  # int32, wraps
    n_slots = num_nodes * num_bins
    return torch.where((ids >= 0) & (ids < n_slots), ids,
                       torch.full_like(ids, -1))


def sort_slots_ref(keys: torch.Tensor, assign: torch.Tensor | None,
                   num_nodes: int, num_bins: int, child: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort kernel's function: a stable sort of each (tree, feature)'s
    rows by slot, dropped rows removed -> (order (T, d, n) int32, starts
    (T, d, num_nodes * B + 1) int32).  Slot s lists its rows in increasing
    row order at ``order[t, f, starts[t, f, s]:starts[t, f, s + 1]]``; the
    tail past ``starts[t, f, -1]`` (the dropped rows' places) is -1."""
    ids = slot_ids(keys, assign, num_nodes, num_bins, child)
    n_slots = num_nodes * num_bins
    key = torch.where(ids >= 0, ids,
                      torch.full_like(ids, n_slots)).contiguous()
    sorted_key, order = torch.sort(key, dim=-1, stable=True)
    bounds = torch.arange(n_slots + 1, dtype=key.dtype, device=key.device)
    starts = torch.searchsorted(
        sorted_key, bounds.expand(*key.shape[:2], n_slots + 1).contiguous())
    order = torch.where(sorted_key < n_slots, order,
                        torch.full_like(order, -1))
    return order.to(torch.int32), starts.to(torch.int32)
