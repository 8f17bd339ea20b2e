"""Plain PyTorch versions of the histogram kernel's entry points, in the
kernel's argument order.

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
