"""Quantile binning (Alg. 2 step 1): the counterpart of
``repro/core/binning.py``.

Missing values: edges are fit with ``nanquantile`` so NaN entries never
poison the quantile grid, and ``bin_data`` routes NaNs to ``NAN_BIN`` (= 0),
which satisfies ``bin <= threshold`` at every split: missing values always
route left.
"""

from __future__ import annotations

import torch

NAN_BIN = 0  # deterministic bin for missing values (routes left at any split)


def quantile_bin_edges(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-feature quantile edges, NaN-safe.

    The linear-interpolation nanquantile of ``jnp.nanquantile``, step for
    step: sort with NaN last, position ``q * (count - 1)``, then
    ``low * (1 - w) + high * w``.  XLA's CPU backend contracts the second
    product and the sum into one FMA; the port takes that step in float64
    and rounds once to float32, which is the FMA's result except in rare
    double-rounding halfway cases.  So the edges equal the JAX package's
    (``torch.nanquantile`` interpolates in another order and differs in the
    last ulp).  One sort along the rows serves every quantile, so
    ``torch.quantile``'s 2**24-element limit does not apply.

    Args:
      x: (n, d) float features; NaN entries are ignored per feature.
      num_bins: number of bins B; returns B - 1 interior edges per feature.
    Returns:
      (d, num_bins - 1) float32 edges, non-decreasing along axis 1; an
      all-NaN column degrades to constant-0 edges.
    """
    x = x.to(torch.float32)
    qs = torch.linspace(0.0, 1.0, num_bins + 1, dtype=torch.float32,
                        device=x.device)[1:-1, None]             # (B-1, 1)
    s = torch.sort(x, dim=0).values                              # NaN last
    last = (~torch.isnan(s)).sum(0, dtype=torch.float32) - 1     # (d,)
    pos = qs * last
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    low = torch.maximum(torch.minimum(low, last), torch.zeros_like(low))
    high = torch.maximum(torch.minimum(high, last), torch.zeros_like(high))
    low_value = s.gather(0, low.long())
    high_value = s.gather(0, high.long())
    edges = ((low_value * low_weight).double()
             + high_value.double() * high_weight.double()).float()  # (B-1, d)
    edges = torch.where(torch.isnan(edges), torch.zeros_like(edges), edges)
    return edges.T.contiguous()


def bin_data(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Digitise features into bin ids: ``bin = #edges strictly below value``
    (``searchsorted`` with ``right=False``), NaN to ``NAN_BIN``.

    Args:
      x: (n, d) float features (NaNs allowed).
      edges: (d, B - 1) per-feature edges.
    Returns:
      (n, d) int32 bin indices.
    """
    cols = x.to(torch.float32).T.contiguous()                 # (d, n)
    b = torch.searchsorted(edges.to(torch.float32).contiguous(), cols,
                           right=False, out_int32=True)
    b = torch.where(torch.isnan(cols), torch.full_like(b, NAN_BIN), b)
    return b.T.contiguous()


def fit_bin(x: torch.Tensor, num_bins: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Fit edges on ``x`` and bin it: (binned (n, d) int32, edges)."""
    edges = quantile_bin_edges(x, num_bins)
    return bin_data(x, edges), edges
