"""``fma``: float32 ``a * b + c`` rounded once, as the FMA instruction that
XLA's CPU backend contracts multiply-adds into (and ``__fmaf_rn`` on the
card) computes it.

The product of two float32 values is exact in float64.  The float64 sum is
rounded to odd (the TwoSum error says whether it was inexact and on which
side of it the exact value lies), and a float64 value rounded to odd
rounds to float32 exactly as the exact value would: 53 bits leave the two
to spare that double rounding needs.
Plain ``(a.double() * b + c).float()`` rounds twice and can miss the
float32 result by an ulp when the float64 sum lands on a float32 tie.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.  ``a`` is a tensor; ``b`` and
    ``c`` tensors or Python floats; all hold float32 values (float64
    tensors of float32 values are taken as they are)."""
    # a 0-d float64 ``a`` would not promote a float32 ``b``; Python floats
    # stay scalars (a device tensor made of one would be a copy to the card)
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    p = a.double() * b
    s = p + c
    # TwoSum: p + c == s + err exactly
    pb = s - p
    err = (p - (s - pb)) + (c - pb)
    # round to odd: truncate toward zero (one ulp down in magnitude where
    # the exact value lies nearer zero than s), then set the last bit if
    # the sum was inexact
    bits = s.view(torch.int64)
    nearer_zero = (err * s < 0).to(torch.int64)
    odd = ((bits - nearer_zero) | (err != 0).to(torch.int64)).view(
        torch.float64)
    return torch.where(torch.isfinite(s), odd, s).float()
