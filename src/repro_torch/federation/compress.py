"""The quantization codec of the federation layer: the counterpart of
``repro/federation/compress.py:167-199`` (``quantize_stats`` and
``dequantize_stats``).

The JAX package draws its stochastic-rounding noise with
``jax.random.uniform`` under threefry, which torch cannot reproduce, so the
noise is an input here: ``uniform`` (the JAX package's draws, for parity)
or drawn from an explicit ``torch.Generator`` on the CPU.  ``jnp.round``
and ``torch.round`` both round half to even.
"""

from __future__ import annotations

import torch


def quantize_stats(x: torch.Tensor, bits: int,
                   uniform: torch.Tensor | None = None,
                   stochastic: bool = True,
                   generator: torch.Generator | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize stats to int``bits`` along the second-last axis.

    Args:
      x: (..., B, C) float32.
      bits: 8 or 16.
      uniform: (..., B, C) float32 draws in [0, 1) for stochastic rounding
        (floor(x/s + u)); None draws them with ``torch.rand`` from
        ``generator`` (default: seed 0) on the CPU.
      stochastic: stochastic rounding, else round half to even.

    Returns:
      (q, scale): q (..., B, C) int8/int16; scale (..., C) float32 with
      ``x ≈ q * scale[..., None, :]``.  All-zero slices get scale 1.
    """
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    absmax = x.abs().amax(dim=-2, keepdim=True)                 # (..., 1, C)
    # divide by a tensor: on CUDA, dividing by a Python scalar multiplies
    # by its rounded reciprocal, which is not XLA's division for 32767
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        torch.ones_like(absmax))
    y = x / scale
    if stochastic:
        if uniform is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            uniform = torch.rand(tuple(x.shape), generator=generator)
        y = torch.floor(y + uniform.to(device=x.device, dtype=torch.float32))
    else:
        y = torch.round(y)
    dtype = torch.int8 if bits == 8 else torch.int16
    q = y.clamp(-qmax, qmax).to(dtype)
    return q, scale[..., 0, :].to(torch.float32)


def dequantize_stats(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_stats``: (..., B, C) int x (..., C) -> float32."""
    return q.to(torch.float32) * scale[..., None, :]
