"""Secure-aggregation simulation (information-flow model, not cryptography):
the counterpart of ``repro/federation/secure.py``.

Passive parties must be able to SUM values they cannot READ.  The model is
pairwise additive masking over float32 (the SecAgg construction of
Bonawitz et al., adapted to VFL): party p adds PRF(p, q)-derived masks
that cancel in the aggregate.  The active party sees only the sum, the
passive parties only masked values.

The JAX package draws each PRF term with ``jax.random.normal`` under
``fold_in(PRNGKey(seed), p * P + q)`` (threefry), which torch cannot
reproduce, so the draws are an input here: ``prf(p, q, shape)`` (the JAX
draws, for parity) or, by default, ``torch.randn`` from a CPU generator
seeded by ``(seed, p * P + q)``.  The masks are formed in the JAX order of
additions, so given the same draws they — and their sum — equal the JAX
package's bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

#: ``prf(p, q, shape) -> (shape) float32`` draws of the pair (p, q), p < q.
Prf = Callable[[int, int, tuple], torch.Tensor]

_MIX = 1_000_003


def native_prf(seed: int, num_parties: int) -> Prf:
    """The port's own PRF: standard normals from a CPU generator seeded by
    ``(seed, p * num_parties + q)``."""

    def prf(p: int, q: int, shape: tuple) -> torch.Tensor:
        key = (seed * _MIX + p * num_parties + q) % (1 << 63)
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            key))

    return prf


def pairwise_masks(seed: int, num_parties: int, shape: tuple,
                   dtype=torch.float32, prf: Optional[Prf] = None,
                   device="cpu") -> torch.Tensor:
    """(P, *shape) masks with ``sum_p masks[p] == 0`` exactly.

    ``mask_p = sum_{q>p} PRF(p,q) - sum_{q<p} PRF(q,p)``, accumulated from
    zeros in the JAX loop order: every term appears once with each sign,
    so the sum cancels (the identical bit patterns cancel pairwise)."""
    if prf is None:
        prf = native_prf(seed, num_parties)
    masks = [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(num_parties)]
    for p in range(num_parties):
        for q in range(p + 1, num_parties):
            draw = prf(p, q, tuple(shape)).to(device=device, dtype=dtype)
            masks[p] = masks[p] + draw
            masks[q] = masks[q] - draw
    return torch.stack(masks)


def mask(values: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Each party's masked contribution: values[p] + masks[p]."""
    return values + masks


def aggregate(masked: torch.Tensor) -> torch.Tensor:
    """Active-party aggregation: the sum over parties, from zeros in party
    order (the masks cancel exactly)."""
    out = torch.zeros_like(masked[0])
    for part in masked:
        out = out + part
    return out
