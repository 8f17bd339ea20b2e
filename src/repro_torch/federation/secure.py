"""Secure-aggregation simulation (information-flow model, not cryptography):
the counterpart of ``repro/federation/secure.py``.

Passive parties must be able to SUM values they cannot READ.  The model is
pairwise additive masking over float32 (the SecAgg construction of
Bonawitz et al., adapted to VFL): party p adds PRF(p, q)-derived masks
that cancel in the aggregate.  The active party sees only the sum, the
passive parties only masked values.

Each PRF term is the JAX package's draw, ``normal(fold_in(PRNGKey(seed),
p * P + q), shape)`` (``core/prng.py``: the same bits), all pairs' in one
batched draw, and the masks are formed in the JAX order of additions, so
they — and their sum — equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng


def pairwise_masks(seed: int, num_parties: int, shape: tuple,
                   dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(P, *shape) masks with ``sum_p masks[p] == 0`` exactly.

    ``mask_p = sum_{q>p} PRF(p,q) - sum_{q<p} PRF(q,p)``, accumulated from
    zeros in the JAX loop order: every term appears once with each sign,
    so the sum cancels (the identical bit patterns cancel pairwise)."""
    pairs = [(p, q) for p in range(num_parties)
             for q in range(p + 1, num_parties)]
    masks = [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(num_parties)]
    keys = prng.fold_in(prng.PRNGKey(seed, device), torch.tensor(
        [p * num_parties + q for p, q in pairs], dtype=torch.int64,
        device=device))
    draws = prng.normal(keys, tuple(shape)).to(dtype)
    for (p, q), draw in zip(pairs, draws):
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
