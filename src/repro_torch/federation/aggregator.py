"""Per-party collectives of the VFL protocol: the counterpart of
``repro/federation/aggregator.py``.

The parties are column blocks of one process (``mesh_roles.PartyBlocks``),
so each provider loops over the blocks where the JAX package's runs once
per party inside ``shard_map``, and each collective is a tensor operation
over the party axis behind one seam that meters its payload:

* ``all_gather(tiled)`` over the party axis is ``plain_gather``, a
  ``torch.cat`` of the parties' payloads along the feature axis;
* the routing ``psum`` is a sum over the parties' bit-packed maps, kept in
  uint8 (carry-free: each row's feature has one owner).

Two aggregation modes, as in the JAX package:

* ``"histogram"`` — every party ships its full per-level histogram
  (Alg. 2 step 7) and the split search runs on the merged one;
* ``"argmax"`` — histograms stay with their party; only each party's best
  (gain, feature, threshold) candidates are exchanged
  (``compress.topk_round_choose_fn``).  Lossless: candidates merge
  party-major, so the first maximum is the centralized one.

Metering: the JAX package traces the SPMD program once, so a
``meter.record`` in its body records ONE sending party's payload per
logical collective, and ``protocol.per_round_cost`` multiplies the
per-passive phases by the passive-party count.  The loops here record party
0's payload once per collective, which is every party's on the even
partition that ``vfl.make_vfl_backend`` enforces.

Sibling subtraction: the child providers are these providers over the
kernel's child form (or ``histogram.as_round_child_fn``), so the exchanged
and metered payload is the left children's, at parent width; every party
derives the right siblings after the merge (``tree.build_round``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import histogram as hist_mod
from repro_torch.core import split as split_mod
from repro_torch.core.types import TreeConfig


def plain_gather(parts, axis: int) -> torch.Tensor:
    """The synchronous level exchange: the parties' payloads, party 0
    first, concatenated along ``axis`` (a tiled ``all_gather``)."""
    return torch.cat(list(parts), dim=axis)


def _local_histograms(base_fn, blocks, g, h, weight, assign, num_nodes,
                      num_bins, kw) -> list:
    """Each party's histogram of its own block: one ``base_fn`` call (one
    kernel launch on the card) per party."""
    return [base_fn(block, g, h, weight, assign, num_nodes, num_bins, **kw)
            for block in blocks]


def federated_round_histogram_fn(
    base_fn: Callable = hist_mod.compute_round_histogram,
    meter=None,
    gather: Callable = plain_gather,
):
    """Round histogram provider of the ``histogram`` aggregation.

    Each party computes its block's (T, nodes, d_party, B, 2K+1) round
    histogram with ``base_fn`` (the keywords ``level`` and
    ``root_delta_rows`` pass through: shared root stays a local
    transformation), then the payloads are gathered along the feature axis:
    ONE exchange per level for the whole round.  ``meter`` records the
    payload one party ships, before ``gather`` (the exchange seam: the
    plain or the double-buffered gather) splits anything."""

    def fn(blocks, g, h, weight, assign, num_nodes, num_bins, **kw):
        local = _local_histograms(base_fn, blocks, g, h, weight, assign,
                                  num_nodes, num_bins, kw)
        if meter is not None:
            meter.record("histograms", local[0])
        return gather(local, 2)

    return fn


def local_round_histogram_fn(
        base_fn: Callable = hist_mod.compute_round_histogram):
    """Round histogram provider of the ``argmax`` aggregation: no exchange.
    The parties' histograms are stored side by side along the feature axis
    (storage, not a message: party p's columns hold only its own
    histogram), so sibling subtraction and compaction run on them as on a
    centralized one; the chooser reads each party's columns alone."""

    def fn(blocks, g, h, weight, assign, num_nodes, num_bins, **kw):
        return torch.cat(_local_histograms(base_fn, blocks, g, h, weight,
                                           assign, num_nodes, num_bins, kw),
                         dim=2)

    return fn


def local_round_leaf_fn():
    """Round leaf-statistics provider ((T, n) -> (T, leaves, 2K+1)): a
    local pass of the active party (Alg. 2 step 14), which also serves the
    compaction liveness counts; weights and routing are known to every
    party, so nothing is exchanged."""
    return hist_mod.round_leaf_stats


def centralized_round_choose_fn(cfg: TreeConfig, num_parties: int,
                                meter=None):
    """Round split chooser of the ``histogram`` aggregation: the merged
    (T, nodes, d, B, 2K+1) histogram is evaluated as centrally.  The
    per-tree feature masks are each party's (T, d_party) columns, gathered
    to match; ``meter`` records one party's mask (1 B per local feature
    per tree)."""

    def fn(hist_global, feature_mask):
        parts = feature_mask.chunk(num_parties, dim=1)
        if meter is not None:
            meter.record("feature_mask", parts[0])
        fmask = plain_gather(parts, 1)
        return split_mod.choose_splits_round(hist_global, fmask, cfg)

    return fn


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) 0/1 tensor into (..., ceil(n/8)) uint8 maps, little-
    endian within each byte: the id_partition wire format, 1 bit a row."""
    n = x.shape[-1]
    n_bytes = -(-n // 8)
    bits = torch.nn.functional.pad(x.to(torch.uint8), (0, n_bytes * 8 - n))
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=x.device)
    return torch.sum(bits.reshape(*x.shape[:-1], n_bytes, 8) * weights,
                     dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (..., ceil(n/8)) uint8 -> (..., n) int32."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.int32)


def federated_round_route_fn(meter=None):
    """Round ownership-masked routing: the whole round's (T, n) go-right
    decisions in ONE exchange per level (Alg. 2 step 3).

    Each party decides the rows whose node splits on one of its own
    columns (``f_local = f_global - p * d_party``; an unsplit node, -1, has
    no owner), bit-packs them into a (T, ceil(n/8)) uint8 map (``meter``
    records one), and the maps are summed over the parties in uint8: every
    bit has at most one non-zero contributor, so the sum is the OR."""

    def fn(blocks, assign, decision):
        node = assign.long()
        f_global = torch.gather(decision.feature, 1, node)     # (T, n)
        thr = torch.gather(decision.threshold, 1, node)
        maps = []
        for p, block in enumerate(blocks):
            n, d_party = block.shape
            f_local = f_global - p * d_party
            owned = (f_local >= 0) & (f_local < d_party) & (f_global >= 0)
            col = f_local.clamp(0, d_party - 1).long()
            fv = torch.gather(block, 1, col.T).T                # (T, n)
            maps.append(pack_bits(owned & (fv > thr)))
        if meter is not None:
            meter.record("id_partition", maps[0])
        merged = torch.sum(torch.stack(maps), dim=0, dtype=torch.uint8)
        return assign * 2 + unpack_bits(merged, assign.shape[1])

    return fn
