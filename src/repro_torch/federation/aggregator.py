"""Per-party collectives of the VFL protocol: the counterpart of
``repro/federation/aggregator.py``.

The parties are column blocks of one process (``mesh_roles.PartyBlocks``),
so each provider works over the blocks where the JAX package's runs once
per party inside ``shard_map`` (the histograms in one launch over the
blocks' table, the routing block by block), and each collective is a
tensor operation over the party axis behind one seam that meters its
payload:

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

The data axis (``-sharded``): the providers also take
``mesh_roles.ShardBlocks``, every (shard, party) block of the padded rows.
The histograms of every (party, shard) block come from ONE ``base_fn``
call a level (one kernel launch on the card) over the whole table, with
each row's shard folded into its node id (``_local_histograms``); the
data axis's ``psum`` is the sum of the shard partials in shard order
0..S-1 (``mesh_roles.shard_sum``), before the party exchange; leaf
statistics and liveness counts are summed the same way, and the routing
maps are one bitmap per shard.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import histogram as hist_mod
from repro_torch.core import split as split_mod
from repro_torch.core.types import TreeConfig
from repro_torch.federation import mesh_roles
from repro_torch.obs import trace as trace_mod

#: the span of every exchange: the code that makes, meters and gathers a
#: message, not the parties' own compute
EXCHANGE = "federation.exchange"


def plain_gather(parts, axis: int) -> torch.Tensor:
    """The synchronous level exchange: the parties' payloads, party 0
    first, concatenated along ``axis`` (a tiled ``all_gather``)."""
    return torch.cat(list(parts), dim=axis)


def _local_histograms(base_fn, blocks, g, h, weight, assign, num_nodes,
                      num_bins, kw, child: bool = False) -> list:
    """Each party's histogram of its own columns, the data shards'
    partials summed in shard order: ONE ``base_fn`` call (one kernel
    launch on the card) over the blocks' whole table for every (party,
    shard) block.

    Row ``r`` of shard ``s`` enters at node ``s * num_nodes + assign[r]``
    (``child``: the ids are child slots ``parent * 2 + side`` and the
    offset ``2 * s * num_nodes`` keeps their parity), so the call's
    ``(T, S * num_nodes, d, B, 2K+1)`` holds each shard's partial as a
    node range and each party's histogram as a column slice, each cell
    the sum of the same rows in the same order as a launch on the block
    alone.  That holds only for ids in ``[0, num_nodes)`` (``child``:
    ``[0, 2 * num_nodes)``): an id past the end would land in the next
    shard's nodes where a block's launch drops it.  ``core.tree``'s ids
    stay in range: compaction clamps its slots to ``a_width - 1`` and a
    child slot is at most ``2 * prev_a - 1``.

    A shared root (``root_delta_rows``) ignores ``assign``, so there each
    block keeps its own call.  Returns the parties' histograms, party 0
    first, as column views."""
    shards = mesh_roles.shard_rows(blocks, g.shape[0])
    if kw.get("root_delta_rows"):
        per_shard = [
            [base_fn(block, g[rows], h[rows], weight[:, rows],
                     assign[:, rows], num_nodes, num_bins, **kw)
             for block in shard]
            for shard, rows in shards]
        return [mesh_roles.shard_sum(parts) for parts in zip(*per_shard)]
    n_shards, n_parties = len(shards), len(shards[0][0])
    ids = assign
    if n_shards > 1:
        ids = torch.add(assign, blocks.row_shard,
                        alpha=(2 if child else 1) * num_nodes)
    hist = base_fn(blocks.table, g, h, weight, ids, n_shards * num_nodes,
                   num_bins, **kw)
    trace_mod.global_tracer().counter(
        "federation.hist_blocks", {"blocks": n_parties * n_shards})
    total = mesh_roles.shard_sum(hist.unflatten(1, (n_shards, num_nodes))
                                 .unbind(1))
    d_party = shards[0][0][0].shape[1]
    return [total[:, :, p * d_party:(p + 1) * d_party]
            for p in range(n_parties)]


def federated_round_histogram_fn(
    base_fn: Callable = hist_mod.compute_round_histogram,
    meter=None,
    gather: Callable = plain_gather,
    child: bool = False,
):
    """Round histogram provider of the ``histogram`` aggregation.

    Each party's (T, nodes, d_party, B, 2K+1) round histogram is its
    column slice of the level's one ``base_fn`` call (``_local_histograms``;
    the keywords ``level`` and ``root_delta_rows`` pass through: shared
    root stays a local transformation), then the payloads are gathered
    along the feature axis:
    ONE exchange per level for the whole round.  ``meter`` records the
    payload one party ships, before ``gather`` (the exchange seam: the
    plain or the double-buffered gather) splits anything.  ``child``:
    ``base_fn`` is a child form, whose ids are child slots."""

    def fn(blocks, g, h, weight, assign, num_nodes, num_bins, **kw):
        local = _local_histograms(base_fn, blocks, g, h, weight, assign,
                                  num_nodes, num_bins, kw, child)
        with trace_mod.global_tracer().span(EXCHANGE, cat="federation"):
            if meter is not None:
                meter.record("histograms", local[0])
            return gather(local, 2)

    return fn


def local_round_histogram_fn(
        base_fn: Callable = hist_mod.compute_round_histogram,
        child: bool = False):
    """Round histogram provider of the ``argmax`` aggregation: no exchange.
    The parties' histograms are stored side by side along the feature axis
    (storage, not a message: party p's columns hold only its own
    histogram), so sibling subtraction and compaction run on them as on a
    centralized one; the chooser reads each party's columns alone.
    ``child`` as in ``federated_round_histogram_fn``."""

    def fn(blocks, g, h, weight, assign, num_nodes, num_bins, **kw):
        return torch.cat(_local_histograms(base_fn, blocks, g, h, weight,
                                           assign, num_nodes, num_bins, kw,
                                           child),
                         dim=2)

    return fn


def local_round_leaf_fn(num_shards: int = 1):
    """Round leaf-statistics provider ((T, n) -> (T, leaves, 2K+1)): a
    local pass of the active party (Alg. 2 step 14), which also serves the
    compaction liveness counts; weights and routing are known to every
    party, so nothing is exchanged.  Over ``num_shards`` data shards (the
    rows padded to a multiple of it) each shard's statistics are its own
    pass, summed in shard order."""
    if num_shards == 1:
        return hist_mod.round_leaf_stats

    def fn(g, h, weight, assign, num_leaves):
        m = g.shape[0] // num_shards
        return mesh_roles.shard_sum(
            hist_mod.round_leaf_stats(g[r], h[r], weight[:, r],
                                      assign[:, r], num_leaves)
            for r in (slice(s * m, (s + 1) * m) for s in range(num_shards)))

    return fn


def centralized_round_choose_fn(cfg: TreeConfig, num_parties: int,
                                meter=None):
    """Round split chooser of the ``histogram`` aggregation: the merged
    (T, nodes, d, B, 2K+1) histogram is evaluated as centrally.  The
    per-tree feature masks are each party's (T, d_party) columns, gathered
    to match; ``meter`` records one party's mask (1 B per local feature
    per tree)."""

    def fn(hist_global, feature_mask):
        with trace_mod.global_tracer().span(EXCHANGE, cat="federation"):
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
    no owner), bit-packs them into a (T, ceil(n/8)) uint8 map, one a data
    shard over its own rows (``meter`` records party 0's maps, every shard
    in one record), and each shard's maps are summed over the parties in
    uint8: every bit has at most one non-zero contributor, so the sum is
    the OR."""

    def fn(blocks, assign, decision):
        node = assign.long()
        f_global = torch.gather(decision.feature, 1, node)     # (T, n)
        thr = torch.gather(decision.threshold, 1, node)
        shards = mesh_roles.shard_rows(blocks, assign.shape[1])
        shard_bits = []
        for shard, rows in shards:
            fg, tr = f_global[:, rows], thr[:, rows]
            bits = []
            for p, block in enumerate(shard):
                d_party = block.shape[1]
                f_local = fg - p * d_party
                owned = (f_local >= 0) & (f_local < d_party) & (fg >= 0)
                col = f_local.clamp(0, d_party - 1).long()
                fv = torch.gather(block, 1, col.T).T            # (T, m)
                bits.append(owned & (fv > tr))
            shard_bits.append(bits)
        with trace_mod.global_tracer().span(EXCHANGE, cat="federation"):
            shard_maps = [[pack_bits(b) for b in bits]
                          for bits in shard_bits]
            if meter is not None:
                meter.record("id_partition",
                             torch.stack([maps[0] for maps in shard_maps]))
            go_right = [
                unpack_bits(torch.sum(torch.stack(maps), dim=0,
                                      dtype=torch.uint8), shard[0].shape[0])
                for (shard, _), maps in zip(shards, shard_maps)]
        return assign * 2 + (go_right[0] if len(go_right) == 1
                             else torch.cat(go_right, dim=1))

    return fn
