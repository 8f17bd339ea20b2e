"""Per-party collectives of the VFL protocol: the counterpart of
``repro/federation/aggregator.py``.

The parties are column ranges of one table in one process
(``mesh_roles.FederatedTable``), so each provider works over their views
where the JAX package's runs once per party inside ``shard_map`` (the
histograms in one launch over the whole table, the routing in one pass
over it), and each collective is a tensor operation over the party axis
behind one seam that meters its payload:

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

The data axis (``-sharded``): the table's rows are padded and split into
the data shards' row ranges (``mesh_roles.DataLayout``).
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


def _local_histograms(base_fn, table, g, h, weight, assign, num_nodes,
                      num_bins, kw, child: bool = False) -> list:
    """Each party's histogram of its own columns, the data shards'
    partials summed in shard order: ONE ``base_fn`` call (one kernel
    launch on the card) over the whole ``mesh_roles.FederatedTable`` for
    every (party, shard) block.

    Row ``r`` of shard ``s`` enters at node ``s * num_nodes + assign[r]``
    (``child``: the ids are child slots ``parent * 2 + side`` and the
    offset ``2 * s * num_nodes`` keeps their parity), so the call's
    ``(T, S * num_nodes, d, B, 2K+1)`` holds each shard's partial as a
    node range and each party's histogram as a column range, each cell
    the sum of the same rows in the same order as a launch on the block
    alone.  That holds only for ids in ``[0, num_nodes)`` (``child``:
    ``[0, 2 * num_nodes)``): an id past the end would land in the next
    shard's nodes where a block's launch drops it.  ``core.tree``'s ids
    stay in range: compaction clamps its slots to ``a_width - 1`` and a
    child slot is at most ``2 * prev_a - 1``.

    A shared root (``root_delta_rows``) ignores ``assign``, so there each
    shard keeps its own full-width call, the partials summed in shard
    order.  Returns the parties' histograms, party 0 first, as column
    views."""
    parties = table.parties
    if kw.get("root_delta_rows"):
        total = mesh_roles.shard_sum(
            base_fn(table.table[rows], g[rows], h[rows], weight[:, rows],
                    assign[:, rows], num_nodes, num_bins, **kw)
            for rows in table.rows)
        return parties.parts(total, 2)
    n_shards = table.data.num_shards
    ids = assign
    if table.row_shard is not None:
        ids = torch.add(assign, table.row_shard,
                        alpha=(2 if child else 1) * num_nodes)
    hist = base_fn(table.table, g, h, weight, ids, n_shards * num_nodes,
                   num_bins, **kw)
    trace_mod.global_tracer().counter(
        "federation.hist_blocks",
        {"blocks": parties.num_parties * n_shards})
    total = mesh_roles.shard_sum(hist.unflatten(1, (n_shards, num_nodes))
                                 .unbind(1))
    return parties.parts(total, 2)


def federated_round_histogram_fn(
    base_fn: Callable = hist_mod.compute_round_histogram,
    meter=None,
    gather: Callable = plain_gather,
    child: bool = False,
):
    """Round histogram provider of the ``histogram`` aggregation.

    Each party's (T, nodes, its columns, B, 2K+1) round histogram is its
    column range of the level's one ``base_fn`` call (``_local_histograms``;
    the keywords ``level`` and ``root_delta_rows`` pass through: shared
    root stays a local transformation), then the payloads are gathered
    along the feature axis:
    ONE exchange per level for the whole round.  ``meter`` records the
    payload one party ships, before ``gather`` (the exchange seam: the
    plain or the double-buffered gather) splits anything.  ``child``:
    ``base_fn`` is a child form, whose ids are child slots."""

    def fn(table, g, h, weight, assign, num_nodes, num_bins, **kw):
        local = _local_histograms(base_fn, table, g, h, weight, assign,
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

    def fn(table, g, h, weight, assign, num_nodes, num_bins, **kw):
        return torch.cat(_local_histograms(base_fn, table, g, h, weight,
                                           assign, num_nodes, num_bins, kw,
                                           child),
                         dim=2)

    return fn


def local_round_leaf_fn(data=mesh_roles.DataLayout()):
    """Round leaf-statistics provider ((T, n) -> (T, leaves, 2K+1)): a
    local pass of the active party (Alg. 2 step 14), which also serves the
    compaction liveness counts; weights and routing are known to every
    party, so nothing is exchanged.  Over ``data``'s shards (the rows
    padded to a multiple of their count) each shard's statistics are its
    own pass, summed in shard order."""
    if data.num_shards == 1:
        return hist_mod.round_leaf_stats

    def fn(g, h, weight, assign, num_leaves):
        return mesh_roles.shard_sum(
            hist_mod.round_leaf_stats(g[r], h[r], weight[:, r],
                                      assign[:, r], num_leaves)
            for r in data.rows(g.shape[0]))

    return fn


def centralized_round_choose_fn(cfg: TreeConfig, num_parties: int,
                                meter=None):
    """Round split chooser of the ``histogram`` aggregation: the merged
    (T, nodes, d, B, 2K+1) histogram is evaluated as centrally.  The
    per-tree feature masks are each party's columns of the (T, d) masks,
    gathered to match; ``meter`` records one party's mask (1 B per local
    feature per tree)."""

    def fn(hist_global, feature_mask):
        with trace_mod.global_tracer().span(EXCHANGE, cat="federation"):
            parts = mesh_roles.even_layout(
                num_parties, feature_mask.shape[1]).parts(feature_mask, 1)
            if meter is not None:
                meter.record("feature_mask", parts[0])
            fmask = plain_gather(parts, 1)
        return split_mod.choose_splits_round(hist_global, fmask, cfg)

    return fn


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) 0/1 tensor into (..., ceil(n/8)) uint8 maps, little-
    endian within each byte: the id_partition wire format, 1 bit a row.
    The bit positions are made on ``x``'s device: no host copy a call."""
    n = x.shape[-1]
    n_bytes = -(-n // 8)
    bits = torch.nn.functional.pad(x.to(torch.uint8), (0, n_bytes * 8 - n))
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return torch.sum(bits.reshape(*x.shape[:-1], n_bytes, 8) << shifts,
                     dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (..., ceil(n/8)) uint8 -> (..., n) int32."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.int32)


def federated_round_route_fn(meter=None):
    """Round ownership-masked routing: the whole round's (T, n) go-right
    decisions in ONE exchange per level (Alg. 2 step 3), in a fixed number
    of tensor ops for every (party, shard) block of the table.

    Each row's node feature is read from the full-width table: a row's
    split column has one owner, so the one compare over the table is every
    party's decision on its own columns (an unsplit node, -1, goes left).
    Each party's bits are the rows it decides (``PartyLayout.owner``),
    bit-packed over each data shard's own rows, all parties and shards in
    one ``pack_bits``: (P, S, T, ceil(m/8)) uint8 maps (``meter`` records
    party 0's, every shard in one record).  The maps are summed over the
    parties in uint8: every bit has at most one non-zero contributor, so
    the sum is the OR."""

    def fn(table, assign, decision):
        parties, n_shards = table.parties, table.data.num_shards
        trace_mod.global_tracer().counter(
            "federation.route_blocks",
            {"blocks": parties.num_parties * n_shards})
        node = assign.long()
        f_global = torch.gather(decision.feature, 1, node).long()   # (T, n)
        thr = torch.gather(decision.threshold, 1, node)
        fv = torch.gather(table.table, 1, f_global.clamp(0).T).T    # (T, n)
        go = (f_global >= 0) & (fv > thr)
        party = torch.arange(parties.num_parties, device=assign.device)
        bits = (parties.owner(f_global) == party[:, None, None]) & go
        t, n = assign.shape
        m = n // n_shards
        with trace_mod.global_tracer().span(EXCHANGE, cat="federation"):
            maps = pack_bits(bits.view(-1, t, n_shards, m).permute(0, 2, 1, 3))
            if meter is not None:
                meter.record("id_partition", maps[0])
            go_right = unpack_bits(torch.sum(maps, dim=0, dtype=torch.uint8),
                                   m)                               # (S, T, m)
        out = assign * 2
        out.view(t, n_shards, m).add_(go_right.transpose(0, 1))
        return out

    return fn
