"""The vertically federated forest builder: the counterpart of
``repro/federation/vfl.py``.

The JAX package runs a round's forest build as one SPMD program whose
party axis is a mesh axis.  The port runs the parties as column ranges of
one table in one process on one card (``mesh_roles``): ``forest_builder``
wraps ``binned`` in a ``mesh_roles.FederatedTable`` once per forest build
(no copy), and ``core.tree.build_round`` drives the federated providers of
``aggregator.py`` / ``compress.py`` over it.  Every party's histogram
comes from one launch of the histogram kernel a level over the full-width
table (on a CPU tensor, the kernel's plain version), each party's its
column range, direct at level 0 and the kernel's child form at levels
>= 1.

Lossless: both aggregations build the trees the centralized builder
builds, bit for bit (the party ranges only partition the feature axis of
computations that are per feature; the merges keep the centralized
first-maximum tie-break).

The data axis (``-sharded``): the rows pad to a multiple of the shard
count with weight-0 rows (after the engine drew its masks over the real
``n``), split into contiguous row ranges (``mesh_roles.DataLayout``), and
the level's one launch takes each row's shard into its node id; the shard
partials are summed in shard order, and the per-tree predictions are
sliced back to ``n``.  The chaos transport (``-chaos``) wraps the level
exchange (the plain or the double-buffered ``-async`` gather) in
``chaos.ChaoticGather``; its slot counter restarts at every forest build.

Registry names: the JAX lattice, ``vfl-histogram[-async][-q8|-q16]`` and
``vfl-argmax[-topk]``, each with its ``-sharded``, ``-chaos`` and
``-sharded-chaos`` twins (suffix order base -> ``-sharded`` ->
``-chaos``).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.core import forest as forest_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.backend import (
    BackendDescriptor,
    TreeBackend,
    register_backend,
)
from repro_torch.core.histogram import histogram_dispatch
from repro_torch.core.types import TreeConfig
from repro_torch.federation import aggregator, compress, mesh_roles
from repro_torch.federation import async_exchange as async_mod
from repro_torch.federation import chaos as chaos_mod
from repro_torch.obs import trace as trace_mod


def make_vfl_backend(
    parties,
    tree: TreeConfig,
    aggregation: str = "histogram",
    transport=None,
    meter=None,
    async_exchange: bool = False,
    draws=None,
    chaos=None,
    shard_samples: bool = False,
    data_shards: int = 1,
) -> TreeBackend:
    """Construct the vertically federated ``TreeBackend``.

    Args:
      parties: the party count, or a ``mesh_roles.PartyLayout`` (which
        also fixes the number of columns).
      tree: the tree config the builds use; a caller's differing config is
        refused.
      aggregation: ``"histogram"`` (every party ships its histogram) or
        ``"argmax"`` (only split candidates are exchanged).
      transport: a ``compress.TransportSpec`` (None = raw float32):
        ``"quantized"`` for the histogram aggregation, ``"topk"`` for the
        argmax one.
      meter: a ``compress.MessageMeter``; every exchange records the
        payload one party ships, and each forest build the (g, h)
        broadcast.
      async_exchange: the double-buffered histogram exchange (histogram
        aggregation only); bit-identical, one metered message a level.
      draws: the quantized transport's rounding draws
        override (``compress.Draws``); None = the JAX keys
        (``compress.transport_key``).
      chaos: a ``chaos.ChaosSpec``: the level exchange (whatever gather
        the flags above select) runs through the fault-injecting,
        checksum-verified chaos transport; the result is bit-identical to
        the wrapped transport's and ``meter`` gains the ``retries`` phase.
      shard_samples, data_shards: the data axis — the rows as
        ``data_shards`` contiguous blocks (``mesh_roles.DataLayout``),
        still one histogram launch a level.
    """
    cfg = tree
    layout = parties if isinstance(parties, mesh_roles.PartyLayout) else None
    num_parties = layout.num_parties if layout is not None else int(parties)
    if num_parties < 1:
        raise ValueError(f"need >= 1 party, got {num_parties}")
    if transport is None:
        transport = compress.RAW
    if async_exchange and aggregation != "histogram":
        raise ValueError(
            "async_exchange applies to the histogram aggregation only (the "
            "argmax candidate exchange is already small)")
    if not shard_samples and data_shards != 1:
        raise ValueError(
            f"data_shards={data_shards} needs a -sharded backend (the data "
            "axis); the unsharded names hold every row in one block")
    data_layout = mesh_roles.DataLayout(data_shards)

    # the exchange gather: plain or double-buffered, and ONE chaos wrapper
    # per backend over it; the forest builders restart its slot counter at
    # every entry
    gather = aggregator.plain_gather
    if async_exchange:
        gather = partial(async_mod.double_buffered_gather, split_axis=-2)
    chaos_gather = None
    if chaos is not None:
        gather = chaos_gather = chaos_mod.ChaoticGather(
            chaos, gather, num_parties, meter=meter)

    # (base provider, whether it is the child form): a provider folds the
    # data shards into its node ids by the form it wraps
    forms = ((histogram_dispatch("cuda-fused-round"), False),
             (histogram_dispatch("cuda-fused-round-child"), True))
    if aggregation == "histogram":
        if transport.kind == "quantized":
            provider = partial(compress.quantized_round_histogram_fn,
                               transport, meter, draws=draws)
        elif transport.kind == "raw":
            provider = partial(aggregator.federated_round_histogram_fn,
                               meter=meter)
        else:
            raise ValueError(
                f"transport {transport.kind!r} does not apply to the "
                "histogram aggregation (use 'raw' or 'quantized')")
        hist_fn, child_fn = (provider(base_fn=base, gather=gather,
                                      child=child) for base, child in forms)
        choose_fn = aggregator.centralized_round_choose_fn(cfg, num_parties,
                                                           meter)
    elif aggregation == "argmax":
        if transport.kind not in ("raw", "topk"):
            raise ValueError(
                f"transport {transport.kind!r} does not apply to the argmax "
                "aggregation (use 'raw' or 'topk')")
        hist_fn, child_fn = (aggregator.local_round_histogram_fn(base, child)
                             for base, child in forms)
        k = transport.k if transport.kind == "topk" else 1
        choose_fn = compress.topk_round_choose_fn(cfg, k, num_parties, meter,
                                                  gather=gather)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")

    impl = f"vfl-{aggregation}"
    if async_exchange:
        impl += "-async"
    if transport.kind != "raw":
        impl += f"-{transport.tag}"
    if shard_samples:
        impl += "-sharded"
    if chaos is not None:
        impl += "-chaos"
    descriptor = BackendDescriptor(
        impl=impl,
        histogram_impl="cuda",
        num_parties=num_parties,
        party_axis=mesh_roles.PARTY_AXIS,
        transport=transport.tag,
        transport_spec=None if transport.kind == "raw" else transport,
        async_exchange=async_exchange,
        shard_samples=shard_samples,
        data_shards=data_shards,
        chaos=chaos,
    )
    inner = TreeBackend(
        descriptor=descriptor,
        round_histogram_fn=hist_fn,
        round_child_histogram_fn=child_fn,
        round_choose_fn=choose_fn,
        round_route_fn=aggregator.federated_round_route_fn(meter),
        round_leaf_fn=aggregator.local_round_leaf_fn(data_layout),
    )

    def _table(binned, g, h, sample_mask, _cfg):
        """Refuse a differing tree config or an uneven split, restart the
        chaos slots, meter the round's (g, h) broadcast (the real n rows)
        and pad the rows for the data shards (weight 0).  Returns
        (``mesh_roles.FederatedTable``, g, h, sample_mask)."""
        if _cfg is not None and _cfg != cfg:
            raise ValueError(
                f"backend {descriptor.impl!r} was built with {cfg}, but the "
                f"caller passed {_cfg}; construct the backend with the same "
                "TreeConfig as FedGBFConfig.tree")
        parties = (layout if layout is not None
                   else mesh_roles.even_layout(num_parties, binned.shape[1]))
        if chaos_gather is not None:
            chaos_gather.begin_trace()
        if meter is not None:
            # the per-round (g, h) broadcast active -> each passive party
            meter.record("grad_broadcast", g)
            meter.record("grad_broadcast", h)
        if not shard_samples:
            return (mesh_roles.FederatedTable.of(binned, parties), g, h,
                    sample_mask)
        # the pad comes after the engine drew its masks over the real n:
        # padded rows carry weight 0, so every histogram, leaf statistic,
        # liveness count and root delta ignores them
        pad = data_layout.padded_rows(binned.shape[0]) - binned.shape[0]
        rows = (0, 0) * (g.dim() - 1) + (0, pad)
        binned, g, h = (F.pad(binned, (0, 0, 0, pad)), F.pad(g, rows),
                        F.pad(h, rows))
        sample_mask = F.pad(sample_mask.to(torch.float32), (0, pad))
        return (mesh_roles.FederatedTable.of(binned, parties, data_layout),
                g, h, sample_mask)

    def forest_builder_per_tree(binned, g, h, sample_mask, feature_mask,
                                _cfg=None, root_delta_rows=0):
        n = binned.shape[0]
        with trace_mod.global_tracer().span(aggregator.EXCHANGE,
                                            cat="federation"):
            table, g, h, sample_mask = _table(binned, g, h, sample_mask,
                                              _cfg)
        trees, per_tree = forest_mod.build_forest_per_tree(
            table, g, h, sample_mask, feature_mask, cfg, backend=inner,
            root_delta_rows=root_delta_rows)
        return trees, per_tree[:, :n]

    def forest_builder(binned, g, h, sample_mask, feature_mask, _cfg=None,
                       root_delta_rows=0):
        trees, per_tree = forest_builder_per_tree(
            binned, g, h, sample_mask, feature_mask, _cfg, root_delta_rows)
        return trees, tree_mod._mean0(per_tree)

    # The per-party providers live on the inner backend only: they take
    # the federated table, not ``binned``.  The public surface is the
    # forest build.
    return TreeBackend(
        descriptor=descriptor,
        forest_builder=forest_builder,
        forest_builder_per_tree=forest_builder_per_tree,
    )


def _vfl_factory(aggregation: str, transport=None,
                 async_exchange: bool = False, shard_samples: bool = False,
                 chaos_enabled: bool = False):
    def factory(tree=None, num_parties: int = 2, **kw):
        if tree is None:
            raise ValueError(
                "vfl backends need tree= (a TreeConfig), e.g. get_backend("
                "'vfl-histogram', tree=TreeConfig(), num_parties=4)")
        explicit = kw.pop("transport", None)
        if (transport is not None and explicit is not None
                and explicit != transport):
            raise ValueError(
                f"backend name encodes transport {transport.tag!r} but "
                f"transport= {explicit!r} was passed; drop the kwarg or use "
                "the matching registry name")
        chaos = kw.pop("chaos", None)
        if chaos_enabled:
            # a -chaos name with no spec runs the zero-fault one: checksums
            # verified, no fault injected
            chaos = chaos if chaos is not None else chaos_mod.ChaosSpec()
        elif chaos is not None:
            raise ValueError(
                "chaos= was passed to a non-chaos backend name; use the "
                "matching '-chaos' registry name")
        return make_vfl_backend(
            num_parties, tree, aggregation=aggregation,
            transport=transport if transport is not None else explicit,
            async_exchange=async_exchange, chaos=chaos,
            shard_samples=shard_samples, **kw)

    return factory


_TRANSPORTS = {
    "histogram": (("", None), ("-q8", compress.Q8), ("-q16", compress.Q16)),
    "argmax": (("", None), ("-topk", compress.TOPK)),
}
for _agg, _variants in _TRANSPORTS.items():
    for _suffix, _transport in _variants:
        for _async in ((False, True) if _agg == "histogram" else (False,)):
            _name = f"vfl-{_agg}" + ("-async" if _async else "") + _suffix
            for _shard, _sname in ((False, _name), (True, _name + "-sharded")):
                for _chaos, _cname in ((False, _sname),
                                       (True, _sname + "-chaos")):
                    register_backend(_cname, _vfl_factory(
                        _agg, _transport, _async, shard_samples=_shard,
                        chaos_enabled=_chaos))
