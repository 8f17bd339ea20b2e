"""The vertically federated forest builder: the counterpart of
``repro/federation/vfl.py``.

The JAX package runs a round's forest build as one SPMD program whose
party axis is a mesh axis.  The port runs the parties as column blocks of
one process on one card (``mesh_roles``): ``forest_builder`` splits
``binned`` into the parties' contiguous blocks once per forest build, and
``core.tree.build_round`` drives the federated providers of
``aggregator.py`` / ``compress.py`` / ``async_exchange.py`` over them.
Every party's histogram is one launch of the histogram kernel on its block
(on a CPU tensor, the kernel's plain version), direct at level 0 and the
kernel's child form at levels >= 1.

Lossless: both aggregations build the trees the centralized builder
builds, bit for bit (the party blocks only partition the feature axis of
computations that are per feature; the merges keep the centralized
first-maximum tie-break).

Registry names (the unsharded, fault-free part of the JAX lattice):
``vfl-histogram[-async][-q8|-q16]`` and ``vfl-argmax[-topk]``.  The
``-sharded`` (data axis) and ``-chaos`` twins are registered and raise
``NotImplementedError``: they come with later slices of the port.
"""

from __future__ import annotations

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


def make_vfl_backend(
    parties,
    tree: TreeConfig,
    aggregation: str = "histogram",
    transport=None,
    meter=None,
    async_exchange: bool = False,
    draws=None,
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
        (``compress.Draws``); None = ``compress.native_draws(seed)``.
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

    direct = histogram_dispatch("cuda-fused-round")
    child = histogram_dispatch("cuda-fused-round-child")
    if aggregation == "histogram":
        if transport.kind not in ("raw", "quantized"):
            raise ValueError(
                f"transport {transport.kind!r} does not apply to the "
                "histogram aggregation (use 'raw' or 'quantized')")
        if async_exchange:
            hist_fn, child_fn = (async_mod.async_round_histogram_fn(
                transport, meter, base, draws) for base in (direct, child))
        elif transport.kind == "quantized":
            hist_fn, child_fn = (compress.quantized_round_histogram_fn(
                transport, meter, base, draws=draws)
                for base in (direct, child))
        else:
            hist_fn, child_fn = (aggregator.federated_round_histogram_fn(
                base, meter) for base in (direct, child))
        choose_fn = aggregator.centralized_round_choose_fn(cfg, num_parties,
                                                           meter)
    elif aggregation == "argmax":
        if transport.kind not in ("raw", "topk"):
            raise ValueError(
                f"transport {transport.kind!r} does not apply to the argmax "
                "aggregation (use 'raw' or 'topk')")
        hist_fn, child_fn = (aggregator.local_round_histogram_fn(base)
                             for base in (direct, child))
        k = transport.k if transport.kind == "topk" else 1
        choose_fn = compress.topk_round_choose_fn(cfg, k, num_parties, meter)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")

    impl = f"vfl-{aggregation}"
    if async_exchange:
        impl += "-async"
    if transport.kind != "raw":
        impl += f"-{transport.tag}"
    descriptor = BackendDescriptor(
        impl=impl,
        histogram_impl="cuda",
        num_parties=num_parties,
        party_axis=mesh_roles.PARTY_AXIS,
        transport=transport.tag,
        transport_spec=None if transport.kind == "raw" else transport,
        async_exchange=async_exchange,
    )
    inner = TreeBackend(
        descriptor=descriptor,
        round_histogram_fn=hist_fn,
        round_child_histogram_fn=child_fn,
        round_choose_fn=choose_fn,
        round_route_fn=aggregator.federated_round_route_fn(meter),
        round_leaf_fn=aggregator.local_round_leaf_fn(),
    )

    def _blocks(binned, g, h, _cfg) -> mesh_roles.PartyBlocks:
        """Refuse a differing tree config or an uneven split, meter the
        round's (g, h) broadcast (the real n rows), split the columns."""
        if _cfg is not None and _cfg != cfg:
            raise ValueError(
                f"backend {descriptor.impl!r} was built with {cfg}, but the "
                f"caller passed {_cfg}; construct the backend with the same "
                "TreeConfig as FedGBFConfig.tree")
        d = binned.shape[1]
        if d % num_parties != 0:
            raise ValueError(
                f"d={d} must shard evenly over {num_parties} parties; "
                "pad columns with data.tabular.pad_features")
        if layout is not None and d != layout.num_features:
            raise ValueError(f"binned has {d} columns, the layout "
                             f"{layout.num_features}")
        if meter is not None:
            # the per-round (g, h) broadcast active -> each passive party
            meter.record("grad_broadcast", g)
            meter.record("grad_broadcast", h)
        return mesh_roles.PartyLayout(num_parties, d).split(binned)

    def forest_builder_per_tree(binned, g, h, sample_mask, feature_mask,
                                _cfg=None, root_delta_rows=0):
        blocks = _blocks(binned, g, h, _cfg)
        return forest_mod.build_forest_per_tree(
            blocks, g, h, sample_mask, feature_mask, cfg, backend=inner,
            root_delta_rows=root_delta_rows)

    def forest_builder(binned, g, h, sample_mask, feature_mask, _cfg=None,
                       root_delta_rows=0):
        trees, per_tree = forest_builder_per_tree(
            binned, g, h, sample_mask, feature_mask, _cfg, root_delta_rows)
        return trees, tree_mod._mean0(per_tree)

    # The per-party providers live on the inner backend only: they take
    # party blocks, not ``binned``.  The public surface is the forest build.
    return TreeBackend(
        descriptor=descriptor,
        forest_builder=forest_builder,
        forest_builder_per_tree=forest_builder_per_tree,
    )


def _vfl_factory(aggregation: str, transport=None,
                 async_exchange: bool = False):
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
        return make_vfl_backend(
            num_parties, tree, aggregation=aggregation,
            transport=transport if transport is not None else explicit,
            async_exchange=async_exchange, **kw)

    return factory


def _later_slice_factory(name: str):
    part = ("the data axis (-sharded)" if "-sharded" in name
            else "the chaos transport (-chaos)")

    def factory(**_kw):
        raise NotImplementedError(
            f"backend {name!r}: {part} comes with a later slice of the "
            "port; this slice has the unsharded, fault-free vfl-* names")

    return factory


_TRANSPORTS = {
    "histogram": (("", None), ("-q8", compress.Q8), ("-q16", compress.Q16)),
    "argmax": (("", None), ("-topk", compress.TOPK)),
}
for _agg, _variants in _TRANSPORTS.items():
    for _suffix, _transport in _variants:
        for _async in ((False, True) if _agg == "histogram" else (False,)):
            _name = f"vfl-{_agg}" + ("-async" if _async else "") + _suffix
            register_backend(_name, _vfl_factory(_agg, _transport, _async))
            for _twin in ("-chaos", "-sharded", "-sharded-chaos"):
                register_backend(_name + _twin,
                                 _later_slice_factory(_name + _twin))
