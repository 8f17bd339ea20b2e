"""TreeBackend: the execution seam of the tree library — the counterpart of
``repro/core/backend.py``, with its centralized backends.

A ``TreeBackend`` bundles the histogram / split / route / leaf providers
and an execution descriptor.  Named backends come from a registry:

  ``"local"``       the plain PyTorch providers (``core.histogram``);
  ``"local-cuda"``  the histogram kernel of ``kernels/histogram``: one
                    launch per level for the whole round (direct at level
                    0, left children at levels >= 1), the single-tree entry
                    point for per-tree callers.  On CPU tensors the
                    kernel's plain version runs, and the descriptor still
                    names ``"cuda"``: it says which provider family ran, the
                    tensors' device says where.

Split search, routing and leaf statistics stay plain PyTorch on every
backend, as they stay plain XLA on the JAX package's ``local-pallas``.

The federated ``vfl-*`` names (``federation/vfl.py``, registered on first
use, as in the JAX package) take ``tree=`` and ``num_parties=``; they
override the whole forest build (``forest_builder`` /
``forest_builder_per_tree``) and run every party's histogram on the
histogram kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class BackendDescriptor:
    """Execution metadata: ``impl`` is the registry name and
    ``histogram_impl`` the histogram provider family (``"segment"`` or
    ``"cuda"``).  The federated backends also fill the party fields:
    ``num_parties``, ``party_axis`` (the JAX package's mesh axis name),
    ``transport`` (``"raw"``, ``"q8"``, ``"q16"``, ``"topk"``) with the
    full ``compress.TransportSpec`` for non-raw formats (the tag cannot
    carry non-default parameters, and byte accounting must not guess
    them), ``async_exchange``, the data axis (``shard_samples`` over
    ``data_shards`` row blocks) and the ``chaos.ChaosSpec`` of a
    ``-chaos`` name."""

    impl: str
    histogram_impl: str = "segment"
    num_parties: int = 1
    party_axis: Optional[str] = None
    transport: str = "raw"
    transport_spec: Optional[object] = None
    async_exchange: bool = False
    shard_samples: bool = False
    data_shards: int = 1
    chaos: Optional[object] = None

    @property
    def is_federated(self) -> bool:
        return self.party_axis is not None


@dataclasses.dataclass(frozen=True)
class TreeBackend:
    """Bundled providers for tree/forest construction.

    Every provider is optional; None selects the plain default.  The
    signatures are those of ``core.histogram`` and ``core.tree``:

      histogram_fn / child_histogram_fn  per-tree histogram providers
        (``compute_histogram`` signature; the child form takes the current
        level's ``assign`` and the PARENT count);
      round_histogram_fn / round_child_histogram_fn  their round-native
        twins over (T, n) weights/assign (``compute_round_histogram``
        contract, with the ``level`` and ``root_delta_rows`` keywords);
      choose_fn / round_choose_fn  histogram -> ``SplitDecision``;
      route_fn / round_route_fn  (binned, assign, decision) -> assign;
      leaf_fn / round_leaf_fn  ``leaf_stats`` / ``round_leaf_stats``;
      forest_builder / forest_builder_per_tree  full overrides of
        ``forest.build_forest`` / ``build_forest_per_tree`` (the federated
        backends: the party split and the (g, h) broadcast happen there).

    ``core.tree.build_round`` prefers a round provider and lifts a per-tree
    one over the tree axis.
    """

    descriptor: BackendDescriptor
    histogram_fn: Optional[Callable] = None
    child_histogram_fn: Optional[Callable] = None
    choose_fn: Optional[Callable] = None
    route_fn: Optional[Callable] = None
    leaf_fn: Optional[Callable] = None
    round_histogram_fn: Optional[Callable] = None
    round_child_histogram_fn: Optional[Callable] = None
    round_choose_fn: Optional[Callable] = None
    round_route_fn: Optional[Callable] = None
    round_leaf_fn: Optional[Callable] = None
    forest_builder: Optional[Callable] = None
    forest_builder_per_tree: Optional[Callable] = None

    @property
    def name(self) -> str:
        return self.descriptor.impl

    def build_forest(self, binned, g, h, sample_mask, feature_mask, cfg,
                     root_delta_rows=0):
        """Build one forest layer: (trees, bagging-mean train prediction)."""
        if self.forest_builder is not None:
            return self.forest_builder(binned, g, h, sample_mask,
                                       feature_mask, cfg,
                                       root_delta_rows=root_delta_rows)
        from repro_torch.core import forest as forest_mod

        return forest_mod.build_forest(
            binned, g, h, sample_mask, feature_mask, cfg, backend=self,
            root_delta_rows=root_delta_rows)

    def build_forest_per_tree(self, binned, g, h, sample_mask, feature_mask,
                              cfg, root_delta_rows=0):
        """Build one forest layer: (trees, per-tree train predictions)."""
        if self.forest_builder_per_tree is not None:
            return self.forest_builder_per_tree(
                binned, g, h, sample_mask, feature_mask, cfg,
                root_delta_rows=root_delta_rows)
        from repro_torch.core import forest as forest_mod

        return forest_mod.build_forest_per_tree(
            binned, g, h, sample_mask, feature_mask, cfg, backend=self,
            root_delta_rows=root_delta_rows)

    def build_tree(self, binned, g, h, sample_mask, feature_mask, cfg):
        """Build one tree (``core.tree.build_tree``)."""
        from repro_torch.core import tree as tree_mod

        return tree_mod.build_tree(binned, g, h, sample_mask, feature_mask,
                                   cfg, backend=self)


def register_backend(name: str, factory: Callable[..., TreeBackend]) -> None:
    """Register a named backend factory: ``factory(**kwargs) -> TreeBackend``."""
    _REGISTRY[name] = factory


def available_backends() -> tuple:
    """Registered names (registering the ``vfl-*`` ones first)."""
    _ensure_vfl_registered()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **kwargs) -> TreeBackend:
    """Construct a named backend; ``vfl-*`` names need ``tree=`` and take
    ``num_parties=`` (default 2)."""
    if name not in _REGISTRY and name.startswith("vfl"):
        _ensure_vfl_registered()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}")
    return _REGISTRY[name](**kwargs)


def resolve_backend(backend, **kwargs) -> TreeBackend:
    """Accept None | name | TreeBackend and return a TreeBackend."""
    if backend is None:
        return get_backend("local")
    if isinstance(backend, str):
        return get_backend(backend, **kwargs)
    if isinstance(backend, TreeBackend):
        return backend
    raise TypeError(
        f"backend must be None, str, or TreeBackend; got {backend!r}")


def _ensure_vfl_registered() -> None:
    import repro_torch.federation.vfl  # noqa: F401  (registers vfl-*)


def _local_factory(**_kw) -> TreeBackend:
    return TreeBackend(BackendDescriptor(impl="local"))


def _local_cuda_factory(**_kw) -> TreeBackend:
    from repro_torch.core.histogram import histogram_dispatch

    return TreeBackend(
        BackendDescriptor(impl="local-cuda", histogram_impl="cuda"),
        histogram_fn=histogram_dispatch("cuda-fused"),
        child_histogram_fn=histogram_dispatch("cuda-fused-child"),
        round_histogram_fn=histogram_dispatch("cuda-fused-round"),
        round_child_histogram_fn=histogram_dispatch("cuda-fused-round-child"),
    )


register_backend("local", _local_factory)
register_backend("local-cuda", _local_cuda_factory)
