"""Core datatypes: the counterpart of ``repro/core/types.py``.

All tree structures are *fixed-topology complete binary trees* of static depth
``max_depth``:

* internal nodes are stored level-order: level ``l`` occupies indices
  ``[2**l - 1, 2**(l+1) - 2]``; ``num_internal = 2**max_depth - 1``;
* ``feature == -1`` marks a node that did not split (its threshold is set to
  ``num_bins`` so every sample routes left, landing in the left-most
  descendant leaf, which carries the node's weight);
* leaves are the ``2**max_depth`` slots of the final level.

Tensors replace the JAX arrays; everything else keeps its field names and
defaults, so a model moves between the packages field by field
(``repro_torch.convert``).  ``quantize_ensemble``'s stochastic rounding
draws the JAX package's uniforms from the same key (``core/prng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class TreeArrays(NamedTuple):
    """A single decision tree (or a stack of them along a leading axis)."""

    feature: torch.Tensor      # (num_internal,) int32 — split feature, -1 = leaf-through
    threshold: torch.Tensor    # (num_internal,) int32 — go left iff bin <= threshold
    gain: torch.Tensor         # (num_internal,) float32 — split gain (eq. 1)
    leaf_weight: torch.Tensor  # (2**max_depth[, K]) float32 leaf weights


def forest_size(trees: TreeArrays) -> int:
    """Number of trees in a stacked forest (leading axis of every field)."""
    return int(trees.feature.shape[0])


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static hyper-parameters of a single decision tree (Alg. 2).

    Same fields and defaults as the JAX package's ``TreeConfig``:
    ``hist_subtraction`` derives right siblings as parent − left at levels
    >= 1, ``max_active_nodes`` caps the live frontier per level (0 = none)
    and ``shared_root`` derives level-0 histograms as shared − delta.
    """

    max_depth: int = 3
    num_bins: int = 32
    lambda_: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1e-3
    hist_subtraction: bool = True
    max_active_nodes: int = 0
    shared_root: bool = False

    @property
    def num_internal(self) -> int:
        return 2 ** self.max_depth - 1

    @property
    def num_leaves(self) -> int:
        return 2 ** self.max_depth

    def active_width(self, level: int) -> int:
        """Live-slot budget of a level: ``min(2**level, max_active_nodes)``
        (the full frontier when uncompacted)."""
        width = 2 ** level
        if self.max_active_nodes:
            return min(width, self.max_active_nodes)
        return width


@dataclasses.dataclass(frozen=True)
class FedGBFConfig:
    """FedGBF / Dynamic FedGBF training configuration (Algs. 1 & 3).

    Same fields and defaults as the JAX package's ``FedGBFConfig``.
    """

    rounds: int = 20
    learning_rate: float = 0.1
    tree: TreeConfig = dataclasses.field(default_factory=TreeConfig)
    loss: str = "logistic"
    n_trees_max: int = 5
    n_trees_min: int = 5
    n_trees_speed: float = 1.0
    rho_id_min: float = 1.0
    rho_id_max: float = 1.0
    rho_id_speed: float = 1.0
    rho_feat: float = 1.0
    base_score: float = 0.0
    sampling: str = "uniform"
    goss_top_share: float = 0.5


class EnsembleModel(NamedTuple):
    """A trained (Dynamic) FedGBF model: one forest per boosting round."""

    forests: tuple               # tuple[TreeArrays, ...], each with leading tree axis
    learning_rate: float
    base_score: float
    bin_edges: torch.Tensor      # (d, num_bins - 1) — quantile edges used in training
    loss: str
    max_depth: int

    @property
    def rounds(self) -> int:
        return len(self.forests)

    @property
    def total_trees(self) -> int:
        return sum(forest_size(f) for f in self.forests)


#: Tensor fields of ``PackedEnsemble`` in the JAX package's
#: ``tree_flatten`` order — the order of the checkpoint's npz leaves.
PACKED_ARRAYS = ("feature", "threshold", "gain", "leaf_weight", "tree_scale",
                 "bin_edges")
#: Static metadata of ``PackedEnsemble`` (the checkpoint's json sidecar).
PACKED_META = ("round_offsets", "learning_rate", "base_score", "loss",
               "max_depth")


@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    """Inference layout: every round's trees in one ``(total_trees, ...)``
    stack (DESIGN.md §3).

    ``round_offsets`` (static, len rounds + 1) keeps the round structure for
    the exact per-round combiner; ``tree_scale`` (= lr / n_trees of the
    tree's round) is the per-tree weight the single-pass combiners and the
    kernels accumulate.
    """

    feature: torch.Tensor      # (total_trees, num_internal) int32
    threshold: torch.Tensor    # (total_trees, num_internal) int32
    gain: torch.Tensor         # (total_trees, num_internal) float32
    leaf_weight: torch.Tensor  # (total_trees, num_leaves[, K]) float32
    tree_scale: torch.Tensor   # (total_trees,) float32 = lr / n_trees(round)
    bin_edges: torch.Tensor    # (d, num_bins - 1) training quantile edges
    round_offsets: tuple
    learning_rate: float
    base_score: float
    loss: str
    max_depth: int

    @property
    def rounds(self) -> int:
        return len(self.round_offsets) - 1

    @property
    def total_trees(self) -> int:
        return int(self.round_offsets[-1])

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device) -> "PackedEnsemble":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in PACKED_ARRAYS})

    def trees(self) -> TreeArrays:
        return TreeArrays(self.feature, self.threshold, self.gain,
                          self.leaf_weight)

    def round_trees(self, r: int) -> TreeArrays:
        """Round ``r``'s stacked TreeArrays."""
        s, e = self.round_offsets[r], self.round_offsets[r + 1]
        return TreeArrays(self.feature[s:e], self.threshold[s:e],
                          self.gain[s:e], self.leaf_weight[s:e])


def pack_ensemble(model: EnsembleModel) -> PackedEnsemble:
    """Flatten an EnsembleModel into the packed inference layout."""
    offsets = [0]
    for f in model.forests:
        offsets.append(offsets[-1] + forest_size(f))
    device = model.bin_edges.device
    scales = torch.cat([
        torch.full((forest_size(f),), model.learning_rate / forest_size(f),
                   dtype=torch.float32, device=device)
        for f in model.forests
    ])

    def cat(field):
        return torch.cat([getattr(f, field) for f in model.forests])

    return PackedEnsemble(
        feature=cat("feature"),
        threshold=cat("threshold"),
        gain=cat("gain"),
        leaf_weight=cat("leaf_weight"),
        tree_scale=scales,
        bin_edges=model.bin_edges,
        round_offsets=tuple(offsets),
        learning_rate=model.learning_rate,
        base_score=model.base_score,
        loss=model.loss,
        max_depth=model.max_depth,
    )


def unpack_ensemble(packed: PackedEnsemble) -> EnsembleModel:
    """Inverse of ``pack_ensemble`` (lossless round-trip)."""
    return EnsembleModel(
        forests=tuple(packed.round_trees(r) for r in range(packed.rounds)),
        learning_rate=packed.learning_rate,
        base_score=packed.base_score,
        bin_edges=packed.bin_edges,
        loss=packed.loss,
        max_depth=packed.max_depth,
    )


#: Threshold of an unsplit node in the value-space table: float32 max, the
#: JAX package's sentinel.  Every sanitised feature value compares
#: ``<= FLOAT_MAX``, so the node routes every sample left.
FLOAT_MAX = float(torch.finfo(torch.float32).max)


def float_thresholds(feature: torch.Tensor, threshold: torch.Tensor,
                     bin_edges: torch.Tensor) -> torch.Tensor:
    """Value-space split thresholds for the fused bin+traverse path.

    ``bin(v) <= t`` is exactly ``v <= edges[f, t]``, so serving compares raw
    floats against ``edges[feature, threshold]``.  Unsplit nodes
    (``feature == -1`` or ``t > B - 2``) get ``FLOAT_MAX``.  Both gather
    indices are clamped into range first, as JAX's clip and its clamping
    gather do: a torch index of -1 would read the last column instead.

    Args:
      feature / threshold: (T, I) int32 packed node tables.
      bin_edges: (d, B - 1) float32 training quantile edges.
    Returns:
      (T, I) float32 value-space thresholds.
    """
    d, num_edges = bin_edges.shape
    num_bins = num_edges + 1
    t = threshold.clamp(0, num_bins - 2).long()
    f = feature.clamp(0, d - 1).long()
    vals = bin_edges[f, t]
    is_split = (feature >= 0) & (threshold <= num_bins - 2)
    return torch.where(is_split, vals,
                       torch.full_like(vals, FLOAT_MAX)).to(torch.float32)


#: Tensor fields of ``QuantizedEnsemble`` in the JAX package's
#: ``tree_flatten`` order, and its static metadata.
QUANTIZED_ARRAYS = ("feature", "threshold", "leaf_q", "leaf_scale",
                    "tree_scale", "bin_edges")
QUANTIZED_META = ("bits",) + PACKED_META


@dataclasses.dataclass(frozen=True)
class QuantizedEnsemble:
    """int8/int16 serving variant of ``PackedEnsemble`` (DESIGN.md §14).

    Structure stays lossless (``feature`` int16, ``threshold`` int8 when
    B <= 126 else int16); the leaf table is stochastically rounded with one
    ``leaf_scale`` per tree (per channel when K-wide); the gain table is
    dropped.  Routing equals the f32 model's, so the margin error is at
    most ``margin_delta_bound``.
    """

    feature: torch.Tensor      # (total_trees, num_internal) int16
    threshold: torch.Tensor    # (total_trees, num_internal) int8/int16
    leaf_q: torch.Tensor       # (total_trees, num_leaves[, K]) int8/int16
    leaf_scale: torch.Tensor   # (total_trees,[ K]) float32 per-tree quantum
    tree_scale: torch.Tensor   # (total_trees,) float32 = lr / n_trees(round)
    bin_edges: torch.Tensor    # (d, num_bins - 1) float32 training edges
    bits: int
    round_offsets: tuple
    learning_rate: float
    base_score: float
    loss: str
    max_depth: int

    @property
    def rounds(self) -> int:
        return len(self.round_offsets) - 1

    @property
    def total_trees(self) -> int:
        return int(self.round_offsets[-1])

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device) -> "QuantizedEnsemble":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in QUANTIZED_ARRAYS})


def quantize_ensemble(packed: PackedEnsemble, bits: int = 8,
                      key: torch.Tensor | None = None,
                      stochastic: bool = True, *,
                      uniform: torch.Tensor | None = None
                      ) -> QuantizedEnsemble:
    """Quantize a packed ensemble for serving (int8/int16 tables).

    The leaf table goes through ``federation.compress.quantize_stats`` as a
    (T, L, K) block (K = 1 for a scalar table), one scale per tree and
    channel.  The stochastic rounding's noise is ``uniform(key, (T, L,
    K))``, ``key`` defaulting to ``PRNGKey(0)`` as in the JAX package;
    ``uniform`` (that shape) overrides it.  A narrowing that loses a
    feature or threshold id raises.
    """
    from repro_torch.core import prng
    from repro_torch.federation import compress

    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    if key is None:
        key = prng.PRNGKey(0)
    num_bins = packed.bin_edges.shape[1] + 1
    thr_dtype = torch.int8 if num_bins <= 126 else torch.int16
    feature = packed.feature.to(torch.int16)
    threshold = packed.threshold.to(thr_dtype)
    if not bool((feature.to(torch.int32) == packed.feature).all()):
        raise ValueError("feature ids do not fit int16")
    if not bool((threshold.to(torch.int32) == packed.threshold).all()):
        raise ValueError(f"bin thresholds do not fit {thr_dtype}")
    lw = packed.leaf_weight
    lw3 = lw[..., None] if lw.dim() == 2 else lw  # (T, L, K)
    q, scale = compress.quantize_stats(lw3, bits, key, stochastic,
                                       uniform=uniform)
    if lw.dim() == 2:
        q, scale = q[..., 0], scale[..., 0]      # (T, L), (T,)
    return QuantizedEnsemble(
        feature=feature, threshold=threshold, leaf_q=q, leaf_scale=scale,
        tree_scale=packed.tree_scale, bin_edges=packed.bin_edges, bits=bits,
        round_offsets=packed.round_offsets,
        learning_rate=packed.learning_rate, base_score=packed.base_score,
        loss=packed.loss, max_depth=packed.max_depth)


def dequantize_leaf(q: QuantizedEnsemble) -> torch.Tensor:
    """f32 leaf table: ``leaf_q * leaf_scale`` per tree (and channel)."""
    if q.leaf_q.dim() == 2:
        return q.leaf_q.to(torch.float32) * q.leaf_scale[:, None]
    return q.leaf_q.to(torch.float32) * q.leaf_scale[:, None, :]


def dequantize_ensemble(q: QuantizedEnsemble) -> PackedEnsemble:
    """Widen a quantized ensemble back to the f32 packed layout; the gain
    table comes back as zeros."""
    return PackedEnsemble(
        feature=q.feature.to(torch.int32),
        threshold=q.threshold.to(torch.int32),
        gain=torch.zeros(tuple(q.feature.shape), dtype=torch.float32,
                         device=q.device),
        leaf_weight=dequantize_leaf(q),
        tree_scale=q.tree_scale, bin_edges=q.bin_edges,
        round_offsets=q.round_offsets, learning_rate=q.learning_rate,
        base_score=q.base_score, loss=q.loss, max_depth=q.max_depth)


def margin_delta_bound(q: QuantizedEnsemble) -> float:
    """Provable |quantized - f32| margin bound over any input: each leaf is
    off by less than one quantum and a row reads one leaf a tree, so
    ``sum_t tree_scale[t] * max_k leaf_scale[t, k]`` (a float32 sum)."""
    per_tree = q.leaf_scale
    if per_tree.dim() == 2:                     # K-channel: worst channel
        per_tree = per_tree.amax(dim=-1)
    return float((q.tree_scale * per_tree).sum())


def serving_tables(model) -> tuple:
    """The fused-serving node tables of a ``PackedEnsemble`` or a
    ``QuantizedEnsemble`` (leaf table dequantized): ``(feature i32 (T, I),
    thr_value f32 (T, I), leaf f32 (T, L[, K]), tree_scale f32 (T,))``,
    contiguous, on the model's device."""
    if isinstance(model, QuantizedEnsemble):
        leaf = dequantize_leaf(model)
    elif isinstance(model, PackedEnsemble):
        leaf = model.leaf_weight
    else:
        raise TypeError("serving_tables takes a PackedEnsemble or a "
                        f"QuantizedEnsemble, got {type(model).__name__}")
    feature = model.feature.to(torch.int32).contiguous()
    thr = float_thresholds(feature, model.threshold.to(torch.int32),
                           model.bin_edges).contiguous()
    return (feature, thr, leaf.to(torch.float32).contiguous(),
            model.tree_scale.to(torch.float32).contiguous())
