"""Ensemble prediction entry points: ``predict``, ``predict_loop`` and
``predict_proba`` of ``repro/core/boosting.py`` (:897-991).

``train_fedgbf`` comes with the training slice.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.core import binning
from repro_torch.core import objective as objective_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.types import (
    EnsembleModel,
    PackedEnsemble,
    pack_ensemble,
    unpack_ensemble,
)
from repro_torch.kernels.ensemble_predict import ops

#: ``impl`` names; ``fused-cuda`` and ``cuda`` are the JAX package's
#: ``fused-pallas`` and ``pallas``.
IMPLS = ("fused", "fused-cuda", "packed", "weighted", "cuda", "loop")


def predict(model: Union[EnsembleModel, PackedEnsemble], x: torch.Tensor,
            impl: str = "packed") -> torch.Tensor:
    """Raw margin F(x) = base + lr * sum_m mean_j T_mj(x) (Alg. 1 l.10).

    ``impl``:
      ``"packed"``      exact per-round combiner (the default);
      ``"weighted"``    single-pass tree_scale combiner on bins;
      ``"cuda"``        the binned ensemble kernel;
      ``"fused"``       binning folded into the traversal: raw floats
                        against value-space thresholds;
      ``"fused-cuda"``  the fused path as one raw-float kernel launch;
      ``"loop"``        the per-round loop over unpacked forests.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown predict impl {impl!r}; options: {IMPLS}")
    x = x.to(torch.float32)
    if impl == "loop":
        return predict_loop(model, x)
    packed = model if isinstance(model, PackedEnsemble) else pack_ensemble(
        model)
    if impl == "fused":
        return tree_mod.predict_packed_fused(packed, x)
    if impl == "fused-cuda":
        return ops.predict_packed_fused_cuda(packed, x.contiguous())
    binned = binning.bin_data(x, packed.bin_edges)
    if impl == "packed":
        return tree_mod.predict_packed(packed, binned)
    if impl == "weighted":
        return tree_mod.predict_packed_weighted(packed, binned)
    return ops.predict_packed_cuda(packed, binned)


def predict_loop(model: Union[EnsembleModel, PackedEnsemble],
                 x: torch.Tensor) -> torch.Tensor:
    """The per-round prediction loop: ``base + sum_r lr * forest_r(x)``."""
    if isinstance(model, PackedEnsemble):
        model = unpack_ensemble(model)
    binned = binning.bin_data(x, model.bin_edges)
    out = objective_mod.get_objective(model.loss).init_raw(
        x.shape[0], model.base_score, device=x.device)
    for trees in model.forests:
        out = out + model.learning_rate * tree_mod.predict_forest(
            trees, binned, model.max_depth)
    return out


def predict_proba(model: Union[EnsembleModel, PackedEnsemble],
                  x: torch.Tensor, impl: str = "packed") -> torch.Tensor:
    """The objective's activation of the raw margin (sigmoid for logistic,
    softmax for multiclass, identity for regression/quantile)."""
    obj = objective_mod.get_objective(model.loss)
    return obj.activation(predict(model, x, impl=impl))
