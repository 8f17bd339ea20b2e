"""Plain PyTorch versions of the two ensemble-traversal kernels.

They keep the kernels' order of floating-point operations, which is also
the TPU kernels' (``repro/kernels/ensemble_predict/ensemble_predict.py``)
as XLA's CPU backend runs them: the accumulator starts at 0, each tree
adds ``acc + leaf * scale`` in tree order as one FMA (rounded once,
``core.fma``; ``__fmaf_rn`` in the CUDA kernels), and the wrapper adds ``base_score`` afterwards.  The raw version
first sanitises its input — NaN to -FLOAT_MAX (routes left), ±inf clipped
to ±FLOAT_MAX — without which ``+inf > FLOAT_MAX`` would route an infinite
feature right at an unsplit node.  The CPU tests hold these against the
Pallas kernels; ``chip_smoke.py`` holds the CUDA kernels against these,
bit for bit, on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.fma import fma
from repro_torch.core.tree import leaf_index
from repro_torch.core.types import FLOAT_MAX


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """NaN -> -FLOAT_MAX, ±inf -> ±FLOAT_MAX (the raw kernel's tile step)."""
    return torch.where(torch.isnan(x), torch.full_like(x, -FLOAT_MAX),
                       x.clamp(-FLOAT_MAX, FLOAT_MAX))


def _sweep(x, feature, threshold, leaf, scale, max_depth):
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(feature.shape[0]):
        idx = leaf_index(x, feature[t], threshold[t], max_depth)
        acc = fma(leaf[t][idx.long()], scale[t], acc)
    return acc


def predict_forest_raw_ref(x: torch.Tensor, feature: torch.Tensor,
                           thr_value: torch.Tensor, leaf: torch.Tensor,
                           scale: torch.Tensor, max_depth: int
                           ) -> torch.Tensor:
    """Raw floats (n, d) f32 against value-space thresholds (T, I) f32:
    (n,) f32 ``sum_t leaf_t[idx] * scale_t``, without ``base_score``."""
    return _sweep(sanitize(x), feature, thr_value, leaf, scale, max_depth)


def predict_forest_binned_ref(binned: torch.Tensor, feature: torch.Tensor,
                              threshold: torch.Tensor, leaf: torch.Tensor,
                              scale: torch.Tensor, max_depth: int
                              ) -> torch.Tensor:
    """Bins (n, d) i32 against bin-space thresholds (T, I) i32: (n,) f32
    ``sum_t leaf_t[idx] * scale_t``, without ``base_score``."""
    return _sweep(binned, feature, threshold, leaf, scale, max_depth)
