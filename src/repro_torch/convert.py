"""Carry state across from the JAX package: numpy arrays in, tensors out.

* ``packed_from_numpy``: a model.  The JAX package's ``PackedEnsemble``
  gives its fields as numpy arrays (``np.asarray`` of each) and its static
  metadata as plain values; the checkpoint loader and the tests that feed
  one model to both packages go through it.
* ``masks_from_numpy``: the sampling masks of a training run.  The JAX
  package draws them with ``jax.random`` under threefry, which torch cannot
  reproduce, so a run that must build the JAX package's trees takes its
  masks: (S, n) sample and (S, d) feature masks, one row per scheduled
  tree build in build order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import StepMasks
from repro_torch.core.types import PACKED_ARRAYS, PACKED_META, PackedEnsemble
from repro_torch.device import resolve


def packed_from_numpy(arrays: dict[str, np.ndarray], meta: dict,
                      device=None) -> PackedEnsemble:
    """A ``PackedEnsemble`` on ``device`` (default ``cuda``) from the
    arrays named in ``types.PACKED_ARRAYS`` and the metadata named in
    ``types.PACKED_META``."""
    dev = resolve(device)
    tensors = {f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(dev)
               for f in PACKED_ARRAYS}
    return PackedEnsemble(
        **tensors,
        round_offsets=tuple(int(o) for o in meta["round_offsets"]),
        learning_rate=float(meta["learning_rate"]),
        base_score=float(meta["base_score"]),
        loss=str(meta["loss"]),
        max_depth=int(meta["max_depth"]),
    )


def packed_to_numpy(packed: PackedEnsemble) -> tuple[dict, dict]:
    """Inverse of ``packed_from_numpy``: (arrays, metadata)."""
    arrays = {f: getattr(packed, f).detach().cpu().numpy()
              for f in PACKED_ARRAYS}
    meta = {f: getattr(packed, f) for f in PACKED_META}
    meta["round_offsets"] = list(meta["round_offsets"])
    return arrays, meta


def masks_from_numpy(sample: np.ndarray, feature: np.ndarray, device=None,
                     n: int | None = None) -> StepMasks:
    """``StepMasks`` on ``device`` (default ``cuda``) from the JAX
    package's (S, n) sample and (S, d) feature masks.  With ``n`` given,
    ``sample`` is the (S, ceil(n / 8)) ``np.packbits`` of the 0/1 masks
    along the rows."""
    dev = resolve(device)
    sample = np.asarray(sample)
    if n is not None:
        sample = np.unpackbits(sample, axis=1, count=n)
    return StepMasks(
        torch.tensor(sample, dtype=torch.float32, device=dev),
        torch.tensor(np.asarray(feature, bool), device=dev))
