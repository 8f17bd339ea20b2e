"""Carry a model across from the JAX package: numpy arrays in, tensors out.

The JAX package's ``PackedEnsemble`` gives its fields as numpy arrays
(``np.asarray`` of each) and its static metadata as plain values; the
checkpoint loader and the tests that feed one model to both packages go
through ``packed_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

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
