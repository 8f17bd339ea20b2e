"""Carry state across from the JAX package: numpy arrays in, tensors out.

* ``packed_from_numpy``: a model.  The JAX package's ``PackedEnsemble``
  gives its fields as numpy arrays (``np.asarray`` of each) and its static
  metadata as plain values; the checkpoint loader and the tests that feed
  one model to both packages go through it.
* ``masks_from_numpy``: explicit sampling masks of a training run, (S, n)
  sample and (S, d) feature masks, one row per scheduled tree build in
  build order (``train_fedgbf(masks=...)``, an override of the draw from
  the run key).
* ``goss_draws_from_numpy``: GOSS's draws, the (S, n) uniforms and (S, d)
  feature masks the JAX package draws from each build's key.
* ``quantized_from_numpy``: a ``QuantizedEnsemble``, as the checkpoint
  loader reads one.
* ``lm_params_from_numpy`` / ``lm_params_to_numpy``: a language model's
  weights as the JAX package's nested parameter dict: each pattern
  position's (and the encoder's) leaves stacked over the units on a leading
  axis, every weight in the ``(in, out)`` layout.  ``lm_param_shapes``
  gives that tree's shapes and dtypes, ``lm_leaves`` its leaves in the JAX
  leaf order (dict keys sorted, lists in order: the checkpoint files'
  order), and ``lm_numpy_params`` a seeded numpy draw of it that both
  packages can load.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import GossDraws, StepMasks
from repro_torch.core.types import (
    PACKED_ARRAYS,
    PACKED_META,
    QUANTIZED_ARRAYS,
    QUANTIZED_META,
    PackedEnsemble,
    QuantizedEnsemble,
)
from repro_torch.device import resolve
from repro_torch.models.model import LMModel, init_rule


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


def goss_draws_from_numpy(uniform: np.ndarray, feature: np.ndarray,
                          device=None) -> GossDraws:
    """``GossDraws`` on ``device`` (default ``cuda``) from (S, n) float32
    uniforms and (S, d) feature masks."""
    dev = resolve(device)
    return GossDraws(
        torch.tensor(np.asarray(uniform, np.float32), device=dev),
        torch.tensor(np.asarray(feature, bool), device=dev))


def quantized_from_numpy(arrays: dict[str, np.ndarray], meta: dict,
                         device=None) -> QuantizedEnsemble:
    """A ``QuantizedEnsemble`` on ``device`` (default ``cuda``) from the
    arrays named in ``types.QUANTIZED_ARRAYS`` and the metadata named in
    ``types.QUANTIZED_META``."""
    dev = resolve(device)
    tensors = {f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(dev)
               for f in QUANTIZED_ARRAYS}
    return QuantizedEnsemble(
        **tensors,
        bits=int(meta["bits"]),
        round_offsets=tuple(int(o) for o in meta["round_offsets"]),
        learning_rate=float(meta["learning_rate"]),
        base_score=float(meta["base_score"]),
        loss=str(meta["loss"]),
        max_depth=int(meta["max_depth"]),
    )


def quantized_to_numpy(q: QuantizedEnsemble) -> tuple[dict, dict]:
    """Inverse of ``quantized_from_numpy``: (arrays, metadata)."""
    arrays = {f: getattr(q, f).detach().cpu().numpy()
              for f in QUANTIZED_ARRAYS}
    meta = {f: getattr(q, f) for f in QUANTIZED_META}
    meta["round_offsets"] = list(meta["round_offsets"])
    return arrays, meta


# ---------------------------------------------------------------------------
# Language-model weights in the JAX package's parameter tree
# ---------------------------------------------------------------------------
#: the std of the noise ``lm_numpy_params`` adds to the leaves that the JAX
#: init sets to constants (norm scales, ``mu``, ``w0``, ``A_log``, ...), so
#: that a test feeding them to both packages exercises every leaf
LM_CONST_JITTER = 0.1


def _stacked(path: tuple) -> bool:
    return path[0] == "units" or path[:2] == ("encoder", "layers")


def _flatten(tree, prefix: tuple = ()):
    """(path, leaf) pairs of a nested JAX tree in the JAX leaf order: dict
    keys sorted, lists in order; anything else (tuples too) is a leaf."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, prefix + (key,))


def _nest(pairs) -> dict:
    """The nested tree of (path, leaf) pairs; int keys make lists."""
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[k] for k in sorted(out)]
        return out

    return listify(root)


def _jax_pairs(model: LMModel):
    """(path, leaf tensor) in the JAX leaf order, stacked over the units."""
    for path, params in model.jax_leaves():
        leaf = torch.stack([p.detach() for p in params]) if _stacked(path) \
            else params[0].detach()
        yield path, leaf


def lm_leaves(model: LMModel) -> list[torch.Tensor]:
    """The model's leaves in the JAX leaf order, each stacked as in the JAX
    tree (what ``save_pytree`` of the JAX params writes)."""
    return [leaf for _, leaf in _jax_pairs(model)]


def lm_params_to_numpy(model: LMModel) -> dict:
    """The JAX nested parameter dict of ``model`` as numpy arrays (bfloat16
    leaves upcast to float32, which is exact)."""
    def to_np(t):
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _nest((path, to_np(leaf)) for path, leaf in _jax_pairs(model))


def lm_param_shapes(cfg) -> dict:
    """The JAX parameter tree of ``cfg`` with ``(shape, dtype name)``
    leaves, from the port's modules on the ``meta`` device (no
    allocation)."""
    model = LMModel(cfg, device="meta")
    return _nest((path, (tuple(leaf.shape), str(leaf.dtype).split(".")[-1]))
                 for path, leaf in _jax_pairs(model))


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, as JAX gives
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_numpy(cfg, tree: dict, device=None) -> LMModel:
    """An ``LMModel`` of ``cfg`` on ``device`` (default ``cuda``) holding
    the JAX nested parameter dict ``tree`` (numpy arrays or tensors; the
    stacked unit axis split over the per-unit modules, each leaf cast to
    its parameter's dtype)."""
    dev = resolve(device)
    model = LMModel(cfg, device="meta").to_empty(device=dev)
    load_lm_tree(model, tree)
    return model


def load_lm_tree(model: LMModel, tree: dict) -> None:
    """Copy the JAX nested parameter dict ``tree`` into ``model``'s
    parameters through ``jax_leaves`` (the one mapping)."""
    flat = dict(_flatten(tree))
    with torch.no_grad():
        for path, params in model.jax_leaves():
            if path not in flat:
                raise ValueError(f"parameter tree lacks {'/'.join(map(str, path))}")
            leaf = _as_tensor(flat.pop(path))
            parts = list(leaf) if _stacked(path) else [leaf]
            for p, part in zip(params, parts, strict=True):
                if tuple(part.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{'/'.join(map(str, path))}: shape "
                        f"{tuple(part.shape)} != {tuple(p.shape)}")
                p.copy_(part)
    if flat:
        raise ValueError(f"unexpected parameter leaves: {sorted(flat)}")


def lm_params_from_leaves(cfg, leaves: list, device=None) -> LMModel:
    """``lm_params_from_numpy`` of a flat list of leaves in the JAX leaf
    order (what ``save_pytree`` of the JAX params wrote)."""
    paths = [path for path, _ in _flatten(lm_param_shapes(cfg))]
    if len(leaves) != len(paths):
        raise ValueError(f"{cfg.name}: expected {len(paths)} parameter "
                         f"leaves, found {len(leaves)}")
    return lm_params_from_numpy(cfg, _nest(zip(paths, leaves)), device)


def lm_numpy_params(cfg, seed: int = 0) -> dict:
    """A seeded numpy draw of ``cfg``'s JAX parameter tree (float32 leaves,
    drawn in the JAX leaf order): each leaf ``base + std * N(0, 1)`` by
    ``models.model.init_rule``, the JAX init's constants with
    ``LM_CONST_JITTER`` noise."""
    rng = np.random.default_rng(seed)
    pairs = []
    for path, (shape, _) in _flatten(lm_param_shapes(cfg)):
        unit_shape = shape[1:] if _stacked(path) else shape
        base, std = init_rule(path[-1], unit_shape, cfg)
        noise = rng.standard_normal(shape) * (std or LM_CONST_JITTER)
        pairs.append((path, (np.asarray(base) + noise).astype(np.float32)))
    return _nest(pairs)
