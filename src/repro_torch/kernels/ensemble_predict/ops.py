"""Wrappers of the ensemble-traversal kernels: the counterparts of
``repro/kernels/ensemble_predict/ops.py``.

* ``predict_forest_cuda``       — bagging mean of one stacked forest
  (``ops.predict_forest_pallas``, :50), binned kernel at scale 1/T;
* ``predict_packed_cuda``       — whole packed ensemble on bins
  (``ops.predict_packed_pallas``, :69), binned kernel;
* ``predict_packed_fused_cuda`` — whole packed ensemble on raw floats
  (``ops.predict_packed_fused_pallas``, :118), raw kernel.

A tensor on the CPU takes the kernel's plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  Each wrapper counts its own launches
in a plain integer attribute, ``launches``, raised only where the kernel is
launched.  The kernel adds no ``base_score``: the packed wrappers add it
after the sweep, as the Pallas wrappers do.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.types import PackedEnsemble, TreeArrays, serving_tables
from repro_torch.kernels import build
from repro_torch.kernels.ensemble_predict import ref

SOURCE = Path(__file__).with_name("csrc") / "ensemble_predict.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (``build.py``)."""
    lib = build.load_library("ensemble_predict", [SOURCE])
    for fn in (lib.ensemble_predict_raw, lib.ensemble_predict_binned):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def sweep(kernel: str, x: torch.Tensor, feature: torch.Tensor,
          threshold: torch.Tensor, leaf: torch.Tensor, scale: torch.Tensor,
          max_depth: int) -> tuple[torch.Tensor, bool]:
    """One kernel call: ``sum_t leaf_t[idx] * scale_t`` per row, (n,) f32,
    and whether the kernel was launched.  ``kernel`` is
    ``"ensemble_predict_raw"`` or ``"ensemble_predict_binned"``.  Counts
    nothing: the wrappers below count their own launches."""
    raw = kernel == "ensemble_predict_raw"
    if x.dim() != 2:
        raise ValueError(f"x: expected (n, d), got shape {tuple(x.shape)}")
    if leaf.dim() != 2:
        raise ValueError(
            "the ensemble_predict kernels serve 2-D (trees, leaves) tables; "
            "K-channel ensembles must use impl='fused'")
    n, d = x.shape
    n_trees = feature.shape[0]
    n_internal, n_leaves = 2 ** max_depth - 1, 2 ** max_depth
    device = x.device
    _check("x", x, torch.float32 if raw else torch.int32, (n, d), device)
    _check("feature", feature, torch.int32, (n_trees, n_internal), device)
    _check("threshold", threshold, torch.float32 if raw else torch.int32,
           (n_trees, n_internal), device)
    _check("leaf", leaf, torch.float32, (n_trees, n_leaves), device)
    _check("scale", scale, torch.float32, (n_trees,), device)
    if device.type == "cpu":
        plain = (ref.predict_forest_raw_ref if raw
                 else ref.predict_forest_binned_ref)
        return plain(x, feature, threshold, leaf, scale, max_depth), False
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors (or the plain "
                         f"version on CPU ones), got {device}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0 or n_trees == 0:
        return out.zero_(), False
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), kernel)(
            x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            leaf.data_ptr(), scale.data_ptr(), out.data_ptr(),
            n, d, n_trees, max_depth, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    return out, True


def predict_forest_cuda(trees: TreeArrays, binned: torch.Tensor,
                        max_depth: int) -> torch.Tensor:
    """Bagging-mean forest prediction on bins, (n,) float32."""
    n_trees = trees.feature.shape[0]
    scale = torch.full((n_trees,), 1.0 / n_trees, dtype=torch.float32,
                       device=binned.device)
    out, launched = sweep(
        "ensemble_predict_binned", binned,
        trees.feature.to(torch.int32).contiguous(),
        trees.threshold.to(torch.int32).contiguous(),
        trees.leaf_weight.to(torch.float32).contiguous(), scale, max_depth)
    predict_forest_cuda.launches += launched
    return out


def predict_packed_cuda(packed: PackedEnsemble, binned: torch.Tensor
                        ) -> torch.Tensor:
    """Whole-ensemble raw margin on bins in one launch, (n,) float32:
    ``base_score + sum_t tree_scale[t] * leaf_t``."""
    margin, launched = sweep(
        "ensemble_predict_binned", binned,
        packed.feature.to(torch.int32).contiguous(),
        packed.threshold.to(torch.int32).contiguous(),
        packed.leaf_weight.to(torch.float32).contiguous(),
        packed.tree_scale.to(torch.float32).contiguous(), packed.max_depth)
    predict_packed_cuda.launches += launched
    return packed.base_score + margin


def predict_packed_fused_cuda(model: PackedEnsemble, x: torch.Tensor
                              ) -> torch.Tensor:
    """Fused bin + traverse + combine on RAW floats in one launch, (n,)
    float32: no binning pass, value-space thresholds
    (``types.serving_tables``), NaN/±inf rows sanitised in the kernel."""
    feature, thr_value, leaf, scale = serving_tables(model)
    margin, launched = sweep("ensemble_predict_raw", x, feature, thr_value,
                             leaf, scale, model.max_depth)
    predict_packed_fused_cuda.launches += launched
    return model.base_score + margin


#: kernel name -> the wrappers that launch it.
KERNELS = {
    "ensemble_predict_raw": (predict_packed_fused_cuda,),
    "ensemble_predict_binned": (predict_forest_cuda, predict_packed_cuda),
}


def reset_launches() -> None:
    for wrappers in KERNELS.values():
        for fn in wrappers:
            fn.launches = 0


def kernel_launches(kernel: str) -> int:
    return sum(fn.launches for fn in KERNELS[kernel])


reset_launches()
