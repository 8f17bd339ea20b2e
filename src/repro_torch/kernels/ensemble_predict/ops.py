"""Wrappers of the ensemble-traversal kernels: the counterparts of
``repro/kernels/ensemble_predict/ops.py``.

* ``predict_forest_cuda``       — bagging mean of one stacked forest
  (``ops.predict_forest_pallas``, :50), binned kernel at scale 1/T;
* ``predict_packed_cuda``       — whole packed ensemble on bins
  (``ops.predict_packed_pallas``, :69), binned kernel;
* ``predict_packed_fused_cuda`` — whole packed ensemble on raw floats
  (``ops.predict_packed_fused_pallas``, :118), raw kernel.

A tensor on the CPU takes the kernel's plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  ``launch_config`` chooses the
kernel's sizes (rows per tile, threads per row, trees per chunk, shared
memory, grid); the C side checks them.  Each wrapper counts its own launches
in a plain integer attribute, ``launches``, raised only where the kernel is
launched.  The kernel adds no ``base_score``: the packed wrappers add it
after the sweep, as the Pallas wrappers do.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from repro_torch.core.types import PackedEnsemble, TreeArrays, serving_tables
from repro_torch.kernels import build
from repro_torch.kernels.ensemble_predict import ref

SOURCE = Path(__file__).with_name("csrc") / "ensemble_predict.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

THREADS = 256                  # per block
SMEM_DEFAULT = 48 * 1024       # a block's shared memory without opting in
SMEM_MAX = 232448              # the most a block may opt into (227 KB)
SMEM_PER_SM = 233472           # 228 KB an SM, 1 KB of it reserved per block
X_TILE_MAX = SMEM_DEFAULT // 2  # larger row tiles read x from global memory
MAX_LANES = 8                  # threads per row
UNROLLED_DEPTH = 3             # the depth with an instance of its own


class LaunchConfig(NamedTuple):
    """The traversal kernels' sizes: ``rows`` per tile and ``lanes``
    (threads) per row, ``rows * lanes == THREADS``; ``chunk`` trees staged
    at a time; the x tile's row ``stride`` (odd) and whether x is staged at
    all (``stage_x``); whether the depth-``UNROLLED_DEPTH`` instance runs
    (``unrolled``) or the runtime-depth one; the block's dynamic shared
    memory ``smem_bytes``; and ``grid``, the blocks, which loop over the
    tiles."""

    rows: int
    lanes: int
    chunk: int
    stride: int
    stage_x: bool
    unrolled: bool
    smem_bytes: int
    grid: int


def smem_residency(cfg: LaunchConfig) -> int:
    """Blocks an SM holds by threads and shared memory alone: an upper
    bound of the occupancy calculator's answer, which also counts
    registers (``blocks_per_sm``)."""
    return min(2048 // THREADS, SMEM_PER_SM // (cfg.smem_bytes + 1024))


def launch_config(n: int, d: int, n_trees: int, max_depth: int,
                  sm_count: int,
                  residency: Callable[[LaunchConfig], int] = smem_residency,
                  lanes: int | None = None,
                  unrolled: bool | None = None) -> LaunchConfig:
    """The kernel's sizes for ``n`` rows of ``d`` features and ``n_trees``
    trees of depth ``max_depth`` on a card of ``sm_count`` SMs, each of
    which holds ``residency(cfg)`` blocks of the instance and shared
    memory ``cfg`` names.

    One thread a row (``lanes`` 1, 256-row tiles, the FMA chain run as the
    trees are walked) where the 256-row tiles give every SM two; below
    that, the most lanes (up to 8) that the trees of one chunk keep busy,
    each tree's leaf value buffered per row for the chain.  ``lanes``, if
    given, is taken instead of that rule (as far as the chunk keeps them
    busy).  The x tile is staged where it fits ``X_TILE_MAX``; a chunk
    holds as many whole trees as fit 48 KB beside it (their packed node
    pairs, leaves, scale and, with lanes > 1, one leaf value per row), at
    least one (depth 12 opts in above 48 KB).  Depth ``UNROLLED_DEPTH``
    takes its own instance unless ``unrolled`` is False.  The grid is the
    tiles, at most the blocks the SMs hold."""
    n_internal, n_leaves = 2 ** max_depth - 1, 2 ** max_depth
    stride = d | 1
    if lanes is None:
        lanes = 1 if -(-n // THREADS) >= 2 * sm_count else MAX_LANES
    while True:
        rows = THREADS // lanes
        tile_bytes = rows * stride * 4
        stage_x = tile_bytes <= X_TILE_MAX
        fixed = tile_bytes if stage_x else 0
        per_tree = 8 * n_internal + 4 * (n_leaves + 1
                                         + (rows if lanes > 1 else 0))
        chunk = max(1, min(n_trees, (SMEM_DEFAULT - fixed) // per_tree))
        if lanes <= chunk or lanes == 1:
            break
        lanes //= 2
    if unrolled is None:
        unrolled = max_depth == UNROLLED_DEPTH
    cfg = LaunchConfig(rows, lanes, chunk, stride, stage_x, unrolled,
                       fixed + chunk * per_tree, 0)
    per_sm = max(1, residency(cfg))
    return cfg._replace(grid=max(1, min(-(-n // rows), sm_count * per_sm)))


@functools.cache
def sm_count_of(index: int) -> int:
    """The SMs of CUDA device ``index`` (``launch_config``'s card size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def blocks_per_sm(kernel: str, index: int, unrolled: bool, stage_x: bool,
                  smem_bytes: int) -> int:
    """Blocks of ``kernel``'s instance (depth ``UNROLLED_DEPTH`` or
    runtime depth, x staged or not, ``smem_bytes`` of dynamic shared
    memory) that one SM of CUDA device ``index`` holds, registers counted:
    the CUDA occupancy calculator."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = library().ensemble_predict_occupancy(
            int(kernel == "ensemble_predict_raw"), int(unrolled),
            int(stage_x), smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{kernel}: occupancy query failed with CUDA "
                           f"error {err}")
    return blocks.value


def config_for(kernel: str, x: torch.Tensor, n_trees: int, max_depth: int,
               lanes: int | None = None,
               unrolled: bool | None = None) -> LaunchConfig:
    """``launch_config`` for ``kernel`` on the CUDA tensor ``x`` (n, d),
    the grid sized by the occupancy calculator on ``x``'s device."""
    index = x.device.index

    def residency(cfg: LaunchConfig) -> int:
        return blocks_per_sm(kernel, index, cfg.unrolled, cfg.stage_x,
                             cfg.smem_bytes)

    return launch_config(x.shape[0], x.shape[1], n_trees, max_depth,
                         sm_count_of(index), residency, lanes, unrolled)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (``build.py``)."""
    lib = build.load_library("ensemble_predict", [SOURCE])
    for fn in (lib.ensemble_predict_raw, lib.ensemble_predict_binned):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.ensemble_predict_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.ensemble_predict_occupancy.restype = ctypes.c_int
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
          max_depth: int, cfg: LaunchConfig | None = None
          ) -> tuple[torch.Tensor, bool]:
    """One kernel call: ``sum_t leaf_t[idx] * scale_t`` per row, (n,) f32,
    and whether the kernel was launched.  ``kernel`` is
    ``"ensemble_predict_raw"`` or ``"ensemble_predict_binned"``; ``cfg``,
    the sizes to launch with, defaults to ``config_for``'s.  Counts
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
    if cfg is None:
        cfg = config_for(kernel, x, n_trees, max_depth)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), kernel)(
            x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            leaf.data_ptr(), scale.data_ptr(), out.data_ptr(),
            n, d, n_trees, max_depth, cfg.rows, cfg.lanes, cfg.chunk,
            cfg.stride, int(cfg.stage_x), int(cfg.unrolled), cfg.smem_bytes,
            cfg.grid, stream)
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
