"""Wrappers of the histogram kernel: the counterparts of
``repro/kernels/histogram/ops.py``.

* ``compute_round_histogram_cuda_fused[_child]`` — a whole round's T trees
  in one launch, ids and stats formed in the kernel
  (``ops.compute_round_histogram_pallas_fused[_child]``); the
  ``local-cuda`` backend's round providers;
* ``compute_histogram_cuda_fused[_child]`` — the single-tree form, the T = 1
  entry point of the same kernel (``ops.compute_histogram_pallas_fused``);
  the backend's per-tree providers and the shared-root delta accumulator;
* ``compute_histogram_cuda`` — the staged entry point: ``ids = assign * B +
  binned`` and ``[g*w, h*w, w]`` staged before the launch
  (``ops.compute_histogram_pallas``, ``histogram_dispatch("cuda")``).

All return the ``core.histogram`` providers' layout, (T, nodes, d, B, 2K+1)
or (nodes, d, B, 2K+1), which is the kernel's own: no padding, no copy.  A
tensor on the CPU takes the kernel's plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  Each of the three public entry
points counts its own launches in ``launches``, raised only where the
kernel is launched; the ``_child`` forms launch through their parents.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.histogram import root_histogram_via_delta, stack_stats
from repro_torch.kernels import build
from repro_torch.kernels.histogram import ref

SOURCE = Path(__file__).with_name("csrc") / "histogram.cu"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use (``build.py``)."""
    lib = build.load_library("histogram", [SOURCE])
    lib.histogram_round.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.histogram_staged.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.histogram_round.restype = ctypes.c_int
    lib.histogram_staged.restype = ctypes.c_int
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


def _device_kind(device: torch.device, kernel: str) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA tensors (or the plain "
                         f"version on CPU ones), got {device}")
    return device.type


def _launch(kernel: str, out: torch.Tensor, *args) -> None:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(library(), kernel)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def histogram_round(binned: torch.Tensor, assign: torch.Tensor,
                    g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    num_nodes: int, num_bins: int,
                    child: bool) -> tuple[torch.Tensor, bool]:
    """One call of the round entry point: binned (n, d) i32, assign / w
    (T, n) i32 / f32, g / h (n, K) f32 -> ((T, num_nodes, d, B, 2K+1) f32,
    whether the kernel was launched).  Counts nothing."""
    if binned.dim() != 2 or assign.dim() != 2 or g.dim() != 2:
        raise ValueError("histogram_round takes binned (n, d), assign (T, n) "
                         "and g (n, K)")
    n, d = binned.shape
    t, k = assign.shape[0], g.shape[1]
    device = binned.device
    _check("binned", binned, torch.int32, (n, d), device)
    _check("assign", assign, torch.int32, (t, n), device)
    _check("g", g, torch.float32, (n, k), device)
    _check("h", h, torch.float32, (n, k), device)
    _check("w", w, torch.float32, (t, n), device)
    if _device_kind(device, "histogram_round") == "cpu":
        return ref.histogram_round_ref(binned, assign, g, h, w, num_nodes,
                                       num_bins, child), False
    out = torch.empty((t, num_nodes, d, num_bins, 2 * k + 1),
                      dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out, False
    _launch("histogram_round", out, binned.data_ptr(), assign.data_ptr(),
            g.data_ptr(), h.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, t,
            k, num_nodes, num_bins, int(child))
    return out, True


def histogram_staged(ids: torch.Tensor, data: torch.Tensor, num_nodes: int,
                     num_bins: int) -> tuple[torch.Tensor, bool]:
    """One call of the staged entry point: ids (n, d) i32, data (n, S) f32
    -> ((num_nodes, d, B, S) f32, whether the kernel was launched)."""
    if ids.dim() != 2 or data.dim() != 2:
        raise ValueError("histogram_staged takes ids (n, d) and data (n, S)")
    n, d = ids.shape
    s = data.shape[1]
    device = ids.device
    _check("ids", ids, torch.int32, (n, d), device)
    _check("data", data, torch.float32, (n, s), device)
    if _device_kind(device, "histogram_staged") == "cpu":
        return ref.histogram_staged_ref(ids, data, num_nodes, num_bins), False
    out = torch.empty((num_nodes, d, num_bins, s), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out, False
    _launch("histogram_staged", out, ids.data_ptr(), data.data_ptr(),
            out.data_ptr(), n, d, s, num_nodes, num_bins)
    return out, True


def _channels(v: torch.Tensor) -> torch.Tensor:
    """(n,) -> (n, 1); (n, K) as it is; float32 and contiguous."""
    v = v.to(torch.float32)
    return (v[:, None] if v.dim() == 1 else v).contiguous()


def _i32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int32).contiguous()


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32).contiguous()


def compute_round_histogram_cuda_fused(binned, g, h, weight, assign,
                                       num_nodes: int, num_bins: int, *,
                                       child: bool = False,
                                       root_delta_rows: int = 0,
                                       level: int = 0) -> torch.Tensor:
    """``core.histogram.compute_round_histogram`` contract, one launch for
    the whole round: weight / assign (T, n) -> (T, num_nodes, d, B, 2K+1).
    ``child=True`` is the subtraction pipeline's round child provider
    (``assign`` the current level's, ``num_nodes`` the parent count);
    ``root_delta_rows > 0`` derives the roots as shared − delta with the
    single-tree entry point as the accumulator."""
    if root_delta_rows:
        return root_histogram_via_delta(
            binned, g, h, weight, num_bins, root_delta_rows,
            base_tree_fn=compute_histogram_cuda_fused)
    out, launched = histogram_round(
        _i32(binned), _i32(assign), _channels(g), _channels(h), _f32(weight),
        num_nodes, num_bins, child)
    compute_round_histogram_cuda_fused.launches += launched
    return out


def compute_round_histogram_cuda_fused_child(binned, g, h, weight, assign,
                                             num_parents: int, num_bins: int,
                                             **kw) -> torch.Tensor:
    """Round child provider: the whole round's left-child histograms at
    parent width in one launch."""
    return compute_round_histogram_cuda_fused(
        binned, g, h, weight, assign, num_parents, num_bins, child=True, **kw)


def compute_histogram_cuda_fused(binned, g, h, weight, assign,
                                 num_nodes: int, num_bins: int, *,
                                 child: bool = False) -> torch.Tensor:
    """``core.histogram.compute_histogram`` contract through the T = 1
    entry point: weight / assign (n,) -> (num_nodes, d, B, 2K+1)."""
    out, launched = histogram_round(
        _i32(binned), _i32(assign)[None], _channels(g), _channels(h),
        _f32(weight)[None], num_nodes, num_bins, child)
    compute_histogram_cuda_fused.launches += launched
    return out[0]


def compute_histogram_cuda_fused_child(binned, g, h, weight, assign,
                                       num_parents: int, num_bins: int
                                       ) -> torch.Tensor:
    """Per-tree child provider: left-child histograms at parent width."""
    return compute_histogram_cuda_fused(binned, g, h, weight, assign,
                                        num_parents, num_bins, child=True)


def compute_histogram_cuda(binned, g, h, weight, assign, num_nodes: int,
                           num_bins: int) -> torch.Tensor:
    """``core.histogram.compute_histogram`` contract through the staged
    entry point: ids and stats staged in PyTorch, then one launch."""
    ids = _i32(assign)[:, None] * num_bins + _i32(binned)
    data = stack_stats(_f32(g), _f32(h), _f32(weight)).contiguous()
    out, launched = histogram_staged(ids.contiguous(), data, num_nodes,
                                     num_bins)
    compute_histogram_cuda.launches += launched
    return out


#: entry-point name -> the wrapper that counts its launches.
KERNELS = {
    "histogram_round": compute_round_histogram_cuda_fused,
    "histogram_tree": compute_histogram_cuda_fused,
    "histogram_staged": compute_histogram_cuda,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def kernel_launches(kernel: str) -> int:
    return KERNELS[kernel].launches


reset_launches()
