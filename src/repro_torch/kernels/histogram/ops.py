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
  (``ops.compute_histogram_pallas``, ``histogram_dispatch("cuda")``);
* ``sort_slots`` — the stable slot sort that every histogram launch runs
  first (``histogram.cu`` steps 1-3), on its own: each (tree, feature)'s
  rows listed slot by slot in row order.

All return the ``core.histogram`` providers' layout, (T, nodes, d, B, 2K+1)
or (nodes, d, B, 2K+1), which is the kernel's own: no padding, no copy.  A
tensor on the CPU takes the kernel's plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  Each of the three public entry
points counts its own launches in ``launches``, raised only where the
kernel is launched; the ``_child`` forms launch through their parents.
Every histogram launch runs the sort kernel first, so each also adds one
to ``sort_slots.launches``.  The wrappers allocate the scratch with
``torch.empty`` — the sort's counts, ``order`` (T, d, n) and ``starts``
(T, d, nodes * B + 1), int32, and the rows' stats packed for the walk;
the kernels allocate nothing.  Each of the three also reports one
``kernel.histogram`` span to the process tracer, at the launch counter's
boundary: the checks, the scratch and the launch (or the plain version).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.histogram import root_histogram_via_delta, stack_stats
from repro_torch.kernels import build
from repro_torch.kernels.histogram import ref
from repro_torch.obs import trace as trace_mod

SOURCE = Path(__file__).with_name("csrc") / "histogram.cu"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use (``build.py``)."""
    lib = build.load_library("histogram", [SOURCE])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.histogram_scratch_ints.argtypes = [i32] * 5
    lib.histogram_packed_floats.argtypes = [i32] * 3
    for fn in (lib.histogram_scratch_ints, lib.histogram_packed_floats):
        fn.restype = ctypes.c_longlong
    lib.histogram_sort.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.histogram_round.argtypes = [ptr] * 6 + [i32] * 7 + [ptr] * 5
    lib.histogram_staged.argtypes = [ptr] * 3 + [i32] * 5 + [ptr] * 5
    for fn in (lib.histogram_sort, lib.histogram_round, lib.histogram_staged):
        fn.restype = i32
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


def _sort_scratch(n: int, d: int, t: int, num_nodes: int, num_bins: int,
                  device: torch.device) -> tuple:
    """(counts, order, starts) of the sort: int32, uninitialised."""
    size = library().histogram_scratch_ints(n, d, t, num_nodes, num_bins)
    if size < 0:
        raise ValueError(f"histogram kernel: unsupported shape n={n} d={d} "
                         f"T={t} nodes={num_nodes} B={num_bins}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    return (empty(size), empty(t, d, n),
            empty(t, d, num_nodes * num_bins + 1))


def _hist_scratch(n: int, d: int, t: int, num_nodes: int, num_bins: int,
                  n_stats: int, device: torch.device) -> tuple:
    """One histogram launch's scratch: the sort's, then the rows' stats
    packed for the walk (float32)."""
    packed = torch.empty(library().histogram_packed_floats(n, t, n_stats),
                         dtype=torch.float32, device=device)
    return _sort_scratch(n, d, t, num_nodes, num_bins, device) + (packed,)


def _ptrs(tensors: tuple) -> list:
    return [a.data_ptr() for a in tensors]


def sort_slots(keys: torch.Tensor, assign: torch.Tensor | None,
               num_nodes: int, num_bins: int, child: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort kernel alone: keys (n, d) i32 — bins with ``assign`` (T, n)
    i32, or staged ids ``assign * B + binned`` when ``assign`` is None (T =
    1) -> (order (T, d, n) i32, starts (T, d, num_nodes * B + 1) i32).
    Slot s of (t, f) lists its rows in increasing row order at
    ``order[t, f, starts[t, f, s]:starts[t, f, s + 1]]``; dropped ids
    (outside ``[0, num_nodes * B)``) are left out and the tail past
    ``starts[t, f, -1]`` is -1.  Counts its launches."""
    if keys.dim() != 2 or (assign is not None and assign.dim() != 2):
        raise ValueError("sort_slots takes keys (n, d) and assign (T, n)")
    n, d = keys.shape
    t = 1 if assign is None else assign.shape[0]
    device = keys.device
    _check("keys", keys, torch.int32, (n, d), device)
    if assign is not None:
        _check("assign", assign, torch.int32, (t, n), device)
    if _device_kind(device, "sort_slots") == "cpu":
        return ref.sort_slots_ref(keys, assign, num_nodes, num_bins, child)
    counts, order, starts = _sort_scratch(n, d, t, num_nodes, num_bins,
                                          device)
    _launch("histogram_sort", order, keys.data_ptr(),
            None if assign is None else assign.data_ptr(), counts.data_ptr(),
            order.data_ptr(), starts.data_ptr(), n, d, t, num_nodes,
            num_bins, int(child), int(assign is None))
    sort_slots.launches += 1
    return order, starts


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
    scratch = _hist_scratch(n, d, t, num_nodes, num_bins, 2 * k + 1, device)
    _launch("histogram_round", out, binned.data_ptr(), assign.data_ptr(),
            g.data_ptr(), h.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, t,
            k, num_nodes, num_bins, int(child), *_ptrs(scratch))
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
    scratch = _hist_scratch(n, d, 1, num_nodes, num_bins, s, device)
    _launch("histogram_staged", out, ids.data_ptr(), data.data_ptr(),
            out.data_ptr(), n, d, s, num_nodes, num_bins, *_ptrs(scratch))
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
    with trace_mod.global_tracer().span("kernel.histogram", cat="kernel"):
        out, launched = histogram_round(
            _i32(binned), _i32(assign), _channels(g), _channels(h),
            _f32(weight), num_nodes, num_bins, child)
        _count(compute_round_histogram_cuda_fused, launched)
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
    with trace_mod.global_tracer().span("kernel.histogram", cat="kernel"):
        out, launched = histogram_round(
            _i32(binned), _i32(assign)[None], _channels(g), _channels(h),
            _f32(weight)[None], num_nodes, num_bins, child)
        _count(compute_histogram_cuda_fused, launched)
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
    with trace_mod.global_tracer().span("kernel.histogram", cat="kernel"):
        ids = _i32(assign)[:, None] * num_bins + _i32(binned)
        data = stack_stats(_f32(g), _f32(h), _f32(weight)).contiguous()
        out, launched = histogram_staged(ids.contiguous(), data, num_nodes,
                                         num_bins)
        _count(compute_histogram_cuda, launched)
    return out


def _count(wrapper, launched: bool) -> None:
    """One launch of ``wrapper``'s entry point: its walk and, before it,
    the sort kernel."""
    wrapper.launches += launched
    sort_slots.launches += launched


#: kernel name -> the wrapper that counts its launches.
KERNELS = {
    "histogram_round": compute_round_histogram_cuda_fused,
    "histogram_tree": compute_histogram_cuda_fused,
    "histogram_staged": compute_histogram_cuda,
    "histogram_sort": sort_slots,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def kernel_launches(kernel: str) -> int:
    return KERNELS[kernel].launches


reset_launches()
