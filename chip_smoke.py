#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of FedGBF serving on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only: no JAX, no module of the JAX
package.  Phases, each of which raises on failure (exit code 1):

1. Device and build: the card's name and power limit, and the kernels'
   ``nvcc`` build with what ``-Xptxas -v`` reports.
2. Kernel vs plain version on the card: both ensemble-traversal kernels
   against their plain PyTorch versions on seeded random ensembles (depth 3
   and 5, one more than a shared-memory chunk of trees at depth 5) at
   n in {257, 8192, 262144}, with NaN and ±inf rows; ``torch.equal`` is
   required.  Then each is timed with CUDA events at the serving shape
   (8192 x 23 requests, the reference model's 78 trees) beside its plain
   version and its bound.
3. Main path: the committed JAX-trained Dynamic FedGBF checkpoint is
   loaded onto the card and serves 1,048,576 requests through
   ``serve_stream`` (``impl="fused-cuda"``, batch 8192, one mid-stream
   hot reload), then 65,536 requests with ``impl="cuda"``.  Each wrapper's
   launch count must equal the batches it scored plus its warm-up, and the
   first 4,096 scores must match the committed JAX scores within 1e-5.
4. Profile: device time by kernel and copy over 16 batches of the
   fused-cuda stream, and the device's busy share of the wall clock.
5. The kernels line, then the card line, then the result line.

Exits non-zero, printing no result, when CUDA is not available or the port
is not beside this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "src" / "repro_torch" / "testdata" / "dynamic_fedgbf_r20"
GOLDEN = ROOT / "src" / "repro_torch" / "testdata" / \
    "dynamic_fedgbf_r20_scores.npz"
SOURCE = "src/repro_torch/kernels/ensemble_predict/csrc/ensemble_predict.cu"
REPLACES = {
    "ensemble_predict_raw": "src/repro/kernels/ensemble_predict/"
                            "ensemble_predict.py:123",
    "ensemble_predict_binned": "src/repro/kernels/ensemble_predict/"
                               "ensemble_predict.py:155",
}
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: serving impl -> (the kernel it launches, the wrapper that counts it)
IMPL_KERNEL = {
    "fused-cuda": ("ensemble_predict_raw", "predict_packed_fused_cuda"),
    "cuda": ("ensemble_predict_binned", "predict_packed_cuda"),
}
SCORE_ATOL = 1e-5          # last-ulp sigmoid differences; expected exact
STREAM = 1 << 20
STREAM_BINNED = 1 << 16
BATCH = 8192
RELOAD_AT_BATCH = 64


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def random_ensemble(rng, n_trees, depth, d, num_bins, device):
    """A valid packed-table ensemble: splits on bins [0, B-2], a fifth of
    the nodes unsplit (feature -1, threshold B), sorted edges."""
    import torch

    from repro_torch.core.types import float_thresholds

    n_internal = 2 ** depth - 1
    feature = rng.integers(0, d, (n_trees, n_internal)).astype(np.int32)
    threshold = rng.integers(0, num_bins - 1,
                             (n_trees, n_internal)).astype(np.int32)
    unsplit = rng.random((n_trees, n_internal)) < 0.2
    feature[unsplit] = -1
    threshold[unsplit] = num_bins
    edges = np.sort(rng.normal(size=(d, num_bins - 1)), axis=1)
    tables = {
        "feature": feature,
        "threshold": threshold,
        "leaf": rng.normal(size=(n_trees, 2 ** depth)),
        "scale": rng.uniform(0.01, 0.1, n_trees),
    }
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in tables.items()}
    t["leaf"] = t["leaf"].float()
    t["scale"] = t["scale"].float()
    t["thr_value"] = float_thresholds(
        t["feature"], t["threshold"],
        torch.from_numpy(edges.astype(np.float32)).to(device)).contiguous()
    return t


def hard_rows(rng, n, d, device):
    """Raw float rows with NaN and ±inf entries and whole non-finite rows."""
    import torch

    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.02] = np.nan
    x[rng.random((n, d)) < 0.01] = np.inf
    x[rng.random((n, d)) < 0.01] = -np.inf
    x[0, :] = np.nan
    x[1, :] = np.inf
    x[2, :] = -np.inf
    return torch.from_numpy(x).to(device)


def time_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls.

    A spin kernel (about 0.1 s) holds the stream while the host enqueues
    the calls, so the events time the device back to back and not the
    host's launch overhead, which is larger than the kernel at this size.
    A caller whose host work outlasts the spin is timed host-bound."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(x, tables, n_out, n_trees, depth) -> tuple[float, str]:
    """Least time for the work, ms: bytes moved once over the HBM rate vs
    per row and tree ``depth`` compares + one multiply + one add over the
    float32 rate."""
    nbytes = x.numel() * x.element_size() + 4 * n_out + sum(
        t.numel() * t.element_size() for t in tables)
    ops = n_out * n_trees * (depth + 2)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def smem_bytes(n_trees: int, depth: int) -> int:
    """Dynamic shared memory of one block, as the launch in
    ensemble_predict.cu sizes it: whole trees up to 48 KB."""
    per_tree = (2 ** depth - 1) * 8 + (2 ** depth + 1) * 4
    return min(n_trees, 48 * 1024 // per_tree) * per_tree


def phase_build() -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels.ensemble_predict import ops

    t0 = time.perf_counter()
    ops.library()
    report = build.reports["ensemble_predict"]
    print(f"build: ensemble_predict in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {report.seconds:.2f} s, {build.build_count} nvcc run) "
          f"-> {report.path.name}")
    for line in report.log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}")
    return {"build_s": report.seconds}


def phase_kernels(device) -> dict:
    """Both kernels against their plain versions; max |kernel - plain|."""
    import torch

    from repro_torch.kernels.ensemble_predict import ops, ref

    rng = np.random.default_rng(11)
    d, num_bins = 23, 32
    err = {"ensemble_predict_raw": 0.0, "ensemble_predict_binned": 0.0}
    for depth, n_trees in ((3, 78), (5, 300)):
        t = random_ensemble(rng, n_trees, depth, d, num_bins, device)
        for n in (257, 8192, 262144):
            x = hard_rows(rng, n, d, device)
            binned = torch.from_numpy(
                rng.integers(0, num_bins, (n, d)).astype(np.int32)).to(device)
            cases = (
                ("ensemble_predict_raw", x, t["thr_value"],
                 ref.predict_forest_raw_ref),
                ("ensemble_predict_binned", binned, t["threshold"],
                 ref.predict_forest_binned_ref),
            )
            for name, xin, thr, plain_fn in cases:
                got, launched = ops.sweep(name, xin, t["feature"], thr,
                                          t["leaf"], t["scale"], depth)
                want = plain_fn(xin, t["feature"], thr, t["leaf"],
                                t["scale"], depth)
                torch.cuda.synchronize()
                check(launched, f"{name} launched")
                diff = float((got - want).abs().max())
                err[name] = max(err[name], diff)
                check(torch.equal(got, want),
                      f"{name} == plain at depth {depth}, {n_trees} trees, "
                      f"n={n} (max |diff| {diff})")
                print(f"kernel == plain: {name:24s} depth {depth} "
                      f"trees {n_trees:3d} n {n:6d}: equal")
    return err


def phase_timing(packed, x) -> dict:
    """Kernel vs plain version at the serving shape, CUDA events."""
    from repro_torch.core.binning import bin_data
    from repro_torch.core.types import serving_tables
    from repro_torch.kernels.ensemble_predict import ops, ref

    feature, thr_value, leaf, scale = serving_tables(packed)
    binned = bin_data(x, packed.bin_edges)
    threshold = packed.threshold.contiguous()
    depth, n_trees = packed.max_depth, packed.total_trees
    runs = {
        "ensemble_predict_raw": (x, thr_value, ref.predict_forest_raw_ref),
        "ensemble_predict_binned": (binned, threshold,
                                    ref.predict_forest_binned_ref),
    }
    out = {}
    for name, (xin, thr, plain_fn) in runs.items():
        def kernel():
            return ops.sweep(name, xin, feature, thr, leaf, scale, depth)

        def plain():
            return plain_fn(xin, feature, thr, leaf, scale, depth)

        ms = time_ms(kernel, iters=200, warmup=20)
        plain_ms = time_ms(plain, iters=10, warmup=2)
        bound_ms, bound_by = bound(xin, (feature, thr, leaf, scale),
                                   xin.shape[0], n_trees, depth)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        print(f"time {name:24s} {xin.shape[0]}x{xin.shape[1]} "
              f"{n_trees} trees: kernel {ms:.5f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.6f} ms ({bound_by}), dynamic shared "
              f"memory {smem_bytes(n_trees, depth)} B/block")
    return out


def serve(packed, requests, impl, swap_plan):
    """One serving run as ``serve_fedgbf.main`` drives it; returns
    (scores, metrics, launches counted by this impl's kernel, expected)."""
    from repro_torch.kernels.ensemble_predict import ops
    from repro_torch.launch import serve_fedgbf as serve_mod

    kernel, _ = IMPL_KERNEL[impl]
    ladder = serve_mod.BatchLadder([BATCH])
    sm = serve_mod.StreamMetrics(BATCH)
    slot = serve_mod.ModelSlot(packed, impl, metrics=sm,
                               warm_sizes=ladder.sizes)
    ops.reset_launches()
    ladder.warm(slot.packed, packed.bin_edges.shape[0], impl)
    t0 = time.perf_counter()
    scores, sm = serve_mod.serve_stream(slot, requests, ladder=ladder,
                                        metrics=sm, swap_plan=swap_plan)
    sm.finalize(time.perf_counter() - t0)
    launches = ops.kernel_launches(kernel)
    # warm-up: one launch per rung, and per successful reload one probe
    # plus one per rung
    expected = (int(sm.batches.value) + len(ladder.sizes)
                + int(sm.reloads.value) * (1 + len(ladder.sizes)))
    return scores, sm, launches, expected


def phase_main_path(device, card) -> dict:
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.data import synthetic
    from repro_torch.kernels.ensemble_predict import ops

    packed = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)
    check(packed.total_trees == 78 and packed.max_depth == 3,
          "reference checkpoint is the 78-tree depth-3 model")
    golden = np.load(GOLDEN)
    ds = synthetic.load("default_credit_card")
    rng = np.random.default_rng(0)
    requests = np.asarray(ds.x_test)[
        rng.integers(0, ds.x_test.shape[0], STREAM)]
    n_gold = golden["proba_fused"].shape[0]

    launches = {}
    runs = (("fused-cuda", requests, {RELOAD_AT_BATCH: str(CHECKPOINT)}),
            ("cuda", requests[:STREAM_BINNED], None))
    for impl, reqs, swap_plan in runs:
        scores, sm, n_launch, expected = serve(packed, reqs, impl, swap_plan)
        kernel, wrapper = IMPL_KERNEL[impl]
        launches[kernel] = n_launch
        check(getattr(ops, wrapper).launches == n_launch,
              f"{wrapper} counted every {kernel} launch")
        check(n_launch == expected,
              f"{impl}: {n_launch} launches == {expected} (batches + warm-up)")
        check(n_launch > 0, f"{kernel} served the stream")
        check(scores.shape == (reqs.shape[0],), f"{impl} score shape")
        check(bool(np.isfinite(scores).all()), f"{impl} scores finite")
        diff = float(np.abs(scores[:n_gold] - golden["proba_fused"]).max())
        check(diff <= SCORE_ATOL,
              f"{impl}: first {n_gold} scores within {SCORE_ATOL} of the "
              f"JAX scores (max |diff| {diff})")
        if swap_plan:
            check(int(sm.reloads.value) == 1, "mid-stream reload swapped in")
        q = sm.quantiles_ms()
        print(f"serve impl={impl} on {card}: {reqs.shape[0]} requests, "
              f"{int(sm.batches.value)} batches of {BATCH}, "
              f"{sm.rows_per_s.value:,.0f} rows/s, batch latency "
              f"p50={q[0.5]:.4f} ms p90={q[0.9]:.4f} ms "
              f"p99={q[0.99]:.4f} ms, {n_launch} launches, "
              f"max |score - JAX| {diff:.3g}")
    return {"packed": packed, "launches": launches, "requests": requests,
            "x": requests[:BATCH]}


def phase_profile(packed, requests) -> None:
    """Where a batch's time goes: ``torch.profiler`` over 16 batches of the
    fused-cuda stream; device time by kernel and copy, and the device's
    busy share of the wall clock (the profiler's own host cost included,
    so the share is a lower bound).  Prints "not measured" if the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve_fedgbf as serve_mod

    ladder = serve_mod.BatchLadder([BATCH])
    slot = serve_mod.ModelSlot(packed, "fused-cuda")
    ladder.warm(slot.packed, packed.bin_edges.shape[0], "fused-cuda")
    reqs = requests[:16 * BATCH]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_mod.serve_stream(slot, reqs, ladder=ladder)
        wall_us = (time.perf_counter() - t0) * 1e6
    device = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's self device
        # time is its kernels' time again
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            device[e.key] = device.get(e.key, 0.0) + us
    if not device:
        print("profile: device time not measured (no CUDA activity seen)")
        return
    total = sum(device.values())
    print(f"profile: 16 batches of {BATCH}, wall {wall_us / 16:.1f} us/batch,"
          f" device busy {total / 16:.1f} us/batch "
          f"({100 * total / wall_us:.1f}% of wall, profiler on)")
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / 16:9.2f} us/batch  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails when the port is not here)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    phase_build()
    err = phase_kernels(device)
    main_path = phase_main_path(device, card)
    timing = phase_timing(main_path["packed"],
                          torch.from_numpy(main_path["x"]).to(device))
    phase_profile(main_path["packed"], main_path["requests"])
    kernels = []
    for name in ("ensemble_predict_raw", "ensemble_predict_binned"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": main_path["launches"][name],
            "max_abs_err": err[name],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": f"{BATCH}x23, 78 trees, depth 3",
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
