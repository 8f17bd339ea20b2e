#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of FedGBF on one NVIDIA card:
training through the histogram kernel, then serving through the
ensemble-traversal kernels.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only: no JAX, no module of the JAX
package.  Phases, each of which raises on failure (exit code 1):

1. Device and build: the card's name and power limit, and both kernel
   libraries' ``nvcc`` builds, started together, with what ``-Xptxas -v``
   reports.
2. Kernels vs plain versions on the card:
   a. both ensemble-traversal kernels against their plain PyTorch versions
      (depth 3 and 5, n in {257, 8192, 262144}, NaN and ±inf rows),
      ``torch.equal`` required;
   b. the histogram kernel's three entry points (round, single tree,
      staged) against their plain versions at rtol = atol = 1e-5, direct
      and child forms, T in {1, 5}, K in {1, 3}, n in {1, 1000, 21000,
      1048576}, the reference shape (d = 23, B = 32, depth 3), a shape of
      several slot chunks (depth 6, B = 256) and a bin column holding
      out-of-range ids; two launches must be ``torch.equal``, and up to
      n = 21000 the kernel must equal the plain version run on the CPU.
3. Serving main path: the committed JAX-trained Dynamic FedGBF checkpoint
   serves 1,048,576 requests through ``serve_stream`` (``impl="fused-
   cuda"``, batch 8192, one mid-stream hot reload), then 65,536 with
   ``impl="cuda"``; launch counts equal batches plus warm-up, and the first
   4,096 scores match the committed JAX scores within 1e-5.
4. Training main path: ``train_fedgbf(dynamic_fedgbf_config(rounds=20),
   backend="local-cuda")`` on ``default_credit_card`` (21,000 x 23) with
   the committed JAX-drawn masks: exactly 60 histogram launches, bin edges
   and the 78 trees' features and thresholds equal to the committed
   checkpoint, leaves within 1e-5, per-round train metrics within 1e-5 of
   the JAX history.  A second, per-level timed run must give the same
   trees and margins.  The model is saved, loaded and serves 65,536
   requests through ``fused-cuda``; its first 4,096 margins must match the
   committed JAX margins within 1e-5.
5. The other two entry points' paths: round 1 rebuilt with per-tree
   providers (the single-tree entry point) and with the staged provider
   (``histogram_dispatch("cuda")``); both must build the ``local-cuda``
   round's trees.
6. The launchers: ``python -m repro_torch.launch.train_fedgbf --rounds 3
   --backend local-cuda`` writes a checkpoint that ``serve_fedgbf
   --checkpoint`` serves.
7. Timing at the main path's shapes (CUDA events) beside the plain
   versions, the bounds and, for the histogram, one ``index_add_``; then a
   profile of the serving stream.
8. The kernels line, then the card line, then the result line.

Exits non-zero, printing no result, when CUDA is not available or the port
is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "src" / "repro_torch" / "testdata" / "dynamic_fedgbf_r20"
GOLDEN = ROOT / "src" / "repro_torch" / "testdata" / \
    "dynamic_fedgbf_r20_scores.npz"
TRAIN_ORACLE = ROOT / "src" / "repro_torch" / "testdata" / \
    "dynamic_fedgbf_r20_train.npz"
SOURCE = "src/repro_torch/kernels/ensemble_predict/csrc/ensemble_predict.cu"
HIST_SOURCE = "src/repro_torch/kernels/histogram/csrc/histogram.cu"
REPLACES = {
    "ensemble_predict_raw": "src/repro/kernels/ensemble_predict/"
                            "ensemble_predict.py:123",
    "ensemble_predict_binned": "src/repro/kernels/ensemble_predict/"
                               "ensemble_predict.py:155",
    "histogram_round": "src/repro/kernels/histogram/train_histogram.py:211",
    "histogram_tree": "src/repro/kernels/histogram/train_histogram.py:100",
    "histogram_staged": "src/repro/kernels/histogram/histogram.py:74",
}
HIST_TOL = 1e-5            # the tests/test_kernels.py bound
TRAIN_ATOL = 1e-5          # leaves, metric vectors, margins
REF_ROUNDS = 20
REF_TREES = 78
REF_HIST_LAUNCHES = 60     # 3 levels x 20 rounds
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
    """Both kernel libraries, one ``nvcc`` each, started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ensemble_predict import ops as ep_ops
    from repro_torch.kernels.histogram import ops as hist_ops

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(ep_ops.library), pool.submit(hist_ops.library)]
        for f in futures:
            f.result()
    wall = time.perf_counter() - t0
    print(f"build: both libraries in {wall:.2f} s ({build.build_count} nvcc "
          f"runs, in parallel)")
    for name in ("ensemble_predict", "histogram"):
        report = build.reports[name]
        print(f"build: {name}: nvcc {report.seconds:.2f} s -> "
              f"{report.path.name}")
        for line in report.log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {line.strip()}")
    return {"build_s": wall}


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


def hist_inputs(rng, n, d, num_bins, n_ids, n_trees, k, device,
                out_of_range=False):
    """One histogram-kernel case: bins in [0, B), assign in [0, n_ids),
    weights 0/1 with some 2.5s, g and h (n, K).  ``out_of_range`` puts ids
    the kernel must drop (or, where node * B + bin still lands in range,
    count as JAX counts them) into the last bin column and every 7th
    assignment."""
    import torch

    binned = rng.integers(0, num_bins, (n, d)).astype(np.int32)
    assign = rng.integers(0, n_ids, (n_trees, n)).astype(np.int32)
    if out_of_range:
        binned[:, -1] = rng.choice(
            [-1, num_bins, num_bins + 3, -num_bins, 0, num_bins - 1], n)
        assign[:, ::7] = rng.choice([-1, n_ids, n_ids + 2],
                                    assign[:, ::7].shape)
    w = ((rng.random((n_trees, n)) < 0.4)
         * rng.choice([1.0, 1.0, 1.0, 2.5], (n_trees, n)))
    arrays = {"binned": binned, "assign": assign,
              "g": rng.normal(size=(n, k)),
              "h": rng.uniform(0.05, 0.25, (n, k)), "w": w}
    out = {}
    for key, v in arrays.items():
        v = v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def hist_cases():
    """(entry, n, d, B, nodes, T, K, child, out_of_range): the reference
    shape (d = 23, B = 32: levels 0-2 direct and child) at n in {1, 1000,
    21000, 1048576}, K = 3, T = 1, out-of-range ids, and depth 6 with
    B = 256 (8,192 slots: many slot chunks)."""
    cases = []
    for n in (1, 1000, 21000, 1 << 20):
        cases += [("round", n, 23, 32, 1, 5, 1, False, False),
                  ("round", n, 23, 32, 2, 5, 1, True, False),
                  ("staged", n, 23, 32, 4, 1, 1, False, False)]
    for n in (1000, 21000):
        cases += [("round", n, 23, 32, 4, 5, 3, False, False),
                  ("round", n, 23, 32, 1, 5, 3, True, False),
                  ("tree", n, 23, 32, 4, 1, 1, False, False),
                  ("tree", n, 23, 32, 2, 1, 3, True, False),
                  ("staged", n, 23, 32, 2, 1, 3, False, False)]
    cases += [("round", 21000, 23, 32, 4, 5, 1, False, True),
              ("tree", 21000, 23, 32, 2, 1, 3, True, True),
              ("staged", 21000, 23, 32, 4, 1, 1, False, True),
              ("round", 21000, 8, 256, 32, 5, 1, False, False),
              ("tree", 21000, 8, 256, 16, 1, 3, True, False),
              ("tree", 1 << 20, 8, 256, 32, 1, 1, False, False),
              ("staged", 21000, 8, 256, 32, 1, 1, False, False)]
    return cases


def _hist_call(entry, t, nodes, num_bins, child):
    """(kernel call, plain call) of one case on the tensors ``t``."""
    from repro_torch.core.histogram import stack_stats
    from repro_torch.kernels.histogram import ops, ref

    if entry == "staged":
        ids = (t["assign"][0][:, None] * num_bins + t["binned"]).contiguous()
        data = stack_stats(t["g"], t["h"], t["w"][0]).contiguous()
        return (lambda: ops.histogram_staged(ids, data, nodes, num_bins),
                lambda dev: ref.histogram_staged_ref(
                    ids.to(dev), data.to(dev), nodes, num_bins))
    args = (t["binned"], t["assign"], t["g"], t["h"], t["w"])
    return (lambda: ops.histogram_round(*args, nodes, num_bins, child),
            lambda dev: ref.histogram_round_ref(
                *(a.to(dev) for a in args), nodes, num_bins, child))


def phase_hist_kernels(device) -> dict:
    """The histogram kernel's entry points against their plain versions:
    within 1e-5 of the plain version on the card, bit-identical across two
    launches and, up to n = 21000, equal to the plain version on the CPU.
    Returns the max |kernel - plain on the card| per entry point."""
    import torch

    rng = np.random.default_rng(12)
    err = {"histogram_round": 0.0, "histogram_tree": 0.0,
           "histogram_staged": 0.0}
    for entry, n, d, num_bins, nodes, n_trees, k, child, oor in hist_cases():
        name = f"histogram_{entry}"
        n_ids = 2 * nodes if child else nodes
        t = hist_inputs(rng, n, d, num_bins, n_ids, n_trees, k, device, oor)
        kernel, plain = _hist_call(entry, t, nodes, num_bins, child)
        (a, launched), (b, _) = kernel(), kernel()
        torch.cuda.synchronize()
        what = (f"{name} n={n} d={d} B={num_bins} nodes={nodes} T={n_trees} "
                f"K={k}{' child' if child else ''}"
                f"{' out-of-range' if oor else ''}")
        check(launched, f"{what}: launched")
        check(torch.equal(a, b), f"{what}: two launches bit-identical")
        want = plain(device)
        diff = float((a - want).abs().max()) if a.numel() else 0.0
        err[name] = max(err[name], diff)
        check(torch.allclose(a, want, rtol=HIST_TOL, atol=HIST_TOL),
              f"{what}: within {HIST_TOL} of plain (max |diff| {diff})")
        on_cpu = ""
        if n <= 21000:
            check(torch.equal(a.cpu(), plain("cpu")),
                  f"{what}: equal to the plain version on the CPU")
            on_cpu = ", == plain on CPU"
        print(f"kernel vs plain: {what}: max |diff| {diff:.3g}, "
              f"deterministic{on_cpu}")
    return err


def load_train_oracle(device):
    """The committed JAX-drawn masks of the reference run (as
    ``StepMasks``), its per-round train metric matrix and final margins."""
    from repro_torch.convert import masks_from_numpy

    z = np.load(TRAIN_ORACLE)
    masks = masks_from_numpy(z["sample_bits"], z["feature"], device=device,
                             n=int(z["n"]))
    return masks, z["train_metrics"], z["final_margin"]


class LevelTimer:
    """Wraps round histogram providers: CUDA events around every call,
    grouped by the tree level the builder passes."""

    def __init__(self):
        self.events: dict = {}

    def wrap(self, fn):
        import torch

        def timed(*args, level=0, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, level=level, **kw)
            stop.record()
            self.events.setdefault(level, []).append((start, stop))
            return out

        return timed

    def per_level(self) -> dict:
        """level -> (calls, total ms); call after a synchronize."""
        return {lvl: (len(ev), sum(a.elapsed_time(b) for a, b in ev))
                for lvl, ev in sorted(self.events.items())}


def _same_trees(model_a, model_b) -> bool:
    import torch

    return all(torch.equal(getattr(fa, f), getattr(fb, f))
               for fa, fb in zip(model_a.forests, model_b.forests)
               for f in ("feature", "threshold", "gain", "leaf_weight"))


def phase_train(device, card) -> dict:
    """The training main path through ``local-cuda``; see the module
    docstring, phase 4."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting
    from repro_torch.core.types import pack_ensemble
    from repro_torch.data import synthetic
    from repro_torch.kernels.histogram import ops

    ds = synthetic.load("default_credit_card")
    masks, metrics_ref, margin_ref = load_train_oracle(device)
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    ckpt = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)

    ops.reset_launches()
    t0 = time.perf_counter()
    model, history = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks, backend="local-cuda",
        device=device)
    wall = time.perf_counter() - t0
    launches = {name: ops.kernel_launches(name) for name in ops.KERNELS}
    check(launches["histogram_round"] == REF_HIST_LAUNCHES,
          f"{launches['histogram_round']} round-histogram launches == "
          f"{REF_HIST_LAUNCHES}")
    packed = pack_ensemble(model)
    check(packed.total_trees == REF_TREES, f"{REF_TREES} trees")
    check(packed.round_offsets == ckpt.round_offsets, "round structure")
    check(torch.equal(packed.bin_edges, ckpt.bin_edges),
          "bin edges equal the checkpoint's")
    check(torch.equal(packed.feature, ckpt.feature)
          and torch.equal(packed.threshold, ckpt.threshold),
          "all 78 trees equal the checkpoint in feature and threshold")
    leaf_diff = float((packed.leaf_weight - ckpt.leaf_weight).abs().max())
    check(leaf_diff <= TRAIN_ATOL, f"leaves within {TRAIN_ATOL} "
          f"(max |diff| {leaf_diff})")
    keys = ("auc", "acc", "f1", "loss")
    got = np.array([[r[k] for k in keys] for r in history.train])
    metric_diff = float(np.abs(got - metrics_ref).max())
    check(got.shape == metrics_ref.shape and metric_diff <= TRAIN_ATOL,
          f"per-round train metrics within {TRAIN_ATOL} of the JAX history "
          f"(max |diff| {metric_diff})")
    margin_diff = float(np.abs(history.final_margin - margin_ref).max())
    check(margin_diff <= TRAIN_ATOL, f"final margins within {TRAIN_ATOL} "
          f"(max |diff| {margin_diff})")
    print(f"train local-cuda on {card}: {REF_ROUNDS} rounds, "
          f"{packed.total_trees} trees in {wall:.3f} s (first call, kernel "
          f"built); launches {launches}; trees == checkpoint, leaves max "
          f"|diff| {leaf_diff:.3g}, metrics max |diff| {metric_diff:.3g}, "
          f"final margins max |diff| {margin_diff:.3g}, final train "
          f"{history.train[-1]}")
    print("train wall per round (ms): " + " ".join(
        f"{1e3 * w:.2f}" for w in history.wall_time_s))

    # a second run, its histogram calls timed per level: same model again
    timer = LevelTimer()
    timed = backend_mod.TreeBackend(
        backend_mod.BackendDescriptor(impl="local-cuda", histogram_impl="cuda"),
        round_histogram_fn=timer.wrap(ops.compute_round_histogram_cuda_fused),
        round_child_histogram_fn=timer.wrap(
            ops.compute_round_histogram_cuda_fused_child))
    t0 = time.perf_counter()
    model2, history2 = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks, backend=timed, device=device)
    wall2 = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(_same_trees(model, model2)
          and np.array_equal(history.final_margin, history2.final_margin),
          "a second run builds bit-identical trees and margins")
    per_level = timer.per_level()
    print(f"train run 2 (per-level events): {wall2:.3f} s, "
          f"{1e3 * wall2 / REF_ROUNDS:.2f} ms per round; identical model")
    for lvl, (calls, ms) in per_level.items():
        print(f"  level {lvl}: {calls} histogram launches, {ms:.3f} ms in "
              f"all, {ms / calls:.4f} ms each "
              f"({'direct' if lvl == 0 else 'left child + parent - left'})")

    # save, load and serve the trained model
    golden = np.load(GOLDEN)
    rng = np.random.default_rng(0)
    requests = np.asarray(ds.x_test)[
        rng.integers(0, ds.x_test.shape[0], STREAM_BINNED)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained")
        ckpt_io.save_ensemble(path, packed)
        loaded = ckpt_io.load_ensemble(path, device=device)
    check(torch.equal(loaded.feature, packed.feature)
          and torch.equal(loaded.leaf_weight, packed.leaf_weight),
          "checkpoint round trip")
    scores, sm, n_launch, expected = serve(loaded, requests, "fused-cuda",
                                           None)
    check(n_launch == expected, f"serving the trained model: {n_launch} "
          f"launches == {expected}")
    n_gold = golden["margin_fused"].shape[0]
    margins = boosting.predict(
        loaded, torch.from_numpy(requests[:n_gold]).to(device),
        impl="fused-cuda").cpu().numpy()
    served_diff = float(np.abs(margins - golden["margin_fused"]).max())
    check(served_diff <= SCORE_ATOL, f"trained model's first {n_gold} "
          f"margins within {SCORE_ATOL} of the JAX margins "
          f"(max |diff| {served_diff})")
    score_diff = float(np.abs(scores[:n_gold] - golden["proba_fused"]).max())
    check(score_diff <= SCORE_ATOL, f"scores within {SCORE_ATOL} "
          f"(max |diff| {score_diff})")
    print(f"serve the trained model: {STREAM_BINNED} requests through "
          f"fused-cuda, {n_launch} launches, first {n_gold} margins max "
          f"|diff| {served_diff:.3g} vs JAX, scores {score_diff:.3g}")
    return {"model": model, "masks": masks, "launches": launches,
            "x_train": ds.x_train, "y_train": ds.y_train}


def round1_inputs(train, device):
    """binned, g, h and the masks of round 1 of the reference run."""
    import torch

    from repro_torch.core import binning
    from repro_torch.core import objective as objective_mod

    x = torch.from_numpy(np.asarray(train["x_train"])).to(device)
    y = torch.from_numpy(np.asarray(train["y_train"],
                                    np.float32)).to(device)
    binned, _ = binning.fit_bin(x, 32)
    obj = objective_mod.get_objective("logistic")
    g, h = obj.grad_hess(y, obj.init_raw(x.shape[0], device=device))
    width = train["model"].forests[0].feature.shape[0]
    return (binned, g, h, train["masks"].sample[:width],
            train["masks"].feature[:width])


def phase_other_paths(device, train) -> dict:
    """Round 1 rebuilt through the single-tree and the staged entry
    points; both must build the local-cuda round's trees."""
    import torch

    from repro_torch.core import backend as backend_mod
    from repro_torch.core.histogram import histogram_dispatch
    from repro_torch.core.types import TreeConfig
    from repro_torch.kernels.histogram import ops

    binned, g, h, smask, fmask = round1_inputs(train, device)
    want = train["model"].forests[0]
    n_trees = smask.shape[0]
    paths = {
        "histogram_tree": backend_mod.TreeBackend(
            backend_mod.BackendDescriptor("local-cuda-per-tree", "cuda"),
            histogram_fn=histogram_dispatch("cuda-fused"),
            child_histogram_fn=histogram_dispatch("cuda-fused-child")),
        "histogram_staged": backend_mod.TreeBackend(
            backend_mod.BackendDescriptor("local-cuda-staged", "cuda"),
            histogram_fn=histogram_dispatch("cuda")),
    }
    launches = {}
    for kernel, bk in paths.items():
        ops.reset_launches()
        trees, _ = bk.build_forest_per_tree(binned, g, h, smask, fmask,
                                            TreeConfig())
        torch.cuda.synchronize()
        launches[kernel] = ops.kernel_launches(kernel)
        check(launches[kernel] == 3 * n_trees,
              f"{kernel}: {launches[kernel]} launches == {3 * n_trees}")
        check(torch.equal(trees.feature, want.feature)
              and torch.equal(trees.threshold, want.threshold)
              and torch.equal(trees.leaf_weight, want.leaf_weight),
              f"round 1 through {kernel} == the local-cuda round")
        print(f"path {bk.name}: round 1, {launches[kernel]} {kernel} "
              f"launches, trees == local-cuda round 1")
    return launches


def phase_launchers() -> None:
    """``train_fedgbf --rounds 3 --backend local-cuda`` writes a checkpoint
    that ``serve_fedgbf --checkpoint`` serves (both on cuda by default)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cli")
        for argv in (["repro_torch.launch.train_fedgbf", "--rounds", "3",
                      "--backend", "local-cuda", "--checkpoint", ckpt],
                     ["repro_torch.launch.serve_fedgbf", "--checkpoint",
                      ckpt, "--requests", "20000"]):
            proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                                  capture_output=True, text=True,
                                  timeout=600)
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
            check(proc.returncode == 0, f"{argv[0]} exits 0 (exit "
                  f"{proc.returncode}: {proc.stderr[-2000:]})")
            print(f"launcher {argv[0]}: exit 0")
            for line in tail:
                print(f"  {line}")


def hist_bound(nbytes: float, ops_count: float) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops_count / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_hist_timing(device, train) -> dict:
    """Each entry point at round 1's level-0 shape (21000 x 23, B = 32, the
    5 trees of round 1 or one of them): kernel, plain version and one
    ``index_add_`` over staged ids, CUDA events; the bound from this run's
    inputs (each read once, the histogram written once; one add per stat
    of each weighted (tree, row, feature))."""
    import torch

    from repro_torch.core.histogram import stack_stats
    from repro_torch.kernels.histogram import ops, ref

    binned, g, h, smask, _ = round1_inputs(train, device)
    n, d = binned.shape
    num_bins, nodes = 32, 1
    g2, h2 = g[:, None].contiguous(), h[:, None].contiguous()
    out = {}
    for name, n_trees in (("histogram_round", smask.shape[0]),
                          ("histogram_tree", 1), ("histogram_staged", 1)):
        w = smask[:n_trees].contiguous()
        assign = torch.zeros((n_trees, n), dtype=torch.int32, device=device)
        if name == "histogram_staged":
            ids = (assign[0][:, None] * num_bins + binned).contiguous()
            data = stack_stats(g, h, w[0]).contiguous()

            def kernel():
                return ops.histogram_staged(ids, data, nodes, num_bins)

            def plain():
                return ref.histogram_staged_ref(ids, data, nodes, num_bins)

            nbytes = (ids.numel() * 4 + data.numel() * 4
                      + nodes * d * num_bins * 3 * 4)
        else:
            def kernel():
                return ops.histogram_round(binned, assign, g2, h2, w, nodes,
                                           num_bins, False)

            def plain():
                return ref.histogram_round_ref(binned, assign, g2, h2, w,
                                               nodes, num_bins, False)

            nbytes = (binned.numel() * 4 + 2 * assign.numel() * 4
                      + 2 * g2.numel() * 4
                      + n_trees * nodes * d * num_bins * 3 * 4)
        # the library yardstick: one index_add_ over the staged ids
        tree_node = (torch.arange(n_trees, device=device)[:, None] * nodes
                     + assign.long())                         # (T, n)
        flat_ids = ((tree_node[:, :, None] * d
                     + torch.arange(d, device=device)) * num_bins
                    + binned.long()[None]).reshape(-1)        # (T*n*d,)
        rows = stack_stats(g, h, w)[:, :, None, :].expand(
            n_trees, n, d, 3).reshape(-1, 3).contiguous()
        acc = torch.zeros((n_trees * nodes * d * num_bins, 3),
                          dtype=torch.float32, device=device)

        def library():
            return acc.index_add_(0, flat_ids, rows)

        ms = time_ms(kernel, iters=50, warmup=5)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        library_ms = time_ms(library, iters=50, warmup=5)
        ops_count = float((w != 0).sum()) * d * 3
        bound_ms, bound_by = hist_bound(nbytes, ops_count)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        print(f"time {name:24s} {n}x{d} T={n_trees} level 0: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.4f} ms, index_add_ "
              f"{library_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}; "
              f"{nbytes / 1e6:.3f} MB, {ops_count:.0f} adds)")
    return out


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
    t_start = time.perf_counter()
    phase_build()
    err = phase_kernels(device)
    err.update(phase_hist_kernels(device))
    main_path = phase_main_path(device, card)
    train = phase_train(device, card)
    launches = dict(main_path["launches"])
    launches["histogram_round"] = train["launches"]["histogram_round"]
    launches.update(phase_other_paths(device, train))
    phase_launchers()
    timing = phase_timing(main_path["packed"],
                          torch.from_numpy(main_path["x"]).to(device))
    timing.update(phase_hist_timing(device, train))
    phase_profile(main_path["packed"], main_path["requests"])
    paths = {
        "ensemble_predict_raw": "serve fused-cuda, 1,048,576 requests",
        "ensemble_predict_binned": "serve cuda, 65,536 requests",
        "histogram_round": "train_fedgbf local-cuda, 20 rounds",
        "histogram_tree": "round 1, per-tree providers",
        "histogram_staged": "round 1, histogram_dispatch('cuda')",
    }
    shapes = {
        "ensemble_predict_raw": f"{BATCH}x23, 78 trees, depth 3",
        "ensemble_predict_binned": f"{BATCH}x23, 78 trees, depth 3",
        "histogram_round": "21000x23, B=32, 5 trees, level 0",
        "histogram_tree": "21000x23, B=32, 1 tree, level 0",
        "histogram_staged": "21000x23, B=32, 1 tree, level 0",
    }
    kernels = []
    for name, shape in shapes.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCE if name.startswith("ensemble") else HIST_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": shape,
            "path": paths[name],
        })
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
