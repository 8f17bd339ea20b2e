#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of FedGBF on one NVIDIA card:
serving (f32 and int8/int16 quantized) through the ensemble-traversal
kernels, then training (uniform and GOSS sampling, kill and resume, and
vertically federated with 4 parties: raw, quantized, under the chaos
transport, with party dropout and the gradient-less fallback, and over 2
row shards) through the histogram kernel; then the LM substrate (no
kernel of its own): SmolLM-135M trained and served at full width, and
every architecture's smoke config against the JAX package's logits; then
the meta-device dry-run held against a real step, its 10 x 4 matrix, the
paper's production-grid forest round and the examples.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only: no JAX, no module of the JAX
package.  Phases, each of which raises on failure (exit code 1):

1. Device and build: the card's name and power limit, and both kernel
   libraries' ``nvcc`` builds, started together, with what ``-Xptxas -v``
   reports.
2. Kernels vs plain versions on the card:
   a. both ensemble-traversal kernels against their plain PyTorch versions,
      ``torch.equal`` required, and two launches bit-identical: depth 3 and
      5 at n in {257, 8192, 262144}, and the edges of the work split (one
      row, a tile's rows -1 and +1, one tree, one tree past the lanes and
      past a chunk, depth 0, 1 and 12, d = 1 and 4096), NaN and ±inf rows,
      unsplit nodes with low thresholds, splits at FLOAT_MAX and features
      past d;
   b. the histogram kernel's three entry points (round, single tree,
      staged) against their plain versions, max |diff| 0 (``torch.equal``),
      direct and child forms, T in {1, 5}, K in {1, 3}, n in {1, 1000,
      21000, 1048576}, the reference shape (d = 23, B = 32, depth 3),
      depth 6 with B = 256 (8,192 slots: counters in device memory), a bin
      column holding out-of-range ids, one slot holding every row, and
      Poisson(3) bins; two launches must be ``torch.equal``, and up to
      n = 21000 the kernel must equal the plain version run on the CPU.
      The sort kernel that every histogram launch runs first is held
      against its plain version (a stable ``torch.sort``) on every case;
   b'. the round entry point on GOSS weights (0, 1 or the non-dyadic
      amplification, at rho_id 0.1 and 0.3): 21000 x 23, B = 32, T = 5,
      direct and child, K in {1, 3}, ``torch.equal`` to the plain version
      on the card and the CPU, two launches equal.
3. Serving main path: the committed JAX-trained Dynamic FedGBF checkpoint
   serves 1,048,576 requests through ``serve_stream`` (``impl="fused-
   cuda"``, batch 8192, one mid-stream hot reload), then 65,536 with
   ``impl="cuda"``; launch counts equal batches plus warm-up, and the first
   4,096 scores match the committed JAX scores within 1e-5.
   b. Quantized serving: the port's ``quantize_ensemble`` with the
      committed JAX uniforms gives the committed JAX int8 and int16 tables
      exactly; each JAX-quantized checkpoint serves the same 1,048,576
      requests through ``fused-cuda`` and 65,536 through ``cuda``, launches
      counted; the first 4,096 margins equal the JAX margins bit for bit,
      and every served row's margin is within ``margin_delta_bound`` of
      the f32 model's.
3c. Seeded draws (``core/prng.py``, the JAX package's ``jax.random``):
   ``random_bits``, ``uniform``, ``permutation``, ``normal`` and
   ``categorical`` on the card ``torch.equal`` to the same calls on CPU
   tensors, batched keys, at n in {1, 23, 21000, 150016, 1048576}; the
   reference run's 78 (sample, feature) mask pairs drawn from
   ``PRNGKey(0)`` on the card, equal to the committed
   ``dynamic_fedgbf_r20_train.npz`` (the draw's wall printed); then the
   reference run trained on ``local-cuda`` with no masks input: exactly 60
   histogram launches, and phase 4's checks against the committed
   checkpoint (trees exact, leaves, metrics and final margins within
   1e-5).
4. Training main path: ``train_fedgbf(dynamic_fedgbf_config(rounds=20),
   backend="local-cuda")`` on ``default_credit_card`` (21,000 x 23) with
   the committed JAX-drawn masks as an explicit input: exactly 60
   histogram launches (and 60
   sorts), bin edges
   and the 78 trees' features and thresholds equal to the committed
   checkpoint, leaves within 1e-5, per-round train metrics within 1e-5 of
   the JAX history.  A second, per-level timed run must give the same
   trees and margins.  The model is saved, loaded and serves 65,536
   requests through ``fused-cuda``; its first 4,096 margins must equal the
   committed JAX margins bit for bit.
   b. GOSS: the same run with ``sampling="goss"`` and the draws of
      ``PRNGKey(0)``: 60 histogram launches, trees, leaves and margins
      ``torch.equal`` to ``backend="local"`` on the card, the GOSS
      invariants on every round, the round wall beside 4's.
   c. Kill and resume: 4's run from ``PRNGKey(0)`` (no masks input)
      stopped after round 8, its train state saved and loaded, rounds 9-20
      trained from the stored margins and the same key: the packed
      ensemble and final margins equal 4's.
   d. Federated: ``vfl-histogram`` with 4 parties as column blocks (the
      23 features padded to 24, masks from ``PRNGKey(0)``): 60 histogram
      launches (one a level for the 4 parties), trees, leaves, final
      margins and the test rows' ``fused-cuda`` scores ``torch.equal`` to a
      ``local-cuda`` run on the same columns and masks, the wire-byte
      ledger reconciled (delta 0 on every phase) and the run's own meter
      equal to it, the round wall beside ``local-cuda``'s; ``vfl-argmax``
      (trees equal) and ``vfl-histogram-q8`` (trains, reconciles, its
      histogram bytes under a quarter of raw's); one party's launch
      (21000 x 6) timed beside a full-width one and one ``index_add_``.
   e. The rest of the federation on 4d's cell: ``vfl-histogram-chaos``
      and ``vfl-argmax-topk-chaos`` (drop 0.05, corrupt 0.02, dup 0.02,
      delay 0.02, seed 13) ``torch.equal`` to their fault-free twins, the
      retry bytes and injected faults equal to the plan's; ``vfl-histogram``
      under a party-dropout mask ``torch.equal`` to ``local-cuda`` under
      it, no split on a degraded column; the gradient-less fallback (4
      party fits, 240 launches, ledger exact); ``vfl-histogram-sharded``
      over 2 row shards (60 launches), rounds 1-5 ``torch.equal`` to the
      same run on CPU tensors; the port's selftest lattice on the card.
      Each model scores the test rows once through ``fused-cuda``.
5. The other two entry points' paths: round 1 rebuilt with per-tree
   providers (the single-tree entry point) and with the staged provider
   (``histogram_dispatch("cuda")``); both must build the ``local-cuda``
   round's trees.
6. The launchers (``python -m repro_torch.launch.*``, six chains side
   by side): ``train_fedgbf`` killed after round 3 of 6 and resumed
   (``--checkpoint-every 2``) ends in the uninterrupted run's train state;
   ``--sampling goss`` trains; at its defaults (no ``--masks``) it saves
   the committed checkpoint's trees; ``vfl-histogram`` trains under the
   chaos flags and party dropout with the gradient-less fallback, and
   ``vfl-histogram-sharded`` over ``--data-shards 2``; ``serve_fedgbf
   --save`` hands a model to ``serve_fedgbf --checkpoint ... --quantize 8
   --metrics-port 0``, which scrapes its own endpoint.
6b. The LM substrate at full width: SmolLM-135M (``get_config``, 30 layers,
   d 576, 9/3 heads, vocab 49152, f32 params, bf16 compute), the JAX init from
   ``PRNGKey(0)``: ``launch.train``'s path for 30 steps at batch 8 x seq 256
   (every ce finite, the last 10 steps' mean below the first 10's; tokens/s);
   one f32 train step at 2 x 64 from the same weights on the card and on the
   CPU (loss and grad norm within ``LM_PARITY_RTOL``);
   ``launch.serve.generate`` on the trained model (batch 4, prompt 32, 32
   greedy tokens; decode tokens/s), and in f32 every decode step's logits
   within 1e-3 of the full forward's; ``torch.profiler`` over two train steps
   and eight decode steps (device busy share, launches a step).
6c. Every architecture's smoke config (and mixtral's at window 8) forward
   and token-by-token decode on the card in f32, on the seeded numpy
   weights, within 1e-4 of the committed JAX logits (RWKV 5e-4;
   ``testdata/lm_smoke_logits.npz``), the MoE aux loss within 1e-6.
7. Timing at the main path's shapes (CUDA events) beside the plain
   versions, the bounds and, for the histogram, one ``index_add_`` (for
   the sort, one stable ``torch.sort``); the traversal kernels also at
   32,768 to 262,144 rows, beside a launch floor, each batch size timed
   with one thread a row and with 8 and with the depth-3 and the
   runtime-depth instance (``ops.launch_config`` picks one of each); the
   round histogram also at the training run's level-1 and level-2 child
   shapes, each launch split into sort and walk with its longest slot
   segment and the device time of each of its kernels; then profiles of
   the serving stream and of the 20-round training run.
8. The dry-run and the rest of the JAX package's entry points:
   a. ``launch.dryrun.run_one`` for SmolLM-135M's train step at 6b's
      shape (8 x 256) on a (1, 1) mesh, on ``meta``, against one real step
      on the card under the same ``CostCounter``: FLOPs equal, the train
      state's bytes equal up to allocator rounding, the peak within
      ``PEAK_RTOL``; the roofline's compute and memory times beside the
      measured step; the same for one decode step at batch 4 (FLOPs);
   b. the single-pod 10 x 4 dry-run matrix on ``meta`` (spawned workers):
      every cell ok or skipped by rule;
   c. ``launch.dryrun_fedgbf``'s sweep on the card: the paper's forest
      round (150,000 rows, 16 parties, 16 or 32 row shards, 8 on the
      explicit grid): every meter reconciled (delta 0), the trees equal
      ``local-cuda``'s, one histogram launch a level, async
      over sync exactly 1, the subtraction and compaction cuts, each wall;
   d. the four examples' ``main(device="cuda")`` at their defaults.
9. The kernels line, then the card line, then the result line.

Exits non-zero, printing no result, when CUDA is not available or the port
is not beside this file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
#: the JAX package's int8/int16 copies of CHECKPOINT, and its uniforms,
#: margins and bounds for them (``tests/test_torch_quantized.py``)
QUANTIZED = {bits: ROOT / "src" / "repro_torch" / "testdata" /
             f"dynamic_fedgbf_r20_q{bits}" for bits in (8, 16)}
QUANTIZED_DATA = ROOT / "src" / "repro_torch" / "testdata" / \
    "dynamic_fedgbf_r20_quantized.npz"
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
    # the first half of every histogram launch, written for the round form
    "histogram_sort": "src/repro/kernels/histogram/train_histogram.py:211",
}
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
#: the traversal kernels' timed batch sizes, the serving batch first
TIMED_ROWS = (BATCH, 1 << 15, 1 << 16, 3 << 15, 1 << 17, 3 << 16, 1 << 18)
#: GOSS budgets of phase 2b': the reference schedule's rho_id ends
GOSS_RHO = (0.1, 0.3)
#: the reference run is stopped after this round and resumed (phase 4c)
RESUME_AT = 8
#: the JAX package's logits of the LM smoke cases (``lm_smoke_cases``), on
#: the weights ``convert.lm_numpy_params(cfg, LM_WEIGHT_SEED)``
#: (``tests/test_torch_lm_model.py`` writes the file)
LM_LOGITS = ROOT / "src" / "repro_torch" / "testdata" / "lm_smoke_logits.npz"
LM_COLS = 64               # vocabulary columns kept in LM_LOGITS
LM_BATCH = 2
LM_INPUT_SEED = 3
LM_WEIGHT_SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def lm_smoke_cases() -> list:
    """(key, config, positions) of the LM smoke cases: every architecture's
    smoke config in float32 over 16 positions, and mixtral's at window 8
    over 24 (the ring buffer wraps twice)."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config

    f32 = dict(compute_dtype="float32")
    cases = [(arch, dataclasses.replace(get_smoke_config(arch), **f32), 16)
             for arch in ARCH_IDS]
    cases.append(("mixtral-8x22b-w8", dataclasses.replace(
        get_smoke_config("mixtral-8x22b"), window=8, **f32), 24))
    return cases


def lm_smoke_atol(cfg) -> float:
    """The logit tolerance of a smoke case against the JAX logits."""
    return LM_SMOKE_ATOL_RWKV if "rwkv" in cfg.pattern else LM_SMOKE_ATOL


def lm_case_inputs(cfg, seq: int) -> tuple[np.ndarray, dict]:
    """A case's numpy inputs: (LM_BATCH, seq) int32 tokens and the
    frontend stubs (patch embeddings or frames), from LM_INPUT_SEED."""
    from repro_torch.launch.train import add_stubs

    rng = np.random.default_rng(LM_INPUT_SEED)
    tokens = rng.integers(0, cfg.vocab, (LM_BATCH, seq)).astype(np.int32)
    stubs = add_stubs({"tokens": tokens}, cfg, rng)
    del stubs["tokens"]
    return tokens, stubs


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def random_ensemble(rng, n_trees, depth, d, num_bins, device):
    """A packed-table ensemble: splits on bins [0, B-2], a fifth of the
    nodes unsplit (feature -1, threshold B), sorted edges; and the tables'
    edges, which routing must get right as well: unsplit nodes whose
    threshold the values exceed (bin -1, value -FLOAT_MAX: they still
    route left), splits at bin B-1 (value threshold FLOAT_MAX, which only
    +inf would exceed unless sanitised) and features past d (clamped to
    d-1)."""
    import torch

    from repro_torch.core.types import FLOAT_MAX, float_thresholds

    n_internal = 2 ** depth - 1
    shape = (n_trees, n_internal)
    feature = rng.integers(0, d, shape).astype(np.int32)
    threshold = rng.integers(0, num_bins - 1, shape).astype(np.int32)
    edge = rng.random(shape)
    threshold[edge < 0.05] = num_bins - 1
    feature[(edge >= 0.05) & (edge < 0.08)] = d + 3
    unsplit = rng.random(shape) < 0.2
    feature[unsplit] = -1
    threshold[unsplit] = np.where(rng.random(unsplit.sum()) < 0.5, num_bins,
                                  -1)
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
    thr_value = float_thresholds(
        t["feature"], t["threshold"],
        torch.from_numpy(edges.astype(np.float32)).to(device))
    # the value-space twin of an unsplit node's low threshold
    t["thr_value"] = torch.where(
        t["threshold"] < 0, torch.full_like(thr_value, -FLOAT_MAX),
        thr_value).contiguous()
    return t


def hard_rows(rng, n, d, device):
    """Raw float rows with NaN and ±inf entries and whole non-finite rows."""
    import torch

    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.02] = np.nan
    x[rng.random((n, d)) < 0.01] = np.inf
    x[rng.random((n, d)) < 0.01] = -np.inf
    x[0:1, :] = np.nan        # slices: n may be below 3
    x[1:2, :] = np.inf
    x[2:3, :] = -np.inf
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


def phase_build() -> None:
    """Both kernel libraries, one ``nvcc`` each, started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ensemble_predict import ops as ep_ops
    from repro_torch.kernels.histogram import ops as hist_ops

    t0 = time.perf_counter()
    jobs = [ep_ops.library, hist_ops.library]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for f in [pool.submit(j) for j in jobs]:
            f.result()
    wall = time.perf_counter() - t0
    print(f"build: {len(jobs)} libraries in {wall:.2f} s "
          f"({build.build_count} nvcc runs, in parallel)")
    for name in build.reports:
        report = build.reports[name]
        print(f"build: {name}: nvcc {report.seconds:.2f} s -> "
              f"{report.path.name}")
        for line in report.log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {line.strip()}")


def traversal_cases() -> list:
    """(n, trees, depth, d) of phase 2a: PR 11's cases (depth 3 and 5, n in
    {257, 8192, 262144}) and the edges of the kernel's work split (sizes
    from ``ops.launch_config``): one row, a tile's rows -1 and +1, one
    tree (256-row tiles), one tree past the lanes and past a chunk, one
    thread a row (262,144 rows, and a ragged last tile), depth 0, 1 and 12
    (one tree a chunk, above 48 KB), d = 1 and d = 4096 (x read from
    global memory)."""
    from repro_torch.kernels.ensemble_predict import ops

    def rows(n_trees, depth, d):
        return ops.launch_config(1, d, n_trees, depth, 132).rows

    def past_chunk(depth, d):
        return ops.launch_config(1, d, 1 << 20, depth, 132).chunk + 1

    cases = [(n, 78, 3, 23) for n in (257, 8192, 262144)]
    cases += [(n, 300, 5, 23) for n in (257, 8192, 262144)]
    # one thread a row from two 256-row tiles an SM on: its ragged edge
    cases += [(2 * ops.THREADS * 132 + 1, 78, 3, 23)]
    r = rows(78, 3, 23)
    cases += [(1, 78, 3, 23), (r - 1, 78, 3, 23), (r + 1, 78, 3, 23),
              (rows(1, 3, 23) + 1, 1, 3, 23), (8192, 1, 3, 23),
              (r + 1, 9, 3, 23), (r + 1, past_chunk(3, 23), 3, 23),
              (8192, past_chunk(3, 23), 3, 23),
              (r + 1, 78, 0, 23), (8192, 78, 1, 23), (r - 1, 78, 1, 23),
              (rows(3, 12, 23) + 1, 3, 12, 23), (8192, 2, 12, 23),
              (1, 1, 12, 1), (8192, 78, 3, 1), (r + 1, 78, 3, 1),
              (8192, 78, 3, 4096), (1, 300, 5, 4096),
              (rows(past_chunk(5, 4096), 5, 4096) - 1, past_chunk(5, 4096),
               5, 4096)]
    return cases


def phase_kernels(device) -> dict:
    """Both kernels against their plain versions, ``torch.equal``, and two
    launches bit-identical, at every case of ``traversal_cases``; max
    |kernel - plain|."""
    import torch

    from repro_torch.kernels.ensemble_predict import ops, ref

    rng = np.random.default_rng(11)
    num_bins = 32
    err = {"ensemble_predict_raw": 0.0, "ensemble_predict_binned": 0.0}
    for n, n_trees, depth, d in traversal_cases():
        t = random_ensemble(rng, n_trees, depth, d, num_bins, device)
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
            args = (xin, t["feature"], thr, t["leaf"], t["scale"], depth)
            cfg = ops.config_for(name, xin, n_trees, depth)
            (got, launched), (again, _) = (ops.sweep(name, *args),
                                           ops.sweep(name, *args))
            want = plain_fn(*args)
            torch.cuda.synchronize()
            what = (f"{name} depth {depth}, {n_trees} trees, n={n}, d={d}")
            check(launched, f"{what}: launched")
            check(torch.equal(got, again), f"{what}: two launches equal")
            diff = float((got - want).abs().max())
            err[name] = max(err[name], diff)
            check(torch.equal(got, want),
                  f"{what}: == plain (max |diff| {diff})")
            print(f"kernel == plain: {what}: equal, deterministic "
                  f"(rows {cfg.rows} x lanes {cfg.lanes}, chunk {cfg.chunk},"
                  f" x {'staged' if cfg.stage_x else 'global'}, "
                  f"{'depth-3' if cfg.unrolled else 'runtime-depth'} "
                  f"instance, "
                  f"{cfg.smem_bytes} B, grid {cfg.grid})")
    return err


def phase_timing(packed, requests) -> dict:
    """Both kernels at the serving shape (8192 x 23, 78 trees, depth 3)
    and at the larger ``TIMED_ROWS`` (32,768 to 262,144 rows): kernel and
    bound (CUDA events, held stream), beside the launch floor (one in-place
    one-element torch op, timed the same way) and the sizes
    ``ops.config_for`` picks; the plain version at 8192 and 262,144 rows.
    Each batch size is also timed with the other choice of threads a row
    (1 or 8) and with the runtime-depth instance in place of the depth-3
    one, so the run shows where each choice of ``ops.launch_config`` pays;
    all three must give the same bits.  Returns the 8192-row numbers."""
    import torch

    from repro_torch.core.binning import bin_data
    from repro_torch.core.types import serving_tables
    from repro_torch.kernels.ensemble_predict import ops, ref

    device = packed.feature.device
    feature, thr_value, leaf, scale = serving_tables(packed)
    threshold = packed.threshold.contiguous()
    depth, n_trees = packed.max_depth, packed.total_trees
    one = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: one.add_(1.0), iters=200, warmup=20)
    print(f"time launch floor (in-place one-element add): {floor_ms:.5f} ms")
    out = {}
    for n in TIMED_ROWS:
        check(requests.shape[0] >= n, f"{n} requests to time")
        x = torch.from_numpy(
            np.ascontiguousarray(requests[:n], np.float32)).to(device)
        binned = bin_data(x, packed.bin_edges)
        runs = {
            "ensemble_predict_raw": (x, thr_value,
                                     ref.predict_forest_raw_ref),
            "ensemble_predict_binned": (binned, threshold,
                                        ref.predict_forest_binned_ref),
        }
        for name, (xin, thr, plain_fn) in runs.items():
            args = (xin, feature, thr, leaf, scale, depth)
            cfg = ops.config_for(name, xin, n_trees, depth)
            check(cfg.unrolled, f"{name}: depth {depth} runs unrolled")
            others = {
                "lanes": ops.config_for(
                    name, xin, n_trees, depth,
                    lanes=ops.MAX_LANES if cfg.lanes == 1 else 1),
                "depth": ops.config_for(name, xin, n_trees, depth,
                                        unrolled=False),
            }
            want = ops.sweep(name, *args)[0]
            for what, c in others.items():
                check(torch.equal(ops.sweep(name, *args, cfg=c)[0], want),
                      f"{name} n={n}: the other {what} gives the same "
                      f"bits")
            ms, lanes_ms, rolled_ms = (
                time_ms(lambda c=c: ops.sweep(name, *args, cfg=c),
                        iters=200, warmup=20)
                for c in (cfg, others["lanes"], others["depth"]))
            bound_ms, bound_by = bound(xin, (feature, thr, leaf, scale),
                                       n, n_trees, depth)
            other = others["lanes"]
            line = (f"time {name:24s} {n}x{xin.shape[1]} {n_trees} trees: "
                    f"kernel {ms:.5f} ms (rows {cfg.rows} x lanes "
                    f"{cfg.lanes}, chunk {cfg.chunk}, grid {cfg.grid}, "
                    f"{cfg.smem_bytes} B/block), with lanes {other.lanes} "
                    f"{lanes_ms:.5f} ms (grid {other.grid}, "
                    f"{other.smem_bytes} B/block), runtime-depth instance "
                    f"{rolled_ms:.5f} ms (grid {others['depth'].grid}), "
                    f"bound {bound_ms:.6f} ms ({bound_by}), launch floor "
                    f"{floor_ms:.5f} ms")
            if n in (BATCH, 1 << 18):
                plain_ms = time_ms(lambda: plain_fn(*args),
                                   iters=5 if n > BATCH else 10, warmup=2)
                line += f", plain {plain_ms:.4f} ms"
            print(line)
            if n == BATCH:
                out[name] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "launch_floor_ms": floor_ms}
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

    launches, stream = {}, {}
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
        stream[impl] = stream_line(sm)
        print(f"serve impl={impl} on {card}: {reqs.shape[0]} requests, "
              f"{int(sm.batches.value)} batches of {BATCH}, "
              f"{stream[impl]}, {n_launch} launches, "
              f"max |score - JAX| {diff:.3g}")
    return {"packed": packed, "launches": launches, "requests": requests,
            "stream": stream}


def stream_line(sm) -> str:
    q = sm.quantiles_ms()
    return (f"{sm.rows_per_s.value:,.0f} rows/s, batch latency "
            f"p50={q[0.5]:.4f} ms p90={q[0.9]:.4f} ms p99={q[0.99]:.4f} ms")


def phase_quantized(device, card, main_path) -> dict:
    """Phase 3b: quantized serving.  The port's ``quantize_ensemble`` of
    the reference checkpoint, given the committed JAX uniforms, must give
    the committed JAX int8 and int16 tables exactly.  Each JAX-quantized
    checkpoint then serves the request stream: 1,048,576 requests through
    ``fused-cuda`` and 65,536 through ``cuda`` (dequantized leaves in both
    traversal kernels), launches counted; the first 4,096 margins of each
    impl equal the committed JAX ``fused`` margins bit for bit, and every
    score the stream served equals the activation of those margins (the
    first 4,096) and of ``predict``'s margins (every row); over every
    served row |margin_q - margin_f32| <= ``margin_delta_bound``.  Rows/s
    and p50/p90 are printed beside the f32 stream's (phase 3)."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import boosting
    from repro_torch.core import objective as objective_mod
    from repro_torch.core.types import (
        QUANTIZED_ARRAYS,
        margin_delta_bound,
        quantize_ensemble,
    )

    data = np.load(QUANTIZED_DATA)
    f32, requests = main_path["packed"], main_path["requests"]
    uniform = torch.from_numpy(data["uniform"]).to(device)
    launches = {IMPL_KERNEL[impl][0]: 0 for impl in IMPL_KERNEL}
    activation = objective_mod.get_objective(f32.loss).activation
    for bits, path in QUANTIZED.items():
        q = ckpt_io.load_ensemble(str(path), device=device)
        check(q.bits == bits and q.total_trees == REF_TREES,
              f"int{bits} checkpoint: {REF_TREES} trees")
        mine = quantize_ensemble(f32, bits, uniform=uniform)
        for f in QUANTIZED_ARRAYS:
            check(torch.equal(getattr(mine, f), getattr(q, f)),
                  f"int{bits} quantize_ensemble {f} == the JAX table")
        bound = margin_delta_bound(q)
        check(abs(bound - float(data[f"bound_q{bits}"]))
              <= 1e-6 * float(data[f"bound_q{bits}"]),
              f"int{bits} bound {bound!r} within rtol 1e-6 of JAX's")
        gold = data[f"margin_q{bits}"]
        for impl, reqs in (("fused-cuda", requests),
                           ("cuda", requests[:STREAM_BINNED])):
            kernel = IMPL_KERNEL[impl][0]
            scores, sm, n_launch, expected = serve(q, reqs, impl, None)
            check(n_launch == expected, f"int{bits} {impl}: {n_launch} "
                  f"launches == {expected}")
            check(scores.shape == (reqs.shape[0],)
                  and bool(np.isfinite(scores).all()),
                  f"int{bits} {impl}: finite scores")
            launches[kernel] += n_launch
            served = torch.from_numpy(scores).to(device)
            want = activation(torch.from_numpy(gold).to(device))
            check(torch.equal(served[:gold.shape[0]], want),
                  f"int{bits} {impl}: first {gold.shape[0]} served scores "
                  f"== the activation of the JAX margins (max |diff| "
                  f"{float((served[:gold.shape[0]] - want).abs().max())})")
            delta = 0.0
            for lo in range(0, reqs.shape[0], 1 << 18):
                x = torch.from_numpy(np.ascontiguousarray(
                    reqs[lo:lo + (1 << 18)], np.float32)).to(device)
                mq = boosting.predict(q, x, impl=impl)
                if lo == 0:
                    head = mq[:gold.shape[0]].cpu().numpy()
                    check(np.array_equal(head, gold),
                          f"int{bits} {impl}: first {gold.shape[0]} margins "
                          f"== the JAX margins (max |diff| "
                          f"{np.abs(head - gold).max()})")
                check(torch.equal(served[lo:lo + x.shape[0]], activation(mq)),
                      f"int{bits} {impl}: served scores of rows {lo}.. == "
                      f"the activation of predict's margins")
                mf = boosting.predict(f32, x, impl=impl)
                delta = max(delta, float((mq - mf).abs().max()))
            check(delta <= bound, f"int{bits} {impl}: max |margin_q - "
                  f"margin_f32| {delta!r} <= bound {bound!r}")
            print(f"serve int{bits} impl={impl} on {card}: {reqs.shape[0]} "
                  f"requests, {stream_line(sm)} (f32: "
                  f"{main_path['stream'][impl]}), {n_launch} launches; first "
                  f"{gold.shape[0]} margins == JAX; max |margin_q - "
                  f"margin_f32| {delta:.4g} <= bound {bound:.4g}")
    return launches


def hist_inputs(rng, n, d, num_bins, n_ids, n_trees, k, device, kind=""):
    """One histogram-kernel case: bins in [0, B), assign in [0, n_ids),
    weights 0/1 with some 2.5s, g and h (n, K).  ``kind``:
    ``"oor"`` puts ids the kernel must drop (or, where node * B + bin still
    lands in range, count as JAX counts them) into the last bin column and
    every 7th assignment; ``"skew"`` puts every row of every (tree,
    feature) into one slot; ``"poisson"`` bins the first 9 features as
    Poisson(3) counts, as the synthetic credit data holds them (one bin
    then takes some 22% of the rows)."""
    import torch

    binned = rng.integers(0, num_bins, (n, d)).astype(np.int32)
    assign = rng.integers(0, n_ids, (n_trees, n)).astype(np.int32)
    if kind == "oor":
        binned[:, -1] = rng.choice(
            [-1, num_bins, num_bins + 3, -num_bins, 0, num_bins - 1], n)
        assign[:, ::7] = rng.choice([-1, n_ids, n_ids + 2],
                                    assign[:, ::7].shape)
    elif kind == "skew":
        binned[:] = num_bins // 2
        assign[:] = n_ids - 1
    elif kind == "poisson":
        binned[:, :9] = np.minimum(rng.poisson(3.0, (n, 9)), num_bins - 1)
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
    """(entry, n, d, B, nodes, T, K, child, kind): the reference shape
    (d = 23, B = 32: levels 0-2 direct and child) at n in {1, 1000, 21000,
    1048576}, K = 3, T = 1, out-of-range ids, depth 6 with B = 256 (8,192
    slots), one slot holding every row, and Poisson(3) bins."""
    cases = []
    for n in (1, 1000, 21000, 1 << 20):
        cases += [("round", n, 23, 32, 1, 5, 1, False, ""),
                  ("round", n, 23, 32, 2, 5, 1, True, ""),
                  ("staged", n, 23, 32, 4, 1, 1, False, "")]
    for n in (1000, 21000):
        cases += [("round", n, 23, 32, 4, 5, 3, False, ""),
                  ("round", n, 23, 32, 1, 5, 3, True, ""),
                  ("tree", n, 23, 32, 4, 1, 1, False, ""),
                  ("tree", n, 23, 32, 2, 1, 3, True, ""),
                  ("staged", n, 23, 32, 2, 1, 3, False, "")]
    cases += [("round", 21000, 23, 32, 4, 5, 1, False, "oor"),
              ("tree", 21000, 23, 32, 2, 1, 3, True, "oor"),
              ("staged", 21000, 23, 32, 4, 1, 1, False, "oor"),
              ("round", 21000, 8, 256, 32, 5, 1, False, ""),
              ("tree", 21000, 8, 256, 16, 1, 3, True, ""),
              ("tree", 1 << 20, 8, 256, 32, 1, 1, False, ""),
              ("staged", 21000, 8, 256, 32, 1, 1, False, ""),
              ("round", 21000, 23, 32, 1, 5, 1, False, "skew"),
              ("staged", 21000, 23, 32, 1, 1, 1, False, "skew"),
              ("round", 21000, 23, 32, 1, 5, 1, False, "poisson"),
              ("round", 21000, 23, 32, 2, 5, 1, True, "poisson")]
    return cases


def _hist_call(entry, t, nodes, num_bins, child):
    """(kernel call, plain call, sort call, plain sort call) of one case on
    the tensors ``t``."""
    from repro_torch.core.histogram import stack_stats
    from repro_torch.kernels.histogram import ops, ref

    if entry == "staged":
        ids = (t["assign"][0][:, None] * num_bins + t["binned"]).contiguous()
        data = stack_stats(t["g"], t["h"], t["w"][0]).contiguous()
        return (lambda: ops.histogram_staged(ids, data, nodes, num_bins),
                lambda dev: ref.histogram_staged_ref(
                    ids.to(dev), data.to(dev), nodes, num_bins),
                lambda: ops.sort_slots(ids, None, nodes, num_bins),
                lambda: ref.sort_slots_ref(ids, None, nodes, num_bins))
    args = (t["binned"], t["assign"], t["g"], t["h"], t["w"])
    return (lambda: ops.histogram_round(*args, nodes, num_bins, child),
            lambda dev: ref.histogram_round_ref(
                *(a.to(dev) for a in args), nodes, num_bins, child),
            lambda: ops.sort_slots(args[0], args[1], nodes, num_bins, child),
            lambda: ref.sort_slots_ref(args[0], args[1], nodes, num_bins,
                                       child))


def phase_hist_kernels(device) -> dict:
    """The histogram kernel's entry points against their plain versions:
    equal to the plain version on the card (max |diff| 0), bit-identical
    across two launches and, up to n = 21000, equal to the plain version
    on the CPU; the sort kernel equal to its plain version.  Returns the
    max |kernel - plain on the card| per kernel (for the sort: of order
    and starts)."""
    import torch

    rng = np.random.default_rng(12)
    err = {"histogram_round": 0.0, "histogram_tree": 0.0,
           "histogram_staged": 0.0, "histogram_sort": 0.0}
    for entry, n, d, num_bins, nodes, n_trees, k, child, kind in hist_cases():
        name = f"histogram_{entry}"
        n_ids = 2 * nodes if child else nodes
        t = hist_inputs(rng, n, d, num_bins, n_ids, n_trees, k, device, kind)
        kernel, plain, sort, plain_sort = _hist_call(entry, t, nodes,
                                                     num_bins, child)
        (a, launched), (b, _) = kernel(), kernel()
        torch.cuda.synchronize()
        what = (f"{name} n={n} d={d} B={num_bins} nodes={nodes} T={n_trees} "
                f"K={k}{' child' if child else ''}"
                f"{' ' + kind if kind else ''}")
        check(launched, f"{what}: launched")
        check(torch.equal(a, b), f"{what}: two launches bit-identical")
        want = plain(device)
        diff = float((a - want).abs().max()) if a.numel() else 0.0
        err[name] = max(err[name], diff)
        check(torch.equal(a, want),
              f"{what}: equal to the plain version (max |diff| {diff})")
        on_cpu = ""
        if n <= 21000:
            check(torch.equal(a.cpu(), plain("cpu")),
                  f"{what}: equal to the plain version on the CPU")
            on_cpu = ", == plain on CPU"
        (order, starts), (order_p, starts_p) = sort(), plain_sort()
        torch.cuda.synchronize()
        sort_diff = max(
            float((order.long() - order_p.long()).abs().max())
            if order.numel() else 0.0,
            float((starts.long() - starts_p.long()).abs().max()))
        err["histogram_sort"] = max(err["histogram_sort"], sort_diff)
        check(torch.equal(order, order_p) and torch.equal(starts, starts_p),
              f"{what}: sort == plain sort (max |diff| {sort_diff})")
        longest = int((starts[..., 1:] - starts[..., :-1]).max())
        print(f"kernel vs plain: {what}: max |diff| {diff:.3g}, "
              f"deterministic{on_cpu}; sort equal, longest segment "
              f"{longest}")
    return err


def phase_goss_hist_kernels(device) -> float:
    """Phase 2b': the round histogram on GOSS's weights, which are 0, 1 or
    the amplification ``(n - n_top) / n_rand`` (not a power of two, so
    ``g * w`` and ``h * w`` round): 21000 x 23, B = 32, T = 5, direct and
    child, K = 1 and 3, at the budgets ``goss_counts`` gives for rho_id
    0.1 and 0.3.  Equal to the plain version on the card and on the CPU
    (``torch.equal``), two launches equal.  Returns the max |diff|."""
    import torch

    from repro_torch.core import forest, prng

    rng = np.random.default_rng(14)
    key = prng.PRNGKey(14, device)
    n, d, num_bins, n_trees = 21000, 23, 32, 5
    err = 0.0
    for rho in GOSS_RHO:
        n_top, n_rand = forest.goss_counts(n, rho, 0.5)
        amplify = float(np.float32(n - n_top) / np.float32(n_rand))
        for k in (1, 3):
            for child in (False, True):
                nodes = 2 if child else 1
                t = hist_inputs(rng, n, d, num_bins,
                                2 * nodes if child else nodes, n_trees, k,
                                device)
                key, sub = prng.split(key).unbind(0)
                t["w"] = forest.goss_weights(
                    t["g"], prng.uniform(sub, (n_trees, n)), n_top,
                    n_rand).contiguous()
                check(set(t["w"].unique().tolist()) <= {0.0, 1.0, amplify},
                      "GOSS weights in {0, 1, amplify}")
                kernel, plain, _, _ = _hist_call("round", t, nodes, num_bins,
                                                 child)
                (a, launched), (b, _) = kernel(), kernel()
                torch.cuda.synchronize()
                what = (f"histogram_round GOSS rho_id={rho} (n_top {n_top}, "
                        f"n_rand {n_rand}, amplify {amplify!r}) T={n_trees} "
                        f"K={k}{' child' if child else ''}")
                check(launched, f"{what}: launched")
                check(torch.equal(a, b), f"{what}: two launches equal")
                want = plain(device)
                diff = float((a - want).abs().max())
                err = max(err, diff)
                check(torch.equal(a, want), f"{what}: == plain (max |diff| "
                      f"{diff})")
                check(torch.equal(a.cpu(), plain("cpu")),
                      f"{what}: == plain on the CPU")
                print(f"kernel vs plain: {what}: equal on the card and the "
                      f"CPU, deterministic")
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
    grouped by the tree level `build_round` passes; keeps each level's first
    call (child form or not, and its arguments) for the timing phase."""

    def __init__(self):
        self.events: dict = {}
        self.first_call: dict = {}

    def wrap(self, fn, child: bool):
        import torch

        def timed(*args, level=0, **kw):
            self.first_call.setdefault(level, (child, args))
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


def check_reference_run(label, model, history, launches, ckpt, metrics_ref,
                        margin_ref, wall_note):
    """Phase 4's checks of a 20-round reference run: 60 round-histogram
    launches and sorts, the committed checkpoint's 78 trees (bin edges,
    features and thresholds exact, leaves within ``TRAIN_ATOL``), the JAX
    history's train metrics and final margins within ``TRAIN_ATOL``.
    Returns the packed model."""
    import torch

    from repro_torch.core.types import pack_ensemble

    check(launches["histogram_round"] == REF_HIST_LAUNCHES,
          f"{label}: {launches['histogram_round']} round-histogram launches "
          f"== {REF_HIST_LAUNCHES}")
    check(launches["histogram_sort"] == REF_HIST_LAUNCHES,
          f"{label}: {launches['histogram_sort']} sorts == "
          f"{REF_HIST_LAUNCHES}")
    packed = pack_ensemble(model)
    check(packed.total_trees == REF_TREES, f"{label}: {REF_TREES} trees")
    check(packed.round_offsets == ckpt.round_offsets,
          f"{label}: round structure")
    check(torch.equal(packed.bin_edges, ckpt.bin_edges),
          f"{label}: bin edges equal the checkpoint's")
    check(torch.equal(packed.feature, ckpt.feature)
          and torch.equal(packed.threshold, ckpt.threshold),
          f"{label}: all 78 trees equal the checkpoint in feature and "
          "threshold")
    leaf_diff = float((packed.leaf_weight - ckpt.leaf_weight).abs().max())
    check(leaf_diff <= TRAIN_ATOL, f"{label}: leaves within {TRAIN_ATOL} "
          f"(max |diff| {leaf_diff})")
    keys = ("auc", "acc", "f1", "loss")
    got = np.array([[r[k] for k in keys] for r in history.train])
    metric_diff = float(np.abs(got - metrics_ref).max())
    check(got.shape == metrics_ref.shape and metric_diff <= TRAIN_ATOL,
          f"{label}: per-round train metrics within {TRAIN_ATOL} of the JAX "
          f"history (max |diff| {metric_diff})")
    margin_diff = float(np.abs(history.final_margin - margin_ref).max())
    check(margin_diff <= TRAIN_ATOL, f"{label}: final margins within "
          f"{TRAIN_ATOL} (max |diff| {margin_diff})")
    print(f"{label}: {REF_ROUNDS} rounds, {packed.total_trees} trees in "
          f"{wall_note}; launches {launches}; trees == checkpoint, leaves "
          f"max |diff| {leaf_diff:.3g}, metrics max |diff| "
          f"{metric_diff:.3g}, final margins max |diff| {margin_diff:.3g}, "
          f"final train {history.train[-1]}")
    print(f"{label} wall per round (ms): " + " ".join(
        f"{1e3 * w:.2f}" for w in history.wall_time_s))
    return packed


#: phase 3c: the draws held card == CPU at these sizes (the reference
#: run's d, its n, the production grid's padded n, a serving stream's)
DRAW_SIZES = (1, 23, 21000, 150016, 1048576)
DRAW_KEYS = 3              # keys in a batch up to 150,016 (1 beyond)


def phase_seeded_draws(device, card) -> dict:
    """Phase 3c: the JAX package's random streams on the card; see the
    module docstring."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import boosting, forest, prng
    from repro_torch.data import synthetic
    from repro_torch.kernels.histogram import ops

    def both(fn, key, *args):
        """fn on the card's and on the CPU's copy of ``key``."""
        got = fn(key.to(device), *args)
        torch.cuda.synchronize()
        return got, fn(key, *args)

    root = prng.PRNGKey(20)
    for n in DRAW_SIZES:
        keys = prng.split(prng.fold_in(root, n), DRAW_KEYS if n <= 150016
                          else 1)
        logits = prng.normal(prng.fold_in(root, n + 1), (2, n)) * 3.0
        cases = {
            "random_bits": (prng.random_bits, keys, (n,)),
            "uniform": (prng.uniform, keys, (n,)),
            "uniform bf16": (lambda k, m: prng.uniform(
                k, m, dtype=torch.bfloat16), keys, (n,)),
            "permutation": (prng.permutation, keys, n),
            "normal": (prng.normal, keys, (n,)),
            "categorical": (lambda k, lg: prng.categorical(k, lg.to(
                k.device)), keys[0], logits),
            "categorical bf16": (lambda k, lg: prng.categorical(k, lg.to(
                k.device, torch.bfloat16)), keys[0], logits),
        }
        for name, (fn, key, arg) in cases.items():
            card_out, cpu_out = both(fn, key, arg)
            check(card_out.device.type == "cuda", f"{name} drawn on the card")
            check(torch.equal(card_out.cpu(), cpu_out),
                  f"{name} n={n}: card == CPU")
        print(f"seeded draws n={n}: random_bits, uniform (f32, bf16), "
              f"permutation, normal, categorical (f32, bf16 logits) over "
              f"{keys.shape[0]} key(s): card == CPU, bit for bit")

    # the reference run's 78 mask pairs, drawn on the card
    ds = synthetic.load("default_credit_card")
    n, d = ds.x_train.shape
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    oracle, metrics_ref, margin_ref = load_train_oracle(device)
    draw_ms = []
    for _ in range(3):    # the first call includes the CUDA context's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = forest.draw_step_masks(cfg, n, d, prng.PRNGKey(0, device))
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    check(masks.sample.device.type == "cuda", "masks drawn on the card")
    check(torch.equal(masks.sample, oracle.sample)
          and torch.equal(masks.feature, oracle.feature),
          f"the {REF_TREES} mask pairs from PRNGKey(0) == the committed "
          "JAX masks")
    print(f"seeded draws: {REF_TREES} (sample, feature) mask pairs of "
          f"{n} x {d} from PRNGKey(0) on {card}: == the committed JAX masks; "
          f"draw wall {' / '.join(f'{ms:.2f}' for ms in draw_ms)} ms "
          f"(calls 1-3)")

    # the reference run from the key alone
    ckpt = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)
    ops.reset_launches()
    t0 = time.perf_counter()
    model, history = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, prng.PRNGKey(0), backend="local-cuda",
        device=device)
    wall = time.perf_counter() - t0
    launches = {name: ops.kernel_launches(name) for name in ops.KERNELS}
    check_reference_run("train seeded (no masks)", model, history, launches,
                        ckpt, metrics_ref, margin_ref,
                        f"{wall:.3f} s (the first training call) on {card}")
    return {"launches": launches, "draw_ms": draw_ms}


def phase_train(device, card) -> dict:
    """The training main path through ``local-cuda``; see the module
    docstring, phase 4."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting
    from repro_torch.data import synthetic
    from repro_torch.kernels.histogram import ops

    ds = synthetic.load("default_credit_card")
    masks, metrics_ref, margin_ref = load_train_oracle(device)
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    ckpt = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)

    ops.reset_launches()
    t0 = time.perf_counter()
    model, history = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks=masks, backend="local-cuda",
        device=device)
    wall = time.perf_counter() - t0
    launches = {name: ops.kernel_launches(name) for name in ops.KERNELS}
    packed = check_reference_run("train local-cuda (masks input)", model,
                                 history, launches, ckpt, metrics_ref,
                                 margin_ref, f"{wall:.3f} s on {card}")

    # a second run, its histogram calls timed per level: same model again
    timer = LevelTimer()
    timed = backend_mod.TreeBackend(
        backend_mod.BackendDescriptor(impl="local-cuda", histogram_impl="cuda"),
        round_histogram_fn=timer.wrap(ops.compute_round_histogram_cuda_fused,
                                      child=False),
        round_child_histogram_fn=timer.wrap(
            ops.compute_round_histogram_cuda_fused_child, child=True))
    t0 = time.perf_counter()
    model2, history2 = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks=masks, backend=timed,
        device=device)
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
    # the kernel accumulates with the FMA that XLA's CPU backend contracts
    # the JAX fused scan into: the margins are the JAX package's, bit for bit
    check(np.array_equal(margins, golden["margin_fused"]),
          f"trained model's first {n_gold} margins equal the JAX margins "
          f"(max |diff| {served_diff})")
    score_diff = float(np.abs(scores[:n_gold] - golden["proba_fused"]).max())
    check(score_diff <= SCORE_ATOL, f"scores within {SCORE_ATOL} "
          f"(max |diff| {score_diff})")
    print(f"serve the trained model: {STREAM_BINNED} requests through "
          f"fused-cuda, {n_launch} launches, first {n_gold} margins max "
          f"|diff| {served_diff:.3g} vs JAX, scores {score_diff:.3g}")
    return {"model": model, "masks": masks, "launches": launches,
            "x_train": ds.x_train, "y_train": ds.y_train,
            "level_calls": timer.first_call, "history": history}


def _walls_ms(history) -> str:
    walls = np.array(history.wall_time_s) * 1e3
    return (f"mean {walls[1:].mean():.2f} ms over rounds 2-{walls.size} "
            f"(round 1 {walls[0]:.2f})")


def phase_goss_train(device, card, uniform_history) -> dict:
    """Phase 4b: GOSS training on the card.  ``train_fedgbf(
    dynamic_fedgbf_config(rounds=20, sampling="goss"), backend="local-
    cuda")`` on the full ``default_credit_card`` training set with the
    draws of ``PRNGKey(0)`` (drawn on the card): exactly 60 round-histogram
    launches; trees, leaves and final margins equal (``torch.equal``) to
    the same draws run through ``backend="local"`` on the card; on every
    round the GOSS invariants: the weight-1 rows are the ``n_top``
    largest |g|, every weight is in {0, 1, amplify}, and at least ``n_top
    + n_rand`` rows weigh.  The per-round wall is printed beside the
    uniform run's."""
    import torch

    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, dynamic, forest, prng
    from repro_torch.data import synthetic
    from repro_torch.kernels.histogram import ops

    steps = []

    class Recording(backend_mod.TreeBackend):
        """``local-cuda``, keeping each round's g and GOSS weights."""

        def build_forest_per_tree(self, binned, g, h, sample_mask, *a, **kw):
            steps.append((g, sample_mask))
            return super().build_forest_per_tree(binned, g, h, sample_mask,
                                                 *a, **kw)

    ds = synthetic.load("default_credit_card")
    n, d = ds.x_train.shape
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS, sampling="goss")
    draws = forest.draw_step_masks(cfg, n, d, prng.PRNGKey(0, device))
    check(draws.uniform.device == device, "GOSS draws made on the card")
    local_cuda = backend_mod.get_backend("local-cuda")
    recording = Recording(**{f.name: getattr(local_cuda, f.name)
                             for f in dataclasses.fields(local_cuda)})
    ops.reset_launches()
    model, history = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks=draws, backend=recording,
        device=device)
    torch.cuda.synchronize()
    launches = {name: ops.kernel_launches(name) for name in ops.KERNELS}
    check(launches["histogram_round"] == REF_HIST_LAUNCHES,
          f"GOSS: {launches['histogram_round']} round-histogram launches == "
          f"{REF_HIST_LAUNCHES}")
    check(len(steps) == REF_ROUNDS, "one forest build a round")
    for m, (g, w) in enumerate(steps, start=1):
        n_top, n_rand = forest.goss_counts(
            n, dynamic.rho_id_schedule(cfg, m), cfg.goss_top_share)
        amplify = float(np.float32(n - n_top) / np.float32(n_rand))
        check(amplify != 1.0, "amplification tells the sets apart")
        mag = g.abs()
        for t in range(w.shape[0]):
            top = w[t] == 1
            check(int(top.sum()) == n_top, f"round {m}: {n_top} top rows")
            check(float(mag[top].min()) >= float(mag[~top].max()),
                  f"round {m}: the top rows hold the largest |g|")
            check(set(w[t].unique().tolist()) <= {0.0, 1.0, amplify},
                  f"round {m}: weights in {{0, 1, {amplify!r}}}")
            check(int((w[t] != 0).sum()) >= n_top + n_rand,
                  f"round {m}: at least n_top + n_rand rows weigh")
    local, local_history = boosting.train_fedgbf(
        ds.x_train, ds.y_train, cfg, masks=draws, backend="local",
        device=device)
    check(_same_trees(model, local),
          "GOSS local-cuda trees and leaves == local on the card")
    check(np.array_equal(history.final_margin, local_history.final_margin),
          "GOSS final margins == local on the card")
    print(f"train GOSS local-cuda on {card}: {REF_ROUNDS} rounds, "
          f"{sum(f.feature.shape[0] for f in model.forests)} trees, "
          f"launches {launches}; GOSS invariants hold on all "
          f"{REF_ROUNDS} rounds; trees, leaves and final margins == local "
          f"on the card; final train {history.train[-1]}")
    print(f"train wall per round: GOSS {_walls_ms(history)}; uniform "
          f"{_walls_ms(uniform_history)}")
    print("train GOSS wall per round (ms): " + " ".join(
        f"{1e3 * w:.2f}" for w in history.wall_time_s))
    return {"launches": launches}


def phase_resume(device, card, train) -> dict:
    """Phase 4c: kill and resume the reference run.  Rounds [0, 8) from
    ``PRNGKey(0)`` (no masks input), ``save_train_state``,
    ``load_train_state``, then [8, 20) from the stored margins and the same
    key (the window replays the key chain): the stitched ``PackedEnsemble``
    equal, array for array, to the uninterrupted run's (phase 4), so the
    committed checkpoint's 78 trees; final margins bit-equal; 60
    round-histogram launches in all."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import boosting, prng
    from repro_torch.core.types import (
        PACKED_ARRAYS,
        EnsembleModel,
        pack_ensemble,
        unpack_ensemble,
    )
    from repro_torch.kernels.histogram import ops

    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    kw = dict(backend="local-cuda", device=device)
    ops.reset_launches()
    first, h1 = boosting.train_fedgbf(train["x_train"], train["y_train"],
                                      cfg, prng.PRNGKey(0, device),
                                      stop_round=RESUME_AT, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state")
        ckpt_io.save_train_state(path, first, h1.final_margin, RESUME_AT,
                                 "chip_smoke reference run")
        state = ckpt_io.load_train_state(path, device=device)
    check(state["completed_rounds"] == RESUME_AT, "state round count")
    rest, h2 = boosting.train_fedgbf(train["x_train"], train["y_train"], cfg,
                                     prng.PRNGKey(0, device),
                                     start_round=RESUME_AT,
                                     init_margin=state["margin"], **kw)
    torch.cuda.synchronize()
    launches = {name: ops.kernel_launches(name) for name in ops.KERNELS}
    check(launches["histogram_round"] == REF_HIST_LAUNCHES,
          f"resume: {launches['histogram_round']} round-histogram launches "
          f"== {REF_HIST_LAUNCHES}")
    prefix = unpack_ensemble(state["packed"])
    stitched = pack_ensemble(EnsembleModel(
        prefix.forests + rest.forests, rest.learning_rate, rest.base_score,
        rest.bin_edges, rest.loss, rest.max_depth))
    whole = pack_ensemble(train["model"])
    check(stitched.round_offsets == whole.round_offsets
          and stitched.total_trees == REF_TREES, "78 trees, same rounds")
    for f in PACKED_ARRAYS:
        check(torch.equal(getattr(stitched, f), getattr(whole, f)),
              f"resumed {f} == the uninterrupted run's")
    ckpt = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)
    check(torch.equal(stitched.feature, ckpt.feature)
          and torch.equal(stitched.threshold, ckpt.threshold),
          "resumed trees == the committed checkpoint's")
    check(np.array_equal(h2.final_margin, train["history"].final_margin),
          "resumed final margins == the uninterrupted run's, bit for bit")
    print(f"resume on {card}: rounds [0, {RESUME_AT}) + train state + "
          f"[{RESUME_AT}, {REF_ROUNDS}): packed ensemble == the "
          f"uninterrupted run's (all six arrays), {REF_TREES} trees == "
          f"checkpoint, final margins bit-equal; launches {launches}")
    return {"launches": launches}




VFL_PARTIES = 4
VFL_FEATURES = 24          # default_credit_card's 23 padded for 4 parties


def _padded_credit(parties: int):
    """default_credit_card with its features padded (constant columns) until
    ``parties`` divides them, as the launcher and the JAX package pad."""
    from repro_torch.data import synthetic, tabular

    ds = synthetic.load("default_credit_card")
    x_train, d = tabular.pad_features(np.asarray(ds.x_train), parties)
    x_test, _ = tabular.pad_features(np.asarray(ds.x_test), parties)
    return x_train, np.asarray(ds.y_train), x_test, d


def phase_vfl_train(device, card) -> dict:
    """Phase 4d: vertically federated training with 4 parties as column
    blocks on the card, ``dynamic_fedgbf_config(rounds=20)`` on
    ``default_credit_card`` padded to 24 features, masks drawn from
    ``PRNGKey(0)`` for 24 columns:

    * ``vfl-histogram``: exactly 60 round-histogram launches (one a level
      on the 21000 x 24 table, each party's histogram its column slice);
      trees, leaves and final margins ``torch.equal`` to a ``local-cuda``
      run on the same padded columns and masks; the wire-byte ledger (the
      dry probe) reconciled with the wire model on every phase, delta 0,
      and the run's own meter equal to the ledger's measured bytes; the
      test rows scored once through ``fused-cuda``, equal to the
      ``local-cuda`` model's scores; the round wall beside
      ``local-cuda``'s;
    * ``vfl-argmax``: 60 launches, trees equal to ``local-cuda``;
    * ``vfl-histogram-q8`` with the JAX rounding keys: trains (finite
      margins), 60 launches, the ledger reconciled, its histogram bytes (int8
      payload + scales) the wire model's and under the raw run's;
    * one party's launch (21000 x 6, the 5 trees of round 1, level 0)
      timed beside a full-width one (21000 x 24) and the plain version."""
    import torch

    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, forest, prng
    from repro_torch.core.types import pack_ensemble
    from repro_torch.federation import compress, protocol
    from repro_torch.kernels.ensemble_predict import ops as ep_ops
    from repro_torch.kernels.histogram import ops

    x_train, y_train, x_test, d = _padded_credit(VFL_PARTIES)
    check(d == VFL_FEATURES, f"features padded to {VFL_FEATURES}")
    n = x_train.shape[0]
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    tree = cfg.tree
    masks = forest.draw_step_masks(cfg, n, d, prng.PRNGKey(0, device))
    want_launches = REF_HIST_LAUNCHES       # one a level for all parties

    def train(backend):
        ops.reset_launches()
        model, history = boosting.train_fedgbf(
            x_train, y_train, cfg, masks=masks, backend=backend,
            device=device)
        torch.cuda.synchronize()
        return model, history, {k: ops.kernel_launches(k)
                                for k in ops.KERNELS}

    local, local_h, _ = train("local-cuda")
    meter = compress.MessageMeter()
    vfl = backend_mod.get_backend("vfl-histogram", tree=tree,
                                  num_parties=VFL_PARTIES, meter=meter)
    model, history, launches = train(vfl)
    for kernel in ("histogram_round", "histogram_sort"):
        check(launches[kernel] == want_launches,
              f"vfl-histogram: {launches[kernel]} {kernel} launches == "
              f"{REF_HIST_LAUNCHES}, one a level for {VFL_PARTIES} parties")
    check(_same_trees(model, local),
          "vfl-histogram trees, leaves == local-cuda's on the padded data")
    check(np.array_equal(history.final_margin, local_h.final_margin),
          "vfl-histogram final margins == local-cuda's, bit for bit")

    ledger = compress.reconciled_ledger(VFL_PARTIES, tree, cfg,
                                        n_samples=n, num_features=d)
    rec = ledger.reconcile()
    check(all(v["match"] and v["delta"] == 0 for v in rec.values()),
          f"wire bytes reconcile on every phase: {rec}")
    live = meter.phase_totals()
    passive = VFL_PARTIES - 1
    for phase, nbytes in live.items():
        mult = passive if phase in protocol.PER_PASSIVE_PHASES else 1
        check(mult * nbytes == ledger.measured[phase],
              f"the run's own meter, {phase}: {mult} x {nbytes} == the "
              f"ledger's {ledger.measured[phase]}")

    x_t = torch.from_numpy(np.ascontiguousarray(x_test)).to(device)
    ep_ops.reset_launches()
    fed_scores = boosting.predict(pack_ensemble(model), x_t,
                                  impl="fused-cuda")
    torch.cuda.synchronize()
    score_launches = ep_ops.kernel_launches("ensemble_predict_raw")
    check(score_launches == 1, f"scoring: {score_launches} launch == 1")
    check(torch.equal(fed_scores, boosting.predict(
        pack_ensemble(local), x_t, impl="fused-cuda")),
        f"{x_t.shape[0]} test rows scored by the federated model == the "
        "local-cuda model's, bit for bit")
    print(f"train vfl-histogram, {VFL_PARTIES} parties on {card}: "
          f"{n} x {d} rows ({d // VFL_PARTIES} columns a party), launches "
          f"{launches}; trees, leaves, margins and test scores == local-"
          f"cuda; wall per round {_walls_ms(history)}, local-cuda's "
          f"{_walls_ms(local_h)}; wire bytes "
          f"{rec['total']['measured']} measured == {rec['total']['predicted']}"
          f" predicted (match=True): " + ", ".join(
              f"{k} {v['measured']}" for k, v in rec.items()
              if k != "total" and v["measured"]))

    argmax, argmax_h, a_launches = train(backend_mod.get_backend(
        "vfl-argmax", tree=tree, num_parties=VFL_PARTIES))
    check(a_launches["histogram_round"] == want_launches,
          f"vfl-argmax: {a_launches['histogram_round']} launches")
    check(_same_trees(argmax, local)
          and np.array_equal(argmax_h.final_margin, local_h.final_margin),
          "vfl-argmax trees, leaves and margins == local-cuda's")
    print(f"train vfl-argmax on {card}: trees == local-cuda, "
          f"{a_launches['histogram_round']} launches, wall per round "
          f"{_walls_ms(argmax_h)}")

    _, q8_h, q_launches = train(backend_mod.get_backend(
        "vfl-histogram-q8", tree=tree, num_parties=VFL_PARTIES))
    check(q_launches["histogram_round"] == want_launches,
          f"vfl-histogram-q8: {q_launches['histogram_round']} launches")
    check(np.isfinite(q8_h.final_margin).all()
          and q8_h.final_margin.shape == (n,), "q8 margins finite, (n,)")
    q_rec = compress.reconciled_ledger(
        VFL_PARTIES, tree, cfg, transport=compress.Q8, n_samples=n,
        num_features=d).reconcile()
    check(all(v["match"] for v in q_rec.values()),
          f"q8 wire bytes reconcile: {q_rec}")
    q_hist, raw_hist = (q_rec["histograms"]["measured"],
                        rec["histograms"]["measured"])
    check(q_hist < raw_hist / 4, f"q8 histogram bytes {q_hist} under a "
          f"quarter of raw's {raw_hist}")
    print(f"train vfl-histogram-q8 on {card}: {q_launches['histogram_round']}"
          f" launches, final train {q8_h.train[-1]} (raw "
          f"{history.train[-1]}); histogram bytes {q_hist} measured == "
          f"predicted, raw {raw_hist} ({raw_hist / q_hist:.2f}x); wall per "
          f"round {_walls_ms(q8_h)}")
    timing = _time_party_launch(device, x_train, y_train, masks)
    return {"launches": launches, "timing": timing,
            "score_launches": score_launches, "model": model,
            "history": history, "local": local, "local_history": local_h,
            "masks": masks, "scores": fed_scores}


def _time_party_launch(device, x_train, y_train, masks) -> dict:
    """Each party's round-histogram launch at round 1's level-0 shape
    (21000 x 6, B = 32, 5 trees; the last block holds the constant pad
    column, one slot with every row) beside a full-width launch (21000 x
    24) in the same call, CUDA events; party 0's plain version and bound."""
    import torch

    from repro_torch.core import binning
    from repro_torch.core import objective as objective_mod
    from repro_torch.core.histogram import stack_stats
    from repro_torch.kernels.histogram import ops, ref

    x = torch.from_numpy(np.ascontiguousarray(x_train)).to(device)
    y = torch.from_numpy(y_train.astype(np.float32)).to(device)
    binned, _ = binning.fit_bin(x, 32)
    obj = objective_mod.get_objective("logistic")
    g, h = obj.grad_hess(y, obj.init_raw(x.shape[0], device=device))
    g2, h2 = g[:, None].contiguous(), h[:, None].contiguous()
    w = masks.sample[:5].to(device).contiguous()
    n, n_trees = binned.shape[0], w.shape[0]
    assign = torch.zeros((n_trees, n), dtype=torch.int32, device=device)
    d_party = binned.shape[1] // VFL_PARTIES
    blocks = [binned[:, p * d_party:(p + 1) * d_party].contiguous()
              for p in range(VFL_PARTIES)]

    def launch(keys):
        return ops.histogram_round(keys, assign, g2, h2, w, 1, 32, False)

    party_ms = [time_ms(lambda k=k: launch(k), iters=50, warmup=5)
                for k in blocks]
    full_ms = time_ms(lambda: launch(binned), iters=50, warmup=5)
    plain_ms = time_ms(lambda: ref.histogram_round_ref(
        blocks[0], assign, g2, h2, w, 1, 32, False), iters=5, warmup=1)
    # the library yardstick on party 0's block: one index_add_ over its
    # staged (tree, feature, bin) ids, as phase 7 times the full width
    flat_ids = ((torch.arange(n_trees, device=device)[:, None, None]
                 * d_party + torch.arange(d_party, device=device)) * 32
                + blocks[0].long()[None]).reshape(-1)      # (T*n*d_party,)
    rows = stack_stats(g, h, w)[:, :, None, :].expand(
        n_trees, n, d_party, 3).reshape(-1, 3).contiguous()
    acc = torch.zeros((n_trees * d_party * 32, 3), dtype=torch.float32,
                      device=device)
    library_ms = time_ms(lambda: acc.index_add_(0, flat_ids, rows),
                         iters=50, warmup=5)
    for p, block in enumerate(blocks):
        check(torch.equal(launch(block)[0], ref.histogram_round_ref(
            block, assign, g2, h2, w, 1, 32, False)),
            f"party {p}'s launch == its plain version")
    nbytes = (blocks[0].numel() * 4 + 2 * assign.numel() * 4
              + 2 * g2.numel() * 4 + n_trees * d_party * 32 * 3 * 4)
    bound_ms, bound_by = hist_bound(nbytes, float((w != 0).sum()) * d_party
                                    * 3)
    print(f"time histogram_round party blocks {n}x{d_party} T={n_trees} "
          f"level 0: kernel " + " / ".join(f"{ms:.5f}" for ms in party_ms)
          + f" ms (parties 0-{VFL_PARTIES - 1}; sum {sum(party_ms):.5f}), "
          f"full width {n}x{binned.shape[1]} {full_ms:.5f} ms in the same "
          f"call; party 0: longest segment "
          f"{longest_segment(ops.sort_slots(blocks[0], assign, 1, 32)[1])} "
          f"rows, plain {plain_ms:.4f} ms, index_add_ {library_ms:.5f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}); last party's longest "
          "segment "
          f"{longest_segment(ops.sort_slots(blocks[-1], assign, 1, 32)[1])}"
          " rows")
    return {"party_ms": party_ms[0], "parties_ms": party_ms,
            "full_ms": full_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms}


#: phase 4e's chaos spec, party-dropout schedule and data shards
CHAOS = dict(drop=0.05, corrupt=0.02, dup=0.02, delay=0.02, seed=13)
DROPOUT = dict(rate=0.4, seed=0, max_retries=1)
DATA_SHARDS = 2
SHARD_WINDOW = 5           # rounds of the sharded run held against the CPU


def phase_vfl_runtime(device, card, vfl) -> dict:
    """Phase 4e: the rest of the federation on phase 4d's cell (4 parties,
    21,000 x 24, masks from ``PRNGKey(0)``), each run's launches counted
    from 0:

    * chaos: ``vfl-histogram-chaos`` and ``vfl-argmax-topk-chaos`` under
      ``CHAOS``: trees, leaves, margins and test scores ``torch.equal`` to
      the fault-free twin's; the probe's ``retries`` bytes equal
      ``wire_retry_bytes`` (the ledger reconciled) and the run's own meter
      the plan replayed at each round's trees; the injected faults equal
      ``plan_summary`` times the rounds;
    * party dropout: ``vfl-histogram`` under ``DROPOUT``'s
      ``round_feature_mask``: ``torch.equal`` to ``local-cuda`` under the
      same mask, no split on a degraded column;
    * the gradient-less fallback over the 4 parties (every one of them
      degraded in some round): 4 party fits on ``local-cuda``, 4 x 60
      launches; the margin/rate ledger equal to ``wire_cost``, the rate
      fit no worse than the concatenation;
    * the data axis: ``vfl-histogram-sharded`` over 2 row shards, one
      launch a level; rounds 1-5 ``torch.equal`` to the same backend on
      CPU tensors (the plain versions); the trees equal to 4d's unsharded
      ones and the margins' max difference printed;
    * the port's selftest lattice with ``--device cuda``, every check
      passing, its wall printed.

    Every run's round wall is printed beside 4d's ``vfl-histogram``."""
    import contextlib
    import io

    import torch

    from repro_torch.core import backend as backend_mod
    from repro_torch.core import boosting, dynamic, prng
    from repro_torch.core.types import pack_ensemble
    from repro_torch.federation import chaos as chaos_mod
    from repro_torch.federation import (compress, gradientless, protocol,
                                        runtime, selftest)
    from repro_torch.kernels.ensemble_predict import ops as ep_ops
    from repro_torch.kernels.histogram import ops

    x_train, y_train, x_test, d = _padded_credit(VFL_PARTIES)
    n = x_train.shape[0]
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    tree, masks = cfg.tree, vfl["masks"]
    x_t = torch.from_numpy(np.ascontiguousarray(x_test)).to(device)
    want_fed = REF_HIST_LAUNCHES            # one a level for all parties
    base_wall = _walls_ms(vfl["history"])
    launches = {}

    def train(label, backend, dev=device, **kw):
        ops.reset_launches()
        model, history = boosting.train_fedgbf(
            x_train, y_train, cfg, masks=masks, backend=backend, device=dev,
            **kw)
        if dev == device:
            torch.cuda.synchronize()
        launches[label] = ops.kernel_launches("histogram_round")
        check(ops.kernel_launches("histogram_sort") == launches[label],
              f"{label}: every histogram launch sorted once")
        return model, history

    def score(model, packed=None):
        ep_ops.reset_launches()
        out = boosting.predict(packed if packed is not None
                               else pack_ensemble(model), x_t,
                               impl="fused-cuda")
        torch.cuda.synchronize()
        check(ep_ops.kernel_launches("ensemble_predict_raw") == 1,
              "one scoring launch")
        launches["scoring"] = launches.get("scoring", 0) + 1
        return out

    def same_run(a, a_h, b, b_h) -> bool:
        return (_same_trees(a, b)
                and np.array_equal(a_h.final_margin, b_h.final_margin))

    # chaos: bit-identity with the fault-free twins, exact retry bytes
    spec = chaos_mod.ChaosSpec(**CHAOS)
    twins = {"vfl-histogram": (vfl["model"], vfl["history"],
                               vfl["scores"])}
    for name, agg, transport in (
            ("vfl-histogram", "histogram", None),
            ("vfl-argmax-topk", "argmax", compress.TOPK)):
        if name not in twins:
            model, hist = train(name, backend_mod.get_backend(
                name, tree=tree, num_parties=VFL_PARTIES))
            twins[name] = (model, hist, score(model))
        base, base_h, base_scores = twins[name]
        meter = compress.MessageMeter()
        label = name + "-chaos"
        model, hist = train(label, backend_mod.get_backend(
            label, tree=tree, num_parties=VFL_PARTIES, meter=meter,
            chaos=spec))
        check(launches[label] == want_fed,
              f"{label}: {launches[label]} launches == {want_fed}")
        check(same_run(model, hist, base, base_h)
              and torch.equal(score(model), base_scores),
              f"{label} under {spec.tag}: trees, leaves, margins and test "
              f"scores == {name}'s, bit for bit")
        ledger = compress.reconciled_ledger(
            VFL_PARTIES, tree, cfg, aggregation=agg, transport=transport,
            n_samples=n, num_features=d, chaos=spec)
        rec = ledger.reconcile()
        d_party = d // VFL_PARTIES
        per_tree = protocol.wire_retry_bytes(
            spec, d_party, tree.num_bins, tree.max_depth, agg, transport,
            tree.hist_subtraction)
        check(ledger.matches()
              and ledger.probe["per_tree"]["retries"] == per_tree,
              f"{label}: probe retries {ledger.probe['per_tree']['retries']}"
              f" == wire_retry_bytes {per_tree}; ledger {rec}")
        slots = protocol._chaos_slot_bytes(d_party, tree.num_bins,
                                           tree.max_depth, agg, transport,
                                           tree.hist_subtraction)
        n_slots = len(slots)
        replay = 0
        for m in range(1, cfg.rounds + 1):
            trees_m = dynamic.n_trees_schedule(cfg, m)
            for s_, payload in enumerate(slots):
                tx = chaos_mod.transmissions_for_slot(spec, s_)
                replay += (tx * chaos_mod.CHECKSUM_BYTES
                           + (tx - 1) * trees_m * payload)
        live = meter.phase_totals()["retries"]
        check(live == replay, f"{label}: the run's retries bytes {live} == "
              f"the plan replayed at the run's trees {replay}")
        plan = chaos_mod.plan_summary(spec, n_slots)
        want_events = {k: cfg.rounds * plan[k] for k in
                       ("dropped", "corrupted", "duplicated", "delayed",
                        "retries")}
        check(meter.events == want_events,
              f"{label}: injected {meter.events} == {cfg.rounds} rounds x "
              f"plan_summary {want_events}")
        print(f"train {label} on {card}: {launches[label]} launches; "
              f"{spec.tag}: {meter.events} over {cfg.rounds} rounds of "
              f"{n_slots} slots; trees, leaves, margins and scores == "
              f"{name}; retries {rec['retries']['measured']} B measured == "
              f"predicted (per tree {per_tree} B), the run's {live} B; wall "
              f"per round {_walls_ms(hist)} ({name}: {_walls_ms(base_h)}; "
              f"4d vfl-histogram {base_wall})")

    # party dropout: the masked federated run == the masked local-cuda run
    sched = runtime.dropout_schedule(
        DROPOUT["rate"], cfg.rounds, VFL_PARTIES, seed=DROPOUT["seed"],
        policy=runtime.RetryPolicy(max_retries=DROPOUT["max_retries"]))
    rmask = runtime.degradation_masks(sched.degraded, d, VFL_PARTIES)
    degraded = runtime.degraded_parties(sched)
    check(rmask is not None and degraded == list(range(VFL_PARTIES)),
          f"dropout schedule degrades every party in some round: {degraded}")
    local, local_h = train("local-cuda masked", "local-cuda",
                           round_feature_mask=rmask)
    model, hist = train("vfl-histogram masked", backend_mod.get_backend(
        "vfl-histogram", tree=tree, num_parties=VFL_PARTIES),
        round_feature_mask=rmask)
    check(launches["vfl-histogram masked"] == want_fed,
          f"masked vfl-histogram: {launches['vfl-histogram masked']} "
          "launches")
    check(same_run(model, hist, local, local_h)
          and torch.equal(score(model), score(local)),
          "masked vfl-histogram: trees, leaves, margins and test scores == "
          "masked local-cuda's, bit for bit")
    packed = pack_ensemble(model)
    selftest.assert_no_banned_splits(packed, rmask)
    check(not _same_trees(model, vfl["model"]),
          "the mask changed the trees")
    print(f"train vfl-histogram, party dropout {DROPOUT} on {card}: "
          f"{int(sched.degraded.sum())} degraded (round, party) cells in "
          f"{sched.degraded_rounds} rounds, {int(sched.retries.sum())} "
          f"retries, backoff {sched.backoff_s:.2f} s simulated; "
          f"{launches['vfl-histogram masked']} launches; == masked "
          f"local-cuda, no split on a degraded column; wall per round "
          f"{_walls_ms(hist)} (4d {base_wall})")

    # the gradient-less fallback for the degraded parties (all 4)
    meter = compress.MessageMeter()
    ops.reset_launches()
    t0 = time.perf_counter()
    gl_packed, info = gradientless.train_gradientless(
        x_train, y_train, cfg, prng.PRNGKey(1000), VFL_PARTIES, meter=meter,
        device=device)
    torch.cuda.synchronize()
    gl_s = time.perf_counter() - t0
    launches["gradientless"] = ops.kernel_launches("histogram_round")
    check(ops.kernel_launches("histogram_sort") == launches["gradientless"],
          "gradient-less: every histogram launch sorted once")
    check(launches["gradientless"] == VFL_PARTIES * REF_HIST_LAUNCHES,
          f"gradient-less: {launches['gradientless']} launches == "
          f"{VFL_PARTIES} party fits x {REF_HIST_LAUNCHES}")
    want = gradientless.wire_cost(n, info["tree_counts"])
    got = meter.phase_totals()
    check(all(got.get(k, 0) == v for k, v in want.items() if k != "total")
          and sum(got.values()) == want["total"],
          f"gradient-less ledger {got} == wire_cost {want}")
    check(info["loss_after"] <= info["loss_before"] + 1e-6,
          f"rate fit: loss {info['loss_before']} -> {info['loss_after']}")
    gl_scores = score(None, gl_packed)
    check(bool(torch.isfinite(gl_scores).all()), "gradient-less scores "
          "finite")
    print(f"gradient-less fallback on {card}: parties {degraded}, "
          f"{launches['gradientless']} launches, {gl_s:.2f} s for 4 party "
          f"fits and the 300-step rate fit; loss {info['loss_before']:.6f} "
          f"-> {info['loss_after']:.6f}; ledger {got} == wire_cost")

    # the data axis: 2 row shards, still one launch a level
    def sharded():
        return backend_mod.get_backend(
            "vfl-histogram-sharded", tree=tree, num_parties=VFL_PARTIES,
            data_shards=DATA_SHARDS)

    model, hist = train("vfl-histogram-sharded", sharded())
    check(launches["vfl-histogram-sharded"] == want_fed,
          f"sharded: {launches['vfl-histogram-sharded']} launches == "
          f"{REF_HIST_LAUNCHES}, one a level for {DATA_SHARDS} shards x "
          f"{VFL_PARTIES} parties")
    win, win_h = train("sharded window", sharded(), stop_round=SHARD_WINDOW)
    cpu, cpu_h = train("sharded window, CPU", sharded(), dev="cpu",
                       stop_round=SHARD_WINDOW)
    fields = ("feature", "threshold", "gain", "leaf_weight")
    check(len(win.forests) == len(cpu.forests) == SHARD_WINDOW
          and all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                  and torch.equal(getattr(a, f), getattr(c, f))
                  for a, b, c in zip(win.forests, cpu.forests,
                                     model.forests)
                  for f in fields)
          and np.array_equal(win_h.final_margin, cpu_h.final_margin),
          f"sharded rounds 1-{SHARD_WINDOW} on the card == on CPU tensors "
          "(plain versions), and == the full run's first rounds")
    fed = vfl["model"]
    same = sum(torch.equal(a.feature[t], b.feature[t])
               and torch.equal(a.threshold[t], b.threshold[t])
               for a, b in zip(model.forests, fed.forests)
               for t in range(a.feature.shape[0]))
    total = sum(f.feature.shape[0] for f in fed.forests)
    margin_diff = float(np.abs(hist.final_margin
                               - vfl["history"].final_margin).max())
    sh_scores = score(model)
    check(bool(torch.isfinite(sh_scores).all()), "sharded scores finite")
    print(f"train vfl-histogram-sharded, {DATA_SHARDS} row shards x "
          f"{VFL_PARTIES} parties on {card}: "
          f"{launches['vfl-histogram-sharded']} launches; rounds 1-"
          f"{SHARD_WINDOW} == the CPU run; {same} of {total} trees' "
          f"features and thresholds == 4d's unsharded, final margins max "
          f"|diff| {margin_diff:.3g}; wall per round {_walls_ms(hist)} (4d "
          f"{base_wall})")

    # the port's selftest lattice on the card
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = selftest.main(["--device", "cuda"])
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines and lines[-1].startswith("ALL FEDERATION"),
          f"selftest on the card: {lines[-3:]}")
    print(f"selftest --device cuda on {card}: "
          f"{sum(line.startswith('OK') for line in lines)} checks passed in "
          f"{time.perf_counter() - t0:.2f} s ({lines[-1]})")
    return launches


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


def _launch(argv: list, want: str, env: dict) -> str:
    """Run one launcher (``python -m ...``) to its end; it must exit 0 and
    print ``want``.  Returns its output."""
    proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{' '.join(argv)} exits 0 (exit "
          f"{proc.returncode}: {proc.stderr[-2000:]})")
    check(want in proc.stdout, f"{' '.join(argv)} prints {want!r}")
    return proc.stdout


def phase_launchers(device) -> None:
    """Phase 6, the launchers, in six chains run side by side (both
    launchers default to cuda):

    * ``train_fedgbf --rounds 6 --checkpoint P --checkpoint-every 2
      --stop-after-round 3``, then the same with ``--resume``;
    * ``train_fedgbf --rounds 6 --checkpoint Q``, uninterrupted: P's
      packed model and margins must equal Q's;
    * ``train_fedgbf --rounds 3 --sampling goss``;
    * ``train_fedgbf --checkpoint R`` at its defaults (20 rounds, the full
      ``default_credit_card``, no ``--masks``: the draws of
      ``PRNGKey(0)``): R's packed model must be the committed checkpoint
      (trees exact, leaves within ``TRAIN_ATOL``);
    * ``train_fedgbf --backend vfl-histogram --parties 4`` with the chaos
      flags, ``--party-dropout 0.5 --retry-max 0 --dropout-fallback
      gradientless`` (every party degraded in some round), then
      ``--backend vfl-histogram-sharded --data-shards 2``;
    * ``serve_fedgbf --rounds 3 --save S``, then ``serve_fedgbf
      --checkpoint S --quantize 8 --metrics-port 0``, which prints its
      self-scrape line."""
    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core.types import PACKED_ARRAYS

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    train, serve_cli = ("repro_torch.launch.train_fedgbf",
                        "repro_torch.launch.serve_fedgbf")
    with tempfile.TemporaryDirectory() as tmp:
        part, whole, saved, ref = (os.path.join(tmp, f)
                                   for f in ("part", "whole", "saved", "ref"))
        chunked = [train, "--rounds", "6", "--checkpoint", part,
                   "--checkpoint-every", "2"]
        chains = {
            "kill and resume": [
                (chunked + ["--stop-after-round", "3"],
                 "stopped after round 3"),
                (chunked + ["--resume"], "resume: 3 completed rounds")],
            "uninterrupted": [([train, "--rounds", "6", "--checkpoint",
                                whole], "checkpoint: 6 rounds")],
            "goss": [([train, "--rounds", "3", "--sampling", "goss"],
                      "sampling=goss")],
            "defaults": [([train, "--checkpoint", ref],
                          "checkpoint: 20 rounds")],
            "federation runtime": [
                ([train, "--rounds", "3", "--backend", "vfl-histogram",
                  "--parties", "4", "--chaos-drop", "0.05",
                  "--chaos-corrupt", "0.02", "--chaos-dup", "0.02",
                  "--chaos-seed", "13", "--party-dropout", "0.5",
                  "--retry-max", "0", "--dropout-fallback", "gradientless"],
                 "gradientless fallback: party 3"),
                ([train, "--rounds", "3", "--backend",
                  "vfl-histogram-sharded", "--parties", "4",
                  "--data-shards", "2"], "4 parties x 2 data shards")],
            "quantized serving": [
                ([serve_cli, "--rounds", "3", "--save", saved, "--requests",
                  "20000"], "saved packed checkpoint"),
                ([serve_cli, "--checkpoint", saved, "--quantize", "8",
                  "--metrics-port", "0", "--requests", "20000"],
                 "self-scrape http://127.0.0.1:")],
        }

        def run(chain):
            return [_launch(argv, want, env) for argv, want in chain]

        with ThreadPoolExecutor(max_workers=len(chains)) as pool:
            outs = dict(zip(chains, pool.map(run, chains.values())))
        for name, chain in chains.items():
            for (argv, want), out in zip(chain, outs[name]):
                label = " ".join(os.path.basename(a) for a in argv)
                print(f"launcher {label} ({name}): exit 0")
                for line in out.strip().splitlines()[-3:]:
                    print(f"  {line}")
        resumed = ckpt_io.load_train_state(part, device=device)
        straight = ckpt_io.load_train_state(whole, device=device)
        defaults = ckpt_io.load_train_state(ref, device=device)["packed"]
    committed = ckpt_io.load_ensemble(str(CHECKPOINT), device=device)
    check(defaults.round_offsets == committed.round_offsets
          and defaults.total_trees == REF_TREES,
          f"launcher defaults: {REF_TREES} trees, the checkpoint's rounds")
    for f in ("bin_edges", "feature", "threshold"):
        check(torch.equal(getattr(defaults, f), getattr(committed, f)),
              f"launcher defaults: {f} == the committed checkpoint's")
    leaf_diff = float((defaults.leaf_weight
                       - committed.leaf_weight).abs().max())
    check(leaf_diff <= TRAIN_ATOL, f"launcher defaults: leaves within "
          f"{TRAIN_ATOL} of the committed checkpoint's (max |diff| "
          f"{leaf_diff})")
    print(f"launchers: train_fedgbf at its defaults (no --masks) saved the "
          f"committed checkpoint's {REF_TREES} trees, leaves max |diff| "
          f"{leaf_diff:.3g}")
    check(resumed["completed_rounds"] == straight["completed_rounds"] == 6,
          "both states hold 6 rounds")
    for f in PACKED_ARRAYS:
        check(torch.equal(getattr(resumed["packed"], f),
                          getattr(straight["packed"], f)),
              f"killed-and-resumed {f} == the uninterrupted run's")
    check(np.array_equal(resumed["margin"], straight["margin"]),
          "killed-and-resumed margins == the uninterrupted run's")
    print("launchers: the killed and resumed run's train state == the "
          "uninterrupted run's (packed model and margins)")


#: phase 6b: SmolLM-135M at full width (``get_config``, the launchers'
#: default ``--arch``)
LM_ARCH = "smollm-135m"
LM_TRAIN = (30, 8, 256)   # steps, batch, seq of the launcher's run
LM_PARITY_SHAPE = (2, 64)  # batch x seq of the card-vs-CPU train step
# card vs CPU loss and grad norm, f32, TF32 off: measured 8.7e-8 and
# 7.1e-8 relative (NVIDIA H100 80GB HBM3, 700 W)
LM_PARITY_RTOL = 1e-6
LM_SERVE = (4, 32, 32)     # batch, prompt, generated tokens
LM_DECODE_ATOL = 1e-3      # decode vs forward logits in f32 (the JAX test's)
# smoke logits vs the committed JAX logits, as the CPU tests hold them;
# RWKV's chunked WKV forms exp(+-cumulated log decay) over 16-token chunks
# (a range to e^43) and amplifies last-bit differences: on the CPU JAX's
# own chunked forward and per-token decode differ by 7.2e-5, the port's
# and JAX's forwards by 1.8e-4 (logits up to 4.2)
LM_SMOKE_ATOL = 1e-4
LM_SMOKE_ATOL_RWKV = 5e-4
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12


def _lm_decode_error(model, tokens) -> float:
    """Max |decode_step logits - forward logits| over every position."""
    import torch

    with torch.no_grad():
        full, _ = model(tokens)
        cache = model.init_cache(*tokens.shape)
        worst = 0.0
        for t in range(tokens.shape[1]):
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    return worst


def phase_lm_full(device, card) -> dict:
    """Phase 6b: SmolLM-135M at full width (30 layers, d 576, 9/3 heads,
    vocab 49152; f32 params, bf16 compute), the JAX init from
    ``PRNGKey(0)``, drawn on the card.

    * ``launch.train``'s path: 30 steps at batch 8 x seq 256 of
      ``MarkovZipfSource`` batches; every ce finite, the mean of the last
      10 below the mean of the first 10; tokens/s over steps 11-30.
    * One train step at batch 2 x seq 64 in f32 (TF32 off) from the same
      weights (``PRNGKey(1)``, drawn on the card) on the card and on the
      CPU: loss and grad norm within ``LM_PARITY_RTOL``.
    * ``launch.serve.generate`` on the trained model: batch 4, prompt 32,
      32 greedy tokens, timed on its second call (every step one
      ``decode_step`` over the batch); then in f32, every decode step's
      logits within ``LM_DECODE_ATOL`` of the full forward's."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data import tokens as tokens_mod
    from repro_torch.launch import serve as serve_mod, train as train_mod
    from repro_torch.models import train as lm_train
    from repro_torch.models.model import LMModel

    cfg = get_config(LM_ARCH)
    n_params = cfg.flops_params()
    torch.cuda.reset_peak_memory_stats()
    steps, batch, seq = LM_TRAIN
    run = train_mod.run(train_mod.parse_args([
        "--arch", LM_ARCH, "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq)]))
    losses, walls = run["losses"], run["walls"]
    check(bool(np.isfinite(losses).all()), "every train ce is finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"last-10 mean ce {last:.4f} < first-10 {first:.4f}")
    train_tok_s = batch * seq * (len(walls) - 10) / (walls[-1] - walls[9])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm train {LM_ARCH}: {n_params:,} params, ce {first:.4f} -> "
          f"{last:.4f}, {train_tok_s:,.0f} tok/s (steps 11-30), model "
          f"FLOPs 6N x tok/s = {6 * n_params * train_tok_s / 1e12:.2f} "
          f"TFLOP/s, {6 * n_params * train_tok_s / BF16_OPS_PER_S:.2%} of "
          f"the bf16 peak; peak memory {peak_gb:.2f} GB | {card}")

    # one f32 step from the same weights, on the card and on the CPU
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    card_model = LMModel(cfg32, device, prng.PRNGKey(1))
    cpu_model = copy.deepcopy(card_model).to("cpu")
    raw = next(tokens_mod.batches(cfg.vocab, *LM_PARITY_SHAPE, seed=1,
                                  num_batches=1))
    step = lm_train.make_train_step(cfg32)
    got = {}
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        state = lm_train.init_train_state(None, cfg32, model=model)
        _, m = step(state, train_mod.to_device(raw, model.embed.tokens.device))
        got[where] = (float(m["loss"]), float(m["grad_norm"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(got["card"], got["cpu"])]
    print(f"lm train step f32, card vs CPU ({LM_PARITY_SHAPE[0]}x"
          f"{LM_PARITY_SHAPE[1]}): loss {got['card'][0]:.7f} / "
          f"{got['cpu'][0]:.7f} (rel {rel[0]:.2e}), grad norm "
          f"{got['card'][1]:.6f} / {got['cpu'][1]:.6f} (rel {rel[1]:.2e})")
    check(max(rel) <= LM_PARITY_RTOL,
          f"card vs CPU train step within rel {LM_PARITY_RTOL}")
    del cpu_model

    # serving: greedy generate on the trained model, bf16 compute
    b, p_len, gen = LM_SERVE
    model = run["state"].model
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, p_len))).to(device)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_mod.generate(model, prompts, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(out.shape == (b, p_len + gen) and bool((out >= 0).all())
          and bool((out < cfg.vocab).all()), "generate's tokens")
    decode_tok_s = b * (p_len + gen) / walls[1]
    print(f"lm serve {LM_ARCH}: batch {b}, prompt {p_len}, gen {gen}: "
          f"{walls[1] * 1e3:.1f} ms ({walls[0] * 1e3:.1f} ms first call), "
          f"{decode_tok_s:,.0f} decode tok/s, "
          f"{(p_len + gen) / walls[1]:,.1f} steps/s; model FLOPs 2N x tok/s "
          f"{2 * n_params * decode_tok_s / BF16_OPS_PER_S:.4%} of the bf16 "
          f"peak | {card}")
    err = _lm_decode_error(card_model, out)
    print(f"lm decode f32 vs forward, {b}x{p_len + gen}: max |diff| {err:.3e}")
    check(err < LM_DECODE_ATOL, f"f32 decode within {LM_DECODE_ATOL} of "
          "the forward")

    # where the time goes: two more train steps, eight decode steps
    step = lm_train.make_train_step(cfg, peak_lr=3e-4, warmup=4,
                                    total_steps=30)
    raws = tokens_mod.batches(cfg.vocab, batch, seq, seed=2, num_batches=2)
    batches = [train_mod.to_device(r, device) for r in raws]
    _lm_profile("train step", 2, lambda: [
        float(step(run["state"], bt)[1]["ce"]) for bt in batches])
    _lm_profile("decode step", 8, lambda: serve_mod.generate(
        model, prompts[:, :4], 4).cpu())
    return {"train_tok_s": train_tok_s, "decode_tok_s": decode_tok_s,
            "parity_rel": rel, "decode_err": err}


def _lm_profile(what: str, n: int, fn) -> None:
    """``torch.profiler`` over ``fn`` (n steps of ``what``): wall, device
    busy time and its share of the wall (the profiler's own host cost
    included, so a lower bound), kernels launched, and the kernels that
    take most of the device time, per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (the optimizer's step range) are spans, not work
    spans = {e.key for e in prof.key_averages()
             if getattr(e, "is_user_annotation", False)
             or e.key.startswith("Optimizer.")}
    times = {k: us for k, us in device_times(prof).items() if k not in spans}
    if not times:
        print(f"profile lm {what}: device time not measured")
        return
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in spans)
    busy_ms = sum(times.values()) / 1e3
    print(f"profile lm {what}: wall {wall_ms / n:.2f} ms, device busy "
          f"{busy_ms / n:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall, "
          f"profiler on), {launches / n:,.0f} device activities a step")
    for key, us in sorted(times.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / n:9.1f} us/step  {key[:90]}")


def phase_lm_smoke(device) -> float:
    """Phase 6c: every architecture's smoke config (and mixtral's at
    window 8) forward and decode on the card in f32, on the committed
    weights' draw, against the committed JAX logits (the first
    ``LM_COLS`` columns) within ``lm_smoke_atol``; decode against the
    card's forward within ``LM_DECODE_ATOL`` (but pixtral, whose stub
    patches only the forward sees).  Returns the worst logit error."""
    import torch

    from repro_torch import convert

    data = np.load(LM_LOGITS)
    worst = 0.0
    for key, cfg, seq in lm_smoke_cases():
        model = convert.lm_params_from_numpy(
            cfg, convert.lm_numpy_params(cfg, LM_WEIGHT_SEED), device)
        tokens, stubs = lm_case_inputs(cfg, seq)
        tokens = torch.from_numpy(tokens).long().to(device)
        stubs = {k: torch.from_numpy(v).to(device) for k, v in stubs.items()}
        with torch.no_grad():
            logits, aux = model(tokens, **stubs)
            cache = model.init_cache(*tokens.shape)
            if cfg.encoder is not None:
                cache = model.fill_cross_cache(cache,
                                               model.encode(stubs["frames"]))
            decode = []
            for t in range(seq):
                lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
                decode.append(lg[:, 0])
        decode = torch.stack(decode, dim=1)
        fwd_err = float(np.abs(logits[..., :LM_COLS].cpu().numpy()
                               - data[f"{key}/logits"]).max())
        dec_err = float(np.abs(decode[..., :LM_COLS].cpu().numpy()
                               - data[f"{key}/decode"]).max())
        aux_err = abs(float(aux) - float(data[f"{key}/aux"]))
        self_err = float((decode - logits).abs().max())
        print(f"lm smoke {key}: forward {fwd_err:.2e}, decode {dec_err:.2e} "
              f"vs JAX; aux {aux_err:.2e}; decode vs forward {self_err:.2e}")
        check(bool(torch.isfinite(logits).all()), f"{key}: finite logits")
        atol = lm_smoke_atol(cfg)
        check(max(fwd_err, dec_err) <= atol,
              f"{key}: logits within {atol} of JAX's")
        check(aux_err <= 1e-6, f"{key}: aux within 1e-6 of JAX's")
        if cfg.frontend != "vision_stub":
            check(self_err < LM_DECODE_ATOL, f"{key}: decode == forward")
        worst = max(worst, fwd_err, dec_err)
    return worst


#: phase 8a: the dry-run's one-card case at phase 6b's train shape and a
#: decode step at phase 6b's serving batch (its cache: prompt + generated)
DRY_TRAIN = ("smollm_8x256", "train", 256, 8)
DRY_DECODE = ("smollm_decode_b4", "decode", 64, 4)
#: the caching allocator's rounding of one tensor: 512 B under 1 MiB; a
#: larger block is not split when less than 1 MiB would remain, so it may
#: hold up to 1 MiB more than the tensor
ALLOC_SMALL, ALLOC_LARGE = 512, 1 << 20
#: the card's peak vs the dry-run's (arguments + the counter's live peak):
#: measured +2.04% in two runs (NVIDIA H100 80GB HBM3, 700.00 W); the card
#: adds cuBLAS workspaces and kernels' temporaries, which no aten op returns
PEAK_RTOL = 0.05


def _step_ms(fn, n: int) -> float:
    """Mean host wall (ms) of ``n`` calls of ``fn``, the device
    synchronised after the last (one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_dryrun_card(device, card) -> dict:
    """Phase 8a: the dry-run's one-card case against the card.

    ``dryrun.run_one`` counts SmolLM-135M's train step at phase 6b's shape
    (8 x 256; f32 params, bf16 compute, remat on) on a (1, 1) mesh, on
    ``meta``; then one real step on the card under the same
    ``CostCounter``: its FLOPs must equal the dry-run's exactly; the train
    state and batch on the card must hold the dry-run's argument bytes
    exactly (but the int64 token indices the model takes and the step,
    which AdamW keeps on the host), and ``memory_allocated`` them up to
    the allocator's rounding; the card's peak (``max_memory_allocated``)
    must sit within ``PEAK_RTOL`` of the dry-run's.  The roofline's
    compute and memory times are printed beside the measured step time.
    Then the same for one decode step at batch 4 (FLOPs exact)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data import tokens as tokens_mod
    from repro_torch.launch import dryrun, shapes, train as train_mod
    from repro_torch.launch.mesh import AbstractMesh, HBM_BYTES
    from repro_torch.models import train as lm_train
    from repro_torch.tools.roofline import CostCounter

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun card: total_memory {total:,} B, launch.mesh.HBM_BYTES "
          f"{HBM_BYTES:,} B | {card}")
    mesh = AbstractMesh({"data": 1, "model": 1})
    cfg = get_config(LM_ARCH)
    spec = shapes.ShapeSpec(*DRY_TRAIN)
    t0 = time.perf_counter()
    report = dryrun.run_one(LM_ARCH, spec, False, save=False, mesh=mesh)
    dry_s = time.perf_counter() - t0
    check(report["status"] == "ok", f"dry-run {report['tag']} ok: "
          f"{report.get('error')}")
    roof, mem = report["roofline"], report["memory"]
    dry_args = mem["argument_bytes_per_device"]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = lm_train.init_train_state(prng.PRNGKey(0), cfg, device)
    raw = next(tokens_mod.batches(cfg.vocab, spec.global_batch, spec.seq_len,
                                  seed=0, num_batches=1))
    batch = train_mod.to_device(raw, device)
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - base
    tensors = [t for p in state.model.parameters()
               for t in (p, state.opt.state[p]["m"], state.opt.state[p]["v"])]
    tensors += list(batch.values())
    card_bytes = sum(t.numel() * t.element_size() for t in tensors)
    slack = sum(ALLOC_LARGE if t.numel() * t.element_size() >= ALLOC_LARGE
                else ALLOC_SMALL for t in tensors)
    index_extra = sum(t.numel() * 4 for t in batch.values())  # int64 - int32
    step = lm_train.make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    with CostCounter() as counter:
        step(state, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    dry_peak = mem["peak_bytes_per_device"] + index_extra
    step_ms = _step_ms(lambda: step(state, batch), 5)
    bound_s = max(roof["compute_s"], roof["memory_s"])
    print(f"dryrun train {report['tag']}: counted in {dry_s:.1f} s; FLOPs "
          f"{roof['flops']:.6e} meta == {counter.flops:.6e} card; arguments"
          f" {dry_args:,} B dry, the card's tensors {card_bytes:,} B "
          f"({index_extra:,} B of int64 indices, no 4 B step tensor), "
          f"allocated {card_args:,} B (+{card_args - card_bytes:,} B of "
          f"rounding, at most {slack:,}); peak {dry_peak:,} B dry (temp "
          f"{mem['temp_bytes_per_device']:,}) vs {card_peak:,} B card "
          f"({card_peak / dry_peak - 1:+.4%}; the card's counter peak "
          f"{counter.peak:,} B); step {step_ms:.2f} ms measured vs roofline "
          f"compute {roof['compute_s'] * 1e3:.4f} ms, memory "
          f"{roof['memory_s'] * 1e3:.4f} ms ({step_ms / 1e3 / bound_s:.1f}x "
          f"the larger) | {card}")
    check(counter.flops == roof["flops"],
          "the card's train-step FLOPs == the dry-run's")
    check(card_bytes == dry_args - 4 + index_extra,
          "the card's train state and batch == the dry-run's arguments")
    check(0 <= card_args - card_bytes <= slack,
          "memory_allocated within the allocator's rounding of them")
    check(abs(card_peak / dry_peak - 1) <= PEAK_RTOL,
          f"the card's peak within {PEAK_RTOL:.0%} of the dry-run's")

    dspec = shapes.ShapeSpec(*DRY_DECODE)
    dreport = dryrun.run_one(LM_ARCH, dspec, False, save=False, mesh=mesh)
    check(dreport["status"] == "ok", f"dry-run {dreport['tag']} ok")
    model = state.model
    del state, step
    cache = model.init_cache(dspec.global_batch, dspec.seq_len)
    token = torch.zeros((dspec.global_batch, 1), dtype=torch.long,
                        device=device)
    pos = dspec.seq_len - 1
    with torch.no_grad():
        with CostCounter() as dcounter:
            model.decode_step(cache, token, pos)
        decode_ms = _step_ms(lambda: model.decode_step(cache, token, pos),
                             20)
    droof = dreport["roofline"]
    print(f"dryrun decode {dreport['tag']}: FLOPs {droof['flops']:.6e} meta"
          f" == {dcounter.flops:.6e} card; step {decode_ms:.3f} ms measured "
          f"vs roofline compute {droof['compute_s'] * 1e3:.6f} ms, memory "
          f"{droof['memory_s'] * 1e3:.6f} ms | {card}")
    check(dcounter.flops == droof["flops"],
          "the card's decode-step FLOPs == the dry-run's")
    return {"train_ms": step_ms, "decode_ms": decode_ms,
            "peak_ratio": card_peak / dry_peak}


def phase_dryrun_matrix() -> float:
    """Phase 8b: ``dryrun.run_one`` for the single-pod 10 x 4 matrix on
    ``meta`` (no device), in spawned worker processes (one a CPU core, up
    to 8): every cell ok, or skipped for long_500k on a full-attention
    arch.  Returns the seconds it took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun, shapes

    cells = [(arch, name) for arch in ARCH_IDS for name in shapes.SHAPES]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(dryrun.run_one, arch, name, False, False)
                   for arch, name in cells]
        reports = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    for (arch, name), r in zip(cells, reports):
        if r["status"] == "skipped":
            check(not shapes.applicable(arch, name)[0],
                  f"{r['tag']} skipped by rule")
            print(f"dryrun matrix {r['tag']}: skipped ({r['reason']})")
            continue
        check(r["status"] == "ok", f"{r['tag']} ok: {r.get('error')}")
        roof = r["roofline"]
        total_s = roof["compute_s"] + roof["memory_s"] + roof["collective_s"]
        print(f"dryrun matrix {r['tag']}: FLOPs {roof['flops']:.4e}, "
              f"arguments {r['memory']['argument_bytes_per_device']:,} B a "
              f"device, peak {r['memory']['peak_bytes_per_device']:,} B, "
              f"dominant {roof['dominant']}, compute + memory + collective "
              f"{total_s:.4f} s (counted in {r['count_s']} s)")
    print(f"dryrun matrix: {len(cells)} cells in {wall:.1f} s")
    return wall


def phase_dryrun_fedgbf(device, card) -> dict:
    """Phase 8c: ``dryrun_fedgbf.sweep`` on the card: the paper's forest
    round (5 depth-3 trees, 150,000 Give-Me-Some-Credit rows padded to 16
    columns, B = 32) on the 16 x 16 grid (and 2 x 16 x 16, pod folded into
    data) with 16 parties as column blocks and the data shards as row
    blocks; ``sweep`` raises unless every run's meter reconciles with the
    wire model (delta 0), the histogram, async and argmax trees equal
    ``local-cuda``'s, and each run launched the histogram kernel (and its
    sort) once a level.  Returns the summed launches,
    the ``local-cuda`` oracle builds' included."""
    from repro_torch.launch import dryrun_fedgbf

    result = dryrun_fedgbf.sweep(device, data_shards=8, save=False)
    oracle = sum(r["oracle_histogram_launches"] for r in result["runs"])
    launches = oracle + sum(r["histogram_launches"] for r in result["runs"])
    sorts = sum(r["sort_launches"] + r["oracle_sort_launches"]
                for r in result["runs"])
    check(sorts == launches, "8c: a sort a histogram launch")
    check(oracle > 0, "8c: the local-cuda oracles launched the kernel")
    ratios = result["ratios"]
    check(ratios["async_over_sync"] == 1.0, "8c: async / sync == 1")
    print(f"dryrun fedgbf: async / sync {ratios['async_over_sync']:.3f}, "
          f"subtraction cut {ratios['subtraction_cut']:.4f}x, depth-5 "
          f"compaction cut {ratios['compaction_cut']:.4f}x; walls "
          + ", ".join(f"{r['tag'].split('__', 2)[2]} "
                      f"{r['wall_s'] * 1e3:.1f} ms" for r in result["runs"])
          + f"; {launches} histogram launches ({oracle} of them the "
          f"local-cuda oracles') | {card}")
    return {"histogram_round": launches, "histogram_sort": sorts}


def phase_examples(device, card) -> dict:
    """Phase 8d: every example's ``main(device="cuda")`` at its defaults
    (``lm_pretrain_e2e`` with ``quick=True``); quickstart prints its AUCs,
    vfl_credit_scoring raises unless every ledger reconciles with its
    run's own meter.  Returns the kernel launches they made."""
    import torch

    from repro_torch.examples import (
        embeddings_head,
        lm_pretrain_e2e,
        quickstart,
        vfl_credit_scoring,
    )
    from repro_torch.kernels.ensemble_predict import ops as ep_ops
    from repro_torch.kernels.histogram import ops as hist_ops

    launches = {}
    for name, fn in (
            ("quickstart", lambda: quickstart.main(device)),
            ("vfl_credit_scoring", lambda: vfl_credit_scoring.main(device)),
            ("embeddings_head", lambda: embeddings_head.main(device)),
            ("lm_pretrain_e2e", lambda: lm_pretrain_e2e.main(device,
                                                             quick=True))):
        hist_ops.reset_launches()
        ep_ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "quickstart":
            check(min(out["dynamic_fedgbf"]["auc"],
                      out["secureboost"]["auc"]) > 0.5,
                  "quickstart AUCs above chance")
        if name == "lm_pretrain_e2e":
            check(bool(np.isfinite(out["losses"]).all()),
                  "lm_pretrain_e2e losses finite")
        counts = {k: hist_ops.kernel_launches(k) for k in hist_ops.KERNELS}
        counts.update({k: ep_ops.kernel_launches(k) for k in ep_ops.KERNELS})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"example {name}: {wall:.1f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} } | {card}")
    return launches


def hist_bound(nbytes: float, ops_count: float) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops_count / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def longest_segment(starts) -> int:
    """The most rows any slot holds: the walk's longest serial chain."""
    return int((starts[..., 1:] - starts[..., :-1]).max())


def phase_hist_timing(device, train) -> dict:
    """Each entry point at round 1's level-0 shape (21000 x 23, B = 32, the
    5 trees of round 1 or one of them): kernel, plain version and one
    ``index_add_`` over staged ids, CUDA events; the bound from this run's
    inputs (each read once, the histogram written once; one add per stat
    of each weighted (tree, row, feature)).  Each launch is split into its
    sort (timed alone) and the walk (the rest).  Then the sort kernel alone
    beside its plain version and one stable ``torch.sort``, and the round
    histogram at the first call of each level of the training run."""
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

            def sort():
                return ops.sort_slots(ids, None, nodes, num_bins)

            def plain():
                return ref.histogram_staged_ref(ids, data, nodes, num_bins)

            nbytes = (ids.numel() * 4 + data.numel() * 4
                      + nodes * d * num_bins * 3 * 4)
        else:
            def kernel():
                return ops.histogram_round(binned, assign, g2, h2, w, nodes,
                                           num_bins, False)

            def sort():
                return ops.sort_slots(binned, assign, nodes, num_bins)

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
        sort_ms = time_ms(sort, iters=50, warmup=5)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        library_ms = time_ms(library, iters=50, warmup=5)
        ops_count = float((w != 0).sum()) * d * 3
        bound_ms, bound_by = hist_bound(nbytes, ops_count)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        print(f"time {name:24s} {n}x{d} T={n_trees} level 0: kernel "
              f"{ms:.5f} ms (sort {sort_ms:.5f} + walk {ms - sort_ms:.5f}; "
              f"longest segment {longest_segment(sort()[1])} rows), plain "
              f"{plain_ms:.4f} ms, index_add_ {library_ms:.5f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}; {nbytes / 1e6:.3f} MB, "
              f"{ops_count:.0f} adds)")
    out["histogram_sort"] = _time_sort(binned, smask.shape[0], num_bins)
    _time_levels(train["level_calls"])
    return out


def _time_sort(binned, n_trees: int, num_bins: int) -> dict:
    """The sort kernel alone at the level-0 round shape, beside its plain
    version and one stable ``torch.sort`` of the same slot ids formed
    beforehand; bound: the keys and assignments read once, order and
    starts written once (no arithmetic to speak of)."""
    import torch

    from repro_torch.kernels.histogram import ops, ref

    n, d = binned.shape
    assign = torch.zeros((n_trees, n), dtype=torch.int32,
                         device=binned.device)
    ids = ref.slot_ids(binned, assign, 1, num_bins)
    key = torch.where(ids >= 0, ids,
                      torch.full_like(ids, num_bins)).contiguous()
    ms = time_ms(lambda: ops.sort_slots(binned, assign, 1, num_bins),
                 iters=50, warmup=5)
    plain_ms = time_ms(lambda: ref.sort_slots_ref(binned, assign, 1,
                                                  num_bins),
                       iters=10, warmup=2)
    library_ms = time_ms(lambda: torch.sort(key, dim=-1, stable=True),
                         iters=50, warmup=5)
    nbytes = 4 * (binned.numel() + assign.numel() + n_trees * d * n
                  + n_trees * d * (num_bins + 1))
    bound_ms, bound_by = hist_bound(nbytes, 0.0)
    print(f"time {'histogram_sort':24s} {n}x{d} T={n_trees} level 0: kernel "
          f"{ms:.5f} ms, plain {plain_ms:.4f} ms, torch.sort {library_ms:.5f}"
          f" ms, bound {bound_ms:.6f} ms ({bound_by}; {nbytes / 1e6:.3f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _time_levels(level_calls: dict) -> None:
    """The round entry point at each level's first call of the training
    run (level 0 direct, levels 1-2 left children at parent width): the
    launch, its sort alone, the longest slot segment, and the device time
    of each of the launch's kernels (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.histogram import ops

    for level, (child, args) in sorted(level_calls.items()):
        binned, g, h, weight, assign, nodes, num_bins = args[:7]
        binned, assign = ops._i32(binned), ops._i32(assign)
        g, h, weight = ops._channels(g), ops._channels(h), ops._f32(weight)

        def kernel():
            return ops.histogram_round(binned, assign, g, h, weight, nodes,
                                       num_bins, child)

        def sort():
            return ops.sort_slots(binned, assign, nodes, num_bins, child)

        ms = time_ms(kernel, iters=50, warmup=5)
        sort_ms = time_ms(sort, iters=50, warmup=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernel()
            torch.cuda.synchronize()
        steps = ", ".join(
            f"{re.search(r'[A-Za-z_]+(?=[<(])', key).group(0)} {us / 20:.2f}"
            for key, us in sorted(device_times(prof).items(),
                                  key=lambda kv: -kv[1]))
        print(f"time histogram_round level {level} "
              f"({'child' if child else 'direct'}, T={assign.shape[0]}, "
              f"nodes={nodes}): {ms:.5f} ms = sort {sort_ms:.5f} + walk "
              f"{ms - sort_ms:.5f}; longest segment "
              f"{longest_segment(sort()[1])} rows; device us per launch: "
              f"{steps}")


def phase_profile(packed, requests) -> None:
    """Where a batch's time goes: ``torch.profiler`` over 16 batches of the
    fused-cuda stream; device time by kernel and copy, and the device's
    busy share of the wall clock (the profiler's own host cost included,
    so the share is a lower bound).  Prints "not measured" if the profiler
    records no device activity."""
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
    device = device_times(prof)
    if not device:
        print("profile: device time not measured (no CUDA activity seen)")
        return
    total = sum(device.values())
    print(f"profile: 16 batches of {BATCH}, wall {wall_us / 16:.1f} us/batch,"
          f" device busy {total / 16:.1f} us/batch "
          f"({100 * total / wall_us:.1f}% of wall, profiler on)")
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / 16:9.2f} us/batch  {key[:90]}")


def device_times(prof) -> dict:
    """Device time (us) by kernel or copy name from a ``torch.profiler``
    run: device-side events only, since a CPU op's self device time is its
    kernels' time again."""
    from torch.autograd import DeviceType

    device = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            device[e.key] = device.get(e.key, 0.0) + us
    return device


def phase_train_profile(device) -> None:
    """Where a training round's time goes: ``torch.profiler`` over the
    20-round reference run; device busy share of the wall clock (the
    profiler's host cost included, so a lower bound) and the device time
    by kernel per round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import boosting
    from repro_torch.data import synthetic

    ds = synthetic.load("default_credit_card")
    masks, _, _ = load_train_oracle(device)
    cfg = boosting.dynamic_fedgbf_config(rounds=REF_ROUNDS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        boosting.train_fedgbf(ds.x_train, ds.y_train, cfg, masks=masks,
                              backend="local-cuda", device=device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    times = device_times(prof)
    if not times:
        print("profile train: device time not measured")
        return
    busy_ms = sum(times.values()) / 1e3
    print(f"profile train: {REF_ROUNDS} rounds, wall {wall_ms:.1f} ms "
          f"(profiler on), device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall), "
          f"{busy_ms / REF_ROUNDS:.3f} ms per round")
    for key, us in sorted(times.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / REF_ROUNDS:9.1f} us/round  {key[:90]}")


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
    err["histogram_round"] = max(err["histogram_round"],
                                 phase_goss_hist_kernels(device))
    main_path = phase_main_path(device, card)
    launches = dict(main_path["launches"])
    for kernel, count in phase_quantized(device, card, main_path).items():
        launches[kernel] += count
    seeded = phase_seeded_draws(device, card)
    train = phase_train(device, card)
    # every training run's round histograms (each sorting first): the
    # reference run from the key and from the masks, GOSS, the reference
    # run killed and resumed, and the 4-party vfl-histogram run
    vfl = phase_vfl_train(device, card)
    launches["ensemble_predict_raw"] += vfl["score_launches"]
    runs = (seeded["launches"], train["launches"],
            phase_goss_train(device, card, train["history"])["launches"],
            phase_resume(device, card, train)["launches"],
            vfl["launches"])
    for kernel in ("histogram_round", "histogram_sort"):
        launches[kernel] = sum(run[kernel] for run in runs)
    # phase 4e's runs: chaos, party dropout, gradient-less, the data axis
    # (each histogram launch sorts once, as phase 4e checks)
    runtime = phase_vfl_runtime(device, card, vfl)
    launches["ensemble_predict_raw"] += runtime.pop("scoring")
    for kernel in ("histogram_round", "histogram_sort"):
        launches[kernel] += sum(runtime.values())
    launches.update(phase_other_paths(device, train))
    phase_launchers(device)
    phase_lm_full(device, card)
    phase_lm_smoke(device)
    timing = phase_timing(main_path["packed"], main_path["requests"])
    timing.update(phase_hist_timing(device, train))
    phase_profile(main_path["packed"], main_path["requests"])
    phase_train_profile(device)
    # phase 8: the dry-run against the card, the matrix on meta, the
    # production-grid forest round and the examples (each path's launches
    # counted from zero)
    phase_dryrun_card(device, card)
    phase_dryrun_matrix()
    for extra in (phase_dryrun_fedgbf(device, card),
                  phase_examples(device, card)):
        for kernel, count in extra.items():
            launches[kernel] += count
    paths = {
        "ensemble_predict_raw": "serve fused-cuda, 1,048,576 requests each "
                                "of the f32, int8 and int16 checkpoints; "
                                "the federated models and the examples "
                                "score the test rows",
        "ensemble_predict_binned": "serve cuda, 65,536 requests each of "
                                   "the f32, int8 and int16 checkpoints",
        "histogram_round": "train_fedgbf local-cuda, 20 rounds: uniform "
                           "from PRNGKey(0) and from the committed masks, "
                           "GOSS, and uniform killed after 8 and resumed; "
                           "vfl-histogram, 4 parties, one launch a level; "
                           "its chaos, party-dropout and 2-shard runs, one "
                           "launch a level; gradient-less, one launch a "
                           "party a level; the production-grid forest "
                           "rounds, one launch a level, and their "
                           "local-cuda oracle builds; the examples' "
                           "training",
        "histogram_tree": "round 1, per-tree providers",
        "histogram_staged": "round 1, histogram_dispatch('cuda')",
        "histogram_sort": "the first step of every histogram_round launch",
    }
    timing["histogram_round"]["party_ms"] = vfl["timing"]["party_ms"]
    timing["histogram_round"]["party_library_ms"] = vfl["timing"][
        "library_ms"]
    shapes = {
        "ensemble_predict_raw": f"{BATCH}x23, 78 trees, depth 3",
        "ensemble_predict_binned": f"{BATCH}x23, 78 trees, depth 3",
        "histogram_round": "21000x23, B=32, 5 trees, level 0",
        "histogram_tree": "21000x23, B=32, 1 tree, level 0",
        "histogram_staged": "21000x23, B=32, 1 tree, level 0",
        "histogram_sort": "21000x23, B=32, 5 trees, level 0",
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
            **({"party_ms": t["party_ms"],
                "party_library_ms": t["party_library_ms"], "party_shape":
                "21000x6, B=32, 5 trees, level 0"} if "party_ms" in t
               else {}),
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
