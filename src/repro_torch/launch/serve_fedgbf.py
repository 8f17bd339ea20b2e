"""Batched FedGBF scoring service on the card: the counterpart of
``repro/launch/serve_fedgbf.py`` (DESIGN.md §14).

Requests arrive as raw floats in microbatches through a power-of-two
``BatchLadder``; each batch is scored by one fused bin + traverse + combine
launch over every tree of every round (``--impl fused-cuda``, the default)
or by binning followed by the binned kernel (``--impl cuda``).  A
``ModelSlot`` validates a candidate checkpoint before it swaps it in
between microbatches; rows with an infinite feature are rejected (scored
NaN, never fed to the ensemble) and clean full batches go to the device
without a host-side staging copy.  Latency is taken after
``torch.cuda.synchronize()``, the counterpart of ``block_until_ready``.

    # serve a JAX-trained checkpoint on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_fedgbf \
        --checkpoint src/repro_torch/testdata/dynamic_fedgbf_r20 \
        --requests 1000000

    # no checkpoint: train Dynamic FedGBF first (local-cuda backend, masks
    # drawn natively from seed 0), then serve it; --save keeps the model
    PYTHONPATH=src python -m repro_torch.launch.serve_fedgbf --rounds 20 \
        --save /tmp/model

``--quantize`` and ``--metrics-port`` are not ported yet.
"""

from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import boosting
from repro_torch.core import objective as objective_mod
from repro_torch.core.types import pack_ensemble
from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.obs import metrics as obs_metrics


def _score_batch(packed, x: torch.Tensor, impl: str) -> torch.Tensor:
    """One microbatch: margin through ``boosting.predict``, then the
    activation the checkpoint's loss names (sigmoid for logistic)."""
    margin = boosting.predict(packed, x, impl=impl)
    return objective_mod.get_objective(packed.loss).activation(margin)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamMetrics:
    """Serving instruments for one scoring stream (bounded memory): the
    JAX package's series, names and semantics unchanged.

    Latency lives only in log-bucketed histograms (overall and per rung);
    occupancy accumulates per model segment and resets at each hot-swap.
    """

    def __init__(self, batch_size: int) -> None:
        r = obs_metrics.MetricsRegistry()
        self.registry = r
        self.latency = r.histogram(
            "fedgbf_serve_batch_latency_seconds",
            "Per-microbatch scoring latency (bin + traverse + combine).",
            lo=1e-6, hi=60.0,
        )
        self.rows = r.counter("fedgbf_serve_rows_total",
                              "Real (non-padding) rows scored.")
        self.batches = r.counter("fedgbf_serve_batches_total",
                                 "Microbatches dispatched.")
        self.padded_rows = r.counter(
            "fedgbf_serve_padded_rows_total",
            "Zero-padding rows scored to keep microbatch shapes static.")
        self.batch_size = r.gauge("fedgbf_serve_batch_size",
                                  "Capacity of the last admitted microbatch.")
        self.occupancy = r.gauge(
            "fedgbf_serve_batch_occupancy",
            "Mean real-row fraction per microbatch (1 = no padding), "
            "accumulated over the current model segment only.")
        self.rows_per_s = r.gauge("fedgbf_serve_rows_per_second",
                                  "Stream throughput over the last run.")
        self.rows_rejected = r.counter(
            "fedgbf_serve_rows_rejected_total",
            "Rows rejected for non-finite (inf) features: scored as NaN, "
            "never fed to the ensemble.")
        self.reloads = r.counter(
            "fedgbf_serve_reloads_total",
            "Hot model reloads that passed validation and were swapped in.")
        self.reload_failures = r.counter(
            "fedgbf_serve_reload_failures_total",
            "Hot reloads refused (corrupt checkpoint / failed probe); the "
            "previous ensemble keeps serving.")
        self.swap_latency = r.histogram(
            "fedgbf_serve_swap_seconds",
            "Validate-before-swap hot reload latency (load + sha256 + probe "
            "+ rung warm), successful swaps only.",
            lo=1e-4, hi=600.0,
        )
        self.model_generation = r.gauge(
            "fedgbf_serve_model_generation",
            "Model segment counter: bumped on every successful hot-swap; "
            "per-segment gauges reset at each bump.")
        self.batch_size.set(batch_size)
        self._capacity = batch_size
        self._rung_hists: dict = {}
        self._seg_rows = 0
        self._seg_slots = 0

    def rung_latency(self, capacity: int) -> obs_metrics.LogBucketHistogram:
        """The labeled per-rung latency histogram (registered lazily)."""
        h = self._rung_hists.get(capacity)
        if h is None:
            h = self.registry.histogram(
                "fedgbf_serve_rung_latency_seconds",
                "Per-microbatch latency by admitted batch capacity; the "
                "admission controller reads each rung's p99 live.",
                lo=1e-6, hi=60.0, labels={"batch_size": str(capacity)},
            )
            self._rung_hists[capacity] = h
        return h

    def observe_batch(self, latency_s: float, real_rows: int,
                      capacity: int | None = None) -> None:
        cap = self._capacity if capacity is None else capacity
        self.latency.observe(latency_s)
        self.rung_latency(cap).observe(latency_s)
        self.rows.inc(real_rows)
        self.batches.inc()
        self.padded_rows.inc(cap - real_rows)
        self.batch_size.set(cap)
        self._seg_rows += real_rows
        self._seg_slots += cap
        self.occupancy.set(
            self._seg_rows / self._seg_slots if self._seg_slots else 0.0)

    def begin_model_segment(self) -> None:
        """Reset per-model gauges at a hot-swap boundary."""
        self._seg_rows = 0
        self._seg_slots = 0
        self.occupancy.set(0.0)
        self.model_generation.set(self.model_generation.value + 1)

    def finalize(self, wall_s: float) -> None:
        if wall_s > 0:
            self.rows_per_s.set(self.rows.value / wall_s)

    def quantiles_ms(self, qs=(0.5, 0.9, 0.99)) -> dict:
        return {q: self.latency.quantile(q) * 1e3 for q in qs}

    def render(self) -> str:
        """Prometheus text exposition of the whole bundle."""
        return self.registry.render()


def ladder_sizes(max_size: int, min_size: int = 256) -> list:
    """Power-of-two batch rungs up to ``max_size`` (always included)."""
    min_size = max(1, min(min_size, max_size))
    sizes, s = [], 1
    while s < max_size:
        if s >= min_size:
            sizes.append(s)
        s *= 2
    sizes.append(max_size)
    return sizes


class BatchLadder:
    """Static batch shapes and the admission policy.

    ``warm`` runs every rung once (the kernel build and its first launch
    happen there, not in the stream).  ``pick`` caps at the smallest rung
    covering the queue, then takes the largest capped rung whose observed
    p99 fits the budget; rungs with fewer than ``min_obs`` observations are
    admitted optimistically.
    """

    def __init__(self, sizes) -> None:
        self.sizes = sorted(set(int(s) for s in sizes))
        if not self.sizes or self.sizes[0] < 1:
            raise ValueError(f"need positive rung sizes, got {sizes!r}")
        self.max_size = self.sizes[-1]

    def warm(self, model, d: int, impl: str) -> None:
        """Score one zero batch per rung on the model's device."""
        for s in self.sizes:
            _score_batch(model, torch.zeros((s, d), dtype=torch.float32,
                                            device=model.device), impl)
        _synchronize(model.device)

    def pick(self, queued: int, budget_s: float | None,
             metrics: StreamMetrics, min_obs: int = 8) -> int:
        cap = self.max_size
        for s in self.sizes:
            if s >= queued:
                cap = s
                break
        if budget_s is None:
            return cap
        for s in reversed(self.sizes):
            if s > cap:
                continue
            h = metrics.rung_latency(s)
            if h.count < min_obs or h.quantile(0.99) <= budget_s:
                return s
        return self.sizes[0]


class ModelSlot:
    """Hot-reloadable model holder with validate-before-swap.

    ``try_reload`` loads a candidate checkpoint (sha256-verified) onto the
    current model's device, scores a zero probe batch, runs every warm
    rung, and only then swaps it in.  A failure leaves the previous model
    serving and counts on ``fedgbf_serve_reload_failures_total`` alone.
    """

    def __init__(self, packed, impl: str = "packed",
                 metrics: StreamMetrics = None, warm_sizes=()) -> None:
        self.packed = packed
        self.impl = impl
        self.metrics = metrics
        self.warm_sizes = tuple(int(s) for s in warm_sizes)

    def _validate(self, packed) -> None:
        d = packed.bin_edges.shape[0]
        probe = torch.zeros((4, d), dtype=torch.float32, device=packed.device)
        scores = _score_batch(packed, probe, self.impl)
        if not bool(torch.isfinite(scores).all()):
            raise ValueError("probe batch produced non-finite scores")
        for s in self.warm_sizes:
            _score_batch(packed, torch.zeros((s, d), dtype=torch.float32,
                                             device=packed.device), self.impl)
        _synchronize(packed.device)

    def try_reload(self, path: str) -> bool:
        t0 = time.perf_counter()
        try:
            candidate = ckpt_io.load_ensemble(path, device=self.packed.device)
            self._validate(candidate)
        except (ValueError, OSError) as e:
            if self.metrics is not None:
                self.metrics.reload_failures.inc()
            print(f"reload REFUSED ({path}): {e} — keeping previous model")
            return False
        self.packed = candidate
        if self.metrics is not None:
            self.metrics.reloads.inc()
            self.metrics.swap_latency.observe(time.perf_counter() - t0)
            self.metrics.begin_model_segment()
        print(f"reload OK ({path}): {candidate.total_trees} trees / "
              f"{candidate.rounds} rounds")
        return True


def _as_tensor(batch: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``batch``'s memory (no host copy).  A read-only
    buffer is only read: the device transfer copies it."""
    if batch.flags.writeable:
        return torch.from_numpy(batch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(batch)


def serve_stream(
    slot: ModelSlot,
    x: np.ndarray,
    *,
    ladder: BatchLadder,
    metrics: StreamMetrics = None,
    p99_budget_s: float | None = None,
    swap_plan: dict | None = None,
) -> tuple[np.ndarray, StreamMetrics]:
    """The serving loop: admission, scoring, mid-stream swaps.

    Each iteration applies any swap scheduled for this batch index
    (``swap_plan``: batch_idx -> checkpoint path), asks the ladder for a
    capacity, and scores one microbatch on the slot's current model.  A
    full clean batch goes from the caller's array straight into the device
    transfer; a copy is made only to zero inf rows (their scores return
    NaN and count on ``fedgbf_serve_rows_rejected_total``) or to pad to
    the admitted capacity.  NaN features are not rejected: they route
    left, as training's ``NAN_BIN`` does.
    """
    n = x.shape[0]
    out = None  # allocated after the first batch: (n,) or (n, K) scores
    if metrics is None:
        metrics = StreamMetrics(ladder.max_size)
    pos = 0
    batch_idx = 0
    while pos < n:
        if swap_plan and batch_idx in swap_plan:
            slot.try_reload(swap_plan[batch_idx])
        device = slot.packed.device
        queued = n - pos
        cap = ladder.pick(queued, p99_budget_s, metrics)
        real = min(cap, queued)
        view = x[pos:pos + real]
        bad = np.isinf(view).any(axis=1)
        nbad = int(bad.sum())
        if nbad or real < cap:
            batch = np.zeros((cap,) + x.shape[1:], x.dtype)
            batch[:real] = view
            if nbad:
                batch[:real][bad] = 0.0
            metrics.rows_rejected.inc(nbad)
        else:
            batch = view
        t0 = time.perf_counter()
        xb = _as_tensor(batch).to(device=device, dtype=torch.float32)
        scores = _score_batch(slot.packed, xb.contiguous(), slot.impl)
        _synchronize(device)
        metrics.observe_batch(time.perf_counter() - t0, real, capacity=cap)
        if out is None:
            out = np.empty((n,) + tuple(scores.shape[1:]), np.float32)
        block = scores[:real].cpu().numpy()
        if nbad:
            block = block.copy()
            block[bad] = np.nan
        out[pos:pos + real] = block
        pos += real
        batch_idx += 1
    return out, metrics


def score_stream(
    packed,
    x: np.ndarray,
    batch_size: int = 8192,
    impl: str = "packed",
    metrics: StreamMetrics = None,
) -> tuple[np.ndarray, StreamMetrics]:
    """Score ``x`` in fixed-shape microbatches on the model's device: the
    single-rung case of ``serve_stream``."""
    slot = ModelSlot(packed, impl)
    return serve_stream(slot, x, ladder=BatchLadder([batch_size]),
                        metrics=metrics if metrics is not None
                        else StreamMetrics(batch_size))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None,
                    help="packed checkpoint path (either package's "
                         "checkpoint.io.save_ensemble); without one, a "
                         "model is trained first")
    ap.add_argument("--save", default=None,
                    help="save the (freshly trained) packed model here")
    ap.add_argument("--rounds", type=int, default=10,
                    help="training rounds when no checkpoint is given")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (no silent CPU fallback)")
    ap.add_argument("--dataset", choices=list(synthetic.DATASETS),
                    default="default_credit_card")
    ap.add_argument("--requests", type=int, default=100_000,
                    help="size of the synthetic request stream")
    ap.add_argument("--batch-size", type=int, default=8192,
                    help="microbatch capacity (the ladder's top rung)")
    ap.add_argument("--impl", choices=["fused-cuda", "cuda", "fused", "weighted",
                             "packed"],
                    default="fused-cuda",
                    help="'fused-cuda' scores raw floats in one kernel "
                         "launch; 'cuda' bins first, then launches the "
                         "binned kernel; the rest are plain PyTorch")
    ap.add_argument("--p99-budget-ms", type=float, default=None,
                    help="latency budget: each batch admits the largest "
                         "ladder rung whose observed p99 fits (implies "
                         "--adaptive)")
    ap.add_argument("--adaptive", action="store_true",
                    help="enable the power-of-two batch ladder even without "
                         "a p99 budget")
    ap.add_argument("--ladder-min", type=int, default=256,
                    help="smallest ladder rung (adaptive mode)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition of the "
                         "stream metrics here ('-' for stdout)")
    ap.add_argument("--reload", default=None, metavar="PATH",
                    help="hot-reload this checkpoint (validate-before-swap)")
    ap.add_argument("--reload-at-batch", type=int, default=None, metavar="N",
                    help="apply --reload between microbatches N-1 and N of "
                         "the live stream (default: before the stream)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    ds = synthetic.load(args.dataset)
    if args.checkpoint:
        packed = ckpt_io.load_ensemble(args.checkpoint, device=device)
        print(f"loaded {args.checkpoint}: {packed.total_trees} trees / "
              f"{packed.rounds} rounds, depth {packed.max_depth}, on "
              f"{device}")
    else:
        model, _ = boosting.train_fedgbf(
            ds.x_train, ds.y_train,
            boosting.dynamic_fedgbf_config(rounds=args.rounds),
            backend="local-cuda", device=device)
        packed = pack_ensemble(model)
        print(f"trained {packed.total_trees} trees / {packed.rounds} rounds "
              f"on {device}")
    if args.save:
        ckpt_io.save_ensemble(args.save, packed)
        print(f"saved packed checkpoint to {args.save}")

    # Synthetic request stream: resample test rows up to --requests users.
    rng = np.random.default_rng(0)
    idx = rng.integers(0, ds.x_test.shape[0], args.requests)
    requests = np.asarray(ds.x_test)[idx]

    batch_size = min(args.batch_size, args.requests)
    if batch_size != args.batch_size:
        print(f"requests < batch-size: shrinking microbatch "
              f"{args.batch_size} -> {batch_size}")
    adaptive = args.adaptive or args.p99_budget_ms is not None
    ladder = BatchLadder(ladder_sizes(batch_size, args.ladder_min)
                         if adaptive else [batch_size])

    sm = StreamMetrics(batch_size)
    slot = ModelSlot(packed, args.impl, metrics=sm, warm_sizes=ladder.sizes)
    swap_plan = {}
    if args.reload:
        if args.reload_at_batch is not None:
            swap_plan[args.reload_at_batch] = args.reload
        else:
            slot.try_reload(args.reload)

    # warm-up: every rung once (kernel build + first launch), outside the
    # stream metrics
    ladder.warm(slot.packed, slot.packed.bin_edges.shape[0], args.impl)

    budget_s = (args.p99_budget_ms * 1e-3
                if args.p99_budget_ms is not None else None)
    t0 = time.perf_counter()
    scores, sm = serve_stream(slot, requests, ladder=ladder, metrics=sm,
                              p99_budget_s=budget_s, swap_plan=swap_plan)
    sm.finalize(time.perf_counter() - t0)
    q = sm.quantiles_ms()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"impl={args.impl} on {where} batch<= {batch_size} "
          f"requests={args.requests}: {sm.rows_per_s.value:,.0f} rows/s, "
          f"batch latency p50={q[0.5]:.3f}ms p90={q[0.9]:.3f}ms "
          f"p99={q[0.99]:.3f}ms "
          f"({int(sm.batches.value)} batches, "
          f"occupancy={sm.occupancy.value:.3f}, "
          f"swaps={int(sm.reloads.value)})")
    if args.metrics_out:
        text = sm.render()
        if args.metrics_out == "-":
            print(text, end="")
        else:
            with open(args.metrics_out, "w") as f:
                f.write(text)
            print(f"metrics exposition -> {args.metrics_out}")
    print(f"score head: {scores[:5]}")


if __name__ == "__main__":
    main()
