"""(Dynamic) FedGBF training (Algs. 1 & 3) and ensemble prediction: the
counterpart of ``repro/core/boosting.py``.

Training: ``train_fedgbf`` is one eager engine with the JAX package's scan
engine's contract (``boosting.py:499-832``): the masks of all S scheduled
tree builds are taken (or drawn) up front, the rounds run in the segments
of ``_plan_segments`` (constant forest width, shared-root crossover), the
shared-root buffer width comes from ``_root_delta_rows``/``_delta_bucket``,
metrics are evaluated on the rounds ``eval_every`` and the final round
select, and the history carries the exact final margins.  GOSS forms each
round's weight masks from that round's gradients and its draws
(``forest.goss_weights``); ``start_round``/``stop_round``/``init_margin``
train a window of the full schedule, so a run stopped and resumed from a
train-state checkpoint stitches to the uninterrupted run's ensemble.

The margin update reproduces the reference's arithmetic: XLA's CPU backend
folds ``y_hat + lr * mean(per_tree)`` into ``fma(sum(per_tree), lr * (1 /
T), y_hat)``, the sum over trees in order and ``lr * (1 / T)`` rounded to
float32 once; ``_boost`` takes the same steps, so the margins — and the
gradients and trees of the next round — equal the JAX package's bit for
bit on the CPU and on the card.

Prediction: ``predict``, ``predict_loop`` and ``predict_proba``
(``boosting.py:897-991``), for a ``PackedEnsemble`` or a
``QuantizedEnsemble``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import binning, dynamic
from repro_torch.core import forest as forest_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.fma import fma
from repro_torch.core.types import (
    EnsembleModel,
    FedGBFConfig,
    PackedEnsemble,
    QuantizedEnsemble,
    dequantize_ensemble,
    pack_ensemble,
    unpack_ensemble,
)
from repro_torch.device import resolve
from repro_torch.kernels.ensemble_predict import ops
from repro_torch.obs import trace as trace_mod


@dataclass
class TrainHistory:
    """Per-round training record.

    ``n_trees``, ``rho_id`` and ``wall_time_s`` have one entry for EVERY
    round; ``rounds`` lists the (1-based) rounds at which metrics were
    evaluated and ``train``/``valid`` align with it.  ``wall_time_s`` is
    each round's own host wall, the device synchronised at its end;
    ``segments`` has one dict per segment of the plan (``width``,
    ``first_round`` 0-based, ``rounds``, ``root_delta_rows``, ``wall_s``,
    host-clock ``t0``/``t1``); ``overhead_s`` is the call's wall outside
    the rounds (binning, mask transfer, the final fetch).
    ``final_margin``/``final_margin_valid`` are the exact float32 margins
    after the last round.
    """

    rounds: list = field(default_factory=list)
    train: list = field(default_factory=list)
    valid: list = field(default_factory=list)
    n_trees: list = field(default_factory=list)
    rho_id: list = field(default_factory=list)
    wall_time_s: list = field(default_factory=list)
    engine: str = "eager"
    segments: list = field(default_factory=list)
    telemetry: dict = field(default_factory=dict)
    overhead_s: float = 0.0
    start_round: int = 0
    final_margin: Optional[np.ndarray] = None
    final_margin_valid: Optional[np.ndarray] = None

    @property
    def total_wall_time_s(self) -> float:
        return float(sum(self.wall_time_s))


def _delta_bucket(rows: int, n: int) -> int:
    """A delta-buffer width rounded up to the next power of two (capped at
    n), as the JAX engines bucket it."""
    bucket = 1
    while bucket < rows:
        bucket *= 2
    return min(bucket, n)


def _root_delta_rows(cfg: FedGBFConfig, n: int, rho_id: float) -> int:
    """Shared-root delta-buffer width for one round: 0 (direct level-0
    pass) unless ``shared_root`` is set, sampling is uniform and at least
    half the rows are kept; then the bucketed masked-out count."""
    if not cfg.tree.shared_root or cfg.sampling != "uniform":
        return 0
    n_keep = forest_mod.sample_keep_count(n, rho_id)
    if n - n_keep > n // 2:
        return 0
    return _delta_bucket(max(1, n - n_keep), n)


def _schedule_segments(n_trees: np.ndarray, split_on=None) -> list:
    """Constant-width segments of a per-round tree-count schedule:
    [(width, first_round, n_rounds), ...], split further wherever
    ``split_on`` changes."""
    segments = []
    start = 0
    for m in range(1, len(n_trees) + 1):
        if (m == len(n_trees) or n_trees[m] != n_trees[start]
                or (split_on is not None and split_on[m] != split_on[start])):
            segments.append((int(n_trees[start]), start, m - start))
            start = m
    return segments


def _keep_counts(cfg: FedGBFConfig, n: int) -> np.ndarray:
    """Per-round sample keep counts, by the host expression the JAX
    engines evaluate (float64 rho)."""
    return np.array([forest_mod.sample_keep_count(
        n, dynamic.rho_id_schedule(cfg, m)) for m in range(1, cfg.rounds + 1)],
        np.int32)


def _plan_segments(cfg: FedGBFConfig, n: int, start_round: int = 0,
                   stop_round: Optional[int] = None) -> list:
    """The segment plan: [(width, first_round, n_rounds, root_delta_rows),
    ...].  Segments split at width changes and at the shared-root
    crossover (rho_id >= 0.5; never under GOSS), and an eligible segment's
    buffer is the bucketed largest masked-out count of its rounds.
    ``start_round``/``stop_round`` clip the FULL plan to the 0-based round
    window [start, stop): a clipped segment keeps the uninterrupted run's
    buffer width."""
    sched, _ = dynamic.flat_schedule(cfg)
    n_keep_round = _keep_counts(cfg, n)
    use_shared_root = cfg.tree.shared_root and cfg.sampling != "goss"
    delta_eligible = None
    if use_shared_root:
        delta_eligible = (n - n_keep_round) <= n // 2
    plan = []
    for width, first, n_rounds in _schedule_segments(
            sched.n_trees, split_on=delta_eligible):
        rdr = 0
        if use_shared_root and delta_eligible[first]:
            seg_delta = int(n - n_keep_round[first:first + n_rounds].min())
            rdr = _delta_bucket(max(1, seg_delta), n)
        plan.append((width, first, n_rounds, rdr))
    start = int(start_round)
    stop = cfg.rounds if stop_round is None else int(stop_round)
    if start > 0 or stop < cfg.rounds:
        clipped = []
        for width, first, n_rounds, rdr in plan:
            a, b = max(first, start), min(first + n_rounds, stop)
            if b > a:
                clipped.append((width, a, b - a, rdr))
        plan = clipped
    return plan


def _goss_counts(cfg: FedGBFConfig, n: int) -> list:
    """Per-round GOSS (n_top, n_rand), by the JAX engines' host arithmetic."""
    return [forest_mod.goss_counts(n, dynamic.rho_id_schedule(cfg, m),
                                   cfg.goss_top_share)
            for m in range(1, cfg.rounds + 1)]


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _boost(margin: torch.Tensor, per_tree: torch.Tensor,
           lr: float) -> torch.Tensor:
    """``margin + lr * mean(per_tree, axis=0)`` as XLA's CPU backend
    computes it: the trees summed in order, then one FMA with the float32
    constant ``lr * (1 / T)``."""
    total = per_tree[0]
    for p in per_tree[1:]:
        total = total + p
    scale = _f32(_f32(lr) * _f32(1.0 / per_tree.shape[0]))
    return fma(total, scale, margin)


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_fedgbf(
    x,
    y,
    cfg: FedGBFConfig,
    masks: Union[forest_mod.StepMasks, forest_mod.GossDraws, None] = None,
    *,
    x_valid=None,
    y_valid=None,
    backend: Union[str, backend_mod.TreeBackend, None] = None,
    eval_every: int = 1,
    verbose: bool = False,
    tracer=None,
    device=None,
    round_feature_mask=None,
    start_round: int = 0,
    stop_round: Optional[int] = None,
    init_margin=None,
    init_margin_valid=None,
) -> tuple[EnsembleModel, TrainHistory]:
    """Train (Dynamic) FedGBF; min == max on both schedules is static
    FedGBF.

    Args:
      x, y: (n, d) features and (n,) labels (arrays or tensors).
      cfg: the training configuration.
      masks: every scheduled build's masks, (S, n) and (S, d), in build
        order — e.g. the JAX package's draws through
        ``convert.masks_from_numpy``; under ``sampling="goss"`` a
        ``forest.GossDraws`` instead (``convert.goss_draws_from_numpy``).
        None draws them natively with ``forest.draw_step_masks`` from seed
        0.  Always the FULL schedule's, also for a window.
      backend: a registry name (``"local"``, ``"local-cuda"``, a
        ``vfl-*`` name: 2 parties, ``cfg.tree``) or a ``TreeBackend``
        (e.g. ``get_backend("vfl-histogram", tree=cfg.tree,
        num_parties=4)``); None = ``"local"``.  A federated backend needs
        d divisible by its parties (``tabular.pad_features``).
      eval_every: evaluate metrics every k rounds (and at the last).
      tracer: an ``obs.trace.Tracer``; None uses the process-global one.
      device: where to train; None = ``cuda`` (``device.resolve``).
      round_feature_mask: the federation's party-dropout mask; it comes
        with ``federation/runtime.py``, so anything but None raises
        ``NotImplementedError``.
      start_round, stop_round: train only the 0-based round window [start,
        stop) of the full schedule (masks, keep counts, segment plan and
        eval gating all follow the full run), so chunks stitch to the
        uninterrupted run's ensemble byte for byte.
      init_margin, init_margin_valid: the margins to resume from (the
        previous chunk's ``history.final_margin``); given exactly when
        ``start_round > 0``.
    Returns:
      (EnsembleModel of the window's rounds, TrainHistory).
    """
    if cfg.sampling not in ("uniform", "goss"):
        raise ValueError(
            f"unknown sampling {cfg.sampling!r}; options: 'uniform', 'goss'")
    stop = cfg.rounds if stop_round is None else int(stop_round)
    start = int(start_round)
    if not 0 <= start < stop <= cfg.rounds:
        raise ValueError(f"round window [{start}, {stop}) invalid for "
                         f"cfg.rounds={cfg.rounds}")
    if (init_margin is None) != (start == 0):
        raise ValueError(
            "init_margin must be given exactly when start_round > 0 (it is "
            "the previous chunk's final_margin)")
    if round_feature_mask is not None:
        raise NotImplementedError(
            "round_feature_mask (party dropout) comes with the federation "
            "slice of the port that brings federation/runtime.py")
    dev = resolve(device)
    if tracer is None:
        tracer = trace_mod.global_tracer()
    # a vfl-* name is built for this run's tree config (and 2 parties)
    bk = backend_mod.resolve_backend(backend, tree=cfg.tree)
    obj = objective_mod.get_objective(cfg.loss)
    use_goss = cfg.sampling == "goss"
    t_call = time.perf_counter()

    x = _as_tensor(x, torch.float32, dev)
    y32 = _as_tensor(y, torch.float32, dev)
    n, d = x.shape
    with tracer.span("binning", cat="train"):
        binned, edges = binning.fit_bin(x, cfg.tree.num_bins)
        binned_valid = (binning.bin_data(
            _as_tensor(x_valid, torch.float32, dev), edges)
            if x_valid is not None else None)
        yv32 = (_as_tensor(y_valid, torch.float32, dev)
                if y_valid is not None else None)

    sched, flat = dynamic.flat_schedule(cfg)
    n_steps = len(flat.round_of_step)
    if masks is None:
        masks = forest_mod.draw_step_masks(cfg, n, d,
                                           torch.Generator().manual_seed(0))
    want = forest_mod.GossDraws if use_goss else forest_mod.StepMasks
    if not isinstance(masks, want):
        raise TypeError(f"sampling={cfg.sampling!r} takes "
                        f"{want.__name__}, got {type(masks).__name__}")
    if (tuple(masks[0].shape) != (n_steps, n)
            or tuple(masks.feature.shape) != (n_steps, d)):
        raise ValueError(
            f"masks: expected ({n_steps}, {n}) sample and ({n_steps}, {d}) "
            f"feature masks for {n_steps} scheduled builds, got "
            f"{tuple(masks[0].shape)} and {tuple(masks.feature.shape)}")
    smask_all = masks[0].to(device=dev, dtype=torch.float32)
    fmask_all = masks.feature.to(device=dev, dtype=torch.bool)
    goss_round = _goss_counts(cfg, n) if use_goss else None

    lr = cfg.learning_rate
    rounds_idx = np.arange(1, cfg.rounds + 1)
    do_eval = (rounds_idx % eval_every == 0) | (rounds_idx == cfg.rounds)
    offsets = np.concatenate([[0], np.cumsum(sched.n_trees)])
    y_hat = (obj.init_raw(n, cfg.base_score, device=dev) if init_margin is None
             else _as_tensor(init_margin, torch.float32, dev))
    y_hat_valid = None
    if binned_valid is not None:
        y_hat_valid = (obj.init_raw(binned_valid.shape[0], cfg.base_score,
                                    device=dev)
                       if init_margin_valid is None
                       else _as_tensor(init_margin_valid, torch.float32, dev))

    history = TrainHistory(start_round=start)
    forests, train_vecs, valid_vecs = [], [], []
    _synchronize(dev)
    for width, first, n_rounds, rdr in _plan_segments(cfg, n, start, stop):
        t_seg = time.perf_counter()
        for m in range(first, first + n_rounds):
            t0 = time.perf_counter()
            s, e = int(offsets[m]), int(offsets[m + 1])
            with tracer.span(f"round {m + 1}", cat="train",
                             args={"n_trees": width,
                                   "rho_id": round(float(sched.rho_id[m]),
                                                   6)}):
                g, h = obj.grad_hess(y32, y_hat)
                smask = smask_all[s:e]
                if use_goss:
                    smask = forest_mod.goss_weights(g, smask, *goss_round[m])
                trees, per_tree = bk.build_forest_per_tree(
                    binned, g, h, smask, fmask_all[s:e], cfg.tree,
                    root_delta_rows=rdr)
                y_hat = _boost(y_hat, per_tree, lr)
                if do_eval[m]:
                    train_vecs.append(obj.metric_vector(y32, y_hat))
                if binned_valid is not None:
                    vp = tree_mod.predict_trees(trees, binned_valid,
                                                cfg.tree.max_depth)
                    y_hat_valid = _boost(y_hat_valid, vp, lr)
                    if do_eval[m]:
                        valid_vecs.append(obj.metric_vector(yv32,
                                                            y_hat_valid))
                forests.append(trees)
                _synchronize(dev)
            history.wall_time_s.append(time.perf_counter() - t0)
        t_end = time.perf_counter()
        history.segments.append({
            "width": width, "first_round": first, "rounds": n_rounds,
            "root_delta_rows": rdr, "wall_s": t_end - t_seg,
            "t0": t_seg, "t1": t_end,
        })

    keys = obj.metric_keys
    tr_np = (torch.stack(train_vecs).cpu().numpy() if train_vecs
             else None)
    va_np = torch.stack(valid_vecs).cpu().numpy() if valid_vecs else None
    history.n_trees = [int(v) for v in sched.n_trees[start:stop]]
    history.rho_id = [dynamic.rho_id_schedule(cfg, m)
                      for m in range(start + 1, stop + 1)]
    eval_rounds = [int(m) for m in np.nonzero(do_eval)[0]
                   if start <= m < stop]
    for i, m in enumerate(eval_rounds):
        history.rounds.append(m + 1)
        tr = dict(zip(keys, (float(v) for v in tr_np[i])))
        history.train.append(tr)
        if va_np is not None:
            history.valid.append(dict(zip(keys, (float(v) for v in va_np[i]))))
        if verbose:
            msg = ", ".join(f"{k}={v:.4f}" for k, v in tr.items())
            print(f"[round {m + 1:3d}] trees={history.n_trees[m - start]} "
                  f"rho_id={history.rho_id[m - start]:.2f} {msg}")
    history.final_margin = y_hat.cpu().numpy()
    if y_hat_valid is not None:
        history.final_margin_valid = y_hat_valid.cpu().numpy()
    history.overhead_s = max(0.0, time.perf_counter() - t_call
                             - history.total_wall_time_s)
    model = EnsembleModel(
        forests=tuple(forests),
        learning_rate=cfg.learning_rate,
        base_score=cfg.base_score,
        bin_edges=edges,
        loss=cfg.loss,
        max_depth=cfg.tree.max_depth,
    )
    return model, history


def secureboost_config(rounds: int = 20, **kw) -> FedGBFConfig:
    """SecureBoost = FedGBF degenerated to 1 tree/round, full sampling
    (§2.3)."""
    kw.setdefault("learning_rate", 0.1)
    return FedGBFConfig(rounds=rounds, n_trees_max=1, n_trees_min=1,
                        rho_id_min=1.0, rho_id_max=1.0, rho_feat=1.0, **kw)


def dynamic_fedgbf_config(rounds: int = 20, **kw) -> FedGBFConfig:
    """The paper's §4.2.2 setting: trees 5 -> 2 (k=1), rho_id 0.1 -> 0.3
    (k=1)."""
    kw.setdefault("learning_rate", 0.1)
    return FedGBFConfig(rounds=rounds, n_trees_max=5, n_trees_min=2,
                        n_trees_speed=1.0, rho_id_min=0.1, rho_id_max=0.3,
                        rho_id_speed=1.0, rho_feat=1.0, **kw)


def federated_forest_config(n_trees: int = 20, rho_id: float = 0.6,
                            **kw) -> FedGBFConfig:
    """Federated Forest baseline (§2.1): pure bagging = one boosting round."""
    return FedGBFConfig(rounds=1, learning_rate=1.0, n_trees_max=n_trees,
                        n_trees_min=n_trees, rho_id_min=rho_id,
                        rho_id_max=rho_id, **kw)


#: ``impl`` names; ``fused-cuda`` and ``cuda`` are the JAX package's
#: ``fused-pallas`` and ``pallas``.
IMPLS = ("fused", "fused-cuda", "packed", "weighted", "cuda", "loop")


def predict(model: Union[EnsembleModel, PackedEnsemble, QuantizedEnsemble],
            x: torch.Tensor, impl: str = "packed") -> torch.Tensor:
    """Raw margin F(x) = base + lr * sum_m mean_j T_mj(x) (Alg. 1 l.10).

    ``impl``:
      ``"packed"``      exact per-round combiner (the default);
      ``"weighted"``    single-pass tree_scale combiner on bins;
      ``"cuda"``        the binned ensemble kernel;
      ``"fused"``       binning folded into the traversal: raw floats
                        against value-space thresholds;
      ``"fused-cuda"``  the fused path as one raw-float kernel launch;
      ``"loop"``        the per-round loop over unpacked forests.

    A ``QuantizedEnsemble`` serves on the fused impls through its
    dequantized leaf table (``types.serving_tables``); the binned impls
    and ``loop`` widen it first (``types.dequantize_ensemble``).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown predict impl {impl!r}; options: {IMPLS}")
    x = x.to(torch.float32)
    if impl == "loop":
        if isinstance(model, QuantizedEnsemble):
            model = dequantize_ensemble(model)
        return predict_loop(model, x)
    packed = (model if isinstance(model, (PackedEnsemble, QuantizedEnsemble))
              else pack_ensemble(model))
    if impl == "fused":
        return tree_mod.predict_packed_fused(packed, x)
    if impl == "fused-cuda":
        return ops.predict_packed_fused_cuda(packed, x.contiguous())
    if isinstance(packed, QuantizedEnsemble):
        packed = dequantize_ensemble(packed)
    binned = binning.bin_data(x, packed.bin_edges)
    if impl == "packed":
        return tree_mod.predict_packed(packed, binned)
    if impl == "weighted":
        return tree_mod.predict_packed_weighted(packed, binned)
    return ops.predict_packed_cuda(packed, binned)


def predict_loop(model: Union[EnsembleModel, PackedEnsemble],
                 x: torch.Tensor) -> torch.Tensor:
    """The per-round prediction loop: ``base + sum_r lr * forest_r(x)``."""
    if isinstance(model, PackedEnsemble):
        model = unpack_ensemble(model)
    binned = binning.bin_data(x, model.bin_edges)
    out = objective_mod.get_objective(model.loss).init_raw(
        x.shape[0], model.base_score, device=x.device)
    for trees in model.forests:
        out = out + model.learning_rate * tree_mod.predict_forest(
            trees, binned, model.max_depth)
    return out


def predict_proba(model: Union[EnsembleModel, PackedEnsemble],
                  x: torch.Tensor, impl: str = "packed") -> torch.Tensor:
    """The objective's activation of the raw margin (sigmoid for logistic,
    softmax for multiclass, identity for regression/quantile)."""
    obj = objective_mod.get_objective(model.loss)
    return obj.activation(predict(model, x, impl=impl))
