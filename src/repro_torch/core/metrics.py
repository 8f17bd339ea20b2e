"""Evaluation metrics reported by the paper: AUC, accuracy, F1 (§4.1) —
the counterpart of ``repro/core/metrics.py``."""

from __future__ import annotations

import torch


def auc(y: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Area under ROC via the Mann-Whitney rank statistic (ties averaged)."""
    y = y.to(torch.float32)
    n = y.shape[0]
    sorted_scores = torch.sort(score).values
    # average ranks for ties: rank = mean of 1-based positions of equal scores
    ranks_lo = torch.searchsorted(sorted_scores, score,
                                  side="left").to(torch.float32)
    ranks_hi = torch.searchsorted(sorted_scores, score,
                                  side="right").to(torch.float32)
    ranks = 0.5 * (ranks_lo + ranks_hi + 1.0)  # 1-based average rank
    n_pos = torch.sum(y)
    n_neg = n - n_pos
    sum_pos_ranks = torch.sum(ranks * y)
    return ((sum_pos_ranks - n_pos * (n_pos + 1.0) / 2.0)
            / torch.clamp(n_pos * n_neg, min=1.0))


def accuracy(y: torch.Tensor, prob: torch.Tensor,
             threshold: float = 0.5) -> torch.Tensor:
    pred = (prob >= threshold).to(torch.float32)
    return torch.mean((pred == y.to(torch.float32)).to(torch.float32))


def f1_score(y: torch.Tensor, prob: torch.Tensor,
             threshold: float = 0.5) -> torch.Tensor:
    y = y.to(torch.float32)
    pred = (prob >= threshold).to(torch.float32)
    tp = torch.sum(pred * y)
    fp = torch.sum(pred * (1.0 - y))
    fn = torch.sum((1.0 - pred) * y)
    return 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1.0)


def classification_report(y: torch.Tensor, margin: torch.Tensor) -> dict:
    """All three paper metrics from raw margins."""
    prob = 1.0 / (1.0 + torch.exp(-margin))
    return {
        "auc": float(auc(y, margin)),
        "acc": float(accuracy(y, prob)),
        "f1": float(f1_score(y, prob)),
    }


def multiclass_report(y: torch.Tensor, margin: torch.Tensor) -> dict:
    """Accuracy + macro-F1 from (n, K) margins (argmax decision rule)."""
    k = margin.shape[-1]
    y = y.to(torch.int32)
    pred = torch.argmax(margin, dim=-1).to(torch.int32)
    f1s = []
    for c in range(k):
        yc = (y == c).to(torch.float32)
        pc = (pred == c).to(torch.float32)
        tp = torch.sum(pc * yc)
        fp = torch.sum(pc * (1.0 - yc))
        fn = torch.sum((1.0 - pc) * yc)
        f1s.append(2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1.0))
    return {
        "acc": float(torch.mean((pred == y).to(torch.float32))),
        "macro_f1": float(torch.mean(torch.stack(f1s))),
    }
