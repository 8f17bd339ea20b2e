"""Training step factory for the LM substrate: the port of
``repro/models/train.py``.

``train_step(state, batch)`` takes one AdamW step on ``state`` in place
(autograd for the backward pass) and returns ``(state, metrics)``, as the
JAX step returns the new state: ``loss``, ``ce``, ``aux``, ``lr`` (the
cosine schedule at ``step + 1``) and ``grad_norm`` (the square root of the
sum over leaves, in the JAX leaf order, of each leaf's sum of squares).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel
from repro_torch.optim import AdamW, cosine_lr


@dataclasses.dataclass
class TrainState:
    model: LMModel
    opt: AdamW


def init_train_state(key: Optional[torch.Tensor], cfg: ModelConfig,
                     device=None,
                     model: Optional[LMModel] = None) -> TrainState:
    """A fresh optimizer over ``model``, or over a new model of ``cfg``
    whose parameters are the JAX ``init_params(key, cfg)``, drawn on
    ``device``."""
    if model is None:
        model = LMModel(cfg, device, key)
    return TrainState(model=model, opt=AdamW(model.parameters()))


def _grad_norm(model: LMModel) -> torch.Tensor:
    total = None
    for _, params in model.jax_leaves():
        for p in params:
            if p.grad is None:
                continue
            s = p.grad.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: dict):
        model, opt = state.model, state.opt
        opt.zero_grad(set_to_none=True)
        loss, parts = model.loss(batch)
        loss.backward()
        lr = cosine_lr(opt.step_count + 1, peak=peak_lr, warmup=warmup,
                       total=total_steps)
        gnorm = _grad_norm(model)
        opt.step(lr)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "lr": lr, "grad_norm": gnorm}
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(model: LMModel, batch: dict):
        loss, parts = model.loss(batch)
        return {"loss": loss, **parts}

    return eval_step
