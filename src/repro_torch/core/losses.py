"""Loss helpers over the objective registry: the counterpart of
``repro/core/losses.py``.  Every function resolves through
``objective.get_objective``, the one source of gradients and losses."""

from __future__ import annotations

import torch

from repro_torch.core import objective as objective_mod


def sigmoid(z: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(z)


def logistic_grad_hess(y: torch.Tensor, y_hat: torch.Tensor):
    """Binary logloss on raw margins: g = p - y, h = p (1 - p)."""
    return objective_mod.get_objective("logistic").grad_hess(y, y_hat)


def squared_grad_hess(y: torch.Tensor, y_hat: torch.Tensor):
    """0.5 * (y_hat - y)^2: g = y_hat - y, h = 1."""
    return objective_mod.get_objective("squared").grad_hess(y, y_hat)


def grad_hess(loss: str, y: torch.Tensor, y_hat: torch.Tensor):
    """``get_objective(loss).grad_hess`` on float32 inputs."""
    obj = objective_mod.get_objective(loss)
    return obj.grad_hess(y.to(torch.float32), y_hat.to(torch.float32))


def loss_value(loss: str, y: torch.Tensor, y_hat: torch.Tensor
               ) -> torch.Tensor:
    """``get_objective(loss).loss_value`` on a float32 target."""
    obj = objective_mod.get_objective(loss)
    return obj.loss_value(y.to(torch.float32), y_hat)
