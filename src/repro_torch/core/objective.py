"""Objective registry, serving half: the counterpart of
``repro/core/objective.py``.

Serving needs only each objective's activation (margin to prediction
space) and its initial margin; ``grad_hess``, the losses and the metric
vectors come with the training slice.  Names are resolved as in the JAX
package: ``logistic``, ``squared``, ``quantile[@alpha]`` and
``softmax{K}`` (``softmax1`` is the logistic objective).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import torch


def _identity(m: torch.Tensor) -> torch.Tensor:
    return m


def _softmax(m: torch.Tensor) -> torch.Tensor:
    return torch.softmax(m, dim=-1)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One registered objective (serving fields only)."""

    name: str
    n_classes: int
    activation: Callable
    init_margin: float = 0.0

    def init_raw(self, n: int, base_score: float = 0.0,
                 device=None) -> torch.Tensor:
        """Initial margin carry: (n,) at K = 1, (n, K) otherwise."""
        shape = (n,) if self.n_classes == 1 else (n, self.n_classes)
        return torch.full(shape, self.init_margin + base_score,
                          dtype=torch.float32, device=device)


_logistic = Objective("logistic", 1, torch.sigmoid)

_REGISTRY = {
    "logistic": _logistic,
    "squared": Objective("squared", 1, _identity),
}


def available_objectives() -> tuple:
    return tuple(sorted(_REGISTRY)) + ("quantile", "softmax{K}")


@lru_cache(maxsize=None)
def _parameterized(name: str) -> Objective:
    if name.startswith("softmax"):
        try:
            k = int(name[len("softmax"):])
        except ValueError:
            raise ValueError(f"bad softmax objective {name!r}: expected "
                             "'softmax<K>' (e.g. 'softmax3')") from None
        if k < 1:
            raise ValueError(f"softmax needs K >= 1, got {k}")
        if k == 1:
            return dataclasses.replace(_logistic, name=name)
        return Objective(name, k, _softmax)
    if name.startswith("quantile"):
        alpha = 0.5
        if name != "quantile":
            if not name.startswith("quantile@"):
                raise ValueError(f"bad quantile objective {name!r}: expected "
                                 "'quantile' or 'quantile@<alpha>'")
            alpha = float(name[len("quantile@"):])
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"quantile alpha must be in (0, 1), got {alpha}")
        return Objective(name, 1, _identity)
    raise ValueError(
        f"unknown objective {name!r}; options: {available_objectives()}")


def get_objective(name: str) -> Objective:
    """Resolve an objective by name (objectives are cached singletons)."""
    obj = _REGISTRY.get(name)
    if obj is not None:
        return obj
    return _parameterized(name)
