"""Objective registry: the counterpart of ``repro/core/objective.py``.

An objective is a narrow interface: per-sample gradients and hessians, a
loss value, a prediction-space activation and the metric set.  The channel
contract is the JAX package's:

* **K = 1 objectives** (``logistic``, ``squared``, ``quantile[@a]``)
  return ``(n,)`` gradients/hessians and flow through the 3-channel
  ``(g, h, count)`` histogram layout;
* **K > 1 objectives** (``softmax{K}``) return ``(n, K)`` each and widen
  the histogram channel axis to ``2K + 1`` channels laid out
  ``(g_1..g_K, h_1..h_K, count)``; the count channel is always LAST.

Names are resolved as in the JAX package: ``logistic``, ``squared``,
``quantile[@alpha]`` and ``softmax{K}`` (``softmax1`` is the logistic
objective).  Every formula keeps the JAX expression's order of operations.

The gradients of the logistic and softmax objectives go through ``exp``,
which XLA's CPU backend computes with its own Cephes polynomial, every
multiply-add contracted into an FMA and subnormal results flushed to zero.
``exp_xla`` takes those steps in the same order (each FMA rounded once,
``core.fma``), so g and h equal the reference's bit for bit on the
CPU and on the card alike, and trees built from them do too.  The metric
vectors and the serving activations use ``torch.exp`` and
``torch.sigmoid``: they are held at a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import torch

from repro_torch.core import metrics
from repro_torch.core.fma import fma as _fma


def _identity(m: torch.Tensor) -> torch.Tensor:
    return m


def _softmax(m: torch.Tensor) -> torch.Tensor:
    return torch.softmax(m, dim=-1)


_FLT_MIN = float(torch.finfo(torch.float32).tiny)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero, as XLA's CPU runtime flushes them."""
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


# the float32 constants of XLA's CPU exp (a Cephes polynomial)
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f32(v: float) -> float:
    """``v`` rounded to float32, returned as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` computed as XLA's CPU backend computes it: clamp to
    [-87.8, 88.8], ``n = floor(x log2(e) + 1/2)`` clamped to [-127, 127],
    ``r = x - n ln2`` in two FMA steps, a degree-7 polynomial by FMAs, then
    ``z * 2**n`` with ``2**-127`` read as 0 and subnormals flushed."""
    x = torch.clamp(x.to(torch.float32), _f32(_EXP_LO), _f32(_EXP_HI))
    n = torch.floor(_fma(x, _f32(_LOG2E), 0.5)).clamp(-127.0, 127.0)
    r = _fma(n, -_f32(_LN2_HI), x)
    r = _fma(n, -_f32(_LN2_LO), r)
    p = [_f32(c) for c in _EXP_POLY]
    z = _fma(r, p[0], p[1])
    for c in p[2:]:
        z = _fma(z, r.double(), c)
    z = _fma(z, (r * r).double(), r.double())
    z = 1.0 + z
    # 2**n from its exponent bits; n = -127 gives the bit pattern of 0.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(z * pow2)


def _one_hot(y: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: labels outside ``[0, k)`` give an all-zero row."""
    labels = y.to(torch.int64)
    return (labels[:, None] == torch.arange(k, device=y.device)).to(dtype)


# ---------------------------------------------------------------------------
# grad/hess + loss formulas
# ---------------------------------------------------------------------------
def _logistic_grad_hess(y, y_hat):
    """Binary logloss on raw margins: g = p - y, h = p (1 - p)."""
    p = _flush(1.0 / (1.0 + exp_xla(-y_hat)))  # jax.nn.sigmoid's HLO
    return p - y, _flush(p * (1.0 - p))


def _logistic_loss(y, y_hat):
    # stable logloss on margins
    return torch.mean(
        torch.clamp(y_hat, min=0) - y_hat * y
        + torch.log1p(torch.exp(-torch.abs(y_hat))))


def _squared_grad_hess(y, y_hat):
    """0.5 * (y_hat - y)^2: g = y_hat - y, h = 1."""
    return y_hat - y, torch.ones_like(y_hat)


def _squared_loss(y, y_hat):
    return 0.5 * torch.mean((y_hat - y) ** 2)


def _quantile_grad_hess(alpha: float):
    def fn(y, y_hat):
        # pinball loss with the constant-hessian surrogate h = 1
        g = torch.where(y > y_hat, torch.full_like(y_hat, -alpha),
                        torch.full_like(y_hat, 1.0 - alpha))
        return g, torch.ones_like(y_hat)

    return fn


def _quantile_loss(alpha: float):
    def fn(y, y_hat):
        e = y - y_hat
        return torch.mean(torch.maximum(alpha * e, (alpha - 1.0) * e))

    return fn


def _softmax_xla(m: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(m - max)`` divided by
    its sum, the K channels summed in order."""
    e = exp_xla(m - m.max(dim=-1, keepdim=True).values)
    total = e[..., 0]
    for c in range(1, e.shape[-1]):
        total = total + e[..., c]
    return e / total[..., None]


def _softmax_grad_hess(k: int):
    def fn(y, y_hat):
        # diagonal-hessian multiclass softmax: g_k = p_k - 1[y = k],
        # h_k = p_k (1 - p_k)
        p = _softmax_xla(y_hat)
        onehot = _one_hot(y, k, p.dtype)
        return p - onehot, p * (1.0 - p)

    return fn


def _softmax_loss(k: int):
    def fn(y, y_hat):
        logp = torch.log_softmax(y_hat, dim=-1)
        onehot = _one_hot(y, k, logp.dtype)
        return -torch.mean(torch.sum(onehot * logp, dim=-1))

    return fn


# ---------------------------------------------------------------------------
# metric vectors, per objective family
# ---------------------------------------------------------------------------
def _logistic_metric_vector(y, margin):
    prob = 1.0 / (1.0 + torch.exp(-margin))  # as metrics.classification_report
    return torch.stack([
        metrics.auc(y, margin),
        metrics.accuracy(y, prob),
        metrics.f1_score(y, prob),
        _logistic_loss(y, margin),
    ])


def _regression_metric_vector(loss_fn):
    def fn(y, margin):
        return torch.stack([
            torch.sqrt(torch.mean((margin - y) ** 2)),
            loss_fn(y, margin),
        ])

    return fn


def _softmax_metric_vector(k: int):
    loss_fn = _softmax_loss(k)

    def fn(y, margin):
        pred = torch.argmax(margin, dim=-1).to(torch.float32)
        acc = torch.mean((pred == y.to(torch.float32)).to(torch.float32))
        return torch.stack([acc, loss_fn(y, margin)])

    return fn


@dataclasses.dataclass(frozen=True)
class Objective:
    """One registered objective.

    ``grad_hess(y, margin) -> (g, h)``: each ``(n,)`` when ``n_classes == 1``
    else ``(n, K)``.  ``loss_value(y, margin) -> scalar``.  ``activation``
    maps raw margins to prediction space.  ``metric_keys`` names the entries
    of ``metric_vector`` in order.  ``init_margin`` is the margin training
    starts from before the config's ``base_score`` shift.
    """

    name: str
    n_classes: int
    activation: Callable
    grad_hess: Callable
    loss_value: Callable
    metric_keys: tuple
    metric_vector: Callable
    init_margin: float = 0.0

    def init_raw(self, n: int, base_score: float = 0.0,
                 device=None) -> torch.Tensor:
        """Initial margin carry: (n,) at K = 1, (n, K) otherwise."""
        shape = (n,) if self.n_classes == 1 else (n, self.n_classes)
        return torch.full(shape, self.init_margin + base_score,
                          dtype=torch.float32, device=device)

    def evaluate(self, y, margin) -> dict:
        """Metric dict: the same quantities, in order, as metric_vector."""
        vec = self.metric_vector(y.to(torch.float32), margin)
        return dict(zip(self.metric_keys, (float(v) for v in vec)))


_logistic = Objective(
    name="logistic",
    n_classes=1,
    activation=torch.sigmoid,
    grad_hess=_logistic_grad_hess,
    loss_value=_logistic_loss,
    metric_keys=("auc", "acc", "f1", "loss"),
    metric_vector=_logistic_metric_vector,
)

_REGISTRY = {
    "logistic": _logistic,
    "squared": Objective(
        name="squared",
        n_classes=1,
        activation=_identity,
        grad_hess=_squared_grad_hess,
        loss_value=_squared_loss,
        metric_keys=("rmse", "loss"),
        metric_vector=_regression_metric_vector(_squared_loss),
    ),
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
        return Objective(
            name=name,
            n_classes=k,
            activation=_softmax,
            grad_hess=_softmax_grad_hess(k),
            loss_value=_softmax_loss(k),
            metric_keys=("acc", "loss"),
            metric_vector=_softmax_metric_vector(k),
        )
    if name.startswith("quantile"):
        alpha = 0.5
        if name != "quantile":
            if not name.startswith("quantile@"):
                raise ValueError(f"bad quantile objective {name!r}: expected "
                                 "'quantile' or 'quantile@<alpha>'")
            alpha = float(name[len("quantile@"):])
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"quantile alpha must be in (0, 1), got {alpha}")
        loss_fn = _quantile_loss(alpha)
        return Objective(
            name=name,
            n_classes=1,
            activation=_identity,
            grad_hess=_quantile_grad_hess(alpha),
            loss_value=loss_fn,
            metric_keys=("rmse", "loss"),
            metric_vector=_regression_metric_vector(loss_fn),
        )
    raise ValueError(
        f"unknown objective {name!r}; options: {available_objectives()}")


def get_objective(name: str) -> Objective:
    """Resolve an objective by name (objectives are cached singletons)."""
    obj = _REGISTRY.get(name)
    if obj is not None:
        return obj
    return _parameterized(name)


def num_stats(n_classes: int) -> int:
    """Histogram channel count for K gradient channels: (g*K, h*K, count)."""
    return 2 * n_classes + 1
