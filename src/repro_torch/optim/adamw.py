"""AdamW and the cosine learning-rate schedule of the JAX package's
``repro/optim/adamw.py``, in its order of operations.

Per step ``t`` (float32): ``bc1 = 1 - b1**t``, ``bc2 = 1 - b2**t``; per
parameter, in float32, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
g^2``, ``p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)``, with
``b2 = 0.95`` and decay on every parameter.  ``torch.optim.AdamW`` decays
before the step and places ``eps`` differently, so it is no substitute.
Moments are kept in the parameter dtype and allocated with the optimizer,
as the JAX ``AdamWState`` is; a parameter without a gradient steps with a
zero one, as every JAX leaf does.  The bias corrections divide
as tensors on the parameter's device: CUDA multiplies by the reciprocal of
a Python or CPU scalar divisor, XLA divides.
"""

from __future__ import annotations

import math

import torch


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.step_count = 0      # the JAX AdamWState.step
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"m": torch.zeros_like(p),
                                 "v": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, lr) -> None:
        """One update at learning rate ``lr`` (a float32 scalar)."""
        self.step_count += 1
        t = torch.tensor(float(self.step_count), dtype=torch.float32)
        lr = float(lr)
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            bc = {}                  # device -> (bc1, bc2)
            for p in group["params"]:
                if p.device not in bc:
                    bc[p.device] = ((1.0 - b1 ** t).to(p.device),
                                    (1.0 - b2 ** t).to(p.device))
                c1, c2 = bc[p.device]
                m, v = self.state[p]["m"], self.state[p]["v"]
                gf = (torch.zeros_like(p) if p.grad is None else p.grad).float()
                m_new = b1 * m.float() + (1 - b1) * gf
                v_new = b2 * v.float() + (1 - b2) * gf.square()
                update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
                pf = p.float()
                p.copy_(pf - lr * (update + wd * pf))
                m.copy_(m_new)
                v.copy_(v_new)


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor: float = 0.0) -> torch.Tensor:
    """Linear warm-up to ``peak``, then cosine to ``floor``: a float32
    scalar tensor."""
    t = torch.as_tensor(step, dtype=torch.float32)
    warm = peak * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
    return torch.where(t < warmup, warm, cos)
