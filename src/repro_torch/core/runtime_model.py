"""The paper's analytical runtime model (eqs. 8-11, appendix A.1-A.2): a
copy of ``repro/core/runtime_model.py`` over the port's config and
schedules.

T_unit is the measured cost of one full-data, full-feature federated decision
tree; a subsampled tree costs T_single = alpha * beta * T_unit (A.1 shows the
m*n*log n complexity makes this linear for large n). From T_unit:

  T_F^L = T_0 + sum_i alpha_i beta_i T_unit              (eq. 9, ideal parallel)
  T_F^U = T_0 + sum_i N_i alpha_i beta_i T_unit          (eq. 10, fully sequential)
  T_S   = T_0 + sum_i alpha_S beta_S T_unit              (eq. 11, SecureBoost)

The same bracketing generalises to any layer-parallel/step-sequential system,
which is how the LM substrate reuses it (DESIGN.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import dynamic
from repro_torch.core.types import FedGBFConfig


@dataclass(frozen=True)
class RuntimeEstimate:
    lower_s: float    # T_F^L — ideal within-layer parallelism
    upper_s: float    # T_F^U — fully sequential
    t0_s: float

    def as_interval(self) -> tuple[float, float]:
        return (self.lower_s, self.upper_s)


def round_schedules(cfg: FedGBFConfig) -> list[tuple[int, float, float]]:
    """Per-round (N_i, alpha_i, beta_i) implied by the dynamic schedules."""
    return [
        (
            dynamic.n_trees_schedule(cfg, m),
            dynamic.rho_id_schedule(cfg, m),
            cfg.rho_feat,
        )
        for m in range(1, cfg.rounds + 1)
    ]


def estimate_fedgbf_runtime(
    cfg: FedGBFConfig, t_unit_s: float, t0_s: float = 0.0
) -> RuntimeEstimate:
    """Eqs. 9-10 applied to a (Dynamic) FedGBF configuration."""
    lower = t0_s
    upper = t0_s
    for n_i, alpha_i, beta_i in round_schedules(cfg):
        single = alpha_i * beta_i * t_unit_s   # eq. 8
        lower += single                        # trees of a layer in parallel
        upper += n_i * single                  # trees of a layer sequential
    return RuntimeEstimate(lower_s=lower, upper_s=upper, t0_s=t0_s)


def estimate_secureboost_runtime(
    rounds: int, t_unit_s: float, t0_s: float = 0.0,
    alpha: float = 1.0, beta: float = 1.0,
) -> float:
    """Eq. 11 (the paper trains the baseline with alpha_S = beta_S = 1)."""
    return t0_s + rounds * alpha * beta * t_unit_s


def error_rate(estimate: float, real: float) -> float:
    """Eq. 14: abs(1 - estimate / real)."""
    return abs(1.0 - estimate / real)


def subsample_time_ratio(alpha: float, n: int) -> float:
    """A.1 eq. 12: T_{alpha n} / T_n = alpha + log2(alpha)/log2(n).

    Used by tests to check our measured tree-build times against the paper's
    linearity assumption (the correction term vanishes for large n).
    """
    import math

    if alpha <= 0:
        raise ValueError("alpha must be positive")
    return alpha + math.log2(alpha) / math.log2(n)
