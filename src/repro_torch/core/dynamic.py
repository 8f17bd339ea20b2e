"""Dynamic FedGBF parameter schedules (§3.2.2, eqs. 6-7): a copy of
``repro/core/dynamic.py``, which imports no JAX; the port keeps its own.

The paper's printed equations have mismatched parentheses and swapped
else-branches (eq. 6 is titled "Dynamic Increasing" but is written with cos
and a V_min tail). We implement the semantics the text and the experiments
unambiguously describe — "the cosine function to reduce the parameter values
round by round and the sine function to increase" with the k=1/k=0.5 worked
example of §3.2.2 — and note the typo here:

  decay     V(b_t) = V_min + (V_max - V_min) * cos( pi (b_t-1) / (2 k (b_T-1)) )
            for b_t in [1, k(b_T-1)+1], then V_min; V_max if b_T == 1.
  increase  V(b_t) = V_min + (V_max - V_min) * sin( pi (b_t-1) / (2 k (b_T-1)) )
            for b_t in [1, k(b_T-1)+1], then V_max; V_max if b_T == 1.

Check against the worked example: decay of tree count 50 -> 15 over b_T = 11
rounds. k=1: cos runs 0..pi/2 across rounds 1..11, so round 1 gives 50 and
round 11 gives 15. k=0.5: the cos phase completes at round 6 (value 15) and
rounds 7..11 hold 15 — exactly the paper's description.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def dynamic_decay(
    b_t: int, b_total: int, v_min: float, v_max: float, k: float = 1.0
) -> float:
    """Cosine decay from v_max (round 1) to v_min (round k*(b_T-1)+1), then hold."""
    if b_total <= 1:
        return v_max
    horizon = k * (b_total - 1)
    if b_t > horizon + 1:
        return v_min
    phase = math.pi * (b_t - 1) / (2.0 * horizon)
    return v_min + (v_max - v_min) * math.cos(phase)


def dynamic_increase(
    b_t: int, b_total: int, v_min: float, v_max: float, k: float = 1.0
) -> float:
    """Sine increase from v_min (round 1) to v_max (round k*(b_T-1)+1), then hold."""
    if b_total <= 1:
        return v_max
    horizon = k * (b_total - 1)
    if b_t > horizon + 1:
        return v_max
    phase = math.pi * (b_t - 1) / (2.0 * horizon)
    return v_min + (v_max - v_min) * math.sin(phase)


def n_trees_schedule(cfg, round_idx: int) -> int:
    """Trees per round (dynamic decaying; paper: 5 -> 2, k = 1). 1-based round."""
    v = dynamic_decay(
        round_idx, cfg.rounds, float(cfg.n_trees_min), float(cfg.n_trees_max),
        cfg.n_trees_speed,
    )
    return max(1, int(round(v)))


def rho_id_schedule(cfg, round_idx: int) -> float:
    """Sample rate per round (dynamic increasing; paper: 0.1 -> 0.3, k = 1)."""
    return float(
        dynamic_increase(
            round_idx, cfg.rounds, cfg.rho_id_min, cfg.rho_id_max, cfg.rho_id_speed
        )
    )


class ScheduleArrays(NamedTuple):
    """Mask-form schedules (DESIGN.md §4): the whole dynamic schedule as
    static-shape per-round arrays — the schedule flips activity bits in a
    fixed ``(rounds, n_trees_max)`` grid instead of changing shapes.

    All arrays are host numpy (the schedule is config, not data).
    """

    n_trees: np.ndarray      # (M,) int32   — scheduled tree count per round
    rho_id: np.ndarray       # (M,) float32 — scheduled sample rate per round
    tree_active: np.ndarray  # (M, n_trees_max) float32 0/1 activity mask


class FlatSchedule(NamedTuple):
    """The schedule flattened to one entry per *scheduled tree build*
    (DESIGN.md §4).

    Derived from ``ScheduleArrays.tree_active``: entry ``s`` is tree slot
    ``tree_in_round[s]`` of round ``round_of_step[s]`` (0-based), in the
    exact order the legacy loop builds trees.  The scanned training engine
    derives every tree's prefix-stable key and its exact-count masks from
    this enumeration in one batched draw, so it does exactly the scheduled
    work — no masked-slot waste.
    """

    round_of_step: np.ndarray   # (S,) int32 — 0-based round index
    tree_in_round: np.ndarray   # (S,) int32 — tree slot within its round


def schedule_arrays(cfg) -> ScheduleArrays:
    """Materialise the (n_trees, rho_id) schedules for all rounds 1..M.

    ``tree_active[m, t] = 1`` iff tree slot ``t`` participates in round
    ``m + 1`` — the first ``n_trees_schedule(m+1)`` slots, so that with
    prefix-stable per-tree keys (``forest.sample_masks``) the active slots
    draw exactly the masks the legacy per-round loop draws.
    """
    rounds = np.arange(1, cfg.rounds + 1)
    n_trees = np.array([n_trees_schedule(cfg, int(m)) for m in rounds], np.int32)
    rho = np.array([rho_id_schedule(cfg, int(m)) for m in rounds], np.float32)
    active = (
        np.arange(cfg.n_trees_max)[None, :] < n_trees[:, None]
    ).astype(np.float32)
    return ScheduleArrays(n_trees=n_trees, rho_id=rho, tree_active=active)


def flat_schedule(cfg) -> tuple[ScheduleArrays, FlatSchedule]:
    """Flatten the mask-form schedule to per-tree-build scan steps.

    Row-major nonzeros of ``tree_active`` enumerate (round, slot) pairs in
    exactly the order the legacy loop builds them.
    """
    sched = schedule_arrays(cfg)
    round_idx, tree_idx = np.nonzero(sched.tree_active)
    flat = FlatSchedule(
        round_of_step=round_idx.astype(np.int32),
        tree_in_round=tree_idx.astype(np.int32),
    )
    return sched, flat
