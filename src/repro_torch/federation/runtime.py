"""Fault-tolerant federation runtime: retries and party-dropout
degradation — a copy of ``repro/federation/runtime.py`` (numpy only; a
party's columns come from ``mesh_roles.PartyLayout``), kept here so the
port imports no module of the JAX package.  The availability
draws come from ``np.random.default_rng([seed, 15485863])`` in both
packages, so a schedule equals the JAX package's array for array.

This is the HOST-side half of the fault story.  The other half
(``federation/chaos.py``) injects transport faults and recovers them by
checksum-verified retransmissions, so a chaotic run stays bit-identical to
a clean one.  Here we model the failures that retransmission can NOT hide:
a party that stops answering for a whole boosting round.

The coordinator's policy is deterministic and replayable:

* ``RetryPolicy`` — how many times a silent party is re-polled and with
  what exponential backoff before the round is *degraded*.
* ``dropout_schedule`` — a seeded per-round / per-party availability draw.
  Each unavailable (round, party) attempt consumes one retry; a party that
  exhausts ``max_retries`` straight attempts is degraded for that round.
* ``degradation_masks`` — lowers the schedule onto the feature axis: a
  degraded party's columns are removed from the round's split search via
  ``train_fedgbf(round_feature_mask=...)``.  The training result is
  therefore bit-identical to a run where those candidates never existed —
  the oracle ``selftest.check_degradation`` asserts exactly that.

Backoff is *simulated* (accounted in seconds, not slept).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.federation import mesh_roles

__all__ = [
    "RetryPolicy",
    "DropoutSchedule",
    "dropout_schedule",
    "degradation_masks",
    "degraded_parties",
    "party_column_slice",
]

# Distinct ``np.random.default_rng`` stream tag so the availability draw can
# never collide with chaos fault planning (streams 7919 / 104729 there).
_DROPOUT_STREAM = 15485863


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Coordinator-side retry/timeout policy for one level exchange.

    ``max_retries`` counts re-polls after the first attempt; attempt ``i``
    (0-based) waits ``backoff(i)`` seconds before retrying, doubling from
    ``base_delay_s`` and capped at ``max_delay_s``.  A party still silent
    after ``1 + max_retries`` attempts is degraded for the round.
    """

    max_retries: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    timeout_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 <= base_delay_s <= max_delay_s")

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (0-based)."""
        return float(min(self.max_delay_s,
                         self.base_delay_s * (2.0 ** attempt)))


@dataclasses.dataclass(frozen=True)
class DropoutSchedule:
    """Replayable outcome of the availability draw for one training run.

    ``degraded[m, p]`` — party ``p`` exhausted its retries in round ``m``.
    ``retries[m, p]`` — re-poll attempts spent on party ``p`` in round ``m``
    (0 when the first poll answered; ``max_retries`` when degraded).
    ``backoff_s`` — total simulated backoff seconds across the run.
    """

    degraded: np.ndarray  # (rounds, parties) bool
    retries: np.ndarray   # (rounds, parties) int32
    backoff_s: float

    @property
    def degraded_rounds(self) -> int:
        return int(np.any(self.degraded, axis=1).sum())

    def round_summary(self, m: int) -> dict:
        """Per-round fault fields for ``--log-json`` / trace (0-based m)."""
        return {
            "retries": int(self.retries[m].sum()),
            "degraded_parties": [int(p) for p in
                                 np.nonzero(self.degraded[m])[0]],
        }


def dropout_schedule(
    rate: float,
    rounds: int,
    num_parties: int,
    seed: int = 0,
    policy: Optional[RetryPolicy] = None,
) -> DropoutSchedule:
    """Draw the deterministic per-round party-availability schedule.

    Each poll of a party fails independently with probability ``rate``;
    the coordinator re-polls up to ``policy.max_retries`` times with
    exponential backoff, then degrades the party for the round.  Identical
    ``(rate, rounds, num_parties, seed, policy)`` always yields the identical
    schedule — the replay property resume and the tests rely on.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    policy = policy or RetryPolicy()
    rng = np.random.default_rng([int(seed), _DROPOUT_STREAM])
    attempts = 1 + policy.max_retries
    # One draw per (round, party, attempt): fail while < rate.
    fails = rng.random((rounds, num_parties, attempts)) < rate
    degraded = np.all(fails, axis=-1)
    # Retries spent: index of first success, or max_retries when degraded.
    first_ok = np.argmin(fails, axis=-1)  # argmin of bool = first False
    retries = np.where(degraded, policy.max_retries, first_ok)
    backoff_s = float(sum(
        policy.backoff(a)
        for m in range(rounds) for p in range(num_parties)
        for a in range(int(retries[m, p]))
    ))
    return DropoutSchedule(
        degraded=degraded,
        retries=retries.astype(np.int32),
        backoff_s=backoff_s,
    )


def party_column_slice(party: int, d: int, num_parties: int) -> slice:
    """Columns owned by ``party`` under the repo's even vertical split
    (``mesh_roles.PartyLayout``)."""
    if d % num_parties:
        raise ValueError(f"d={d} not divisible by num_parties={num_parties}")
    return mesh_roles.PartyLayout(num_parties, d).columns(party)


def degradation_masks(
    degraded: np.ndarray, d: int, num_parties: int
) -> Optional[np.ndarray]:
    """Lower a (rounds, parties) degradation table to a (rounds, d) mask.

    Round ``m``'s mask is False exactly on the columns of the parties
    degraded in that round — the shape ``train_fedgbf(round_feature_mask=)``
    consumes.  Returns None when nothing is degraded so the no-dropout path
    stays byte-for-byte the pre-§13 program.
    """
    degraded = np.asarray(degraded, dtype=bool)
    if not degraded.any():
        return None
    rounds = degraded.shape[0]
    mask = np.ones((rounds, d), dtype=bool)
    for p in range(num_parties):
        mask[degraded[:, p], party_column_slice(p, d, num_parties)] = False
    if not mask.any(axis=1).all():
        bad = int(np.nonzero(~mask.any(axis=1))[0][0])
        raise ValueError(
            f"round {bad + 1}: every party degraded — no candidates left; "
            "lower --party-dropout or raise the retry budget"
        )
    return mask


def degraded_parties(schedule: DropoutSchedule) -> List[int]:
    """Parties degraded in at least one round (gradientless-fallback set)."""
    return [int(p) for p in np.nonzero(schedule.degraded.any(axis=0))[0]]
