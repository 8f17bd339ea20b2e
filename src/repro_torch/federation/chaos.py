"""Chaos transport: seeded fault injection at the level-exchange seam — the
counterpart of ``repro/federation/chaos.py``.

Composes over any gather the federated backends use (plain,
double-buffered async, quantized payloads, top-k candidates) and
deterministically injects faults into the party exchange — dropped
(zeroed), bit-corrupted, duplicated and delayed level payloads — while a
checksum channel lets the receiver *detect* every fault and select the
clean retransmission.

Fault model
-----------
Each exchange — one gather call — is a *slot*.  ``plan_for_slot`` derives
the slot's fault schedule from ``(spec.seed, slot)`` with numpy's
counter-based generator (the JAX package's streams, so the plans are equal
slot for slot): up to ``max_retries`` failed attempts (drop or corrupt),
then one clean transmission, optionally duplicated or delayed.  The
schedule is pure host arithmetic, so the predicted ledger replays it byte
for byte (``protocol.wire_retry_bytes``).  Retry exhaustion (a party that
drops out for a round) is modelled one layer up, in ``runtime.py``.

The JAX package numbers the slots once per traced forest program and
replays them every round.  The port builds eagerly, so the backends reset
the counter at every forest-build entry (``begin_trace``): every round
makes the same slots 0..L-1, one a histogram gather per level or three
(gain, feature, threshold) per level under argmax/top-k.

Detection and recovery
----------------------
Every transmission ships each sender's checksum of its clean payload
beside the (possibly faulted) payload.  The checksum is a position-weighted
byte sum with odd weights mod 2^32, so any single bit flip and any zeroed
nonzero payload changes it.  The receiver recomputes each party slice's
checksum of the gathered result and folds the attempts, taking for every
party slice the first transmission whose checksum verified.  The last
attempt is clean, so the folded result equals the fault-free gather bit for
bit.  A faulted attempt faults only its victim party's block.

Accounting
----------
The meter's ``"retries"`` phase gets 4 checksum bytes per transmission plus
the full payload (party 0's) for every transmission after the first, and
its event counters the faults the transport injected (``dropped``,
``corrupted``, ``duplicated``, ``delayed``, ``retries``: the keys of
``plan_summary``).

Checksums, faults and the fold are plain tensor arithmetic on the
payload's device; the JAX package runs them as XLA ops, not in a Pallas
kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: checksum channel width per transmission (uint32 on the wire)
CHECKSUM_BYTES = 4

_PLAN_STREAM = 7919      # rng stream for fault kinds (shared with the ledger)
_DETAIL_STREAM = 104729  # rng stream for victims and bit positions
_GOLDEN = 2654435761     # odd multiplier of the checksum's position weights
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Seeded fault-injection configuration (frozen and hashable, like
    ``compress.TransportSpec``)."""

    drop: float = 0.0      # P(attempt payload zeroed in flight)
    corrupt: float = 0.0   # P(attempt payload has one bit flipped)
    dup: float = 0.0       # P(clean transmission duplicated)
    delay: float = 0.0     # P(clean transmission delayed — event only)
    seed: int = 0
    max_retries: int = 3

    def __post_init__(self):
        for name in ("drop", "corrupt", "dup", "delay"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"chaos {name} rate {v} outside [0, 1]")
        if self.drop + self.corrupt >= 1.0:
            raise ValueError("drop + corrupt must be < 1 (a transmission "
                             "must be able to succeed)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def zero_fault(self) -> bool:
        return (self.drop == 0.0 and self.corrupt == 0.0
                and self.dup == 0.0 and self.delay == 0.0)

    @property
    def tag(self) -> str:
        return (f"chaos(drop={self.drop},corrupt={self.corrupt},"
                f"dup={self.dup},delay={self.delay},seed={self.seed})")


def plan_for_slot(spec: ChaosSpec, slot: int) -> tuple:
    """Deterministic fault schedule of exchange slot ``slot``:
    ``(fails, final)``, ``fails`` a list of failed-attempt kinds
    (``"drop"`` | ``"corrupt"``, at most ``max_retries``) and ``final`` the
    clean transmission's disposition (``"clean"`` | ``"dup"`` |
    ``"delay"``)."""
    rng = np.random.default_rng([spec.seed, _PLAN_STREAM, slot])
    fails = []
    for _ in range(spec.max_retries):
        u = rng.random()
        if u < spec.drop:
            fails.append("drop")
        elif u < spec.drop + spec.corrupt:
            fails.append("corrupt")
        else:
            break
    u = rng.random()
    final = ("dup" if u < spec.dup
             else "delay" if u < spec.dup + spec.delay else "clean")
    return fails, final


def slot_details(spec: ChaosSpec, slot: int, num_parties: int,
                 n_fails: int) -> list:
    """Victim party and bit position of every failed attempt in a slot —
    a separate rng stream, so the byte accounting never needs them."""
    rng = np.random.default_rng([spec.seed, _DETAIL_STREAM, slot])
    return [(int(rng.integers(num_parties)), int(rng.integers(1 << 30)))
            for _ in range(n_fails)]


def transmissions_for_slot(spec: ChaosSpec, slot: int) -> int:
    fails, final = plan_for_slot(spec, slot)
    return len(fails) + 1 + (1 if final == "dup" else 0)


def plan_summary(spec: ChaosSpec, n_slots: int) -> dict:
    """Fault events over one forest build's slots (= one boosting round:
    every round makes the same slots)."""
    out = {"dropped": 0, "corrupted": 0, "duplicated": 0, "delayed": 0,
           "retries": 0, "slots": n_slots}
    for s in range(n_slots):
        fails, final = plan_for_slot(spec, s)
        out["dropped"] += sum(1 for k in fails if k == "drop")
        out["corrupted"] += sum(1 for k in fails if k == "corrupt")
        out["duplicated"] += 1 if final == "dup" else 0
        out["delayed"] += 1 if final == "delay" else 0
        out["retries"] += len(fails) + (1 if final == "dup" else 0)
    out["faults_injected"] = (out["dropped"] + out["corrupted"]
                              + out["duplicated"] + out["delayed"])
    return out


def n_slots_per_tree(aggregation: str, max_depth: int) -> int:
    """Exchange slots one forest build makes: one histogram gather per
    level, or three candidate gathers per level (gain, feature, threshold)
    under argmax/top-k."""
    return max_depth if aggregation == "histogram" else 3 * max_depth


def _raw_bytes(x: torch.Tensor) -> torch.Tensor:
    """(..., m) payload rows as (..., m * itemsize) uint8, in memory order
    (little-endian, as the JAX package's ``bitcast_convert_type``)."""
    return x.contiguous().view(torch.uint8)


def _checksum_rows(u: torch.Tensor) -> torch.Tensor:
    """uint32 checksums (as int64) of the rows of a (..., nbytes) uint8
    tensor.  Each product byte * weight is reduced mod 2^32 before the sum,
    so an int64 sum of fewer than 2^31 terms cannot overflow."""
    idx = torch.arange(u.shape[-1], dtype=torch.int64, device=u.device)
    weights = (idx * _GOLDEN + 1) & _MASK32
    return ((u.to(torch.int64) * weights) & _MASK32).sum(-1) & _MASK32


def payload_checksum(x: torch.Tensor) -> torch.Tensor:
    """uint32 checksum (a 0-dim int64 tensor) of a payload's raw bytes: the
    position-weighted byte sum with odd weights ``i * 2654435761 + 1`` mod
    2^32, so any single bit flip — and any zeroing of a nonzero payload —
    changes it (``odd * 2^b != 0 mod 2^32`` for b < 32)."""
    return _checksum_rows(_raw_bytes(x).reshape(-1))


def _flip_one_bit(x: torch.Tensor, rand: int) -> torch.Tensor:
    """``x`` with bit ``rand mod (8 * nbytes)`` of its raw bytes flipped."""
    flat = _raw_bytes(x).reshape(-1).clone()
    pos = rand % (flat.numel() * 8)
    flat[pos // 8] ^= 1 << (pos % 8)
    return flat.view(x.dtype).reshape(x.shape)


def _per_party_view(g: torch.Tensor, axis: int, parties: int):
    """The gathered payload as (party, slice): the parties' equal blocks
    folded out of the concatenation axis ``axis``."""
    axis = axis % g.ndim
    shape = tuple(g.shape)
    new = (shape[:axis] + (parties, shape[axis] // parties)
           + shape[axis + 1:])
    return g.reshape(new), axis


class ChaoticGather:
    """Fault-injecting gather, composable over any base exchange with the
    port's seam signature ``gather(parts, axis)`` (``parts`` the parties'
    payloads, party 0 first, concatenated along ``axis``).  The slot
    counter indexes the fault plan; the backends reset it at every
    forest-build entry (``begin_trace``)."""

    def __init__(self, spec: ChaosSpec, base_gather, num_parties: int,
                 meter=None):
        self.spec = spec
        self.base_gather = base_gather
        self.num_parties = num_parties
        self.meter = meter
        self._slot = 0

    def begin_trace(self) -> None:
        self._slot = 0

    def _checksums(self, g: torch.Tensor, axis: int) -> torch.Tensor:
        """(P,) checksums of the gathered payload's party slices."""
        pv, pax = _per_party_view(g, axis, self.num_parties)
        rows = pv.movedim(pax, 0).reshape(self.num_parties, -1)
        return _checksum_rows(_raw_bytes(rows))

    def __call__(self, parts, axis: int) -> torch.Tensor:
        parts = list(parts)
        slot, self._slot = self._slot, self._slot + 1
        spec, parties = self.spec, self.num_parties
        if len(parts) != parties:
            raise ValueError(f"{len(parts)} payloads for {parties} parties")
        fails, final = plan_for_slot(spec, slot)
        details = slot_details(spec, slot, parties, len(fails))
        if self.meter is not None:
            for kind, event in (("drop", "dropped"), ("corrupt",
                                                      "corrupted")):
                self.meter.count(event, fails.count(kind))
            self.meter.count("duplicated", int(final == "dup"))
            self.meter.count("delayed", int(final == "delay"))
            self.meter.count("retries", len(fails) + int(final == "dup"))

        # each sender's checksum of its clean payload rides every
        # transmission; the receiver verifies per party slice
        chk_all = torch.stack([payload_checksum(x) for x in parts])
        gathered, oks = [], []
        n_tx = len(fails) + 1 + (1 if final == "dup" else 0)
        for t in range(n_tx):
            sent = parts
            if t < len(fails):
                victim, rand = details[t]
                x = parts[victim]
                sent = list(parts)
                sent[victim] = (torch.zeros_like(x) if fails[t] == "drop"
                                else _flip_one_bit(x, rand))
            g = self.base_gather(sent, axis)
            gathered.append(g)
            oks.append(self._checksums(g, axis) == chk_all)
            if self.meter is not None:
                self.meter.record_nbytes("retries", CHECKSUM_BYTES)
                if t > 0:
                    self.meter.record("retries", parts[0])

        # fold: per party slice, the first transmission whose checksum
        # verified (the last one is clean by construction)
        result = gathered[-1]
        for g, ok in zip(reversed(gathered[:-1]), reversed(oks[:-1])):
            pv_g, pax = _per_party_view(g, axis, parties)
            pv_r, _ = _per_party_view(result, axis, parties)
            okb = ok.reshape((1,) * pax + (parties,)
                             + (1,) * (pv_g.ndim - pax - 1))
            result = torch.where(okb, pv_g, pv_r).reshape(g.shape)
        return result
