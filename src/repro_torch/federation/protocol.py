"""Message ledger: exact per-round communication volume of the VFL protocol
— a copy of ``repro/federation/protocol.py`` (plain arithmetic, no JAX),
kept here so the port imports no module of the JAX package.  The chaos
transport's retry model (``wire_retry_bytes``) replays the port's own copy
of the fault plan (``federation/chaos.py``).

The paper motivates FedGBF by SecureBoost's "high interactive communication
costs" but never quantifies them; this module does, from first principles, so
the communication claim becomes measurable (benchmarks/comm_bench.py ->
BENCH_comm.json) and so the dry-run's collective-roofline term for the
tabular workload has a ground truth to compare against.

Two cost models live here (DESIGN.md §5):

* the **Paillier protocol model** (``tree_cost`` / ``run_cost``) — the
  paper-world prediction: histogram entries priced as ciphertexts, id
  partitions as bitmaps, sampling rates shrinking the messages;
* the **wire model** (``wire_party_tree_cost`` / ``wire_run_cost``) — the
  predicted *actual* payload of the SPMD implementation (plaintext float32/
  int payloads, full shard width, the feature mask as its own message),
  per transport format (raw / quantized / top-k).

``ProtocolLedger`` reconciles the wire model against *measured* bytes — the
payload sizes every collective in federation/{aggregator,compress,vfl}.py
reports (``compress.MessageMeter`` / ``probe_tree_cost``).  For the lossless
transports measured must equal predicted exactly; a mismatch means the
implementation and the cost model drifted apart.

Message inventory per *tree* (Alg. 2), with n = samples, d_p = party p's
features, B = bins, L = levels (= max_depth), P = passive parties:

  1. grad broadcast     active -> each passive: n ciphertext pairs (g, h)
                        [once per boosting round, shared by the round's trees
                        when sample masks are communicated as id lists]
  2. histograms         each passive -> active, per level:
                        nodes(l) * d_p * B * 2 ciphertexts  ("histogram" mode)
                        or nodes(l) * (1 gain + 1 feat + 1 thr) plaintexts
                        ("argmax" mode — the beyond-paper variant)
  3. split notify       active -> owner party: nodes(l) small tuples
  4. id partition       owner -> active: n-bit bitmap per level

Ciphertext size: Paillier with ``key_bits`` modulus has 2*key_bits-bit
ciphertexts (mod N^2); FATE's default key is 1024 bits -> 256 B each.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import dynamic
from repro_torch.core.types import FedGBFConfig


@dataclass(frozen=True)
class ProtocolCosts:
    """Per-phase byte counts for one full training run."""

    grad_broadcast: int
    histograms: int
    split_notify: int
    id_partition: int

    @property
    def total(self) -> int:
        return (
            self.grad_broadcast + self.histograms
            + self.split_notify + self.id_partition
        )

    def breakdown(self) -> dict:
        return {
            "grad_broadcast": self.grad_broadcast,
            "histograms": self.histograms,
            "split_notify": self.split_notify,
            "id_partition": self.id_partition,
            "total": self.total,
        }


@dataclass(frozen=True)
class ProtocolSpec:
    n_samples: int
    party_dims: tuple          # features per passive+active party (active first)
    num_bins: int = 32
    max_depth: int = 3
    key_bits: int = 1024       # Paillier modulus
    aggregation: str = "histogram"   # or "argmax"
    # Sibling-subtraction pipeline (DESIGN.md §6): levels >= 1 exchange only
    # the left-child histograms (half the frontier); the right siblings are
    # derived locally by the receiver.  Must mirror the implementation's
    # ``TreeConfig.hist_subtraction``.
    hist_subtraction: bool = False
    # Frontier compaction (round engine, DESIGN.md §9): per-level exchanged
    # node count is the static live-slot budget min(2^level,
    # max_active_nodes), not the 2^level frontier.  0 = uncompacted.  Must
    # mirror ``TreeConfig.max_active_nodes``.
    max_active_nodes: int = 0
    # Row sharding (DESIGN.md §8): number of sample shards the rows are
    # distributed over (the mesh's data×pod extent under ``shard_samples``).
    # Only the id_partition bitmap depends on it: each shard ships its own
    # ``ceil(ceil(n/shards)/8)``-byte bitmap per level (rows pad to the
    # shard granularity with weight-0 entries), so the per-shard byte
    # rounding is visible in the wire total.  1 = single host.
    data_shards: int = 1
    # Gradient channels K of the objective (DESIGN.md §11): scalar
    # objectives (logistic, squared, quantile) have K = 1; softmax{K} ships
    # K per-class (g, h) pairs.  Scales the grad broadcast (2K values/row),
    # the histogram payloads (2K wire channels + the local count) and the
    # Paillier ciphertext counts (2K ciphertexts per bin).  Must mirror
    # ``objective.get_objective(cfg.loss).n_classes``.
    n_channels: int = 1

    @property
    def ciphertext_bytes(self) -> int:
        return 2 * self.key_bits // 8

    @property
    def passive_parties(self) -> int:
        return len(self.party_dims) - 1

    def active_nodes(self, level: int) -> int:
        """Static exchanged-slot width of a level (compaction-aware)."""
        return _active_nodes(level, self.max_active_nodes)


def _active_nodes(level: int, max_active_nodes: int) -> int:
    width = 2 ** level
    return min(width, max_active_nodes) if max_active_nodes else width


def _nodes_sent(level: int, hist_subtraction: bool,
                max_active_nodes: int) -> int:
    """Histogram-mode node-histograms one party ships at ``level``: the
    active slot width — under subtraction, levels >= 1 ship only the left
    children, i.e. the PARENT level's active width (the §6 halving and the
    §9 compaction compose in this one expression)."""
    if level == 0 or not hist_subtraction:
        return _active_nodes(level, max_active_nodes)
    return _active_nodes(level - 1, max_active_nodes)


def tree_cost(spec: ProtocolSpec, rho_id: float, rho_feat: float) -> ProtocolCosts:
    """Bytes exchanged to build ONE tree (grad broadcast excluded; it is
    per-round, see run_cost)."""
    n = int(round(spec.n_samples * rho_id))
    ct = spec.ciphertext_bytes
    hist_bytes = 0
    notify_bytes = 0
    partition_bytes = 0
    for level in range(spec.max_depth):
        # subtraction halves and compaction caps the exchanged node count —
        # the same ``_nodes_sent`` expression in both cost models.
        nodes = spec.active_nodes(level)
        nodes_sent = _nodes_sent(
            level, spec.hist_subtraction, spec.max_active_nodes
        )
        for d_p in spec.party_dims[1:]:  # passive parties only send histograms
            d_eff = max(1, int(round(d_p * rho_feat)))
            if spec.aggregation == "histogram":
                # 2K ciphertexts per bin: one (g, h) pair per channel.
                hist_bytes += (nodes_sent * d_eff * spec.num_bins
                               * 2 * spec.n_channels * ct)
            else:  # argmax: gain (f32) + feature (i32) + threshold (i32)
                hist_bytes += nodes * 12
        notify_bytes += nodes * 12
        partition_bytes += (n + 7) // 8  # one n-bit bitmap per level
    return ProtocolCosts(
        grad_broadcast=0,
        histograms=hist_bytes,
        split_notify=notify_bytes,
        id_partition=partition_bytes,
    )


def run_cost(spec: ProtocolSpec, cfg: FedGBFConfig) -> ProtocolCosts:
    """Total bytes for a full (Dynamic) FedGBF training run under ``cfg``."""
    ct = spec.ciphertext_bytes
    grad = hist = notify = part = 0
    for m in range(1, cfg.rounds + 1):
        n_trees = dynamic.n_trees_schedule(cfg, m)
        rho_id = dynamic.rho_id_schedule(cfg, m)
        n_eff = int(round(spec.n_samples * rho_id))
        # one encrypted (g, h) broadcast per round, to each passive party,
        # restricted to the union of sampled ids (bounded by n_eff * trees);
        # 2K ciphertexts per sampled row under a K-channel objective.
        grad += spec.passive_parties * min(
            spec.n_samples, n_eff * n_trees
        ) * 2 * spec.n_channels * ct
        for _ in range(n_trees):
            c = tree_cost(spec, rho_id, cfg.rho_feat)
            hist += c.histograms
            notify += c.split_notify
            part += c.id_partition
    return ProtocolCosts(grad, hist, notify, part)


@dataclass
class Ledger:
    """Mutable run-time ledger for drivers that want live accounting."""

    entries: list = field(default_factory=list)

    def record(self, phase: str, nbytes: int, round_idx: int) -> None:
        self.entries.append({"phase": phase, "bytes": int(nbytes), "round": round_idx})

    def total(self) -> int:
        return sum(e["bytes"] for e in self.entries)

    def by_phase(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e["phase"]] = out.get(e["phase"], 0) + e["bytes"]
        return out


# ---------------------------------------------------------------------------
# Wire model: predicted ACTUAL payloads of the SPMD implementation
# ---------------------------------------------------------------------------

#: phases whose recorded payload is per *sending party* — the measured run
#: cost multiplies them by the passive-party count (the active party's own
#: contribution never traverses the wire).  ``id_partition`` is counted once
#: per level: protocol-wise it is the owning party's single message (the
#: other parties' psum contributions are structurally zero).
PER_PASSIVE_PHASES = ("grad_broadcast", "histograms", "feature_mask",
                      "split_candidates", "retries")

#: ``retries`` is the chaos transport's integrity + retransmission channel
#: (DESIGN.md §13): 4 checksum bytes per transmission plus the full payload
#: for every transmission after the first.  Zero when no chaos wrapper is
#: active; at zero fault rate it is exactly 4 bytes per exchange slot.
WIRE_PHASES = ("grad_broadcast", "histograms", "feature_mask",
               "split_candidates", "id_partition", "retries")


def wire_party_tree_cost(
    n_samples: int,
    d_party: int,
    num_bins: int,
    max_depth: int,
    aggregation: str = "histogram",
    transport=None,
    hist_subtraction: bool = False,
    max_active_nodes: int = 0,
    data_shards: int = 1,
    n_channels: int = 1,
    chaos=None,
) -> dict:
    """Predicted actual bytes ONE party ships to build ONE tree, mirroring
    the shard_map implementation payload-for-payload (the quantity
    ``compress.probe_tree_cost`` measures from the traced program):

      histogram mode   per level: the full local float32 (g, h, count)
                       histogram ``nodes * d_party * B * (2K+1) * 4`` — or,
                       when quantized, ``nodes * d_party * (B * 2K * bits/8
                       + 2K * 4)`` (int payload for the 2K g/h wire
                       channels + one float32 scale per (node, feature,
                       channel); the count channel stays local) — plus
                       the bool feature-mask slice (``d_party`` bytes; the
                       mask rides the wire, it does not shrink the
                       histogram, unlike the Paillier model's ``rho_feat``).
                       K = ``n_channels`` is 1 for scalar objectives;
      argmax mode      per level: ``nodes * k * 12`` candidate bytes
                       (gain f32 + feature i32 + threshold i32), k = 1 raw
                       or ``transport.k`` for top-k;
      id_partition     per level: the BIT-PACKED routing bitmap — 1 bit per
                       sample, ``ceil(n_shard/8)`` uint8 bytes per data
                       shard with ``n_shard = ceil(n/data_shards)`` (rows
                       pad to the shard granularity with weight-0 entries;
                       each shard ships its own byte-rounded slice).  The
                       SPMD psum operand covers every sample, masked or not
                       (counted once, not per party).

    ``transport`` is a ``compress.TransportSpec`` or None (raw).
    ``hist_subtraction`` halves the histogram-mode payload node count at
    levels >= 1 (only the left children ship; DESIGN.md §6) — at depth 3 the
    per-tree histogram phase drops from 7 to 4 node-histograms, a 1.75× cut.
    ``max_active_nodes`` caps every level's exchanged node count at the
    round engine's static live-slot budget (frontier compaction, DESIGN.md
    §9) — the T-axis round collective ships exactly ``active(level)`` slots
    per tree regardless of the 2^level frontier.
    """
    kind = "raw" if transport is None else transport.kind
    phases = dict.fromkeys(WIRE_PHASES, 0)
    hist_levels = wire_hist_level_bytes(
        d_party, num_bins, max_depth, transport, hist_subtraction,
        max_active_nodes, n_channels,
    )
    n_shard = -(-n_samples // data_shards)  # rows pad to shard granularity
    id_bytes = data_shards * ((n_shard + 7) // 8)
    for level in range(max_depth):
        nodes = _active_nodes(level, max_active_nodes)
        if aggregation == "histogram":
            phases["histograms"] += hist_levels[level]
            phases["feature_mask"] += d_party
        else:  # argmax
            k = transport.k if kind == "topk" else 1
            k = min(k, d_party * num_bins)
            phases["split_candidates"] += nodes * k * (4 + 4 + 4)
        phases["id_partition"] += id_bytes
    if chaos is not None:
        phases["retries"] = wire_retry_bytes(
            chaos, d_party, num_bins, max_depth, aggregation, transport,
            hist_subtraction, max_active_nodes, n_channels,
        )
    return phases


def _chaos_slot_bytes(
    d_party: int,
    num_bins: int,
    max_depth: int,
    aggregation: str = "histogram",
    transport=None,
    hist_subtraction: bool = False,
    max_active_nodes: int = 0,
    n_channels: int = 1,
) -> list:
    """Per-SLOT payload bytes of the chaos-wrapped exchange, in the exact
    order the forest build makes its gathers: one histogram gather per
    level (the quantized int payload only — the scale gather is outside
    the chaos seam), or three candidate gathers (gain, feature, threshold)
    per level under argmax/top-k."""
    kind = "raw" if transport is None else transport.kind
    gh = 2 * n_channels
    slots = []
    if aggregation == "histogram":
        per_node = (num_bins * gh * transport.bits // 8
                    if kind == "quantized" else num_bins * (gh + 1) * 4)
        for level in range(max_depth):
            nodes = _nodes_sent(level, hist_subtraction, max_active_nodes)
            slots.append(nodes * d_party * per_node)
    else:  # argmax: three (nodes, k) gathers of 4-byte lanes
        k = transport.k if kind == "topk" else 1
        k = min(k, d_party * num_bins)
        for level in range(max_depth):
            nodes = _active_nodes(level, max_active_nodes)
            slots.extend([nodes * k * 4] * 3)
    return slots


def wire_retry_bytes(
    chaos,
    d_party: int,
    num_bins: int,
    max_depth: int,
    aggregation: str = "histogram",
    transport=None,
    hist_subtraction: bool = False,
    max_active_nodes: int = 0,
    n_channels: int = 1,
) -> int:
    """Predicted per-tree ``retries`` bytes under a ``chaos.ChaosSpec``:
    replay the pure fault plan slot by slot and charge 4 checksum bytes per
    transmission plus the slot payload for every retransmission — the
    predicted twin of what ``chaos.ChaoticGather`` meters, so the ledger's
    reconciliation stays exact under injected faults."""
    from repro_torch.federation.chaos import CHECKSUM_BYTES, plan_for_slot

    slots = _chaos_slot_bytes(d_party, num_bins, max_depth, aggregation,
                              transport, hist_subtraction, max_active_nodes,
                              n_channels)
    total = 0
    for s, payload in enumerate(slots):
        fails, final = plan_for_slot(chaos, s)
        tx = len(fails) + 1 + (1 if final == "dup" else 0)
        total += tx * CHECKSUM_BYTES + (tx - 1) * payload
    return total


def wire_hist_level_bytes(
    d_party: int,
    num_bins: int,
    max_depth: int,
    transport=None,
    hist_subtraction: bool = False,
    max_active_nodes: int = 0,
    n_channels: int = 1,
) -> list:
    """Per-LEVEL histogram-phase bytes one party ships for one tree
    (histogram aggregation) — the level profile benchmarks record so the
    subtraction pipeline's shape (full root, half everywhere below) and the
    compaction cap (active width, not 2^level) are visible, not just the
    per-tree total.  ``n_channels`` (K) widens the stats lanes only: raw
    payloads carry 2K+1 float32 channels, quantized ones 2K int channels +
    2K float32 scales (count stays local)."""
    kind = "raw" if transport is None else transport.kind
    gh = 2 * n_channels
    per_node = (
        num_bins * gh * transport.bits // 8 + gh * 4 if kind == "quantized"
        else num_bins * (gh + 1) * 4
    )
    return [
        _nodes_sent(level, hist_subtraction, max_active_nodes)
        * d_party * per_node
        for level in range(max_depth)
    ]


def wire_run_cost(spec: ProtocolSpec, cfg: FedGBFConfig, transport=None,
                  chaos=None) -> dict:
    """Predicted actual bytes for a full training run under ``cfg``.

    Per-passive-party phases scale by the passive count; ``party_dims`` must
    be the *even shard* dims the implementation runs with (``d_global /
    parties`` after ``data.tabular.pad_features``).  The (g, h) broadcast is
    ``n * 2 * 4`` bytes per passive party per round — the arrays enter the
    program replicated and full-length regardless of the sampling schedule
    (the Paillier model's id-list shrinkage has no wire counterpart here).
    """
    d_party = spec.party_dims[-1]
    per_tree = wire_party_tree_cost(
        spec.n_samples, d_party, spec.num_bins, spec.max_depth,
        spec.aggregation, transport, spec.hist_subtraction,
        spec.max_active_nodes, spec.data_shards, spec.n_channels,
        chaos=chaos,
    )
    grad_per_round = spec.n_samples * 2 * spec.n_channels * 4
    return _assemble_run_cost(per_tree, grad_per_round,
                              spec.passive_parties, cfg)


def measured_run_cost(
    per_tree: dict, grad_per_round: int, passive_parties: int,
    cfg: FedGBFConfig,
) -> dict:
    """Scale ``compress.probe_tree_cost`` measurements up to a full run with
    the exact schedule arithmetic of ``wire_run_cost`` — the two dicts must
    match key-for-key for lossless AND quantized transports (payload sizes
    are shape-determined either way).

    Scope of the reconciliation: the *per-tree payloads* are the genuinely
    independent cross-check (traced operands vs hand-derived formulas); the
    schedule/passive-party scaling is deliberately shared between both
    sides (``_assemble_run_cost``), so drift in that arithmetic moves
    measured and predicted together and is covered by the protocol-model
    tests instead, not by ``ProtocolLedger.matches()``."""
    return _assemble_run_cost(per_tree, grad_per_round, passive_parties, cfg)


def per_round_cost(per_tree, grad_per_round, passive_parties, cfg) -> list:
    """Per-ROUND wire bytes under the schedule: one {phase: bytes} dict per
    round, m = 1..cfg.rounds.

    This is the single schedule/passive-party scaling ``_assemble_run_cost``
    sums — exported so the trace/log join (DESIGN.md §12) emits EXACTLY the
    ledger's numbers per round: summing these rows reproduces
    ``measured_run_cost``/``wire_run_cost`` phase-for-phase by construction,
    which is what makes the Perfetto wire spans reconcile exactly with
    ``ProtocolLedger.breakdown()``.
    """
    rows = []
    for m in range(1, cfg.rounds + 1):
        n_trees = dynamic.n_trees_schedule(cfg, m)
        row = dict.fromkeys(WIRE_PHASES, 0)
        row["grad_broadcast"] += passive_parties * grad_per_round
        for phase, nbytes in per_tree.items():
            mult = passive_parties if phase in PER_PASSIVE_PHASES else 1
            row[phase] = row.get(phase, 0) + mult * n_trees * nbytes
        rows.append(row)
    return rows


def _assemble_run_cost(per_tree, grad_per_round, passive_parties, cfg) -> dict:
    out = dict.fromkeys(WIRE_PHASES, 0)
    for row in per_round_cost(per_tree, grad_per_round, passive_parties, cfg):
        for phase, nbytes in row.items():
            out[phase] = out.get(phase, 0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclass
class ProtocolLedger:
    """Measured-vs-predicted accounting for one training run (DESIGN.md §5).

    ``spec``/``cfg``/``transport`` fix the predicted wire model;
    ``record_measured`` accumulates the measured side (from
    ``compress.probe_tree_cost`` scaled by the schedule, or any driver
    recording live).  ``reconcile`` diffs the two per phase — exact equality
    is the contract for every transport (payload sizes are shape-determined
    even when the *values* are lossy), asserted by ``federation/selftest.py``
    and reported in BENCH_comm.json.
    """

    spec: ProtocolSpec
    cfg: FedGBFConfig
    transport: object = None     # compress.TransportSpec or None (raw)
    chaos: object = None         # chaos.ChaosSpec or None (no fault wrapper)
    measured: dict = field(default_factory=dict)
    #: the last ``record_run`` probe, kept so per-round views
    #: (``per_round_measured``) are derivable from the ledger alone
    probe: dict = field(default_factory=dict)

    def record_measured(self, phase: str, nbytes: int) -> None:
        self.measured[phase] = self.measured.get(phase, 0) + int(nbytes)

    def record_run(self, per_tree: dict, grad_per_round: int) -> None:
        """Accumulate a whole run's measured bytes from a per-tree probe."""
        self.probe = {"per_tree": dict(per_tree),
                      "grad_per_round": int(grad_per_round)}
        run = measured_run_cost(
            per_tree, grad_per_round, self.spec.passive_parties, self.cfg
        )
        for phase, nbytes in run.items():
            if phase != "total":
                self.record_measured(phase, nbytes)

    def per_round_measured(self) -> list:
        """Measured bytes per round (``per_round_cost`` over the stored
        probe) — the rows the trace exporter and ``--log-json`` consume;
        their per-phase sums equal ``self.measured`` exactly.  Empty when
        no ``record_run`` probe was taken."""
        if not self.probe:
            return []
        return per_round_cost(
            self.probe["per_tree"], self.probe["grad_per_round"],
            self.spec.passive_parties, self.cfg,
        )

    def predicted(self) -> dict:
        """Wire-model prediction (actual plaintext payloads)."""
        return wire_run_cost(self.spec, self.cfg, self.transport,
                             chaos=self.chaos)

    def predicted_paillier(self) -> ProtocolCosts:
        """Paper-world protocol prediction (Paillier ciphertext rates)."""
        return run_cost(self.spec, self.cfg)

    def measured_total(self) -> int:
        return sum(self.measured.values())

    def reconcile(self) -> dict:
        """Per-phase {predicted, measured, delta, match}; 'match' is exact."""
        pred = self.predicted()
        phases = [p for p in pred if p != "total"]
        out = {}
        for phase in phases:
            p, m = pred[phase], self.measured.get(phase, 0)
            out[phase] = {"predicted": p, "measured": m,
                          "delta": m - p, "match": m == p}
        out["total"] = {
            "predicted": pred["total"], "measured": self.measured_total(),
            "delta": self.measured_total() - pred["total"],
            "match": self.measured_total() == pred["total"],
        }
        return out

    def matches(self) -> bool:
        return all(v["match"] for v in self.reconcile().values())

    def breakdown(self) -> dict:
        """Per-phase measured/predicted totals plus per-*mode* wire totals
        (histogram vs argmax under this spec/cfg, raw transport, each with
        and without sibling subtraction), so benchmarks diff the modes
        without re-deriving the schedule math.  ``hist_phase_by_mode``
        carries the histogram-phase bytes alone — the quantity the
        subtraction pipeline halves (7 → 4 node-histograms per depth-3 tree,
        a 1.75× phase cut, visible as histogram vs histogram+sub)."""
        from dataclasses import replace

        modes, hist_phase = {}, {}
        for name, agg, sub in (
            ("histogram", "histogram", False),
            ("histogram+sub", "histogram", True),
            ("argmax", "argmax", False),
        ):
            run = wire_run_cost(
                replace(self.spec, aggregation=agg, hist_subtraction=sub),
                self.cfg,
            )
            modes[name] = run["total"]
            hist_phase[name] = run["histograms"]
        return {
            "measured": dict(self.measured),
            "measured_total": self.measured_total(),
            "predicted": self.predicted(),
            "predicted_paillier": self.predicted_paillier().breakdown(),
            "modes": modes,
            "hist_phase_by_mode": hist_phase,
        }
