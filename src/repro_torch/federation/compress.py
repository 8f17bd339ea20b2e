"""Message compression and byte metering of the VFL transport: the
counterpart of ``repro/federation/compress.py``.

* The quantization codec (``quantize_stats`` / ``dequantize_stats``).  The
  JAX package draws its stochastic-rounding noise with
  ``jax.random.uniform`` under threefry, which torch cannot reproduce, so
  the noise is an input here: ``uniform`` (the JAX package's draws, for
  parity) or drawn from an explicit ``torch.Generator`` on the CPU.
  ``jnp.round`` and ``torch.round`` both round half to even.
* ``TransportSpec``: the wire format of the per-level exchange — raw
  float32, int8/int16 histogram payloads plus per-(node, feature,
  channel) scales (``quantized_round_histogram_fn``; the count channel is
  never shipped, so the merged histogram's count is 0), or each party's k
  best split candidates (``topk_round_choose_fn``).
* ``MessageMeter`` and the probes: every exchange records the payload it
  ships.  The JAX probes trace the program with ``jax.eval_shape``; the
  port's run a dry call instead — a fresh meter, a fresh backend, one
  T = 1 (or T-tree) forest build on zero inputs — and read the meter.
  ``reconciled_ledger`` hands the measured per-tree bytes to
  ``protocol.ProtocolLedger``, whose wire model must agree exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import histogram as hist_mod
from repro_torch.core import split as split_mod
from repro_torch.core.types import TreeConfig
from repro_torch.federation import aggregator

#: histogram stat channels on the wire under quantization for a K = 1
#: objective: (sum_g, sum_h); K-channel objectives ship 2K (everything but
#: the trailing count).
GH_STATS = 2


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """Wire format of the per-level VFL exchange.

    ``kind``: ``"raw"`` (float32 payloads), ``"quantized"`` (int``bits``
    histogram payload + float32 scales; histogram aggregation only) or
    ``"topk"`` (``k`` best candidates per node per party; argmax
    aggregation only).  ``seed`` roots the native rounding draws."""

    kind: str = "raw"
    bits: int = 8
    k: int = 4
    stochastic: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("raw", "quantized", "topk"):
            raise ValueError(f"unknown transport kind {self.kind!r}")
        if self.kind == "quantized" and self.bits not in (8, 16):
            raise ValueError(f"quantized transport needs bits in (8, 16), "
                             f"got {self.bits}")
        if self.kind == "topk" and self.k < 1:
            raise ValueError(f"topk transport needs k >= 1, got {self.k}")

    @property
    def tag(self) -> str:
        """Short name in backend names: "raw", "q8", "q16" or "topk"."""
        if self.kind == "quantized":
            return f"q{self.bits}"
        return self.kind


RAW = TransportSpec()
Q8 = TransportSpec(kind="quantized", bits=8)
Q16 = TransportSpec(kind="quantized", bits=16)
TOPK = TransportSpec(kind="topk", k=4)


def quantize_stats(x: torch.Tensor, bits: int,
                   uniform: torch.Tensor | None = None,
                   stochastic: bool = True,
                   generator: torch.Generator | None = None,
                   reciprocal: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize stats to int``bits`` along the second-last axis.

    Args:
      x: (..., B, C) float32.
      bits: 8 or 16.
      uniform: (..., B, C) float32 draws in [0, 1) for stochastic rounding
        (floor(x/s + u)); None draws them with ``torch.rand`` from
        ``generator`` (default: seed 0) on the CPU.
      stochastic: stochastic rounding, else round half to even.
      reciprocal: form the scale as ``absmax`` times the float32
        reciprocal of ``qmax``, as XLA compiles the division by that
        constant inside a jitted program (the JAX package's transport);
        False divides, as its eager ``quantize_ensemble`` does.

    Returns:
      (q, scale): q (..., B, C) int8/int16; scale (..., C) float32 with
      ``x ≈ q * scale[..., None, :]``.  All-zero slices get scale 1.
    """
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    absmax = x.abs().amax(dim=-2, keepdim=True)                 # (..., 1, C)
    # divide by a tensor: on CUDA, dividing by a Python scalar multiplies
    # by its rounded reciprocal, which is not XLA's division for 32767
    if reciprocal:
        scaled = absmax * torch.full_like(absmax, float(
            torch.tensor(1.0) / torch.tensor(qmax)))
    else:
        scaled = absmax / torch.full_like(absmax, qmax)
    scale = torch.where(absmax > 0, scaled, torch.ones_like(absmax))
    y = x / scale
    if stochastic:
        if uniform is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            uniform = torch.rand(tuple(x.shape), generator=generator)
        y = torch.floor(y + uniform.to(device=x.device, dtype=torch.float32))
    else:
        y = torch.round(y)
    dtype = torch.int8 if bits == 8 else torch.int16
    q = y.clamp(-qmax, qmax).to(dtype)
    return q, scale[..., 0, :].to(torch.float32)


def dequantize_stats(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_stats``: (..., B, C) int x (..., C) -> float32."""
    return q.to(torch.float32) * scale[..., None, :]


# ---------------------------------------------------------------------------
# Rounding draws
# ---------------------------------------------------------------------------
#: ``draws(level, num_nodes, party, shape) -> (shape) float32 uniforms`` in
#: [0, 1): the stochastic-rounding noise of one party's payload at one
#: level.  The JAX package keys it ``fold_in(fold_in(fold_in(PRNGKey(seed),
#: level), num_nodes), party)``, independent of the round and of the
#: training key; parity tests pass those draws.
Draws = Callable[[int, int, int, tuple], torch.Tensor]

_MIX = 1_000_003


def native_draws(seed: int = 0) -> Draws:
    """The port's own draws: ``torch.rand`` on the CPU from a generator
    seeded by (seed, level, num_nodes, party), so a run on the card and one
    on the CPU round the same way; the caller moves them to the device."""

    def draws(level: int, num_nodes: int, party: int,
              shape: tuple) -> torch.Tensor:
        key = seed
        for v in (level, num_nodes, party):
            key = (key * _MIX + v) % (1 << 63)
        return torch.rand(shape, generator=torch.Generator().manual_seed(
            key))

    return draws


# ---------------------------------------------------------------------------
# Measured-bytes plumbing
# ---------------------------------------------------------------------------
class MessageMeter:
    """Recorder of the payloads the exchanges ship.

    Each exchange calls ``record(phase, tensor)`` once on the payload ONE
    party ships (``numel * element_size`` bytes).  The JAX meter records
    once per trace; this one once per call, so the per-tree ledger numbers
    come from a dry T = 1 call (``probe_tree_cost``), and a whole run's
    meter is a different quantity."""

    def __init__(self) -> None:
        self.entries: list = []

    def record(self, phase: str, tensor: torch.Tensor) -> None:
        self.entries.append({"phase": phase, "nbytes": int(tensor.numel())
                             * tensor.element_size()})

    def phase_totals(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e["phase"]] = out.get(e["phase"], 0) + e["nbytes"]
        return out

    def phase_counts(self) -> dict:
        """Records per phase: the round engine's 'one exchange per level,
        whatever T' contract is checked against these."""
        out: dict = {}
        for e in self.entries:
            out[e["phase"]] = out.get(e["phase"], 0) + 1
        return out

    def reset(self) -> None:
        self.entries = []


def _dry_build(num_parties: int, tree: TreeConfig, n_trees: int,
               n_samples: int, num_features: int, n_channels: int,
               device, **backend_kw) -> MessageMeter:
    """One forest build of a fresh metered backend on zero inputs."""
    from repro_torch.federation import vfl  # vfl imports this module

    meter = MessageMeter()
    backend = vfl.make_vfl_backend(num_parties, tree, meter=meter,
                                   **backend_kw)
    gh_shape = (n_samples,) if n_channels == 1 else (n_samples, n_channels)
    zeros = torch.zeros(gh_shape, dtype=torch.float32, device=device)
    backend.build_forest_per_tree(
        torch.zeros((n_samples, num_features), dtype=torch.int32,
                    device=device),
        zeros, zeros,
        torch.zeros((n_trees, n_samples), dtype=torch.float32, device=device),
        torch.ones((n_trees, num_features), dtype=torch.bool, device=device),
        tree)
    return meter


def probe_tree_cost(
    num_parties: int,
    tree: TreeConfig,
    aggregation: str = "histogram",
    transport: Optional[TransportSpec] = None,
    n_samples: int = 1024,
    num_features: Optional[int] = None,
    async_exchange: bool = False,
    n_channels: int = 1,
    device="cpu",
) -> tuple[dict, int]:
    """ONE tree's per-phase wire bytes, measured by a dry T = 1 build.

    Returns (per_tree, grad_per_round): ``per_tree`` maps phase -> bytes
    one sending party ships for one tree (``protocol.PER_PASSIVE_PHASES``
    says which phases scale by the passive parties); ``grad_per_round`` is
    the (g, h) broadcast to one passive party per round."""
    d = num_features if num_features is not None else num_parties * 2
    if d % num_parties:
        raise ValueError(f"num_features={d} must divide over {num_parties} "
                         "parties")
    meter = _dry_build(num_parties, tree, 1, n_samples, d, n_channels,
                       device, aggregation=aggregation, transport=transport,
                       async_exchange=async_exchange)
    totals = meter.phase_totals()
    grad = totals.pop("grad_broadcast", 0)
    return totals, grad


def probe_round_collectives(
    num_parties: int,
    tree: TreeConfig,
    n_trees: int,
    aggregation: str = "histogram",
    transport: Optional[TransportSpec] = None,
    n_samples: int = 1024,
    num_features: Optional[int] = None,
    async_exchange: bool = False,
    device="cpu",
) -> dict:
    """A dry T-tree ROUND build's records per phase and bytes: one
    histogram exchange per level whatever T (two under quantization: the
    int payload and the scales), the async exchange included.

    Returns {"counts": phase -> records, "totals": phase -> bytes}."""
    d = num_features if num_features is not None else num_parties * 2
    meter = _dry_build(num_parties, tree, n_trees, n_samples, d, 1, device,
                       aggregation=aggregation, transport=transport,
                       async_exchange=async_exchange)
    return {"counts": meter.phase_counts(), "totals": meter.phase_totals()}


def reconciled_ledger(
    num_parties: int,
    tree: TreeConfig,
    cfg,
    aggregation: str = "histogram",
    transport: Optional[TransportSpec] = None,
    n_samples: int = 1024,
    num_features: Optional[int] = None,
    async_exchange: bool = False,
    n_channels: int = 1,
    device="cpu",
):
    """Measured-vs-predicted accounting of a training run in one call: the
    dry probe's per-tree bytes recorded into a ``protocol.ProtocolLedger``
    built for the same even party dims, ready for ``reconcile()`` /
    ``breakdown()``.  Pass the backend's own transport
    (``descriptor.transport_spec``)."""
    from repro_torch.federation import protocol

    d = num_features if num_features is not None else num_parties * 2
    per_tree, grad = probe_tree_cost(
        num_parties, tree, aggregation=aggregation, transport=transport,
        n_samples=n_samples, num_features=d, async_exchange=async_exchange,
        n_channels=n_channels, device=device)
    spec = protocol.ProtocolSpec(
        n_samples=n_samples, party_dims=(d // num_parties,) * num_parties,
        num_bins=tree.num_bins, max_depth=tree.max_depth,
        aggregation=aggregation, hist_subtraction=tree.hist_subtraction,
        max_active_nodes=tree.max_active_nodes, n_channels=n_channels)
    ledger = protocol.ProtocolLedger(spec=spec, cfg=cfg, transport=transport)
    ledger.record_run(per_tree, grad)
    return ledger


# ---------------------------------------------------------------------------
# Compressed exchanges
# ---------------------------------------------------------------------------
def quantized_round_histogram_fn(
    transport: TransportSpec = Q8,
    meter: Optional[MessageMeter] = None,
    base_fn: Callable = hist_mod.compute_round_histogram,
    gather: Optional[Callable] = None,
    draws: Optional[Draws] = None,
):
    """Round histogram provider with the quantized exchange: each party
    quantizes its (T, nodes, d_party, B, 2K) g/h channels (the count stays
    local) with one scale per (tree, node, feature, channel), the int
    payloads ride ``gather`` (the exchange seam) and the scales a plain
    gather, and the merged histogram is dequantized with a zero count
    channel.  ``draws`` supplies each party's rounding noise per (level,
    num_nodes, party) (default ``native_draws(transport.seed)``); shared
    root (``root_delta_rows``) is applied before quantization.  The scales
    are ``absmax`` times the float32 ``1 / qmax``: the JAX transport runs
    inside a jitted program, where XLA turns the division by the constant
    into that product."""
    if transport.kind != "quantized":
        raise ValueError(f"need a quantized TransportSpec, got {transport!r}")
    if gather is None:
        gather = aggregator.plain_gather
    if draws is None:
        draws = native_draws(transport.seed)

    def fn(blocks, g, h, weight, assign, num_nodes, num_bins, level=0,
           **kw):
        qs, scales = [], []
        for party, block in enumerate(blocks):
            local = base_fn(block, g, h, weight, assign, num_nodes, num_bins,
                            level=level, **kw)
            payload = local[..., :-1]
            uniform = (draws(level, num_nodes, party, tuple(payload.shape))
                       if transport.stochastic else None)
            q, scale = quantize_stats(payload, transport.bits, uniform,
                                      transport.stochastic, reciprocal=True)
            qs.append(q)
            scales.append(scale)
        if meter is not None:
            meter.record("histograms", qs[0])
            meter.record("histograms", scales[0])
        deq = dequantize_stats(gather(qs, 2),
                               aggregator.plain_gather(scales, 2))
        count = torch.zeros(deq.shape[:-1] + (1,), dtype=deq.dtype,
                            device=deq.device)
        return torch.cat([deq, count], dim=-1)

    return fn


def topk_round_choose_fn(
    cfg: TreeConfig,
    k: int,
    num_parties: int,
    meter: Optional[MessageMeter] = None,
    gather: Optional[Callable] = None,
):
    """Round split chooser exchanging each party's k best candidates per
    node (the argmax aggregation is k = 1), batched over the tree axis:
    one exchange of three (T, nodes, k) payloads per level.

    Each party evaluates the gains of its own columns of the side-by-side
    party histograms (``aggregator.local_round_histogram_fn``), masks its
    features out with -inf, and takes its ``min(k, d_party * B)`` best by
    a STABLE descending sort — equal gains keep the lower flat index, as
    ``lax.top_k`` orders them (``torch.topk`` promises no order of ties).
    The candidates merge party-major (``gather``, the stacking seam: a
    concatenation along the candidate axis), so the first maximum of the
    merged list is the centralized first maximum: lossless for any k."""
    if gather is None:
        gather = aggregator.plain_gather

    def fn(hist, feature_mask):
        t, num_nodes, d, num_bins, _ = hist.shape
        d_party = d // num_parties
        k_eff = min(k, d_party * num_bins)
        gains_all, feats_all, thrs_all = [], [], []
        for party in range(num_parties):
            cols = slice(party * d_party, (party + 1) * d_party)
            gains = split_mod.split_gains(hist[:, :, cols], cfg)
            gains = torch.where(feature_mask[:, None, cols, None], gains,
                                torch.full_like(gains, split_mod.NEG_INF))
            flat = gains.reshape(t, num_nodes, d_party * num_bins)
            top_gain, top_idx = torch.sort(flat, dim=-1, descending=True,
                                           stable=True)
            top_gain, top_idx = top_gain[..., :k_eff], top_idx[..., :k_eff]
            gains_all.append(top_gain.contiguous())
            feats_all.append((top_idx // num_bins).to(torch.int32)
                             + party * d_party)
            thrs_all.append((top_idx % num_bins).to(torch.int32))
        if meter is not None:
            for arr in (gains_all[0], feats_all[0], thrs_all[0]):
                meter.record("split_candidates", arr)
        g2 = gather(gains_all, -1)                 # (T, nodes, P * k_eff)
        f2, t2 = gather(feats_all, -1), gather(thrs_all, -1)
        best = torch.argmax(g2, dim=-1, keepdim=True)       # first maximum
        best_gain = torch.gather(g2, -1, best)[..., 0]
        has_split = best_gain > 0.0
        feature = torch.gather(f2, -1, best)[..., 0]
        threshold = torch.gather(t2, -1, best)[..., 0]
        return split_mod.SplitDecision(
            feature=torch.where(has_split, feature,
                                torch.full_like(feature, -1)),
            threshold=torch.where(has_split, threshold,
                                  torch.full_like(threshold, num_bins)),
            gain=best_gain)

    return fn


def topk_choose_fn(cfg: TreeConfig, k: int, num_parties: int,
                   meter: Optional[MessageMeter] = None,
                   gather: Optional[Callable] = None):
    """Per-tree twin of ``topk_round_choose_fn``: hist (nodes, d, B, S)
    and feature_mask (d,) -> (nodes,) decision."""
    round_fn = topk_round_choose_fn(cfg, k, num_parties, meter, gather)

    def fn(hist, feature_mask):
        return split_mod.SplitDecision(*(
            v[0] for v in round_fn(hist[None], feature_mask[None])))

    return fn
