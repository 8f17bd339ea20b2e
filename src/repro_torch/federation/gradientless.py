"""Gradient-less party-local training with learnable per-tree rates: the
counterpart of ``repro/federation/gradientless.py``.

The no-gradient-sharing privacy point, after Ma et al.'s "Gradient-less
Federated GBT with Learnable Learning Rates": FedGBF ships per-sample
(g, h) to every passive party and per-level histograms back; this mode
removes those messages instead of encrypting them.

* **Per-party local trees.**  Every party runs ordinary (centralized)
  FedGBF boosting on its OWN feature slice — on the card through the
  histogram kernel (``backend="local-cuda"``) — so gradients and
  histograms never leave the party.  Its trees reference only its own
  columns (offset to global column ids in the assembled ensemble).
* **Learnable per-tree rates.**  Each passive party ships its trees' raw
  per-tree margins on the training set, (T_p, n[, K]) floats; the active
  party fits one rate per tree by Adam on the global objective loss
  (``fit_tree_scales``).  The rates land in ``PackedEnsemble.tree_scale``,
  whose weighted combiner is exactly the model trained here.
* **Ledger.**  Margins in, rates out; the histogram, gradient and routing
  phases are identically zero (``wire_cost``), and a ``MessageMeter``
  records the actual margin and rate tensors.

Each party's fit draws its masks from ``fold_in(rng, p)``, the JAX package's
stream (``core/prng.py``), so the per-party trees are the JAX package's;
explicit per-party masks override the draw.  The rate fit runs in float32 with
``torch.autograd.grad`` in place of ``jax.grad``, in the JAX update order;
XLA's and torch's reductions differ in the last ulp, which over 300 steps
leaves the rates within about 1e-6 relative of the JAX package's (ROADMAP §3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import binning, boosting
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core import tree as tree_mod
from repro_torch.core.types import FedGBFConfig, PackedEnsemble, pack_ensemble
from repro_torch.device import resolve
from repro_torch.federation import mesh_roles


def _combine(w: torch.Tensor, margins: torch.Tensor,
             base: float) -> torch.Tensor:
    """``einsum('t,tn...->n...', w, margins) + base``."""
    return torch.tensordot(w, margins, dims=1) + base


def fit_tree_scales(margins: torch.Tensor, y: torch.Tensor,
                    init_scale: torch.Tensor, objective_name: str,
                    base_score: float = 0.0, steps: int = 300,
                    lr: float = 0.05) -> torch.Tensor:
    """Learn one rate per tree by Adam on the global objective loss.

    ``margins`` is the stacked per-tree raw output on the training set —
    (T, n), or (T, n, K) for K-channel objectives — and the model is the
    packed combiner itself: ``loss(w) = loss_value(y, base + einsum(
    't,tn...->n...', w, margins))``.  Starting from the per-party packed
    scales makes step 0 the plain concatenation of the local models.
    Float32 throughout, ``t`` a float32 carry, the JAX update order."""
    obj = objective_mod.get_objective(objective_name)
    margins = margins.to(torch.float32)
    y = y.to(torch.float32)
    w = init_scale.to(torch.float32).clone()
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    t = torch.zeros((), dtype=torch.float32, device=w.device)
    for _ in range(steps):
        wg = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            obj.loss_value(y, _combine(wg, margins, base_score)), wg)
        t = t + 1.0
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        m_hat = m / (1.0 - torch.pow(0.9, t))
        v_hat = v / (1.0 - torch.pow(0.999, t))
        w = w - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return w.detach()


def train_gradientless(
    x,
    y,
    cfg: FedGBFConfig,
    rng: torch.Tensor,
    num_parties: int,
    masks: Optional[Sequence] = None,
    scale_steps: int = 300,
    scale_lr: float = 0.05,
    meter=None,
    backend="local-cuda",
    device=None,
) -> tuple[PackedEnsemble, dict]:
    """Train the gradient-less party-local ensemble (module docstring).

    Args:
      x, y: (n, d) features (d divisible by ``num_parties``) and labels.
      rng: the run key (``prng.PRNGKey``); party p's fit draws from
        ``fold_in(rng, p)``, so parties stay independent.
      masks: an explicit override: one ``StepMasks`` (``GossDraws`` under
        GOSS) per party, for its ``d / num_parties`` columns.
      meter: a ``compress.MessageMeter``: records each passive party's
        margin block (``tree_margins``) and the rate vector sent back to
        each passive party (``tree_scales``), and nothing else.
      backend: each party's centralized fit (``"local-cuda"``: the
        histogram kernel; its plain version on CPU tensors).
      device: where to train; None = ``cuda``.

    Returns (packed, info): ``packed`` a ``PackedEnsemble`` (global
    feature ids, learned ``tree_scale``, one logical round); ``info`` the
    training loss before and after the rate fit and the per-party tree
    counts.
    """
    dev = resolve(device)
    x = boosting._as_tensor(x, torch.float32, dev)
    y = boosting._as_tensor(y, torch.float32, dev)
    layout = mesh_roles.PartyLayout(num_parties, x.shape[1])
    if masks is not None and len(masks) != num_parties:
        raise ValueError(f"{len(masks)} mask sets for {num_parties} parties")
    obj = objective_mod.get_objective(cfg.loss)

    party_packed, party_margins, tree_counts = [], [], []
    for p, cols in enumerate(layout.parts(x, 1)):
        x_p = cols.contiguous()
        model_p, _ = boosting.train_fedgbf(
            x_p, y, cfg, prng.fold_in(prng.as_key(rng), p),
            masks=None if masks is None else masks[p], backend=backend,
            device=dev)
        packed_p = pack_ensemble(model_p)
        binned_p = binning.bin_data(x_p, packed_p.bin_edges)
        margins_p = tree_mod.predict_trees(packed_p.trees(), binned_p,
                                           packed_p.max_depth)
        if meter is not None and p > 0:
            # the one inbound message: a passive party's per-tree margins
            meter.record("tree_margins", margins_p)
        party_packed.append(packed_p)
        party_margins.append(margins_p)
        tree_counts.append(packed_p.total_trees)

    margins = torch.cat(party_margins, dim=0)
    init_scale = torch.cat([pk.tree_scale for pk in party_packed])
    base = float(cfg.base_score) + obj.init_margin
    loss_before = float(obj.loss_value(y, _combine(init_scale, margins,
                                                   base)))
    scales = fit_tree_scales(margins, y, init_scale, cfg.loss,
                             base_score=base, steps=scale_steps,
                             lr=scale_lr)
    if meter is not None:
        # the one outbound message: the rates, to each passive party
        for _ in range(num_parties - 1):
            meter.record("tree_scales", scales)
    loss_after = float(obj.loss_value(y, _combine(scales, margins, base)))

    features = torch.cat([
        torch.where(pk.feature >= 0, pk.feature + layout.columns(p).start,
                    pk.feature)
        for p, pk in enumerate(party_packed)])
    packed = PackedEnsemble(
        feature=features,
        threshold=torch.cat([pk.threshold for pk in party_packed]),
        gain=torch.cat([pk.gain for pk in party_packed]),
        leaf_weight=torch.cat([pk.leaf_weight for pk in party_packed]),
        tree_scale=scales,
        bin_edges=torch.cat([pk.bin_edges for pk in party_packed]),
        round_offsets=(0, int(sum(tree_counts))),
        learning_rate=cfg.learning_rate,
        base_score=base,
        loss=cfg.loss,
        max_depth=cfg.tree.max_depth,
    )
    info = {
        "loss_before": loss_before,
        "loss_after": loss_after,
        "tree_counts": tree_counts,
        "n_channels": obj.n_classes,
    }
    return packed, info


def wire_cost(n_samples: int, tree_counts: list,
              n_channels: int = 1) -> dict:
    """Predicted wire bytes of one gradient-less training run: each
    PASSIVE party ships its margin block once (``T_p * n * K * 4`` bytes;
    party 0 keeps its own) and receives the rate vector (``T_total * 4``
    bytes); every phase of the gradient-sharing protocol is zero."""
    total_trees = int(sum(tree_counts))
    passive = len(tree_counts) - 1
    margins = sum(int(t) * n_samples * n_channels * 4
                  for t in tree_counts[1:])
    out = {
        "tree_margins": margins,
        "tree_scales": passive * total_trees * 4,
        "histograms": 0,
        "grad_broadcast": 0,
        "id_partition": 0,
        "feature_mask": 0,
        "split_candidates": 0,
    }
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out
