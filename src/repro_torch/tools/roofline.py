"""Roofline terms of the dry-run: the counterpart of
``repro/tools/roofline.py``, with the H100 constants of
``launch/mesh.py``.

Three terms per (arch, shape, mesh), in seconds:

  compute    = FLOPs / (chips * peak bf16 FLOP/s)
  memory     = bytes / (chips * HBM rate)
  collective = collective_bytes / (chips * link rate)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled program and collective bytes from its optimized HLO
(``parse_collectives``, ``roofline_from_compiled``).  The port compiles
nothing, so it has no such artifact and ports neither: ``CostCounter``
counts the eager program's aten ops instead, and ``collective_stats``
derives collective bytes from the partition specs by a stated rule.  Both
are models of a sharded run, not measurements of one.

``CostCounter`` (a ``TorchDispatchMode``) records, for every aten op that
runs under it (on ``meta`` tensors in the dry-run, on the card in
``chip_smoke.py`` phase 8a):

* **FLOPs**: PyTorch's FLOP registry (``torch.utils.flop_counter``, what
  ``FlopCounterMode`` counts): matrix products, convolutions and attention
  at 2 per multiply-add; elementwise ops count 0.
* **bytes**: every tensor input's and output's elements times their size,
  per op: eager, unfused traffic, each op reading its inputs once and
  writing its outputs once.  View ops (no data moved) and ``empty*``
  (nothing written) count 0.
* **peak**: the most bytes held at once by storages that ops under the
  counter allocated (an output tensor's storage, counted once, freed when
  the last tensor on it that an op returned dies); memory the program had
  before it started (its arguments) is not in it.

``model_flops_estimate`` anchors the useful-compute ratio: 6 N D for
training, 2 N D for inference, N the active parameters
(``count_params_analytic(cfg, active_only=True)``).
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_aten = torch.ops.aten
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided, _aten.empty_like}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out: list) -> list:
    """The tensors in an op's (nested list/tuple/dict) arguments or
    results."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


class CostCounter(TorchDispatchMode):
    """Counts ``flops``, ``bytes``, ``ops`` and ``peak`` (see the module
    docstring) of the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.peak = 0
        self.live = 0
        self._refs: dict[int, list] = {}   # storage -> [tensors alive, bytes]

    def _release(self, key: int) -> None:
        entry = self._refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor, in_keys: set) -> None:
        key = t.untyped_storage()._cdata
        entry = self._refs.get(key)
        if entry is None:
            if key in in_keys:
                return      # an argument's storage (a view, an in-place op)
            entry = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out, [])
        ins = _tensors(kwargs, _tensors(args, []))
        if not func.is_view and func._overloadpacket not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, in_keys)
        return out

    def costs(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "ops": self.ops, "peak": self.peak}


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, times: int = 1) -> None:
        self.bytes_by_kind[kind] = (self.bytes_by_kind.get(kind, 0)
                                    + times * nbytes)
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + times


@dataclass(frozen=True)
class LeafUse:
    """One parameter leaf as the collective rule sees it: JAX ``path``,
    (stacked) ``shape``, bytes an element, the activation ``rows`` one
    application projects, and the ``uses`` (applications a step) beyond
    its stacked lead dims (zamba2's shared block: its applications)."""

    path: tuple
    shape: tuple
    itemsize: int
    rows: int
    uses: int = 1


def collective_stats(leaves, mesh, kind: str, act_itemsize: int,
                     remat: bool = True) -> CollectiveStats:
    """Per-device collective bytes of a step (result sizes, the JAX
    parser's convention) by this rule, over the specs of
    ``launch/shardings.py``:

    * **all-gather**: each parameter leaf sharded over "data" is gathered
      over "data" once per forward pass, and in training once more for the
      remat recompute (if ``remat``) and once for the backward; each gather
      yields the leaf over its other axes' shards
      (``bytes / shards-off-data``);
    * **reduce-scatter** (training): its gradient, once, to the device's
      shard (``bytes / shards``);
    * **all-reduce**: each projection whose contraction dim (``shape[-2]``)
      is sharded over "model" all-reduces its output activation, ``rows``
      (over the batch axes' shards when the batch divides them) x
      ``shape[-1]`` x ``act_itemsize``, once forward and, in training,
      once backward; an expert weight (E, F, D) projects ``rows`` copies in
      all, whatever E.

    An axis of size 1 moves nothing.  Not counted: gradients of leaves
    replicated over "data", the "pod" axis's gradient reduction, the MoE
    token exchange, and a tied embedding's logits."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.shardings import (
        param_spec,
        shard_count,
        sharded_axes,
    )

    stats = CollectiveStats()
    train = kind == "train"
    gathers = (3 if remat else 2) if train else 1
    batch_shards = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    for leaf in leaves:
        spec = param_spec(leaf.path, leaf.shape, mesh)
        if not spec:
            continue
        nbytes = math.prod(leaf.shape) * leaf.itemsize
        axes = [a for entry in spec for a in sharded_axes(entry)
                if mesh.shape[a] > 1]             # a 1-wide axis moves nothing
        if "data" in axes:
            off_data = shard_count(spec, mesh) // mesh.shape["data"]
            stats.add("all-gather", nbytes // off_data, gathers * leaf.uses)
            if train:
                stats.add("reduce-scatter",
                          nbytes // shard_count(spec, mesh), leaf.uses)
        if "model" in sharded_axes(spec[-2]) and "model" in axes:
            moe = "moe" in leaf.path and len(leaf.shape) >= 3
            apps = math.prod(leaf.shape[:-3] if moe else leaf.shape[:-2])
            rows = leaf.rows
            if rows % batch_shards == 0:
                rows //= batch_shards
            stats.add("all-reduce", rows * leaf.shape[-1] * act_itemsize,
                      (2 if train else 1) * apps * leaf.uses)
    return stats


@dataclass
class Roofline:
    flops: float              # whole-program FLOPs (all chips)
    hbm_bytes: float          # whole-program bytes accessed
    collective_bytes: float   # whole-program bytes moved by collectives
    chips: int
    model_flops: float        # 6*N(_active)*D useful FLOPs

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * ICI_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def model_flops_estimate(cfg, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference (N = active params)."""
    from repro_torch.models.model import count_params_analytic

    n_active = count_params_analytic(cfg, active_only=True)
    per_token = 6.0 if kind == "train" else 2.0
    return per_token * n_active * tokens


def roofline_from_costs(per_device: dict, cfg, shape_spec,
                        chips: int) -> Roofline:
    """A Roofline from ``costmodel.count_step``'s per-device costs."""
    tokens = shape_spec.global_batch * (
        shape_spec.seq_len if shape_spec.kind != "decode" else 1
    )
    return Roofline(
        flops=per_device["flops"] * chips,
        hbm_bytes=per_device["bytes"] * chips,
        collective_bytes=per_device["collective_bytes"] * chips,
        chips=chips,
        model_flops=model_flops_estimate(cfg, tokens, shape_spec.kind),
    )
