"""Activation partition specs: the counterpart of
``repro/models/partition.py``.

The JAX package anchors activation shardings with
``with_sharding_constraint`` at fixed sites of the forward, so that GSPMD
does not fall back to replication; off a mesh every anchor is a no-op.  The
port runs on one card and shards nothing, so its anchors record: inside
``recording(axes)`` (the dry-run's context: ``launch/costmodel.count_step``
runs every step in it, and the report lists the specs under
``activation_specs``) each site records ``(site, shape, spec)`` and returns
its input unchanged; outside it, every site returns its input and costs
one context-variable read.

A spec is a tuple with one entry a dimension: ``None`` (replicated), a
mesh-axis name, or a tuple of names (sharded over their product); an axis
tuple of one name is written as the name, as ``jax.sharding.PartitionSpec``
normalises it.  Every builder takes a shape and the mesh's axis sizes
(``{"data": 16, "model": 16}``) and returns a spec, or None where the JAX
builder places no constraint: an axis drops out whenever the dimension is
not divisible by its size (MQA kv = 1, batch 1, 9 heads, ...).

Axis conventions: batch -> ("pod", "data"), feature/head/expert fan-out ->
"model".
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional

import torch

Spec = tuple


@dataclasses.dataclass
class Recorder:
    """The mesh axes the sites build their specs for, and what they built:
    ``records`` is ``[(site, shape, spec), ...]`` in call order."""

    axes: dict
    records: list = dataclasses.field(default_factory=list)

    def summary(self) -> list[dict]:
        """Each distinct ``(site, shape, spec)`` in first-seen order with
        ``count``, the times it was placed (JSON-ready)."""
        counts: dict = {}
        for record in self.records:
            counts[record] = counts.get(record, 0) + 1
        return [{"site": site, "shape": list(shape), "spec": list(spec),
                 "count": n} for (site, shape, spec), n in counts.items()]


_RECORDER: contextvars.ContextVar[Optional[Recorder]] = contextvars.ContextVar(
    "repro_torch_partition_recorder", default=None)


@contextlib.contextmanager
def recording(axes: dict):
    """Record every site's spec for a mesh of ``axes`` (name -> size)."""
    rec = Recorder(dict(axes))
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def axis_entry(names: tuple):
    """A spec entry over ``names``: None, the one name, or the tuple."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _batch_axes(axes: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axes)


def _fits(dim: int, names, axes: dict) -> bool:
    if isinstance(names, str):
        names = (names,)
    total = 1
    for n in names:
        if n not in axes:
            return False
        total *= axes[n]
    return dim % total == 0


def constrain(x: torch.Tensor, site: str,
              builder: Callable[[tuple, dict], Optional[Spec]]
              ) -> torch.Tensor:
    """Record ``builder(x.shape, axes)`` under ``site`` when recording and
    the builder places a constraint; return ``x`` unchanged."""
    rec = _RECORDER.get()
    if rec is not None:
        spec = builder(tuple(x.shape), rec.axes)
        if spec is not None:
            rec.records.append((site, tuple(x.shape), spec))
    return x


# ---------------------------------------------------------------------------
# Spec builders: (shape, axes) -> spec or None
# ---------------------------------------------------------------------------
def tokens_spec(shape: tuple, axes: dict) -> Optional[Spec]:
    """(B, S, ...) activations between blocks: batch over (pod, data)."""
    ba = _batch_axes(axes)
    if not ba or not _fits(shape[0], ba, axes):
        return None
    return (axis_entry(ba),) + (None,) * (len(shape) - 1)


def fused_heads_spec(shape: tuple, axes: dict, n_heads: Optional[int] = None,
                     seq_ok: bool = True) -> Optional[Spec]:
    """(B, S, H*hd) fused-head activations (attention output before w_o).

    When the heads divide the model axis, shard the fused dim (w_o's
    contraction reduces locally). When they do not (gemma2 H=8), keep the
    sequence sharding the scores carried: constraining the fused dim made
    XLA all-gather the (S, S) probabilities in the backward."""
    ba = _batch_axes(axes)
    b = axis_entry(ba) if (ba and _fits(shape[0], ba, axes)) else None
    heads_fit = n_heads is None or _fits(n_heads, "model", axes)
    if (not heads_fit and seq_ok and shape[1] > 1
            and _fits(shape[1], "model", axes)):
        return (b, "model", None)
    m = "model" if _fits(shape[-1], "model", axes) else None
    if b is None and m is None:
        return None
    return (b, None, m)


def heads_spec(shape: tuple, axes: dict, role: str = "q",
               seq_ok: bool = True) -> Optional[Spec]:
    """(B, S, H, hd) split heads.

    Preference order:
      1. heads over "model" when H divides: zero-redundancy head
         parallelism;
      2. for QUERIES: the query-sequence dim over "model", which keeps the
         (S, S) score/prob tensors sharded through forward and backward;
      3. head_dim over "model" (the fallback, kept for decode's S == 1);
      4. batch only.
    K/V never shard the sequence (they are contracted over the full key
    sequence)."""
    ba = _batch_axes(axes)
    b = axis_entry(ba) if (ba and _fits(shape[0], ba, axes)) else None
    if _fits(shape[2], "model", axes):
        return (b, None, "model", None)
    if (role == "q" and seq_ok and shape[1] > 1
            and _fits(shape[1], "model", axes)):
        return (b, "model", None, None)
    if role != "kv" and _fits(shape[3], "model", axes):
        return (b, None, None, "model")
    return (b, None, None, None) if b else None


def ff_spec(shape: tuple, axes: dict) -> Optional[Spec]:
    """(B, S, F) FFN hidden (or (T, F) for MoE): last dim over model."""
    ba = _batch_axes(axes)
    b = (axis_entry(ba) if (len(shape) >= 3 and ba
                            and _fits(shape[0], ba, axes)) else None)
    m = "model" if _fits(shape[-1], "model", axes) else None
    if b is None and m is None:
        return None
    return (b,) + (None,) * (len(shape) - 2) + (m,)


def ecd_spec(shape: tuple, axes: dict) -> Optional[Spec]:
    """(E, C, last) capacity-padded MoE buckets: capacity over the batch
    axes, the last dim over model (the JAX ``moe._ecd_spec``)."""
    _, C, last = shape
    ba = _batch_axes(axes)
    total = 1
    for a in ba:
        total *= axes[a]
    c_ax = axis_entry(ba) if (ba and C % total == 0) else None
    m_ax = "model" if ("model" in axes and last % axes["model"] == 0) else None
    if c_ax is None and m_ax is None:
        return None
    return (None, c_ax, m_ax)


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------
def shard_tokens(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "tokens", tokens_spec)


def shard_fused_heads(x: torch.Tensor, n_heads: Optional[int] = None,
                      seq_ok: bool = True) -> torch.Tensor:
    return constrain(x, "fused_heads", lambda shape, axes: fused_heads_spec(
        shape, axes, n_heads, seq_ok))


def shard_heads(x: torch.Tensor, role: str = "q",
                seq_ok: bool = True) -> torch.Tensor:
    return constrain(x, f"heads/{role}", lambda shape, axes: heads_spec(
        shape, axes, role, seq_ok))


def shard_ff(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "ff", ff_spec)


def shard_ecd(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "moe/ecd", ecd_spec)
