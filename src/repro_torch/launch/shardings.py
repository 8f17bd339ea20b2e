"""Parameter / train-state / batch / cache partition specs of the LM
substrate: the counterpart of ``repro/launch/shardings.py``.

Rules: weight matrices shard their contraction structure as (FSDP over
"data", tensor-parallel over "model") —

  up-projections   (..., D_in, D_out):  (..., "data", "model")
  down-projections (..., D_in, D_out):  (..., "model", "data")
  expert weights   (U, E, D, F):        the trailing two dims, D replicated
  vectors / norms / small tables:       replicated

An axis is dropped whenever the dim is not divisible by the mesh axis size,
checked per leaf, so MQA (kv=1) K/V projections replicate on "model" while
the 48-head Q shards.  Caches shard batch over (pod, data) and the
cache-length (or head) dim over "model" when divisible.

Specs are plain tuples (``models/partition.py``) computed on the JAX
package's leaf shapes: parameters as ``LMModel.jax_leaves()`` stacks them
over the units, caches as ``LMModel.jax_cache_leaves()`` does.  Nothing is
distributed; ``placements`` maps a spec to ``torch.distributed.tensor``
placements for a reader who wants them.
"""

from __future__ import annotations

from repro_torch.launch.mesh import AbstractMesh, batch_axes
from repro_torch.models.partition import axis_entry

# Param leaves whose LAST TWO dims shard ("model", "data") instead of
# ("data", "model"): the down/output projections.
_REVERSED = {"w_down", "w_out", "wo", "out_proj"}
# Leaves that stay replicated regardless of shape.
_REPLICATED = {"scale", "bias", "mu", "u", "w0", "A_log", "D", "dt_bias",
               "norm", "ln_scale", "ln_bias", "router"}


def _leaf_name(path: tuple) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _divides(dim: int, axis: str, mesh: AbstractMesh) -> bool:
    return axis in mesh.shape and dim % mesh.shape[axis] == 0


def _in_moe(path: tuple) -> bool:
    return "moe" in path


def param_spec(path: tuple, shape: tuple, mesh: AbstractMesh) -> tuple:
    """The spec of the parameter leaf at JAX ``path`` with ``shape``."""
    name = _leaf_name(path)
    if name in _REPLICATED or len(shape) < 2:
        return ()
    d_in, d_out = shape[-2], shape[-1]
    lead = (None,) * (len(shape) - 2)
    if _in_moe(path) and len(shape) >= 3:
        # Expert weights (U, E, D, F) / (U, E, F, D): keep the
        # up-projection's contraction dim (D) replicated so 'ecd,edf' needs
        # no all-reduce; shard F over "model".
        if name in _REVERSED:  # w_down (E, F, D)
            a_in = "model" if _divides(d_in, "model", mesh) else None
            return (*lead, a_in, None)
        a_out = "model" if _divides(d_out, "model", mesh) else None
        return (*lead, None, a_out)
    if name in _REVERSED:
        a_in = "model" if _divides(d_in, "model", mesh) else None
        a_out = "data" if _divides(d_out, "data", mesh) else None
    else:
        a_in = "data" if _divides(d_in, "data", mesh) else None
        a_out = "model" if _divides(d_out, "model", mesh) else None
    return (*lead, a_in, a_out)


def param_leaves(cfg) -> list:
    """[(JAX path, meta leaf)] of ``cfg``'s parameters in the JAX leaf
    order, stacked over the units as the JAX tree stacks them (``meta``:
    no allocation)."""
    from repro_torch import convert
    from repro_torch.models.model import LMModel

    return list(convert._jax_pairs(LMModel(cfg, device="meta")))


def param_shardings(cfg, mesh: AbstractMesh) -> dict:
    """{JAX path: spec} for every parameter leaf, in the JAX leaf order."""
    return {path: param_spec(path, tuple(leaf.shape), mesh)
            for path, leaf in param_leaves(cfg)}


def train_state_shardings(cfg, mesh: AbstractMesh) -> dict:
    """Specs of the train state (params, AdamW step, m, v): the moments
    mirror the parameter specs exactly, the step is replicated."""
    ps = param_shardings(cfg, mesh)
    return {"params": ps, "opt": {"step": replicated(), "m": dict(ps),
                                  "v": dict(ps)}}


def batch_spec(mesh: AbstractMesh, ndim: int,
               batch_size: int | None = None) -> tuple:
    """Token/label batches: batch dim over (pod, data) when divisible;
    falls back through (data,) alone, then replication (batch == 1)."""
    for ba in (batch_axes(mesh), ("data",) if "data" in mesh.shape else ()):
        if not ba:
            continue
        total = 1
        for a in ba:
            total *= mesh.shape[a]
        if batch_size is None or batch_size % total == 0:
            return (axis_entry(ba),) + (None,) * (ndim - 1)
    return (None,) * ndim


def cache_spec(path: tuple, shape: tuple, mesh: AbstractMesh,
               batch_dim: int = 1) -> tuple:
    """Decode caches, leaf shapes (U, B, ...) (``batch_dim`` 1; a unit's
    own leaves (B, ...) take 0).  Shard B over (pod, data) when divisible;
    shard the largest trailing dim over "model", plus any batch axes the
    batch dim could not use (long_500k's B = 1 leaves "data" idle, and
    folding it into the cache-length dim cuts the per-device cache by the
    data-axis size)."""
    ba = batch_axes(mesh)
    total_batch_shards = 1
    for a in ba:
        total_batch_shards *= mesh.shape[a]
    spec = [None] * len(shape)
    batch_sharded = (len(shape) > batch_dim
                     and shape[batch_dim] % total_batch_shards == 0)
    if batch_sharded:
        spec[batch_dim] = axis_entry(ba)
    trail_axes = ("model",) if batch_sharded else tuple(ba) + ("model",)
    # trailing dims: pick the largest divisible dim after batch
    for axes in (trail_axes, ("model",)):
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        best = None
        for i in range(batch_dim + 1, len(shape)):
            if shape[i] % total == 0 and (best is None
                                          or shape[i] > shape[best]):
                best = i
        if best is not None:
            spec[best] = axis_entry(axes)
            break
    return tuple(spec)


def cache_leaves(cfg, batch: int, seq_len: int) -> list:
    """[(JAX path, stacked shape, dtype)] of ``cfg``'s decode cache in the
    JAX layout (every leaf stacked over the units), from a ``meta``
    cache."""
    from repro_torch.models.model import LMModel

    cache = LMModel(cfg, device="meta").init_cache(batch, seq_len)
    return [(path, (len(ts), *ts[0].shape), ts[0].dtype)
            for path, ts in LMModel.jax_cache_leaves(cache)]


def cache_shardings(cfg, mesh: AbstractMesh, batch: int,
                    seq_len: int) -> dict:
    """{JAX path: spec} for every cache leaf, in the JAX leaf order."""
    return {path: cache_spec(path, shape, mesh)
            for path, shape, _ in cache_leaves(cfg, batch, seq_len)}


def replicated() -> tuple:
    return ()


def sharded_axes(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_count(spec: tuple, mesh: AbstractMesh) -> int:
    """How many pieces ``spec`` cuts a leaf into on ``mesh``."""
    total = 1
    for entry in spec:
        for a in sharded_axes(entry):
            total *= mesh.shape[a]
    return total


def placements(spec: tuple, mesh: AbstractMesh) -> tuple:
    """The ``torch.distributed.tensor`` placement of each mesh axis, in
    mesh order: ``Shard(i)`` where the axis shards dim ``i``, else
    ``Replicate()``.  Needs no process group."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: i for i, entry in enumerate(spec)
              for a in sharded_axes(entry)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


def spec_from_placements(places: tuple, mesh: AbstractMesh,
                         ndim: int) -> tuple:
    """The spec of ``placements`` for an ``ndim``-dim leaf (its inverse;
    the axes of a dimension in mesh order)."""
    from torch.distributed.tensor import Shard

    axes = [[] for _ in range(ndim)]
    for a, p in zip(mesh.axis_names, places):
        if isinstance(p, Shard):
            axes[p.dim].append(a)
    return tuple(axis_entry(tuple(names)) for names in axes)
