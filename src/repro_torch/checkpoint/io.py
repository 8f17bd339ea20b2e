"""Checkpoints in the JAX package's format (``repro/checkpoint/io.py``),
so a checkpoint moves between the packages in both directions.

A checkpoint is a pair of files:

* ``<path>.npz`` — the leaves as ``leaf_0`` .. ``leaf_{k-1}``: for a
  ``PackedEnsemble`` its six tensors in ``types.PACKED_ARRAYS`` order (the
  JAX pytree's ``tree_flatten`` order), for a ``QuantizedEnsemble`` its six
  in ``types.QUANTIZED_ARRAYS`` order, for a train state the packed six
  and then the margins (and the key, when one was stored);
* ``<path>.meta.json`` — the leaves' dtypes, the npz's sha256 and the
  static metadata under ``"packed_ensemble"`` or ``"quantized_ensemble"``
  (and ``"train_state"``).

A language model's weights (``save_lm_params``/``load_lm_params``) are the
leaves of the JAX parameter tree in its leaf order, each stacked over the
units, as ``save_pytree(path, state.params)`` writes them in the JAX
package: a file written by either package's launcher loads in the other.

``save_pytree``/``load_pytree`` take flat lists of arrays, the one pytree
shape the port writes.  Every write lands via temp file + ``os.replace``,
npz first and sidecar second, so a kill at any instant leaves one complete
generation.  Loads re-hash the npz and refuse a mismatch with
``ValueError``.  The ensemble and train-state calls are spans on the
process-global tracer.
"""

from __future__ import annotations

import hashlib
import io as io_mod
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.convert import (
    lm_leaves,
    lm_params_from_leaves,
    packed_from_numpy,
    packed_to_numpy,
    quantized_from_numpy,
    quantized_to_numpy,
)
from repro_torch.core.types import (
    PACKED_ARRAYS,
    PACKED_META,
    QUANTIZED_ARRAYS,
    EnsembleModel,
    PackedEnsemble,
    QuantizedEnsemble,
    pack_ensemble,
)
from repro_torch.device import resolve
from repro_torch.obs import trace as trace_mod

_BF16 = "bfloat16"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via a temp file in the same directory and
    ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _as_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, sidecar dtype): bfloat16 is stored as its uint16
    bits, as the JAX package stores it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy(), _BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(path: str, leaves, extra_meta: dict | None = None) -> None:
    """Persist a flat list of arrays or tensors atomically; ``extra_meta``
    merges into the sidecar."""
    arrays, entries = {}, []
    for i, leaf in enumerate(leaves):
        arr, dtype = _as_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        entries.append({"dtype": dtype})
    meta = {"treedef": f"PyTreeDef([{', '.join('*' for _ in entries)}])",
            "leaves": entries}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io_mod.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    meta["npz_sha256"] = hashlib.sha256(payload).hexdigest()
    if extra_meta:
        meta.update(extra_meta)
    # npz first, sidecar second: a kill between the two leaves a new npz
    # beside the OLD sidecar, whose stale sha256 refuses the pair
    _atomic_write_bytes(_npz_path(path), payload)
    _atomic_write_bytes(_meta_path(path), json.dumps(meta).encode())


def _load_leaves(path: str, meta: dict) -> list:
    """The npz leaves as numpy arrays (bfloat16 ones as their uint16
    bits), after checking the sidecar's sha256."""
    npz_path = _npz_path(path)
    with open(npz_path, "rb") as f:
        payload = f.read()
    want = meta.get("npz_sha256")
    if want is not None:
        got = hashlib.sha256(payload).hexdigest()
        if got != want:
            raise ValueError(
                f"checkpoint {npz_path} is corrupt or truncated: npz sha256 "
                f"{got[:12]}… does not match sidecar {want[:12]}… "
                f"(file may be from a torn write; re-save the checkpoint)")
    try:
        npz = np.load(io_mod.BytesIO(payload))
        leaves = []
        for i, entry in enumerate(meta["leaves"]):
            arr = npz[f"leaf_{i}"]
            stored = "uint16" if entry["dtype"] == _BF16 else entry["dtype"]
            if str(arr.dtype) != stored:
                raise ValueError(f"leaf_{i} has dtype {arr.dtype}, sidecar "
                                 f"says {entry['dtype']}")
            leaves.append(arr)
    except ValueError:
        raise
    except Exception as e:  # zipfile/format errors from a truncated payload
        raise ValueError(
            f"checkpoint {npz_path} failed to deserialize ({e!r}); the file "
            "is corrupt or truncated") from e
    return leaves


def _read_meta(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)


def load_pytree(path: str, device=None) -> list:
    """The leaves of a ``save_pytree`` checkpoint (either package's) as a
    list of tensors on ``device`` (default ``cuda``), bfloat16 restored."""
    dev = resolve(device)
    meta = _read_meta(path)
    out = []
    for arr, entry in zip(_load_leaves(path, meta), meta["leaves"]):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if entry["dtype"] == _BF16:
            t = t.view(torch.bfloat16)
        out.append(t.to(dev))
    return out


def _packed_leaves(model) -> tuple[list, dict]:
    """The npz leaves and sidecar metadata of a model, packed."""
    if isinstance(model, EnsembleModel):
        model = pack_ensemble(model)
    if not isinstance(model, PackedEnsemble):
        raise TypeError(
            f"expected EnsembleModel or PackedEnsemble, got {model!r}")
    arrays, meta = packed_to_numpy(model)
    return [arrays[f] for f in PACKED_ARRAYS], meta


def save_ensemble(path: str, model) -> None:
    """Persist an ``EnsembleModel`` or ``PackedEnsemble`` packed, or a
    ``QuantizedEnsemble`` with its int8/int16 tables as they are."""
    with trace_mod.global_tracer().span("checkpoint.save", cat="io",
                                        args={"path": path}):
        if isinstance(model, QuantizedEnsemble):
            arrays, qmeta = quantized_to_numpy(model)
            meta = {f: qmeta[f] for f in PACKED_META}
            meta["bits"] = int(qmeta["bits"])
            save_pytree(path, [arrays[f] for f in QUANTIZED_ARRAYS],
                        extra_meta={"quantized_ensemble": meta})
            return
        leaves, meta = _packed_leaves(model)
        save_pytree(path, leaves, extra_meta={"packed_ensemble": meta})


def load_ensemble(path: str, device=None):
    """Load an ensemble checkpoint onto ``device`` (default ``cuda``): a
    ``PackedEnsemble``, or a ``QuantizedEnsemble`` for a
    ``"quantized_ensemble"`` sidecar."""
    with trace_mod.global_tracer().span("checkpoint.load", cat="io",
                                        args={"path": path}):
        meta = _read_meta(path)
        if "quantized_ensemble" in meta:
            leaves = _load_leaves(path, meta)
            if len(leaves) != len(QUANTIZED_ARRAYS):
                raise ValueError(f"{path}: expected {len(QUANTIZED_ARRAYS)} "
                                 f"leaves, found {len(leaves)}")
            return quantized_from_numpy(dict(zip(QUANTIZED_ARRAYS, leaves)),
                                        meta["quantized_ensemble"], device)
        if "packed_ensemble" not in meta or "train_state" in meta:
            raise ValueError(
                f"{path} is not a packed-ensemble checkpoint (missing "
                "'packed_ensemble' metadata, or a train state: use "
                "load_train_state)")
        leaves = _load_leaves(path, meta)
        if len(leaves) != len(PACKED_ARRAYS):
            raise ValueError(f"{path}: expected {len(PACKED_ARRAYS)} leaves, "
                             f"found {len(leaves)}")
        return packed_from_numpy(dict(zip(PACKED_ARRAYS, leaves)),
                                 meta["packed_ensemble"], device)


def save_train_state(path: str, model, margin, completed_rounds: int,
                     fingerprint: str, rng_key=None, margin_valid=None,
                     history: dict | None = None) -> None:
    """Persist the boosting resume carrier in the JAX package's layout:
    the packed ensemble of the completed rounds, the exact float32 margins
    (train, then valid when given), an optional key, and the completed
    round count with the configuration fingerprint that ``--resume``
    checks; ``history`` is an optional JSON-serialisable dict."""
    with trace_mod.global_tracer().span("checkpoint.save_state", cat="io",
                                        args={"path": path,
                                              "rounds": completed_rounds}):
        leaves, meta = _packed_leaves(model)
        arrays = leaves + [_as_numpy(margin)[0]]
        if margin_valid is not None:
            arrays.append(_as_numpy(margin_valid)[0])
        if rng_key is not None:
            arrays.append(_as_numpy(rng_key)[0])
        state = {
            "completed_rounds": int(completed_rounds),
            "config_fingerprint": fingerprint,
            "n_ensemble_leaves": len(leaves),
            "has_margin_valid": margin_valid is not None,
            "has_rng_key": rng_key is not None,
        }
        if history is not None:
            state["history"] = history
        save_pytree(path, arrays, extra_meta={"packed_ensemble": meta,
                                              "train_state": state})


def load_train_state(path: str, device=None) -> dict:
    """Load a resume carrier written by either package's
    ``save_train_state``: ``{"packed"`` (on ``device``, default ``cuda``),
    ``"margin"``, ``"margin_valid"``, ``"rng_key"`` (numpy),
    ``"completed_rounds"``, ``"config_fingerprint"``, ``"history"}``."""
    with trace_mod.global_tracer().span("checkpoint.load_state", cat="io",
                                        args={"path": path}):
        meta = _read_meta(path)
        if "train_state" not in meta:
            raise ValueError(
                f"{path} is not a train-state checkpoint (missing "
                "'train_state' metadata)")
        state = meta["train_state"]
        leaves = _load_leaves(path, meta)
        ne = state["n_ensemble_leaves"]
        if len(leaves) <= ne:
            raise ValueError(f"{path}: no margins after the {ne} ensemble "
                             "leaves")
        packed = packed_from_numpy(dict(zip(PACKED_ARRAYS, leaves[:ne])),
                                   meta["packed_ensemble"], device)
        rest = list(leaves[ne:])
        margin = rest.pop(0)
        margin_valid = rest.pop(0) if state["has_margin_valid"] else None
        rng_key = rest.pop(0) if state["has_rng_key"] else None
        return {
            "packed": packed,
            "margin": margin,
            "margin_valid": margin_valid,
            "rng_key": rng_key,
            "completed_rounds": state["completed_rounds"],
            "config_fingerprint": state["config_fingerprint"],
            "history": state.get("history"),
        }


def save_lm_params(path: str, model) -> None:
    """Persist an ``LMModel``'s weights in the JAX parameter tree's leaf
    order (bfloat16 leaves as their uint16 bits)."""
    with trace_mod.global_tracer().span("checkpoint.save_lm", cat="io",
                                        args={"path": path}):
        save_pytree(path, lm_leaves(model))


def load_lm_params(path: str, cfg, device=None):
    """An ``LMModel`` of ``cfg`` on ``device`` (default ``cuda``) holding
    the weights of a params file written by either package."""
    with trace_mod.global_tracer().span("checkpoint.load_lm", cat="io",
                                        args={"path": path}):
        return lm_params_from_leaves(cfg, load_pytree(path, device="cpu"),
                                     device)
