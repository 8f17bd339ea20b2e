"""Packed-ensemble checkpoints in the JAX package's format
(``repro/checkpoint/io.py``), so a checkpoint moves between the packages
in both directions.

A checkpoint is a pair of files:

* ``<path>.npz`` — the six tensors of ``PackedEnsemble`` as ``leaf_0`` ..
  ``leaf_5``, in ``types.PACKED_ARRAYS`` order (the JAX pytree's
  ``tree_flatten`` order);
* ``<path>.meta.json`` — the leaves' dtypes, the npz's sha256 and the
  static metadata under ``"packed_ensemble"``.

Every write lands via temp file + ``os.replace``, npz first and sidecar
second, so a kill at any instant leaves one complete generation.  Loads
re-hash the npz and refuse a mismatch with ``ValueError``.  Both calls are
spans on the process-global tracer (``checkpoint.save`` /
``checkpoint.load``).
"""

from __future__ import annotations

import hashlib
import io as io_mod
import json
import os
import tempfile

import numpy as np

from repro_torch.convert import packed_from_numpy, packed_to_numpy
from repro_torch.core.types import (
    PACKED_ARRAYS,
    EnsembleModel,
    PackedEnsemble,
    pack_ensemble,
)
from repro_torch.obs import trace as trace_mod


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


def save_ensemble(path: str, model) -> None:
    """Persist an ``EnsembleModel`` or ``PackedEnsemble``, packed."""
    with trace_mod.global_tracer().span("checkpoint.save", cat="io",
                                        args={"path": path}):
        if isinstance(model, EnsembleModel):
            model = pack_ensemble(model)
        if not isinstance(model, PackedEnsemble):
            raise TypeError(
                f"expected EnsembleModel or PackedEnsemble, got {model!r}")
        arrays, meta = packed_to_numpy(model)
        leaves = [arrays[f] for f in PACKED_ARRAYS]
        buf = io_mod.BytesIO()
        np.savez(buf, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
        payload = buf.getvalue()
        sidecar = {
            "treedef": f"PyTreeDef([{', '.join('*' for _ in leaves)}])",
            "leaves": [{"dtype": str(a.dtype)} for a in leaves],
            "npz_sha256": hashlib.sha256(payload).hexdigest(),
            "packed_ensemble": meta,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # npz first, sidecar second: a kill between the two leaves a new
        # npz beside the OLD sidecar, whose stale sha256 refuses the pair
        _atomic_write_bytes(_npz_path(path), payload)
        _atomic_write_bytes(_meta_path(path), json.dumps(sidecar).encode())


def _load_leaves(path: str, meta: dict) -> list:
    """The npz leaves, after checking the sidecar's sha256."""
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
            if str(arr.dtype) != entry["dtype"]:
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


def load_ensemble(path: str, device=None) -> PackedEnsemble:
    """Load a packed checkpoint onto ``device`` (default ``cuda``)."""
    with trace_mod.global_tracer().span("checkpoint.load", cat="io",
                                        args={"path": path}):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
        if "quantized_ensemble" in meta:
            raise ValueError(
                f"{path} is a quantized_ensemble checkpoint: QuantizedEnsemble"
                " is not ported yet; serve the f32 checkpoint")
        if "packed_ensemble" not in meta:
            raise ValueError(
                f"{path} is not a packed-ensemble checkpoint (missing "
                "'packed_ensemble' metadata)")
        leaves = _load_leaves(path, meta)
        if len(leaves) != len(PACKED_ARRAYS):
            raise ValueError(f"{path}: expected {len(PACKED_ARRAYS)} leaves, "
                             f"found {len(leaves)}")
        return packed_from_numpy(dict(zip(PACKED_ARRAYS, leaves)),
                                 meta["packed_ensemble"], device)
