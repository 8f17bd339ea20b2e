"""Checkpoints across the packages: JAX save -> port load, port save -> JAX
load, and refusal of corrupt, truncated and unported checkpoints (CPU)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as j_io
from repro.core import boosting as j_boosting
from repro_torch.checkpoint import io as t_io
from repro_torch.core import boosting as t_boosting
from repro_torch.obs import trace as t_trace
from torch_parity import (FIELDS, hard_rows, jax_packed, random_packed_arrays,
                          torch_packed)


@pytest.fixture
def model():
    rng = np.random.default_rng(5)
    arrays, meta = random_packed_arrays(rng, [4, 3, 2], 3, 11, base=0.5)
    return arrays, meta, hard_rows(rng, 200, arrays["bin_edges"])


def _same(tp, jp):
    for f in FIELDS:
        got, want = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("round_offsets", "learning_rate", "base_score", "loss",
              "max_depth"):
        assert getattr(tp, f) == getattr(jp, f), f


def test_jax_save_port_load(model, tmp_path):
    arrays, meta, x = model
    jp = jax_packed(arrays, meta)
    path = str(tmp_path / "from_jax")
    j_io.save_ensemble(path, jp)
    tp = t_io.load_ensemble(path, device="cpu")
    _same(tp, jp)
    np.testing.assert_allclose(
        t_boosting.predict(tp, torch.from_numpy(x), impl="fused").numpy(),
        np.asarray(j_boosting.predict(jp, jnp.asarray(x), impl="fused")),
        rtol=0, atol=1e-6)


def test_port_save_jax_load(model, tmp_path):
    arrays, meta, _ = model
    tp = torch_packed(arrays, meta)
    path = str(tmp_path / "from_port")
    t_io.save_ensemble(path, tp)
    _same(tp, j_io.load_ensemble(path))
    with open(path + ".meta.json") as f:
        side = json.load(f)
    j_io.save_ensemble(str(tmp_path / "ref"), jax_packed(arrays, meta))
    with open(str(tmp_path / "ref") + ".meta.json") as f:
        ref_side = json.load(f)
    # the same sidecar, down to the sha256 of the same npz bytes
    assert side == ref_side


def test_save_load_are_traced(model, tmp_path):
    arrays, meta, _ = model
    tracer = t_trace.Tracer()
    t_trace.set_global_tracer(tracer)
    try:
        path = str(tmp_path / "traced")
        t_io.save_ensemble(path, torch_packed(arrays, meta))
        t_io.load_ensemble(path, device="cpu")
    finally:
        t_trace.set_global_tracer(t_trace.NULL_TRACER)
    assert [s.name for s in tracer.spans] == ["checkpoint.save",
                                              "checkpoint.load"]


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_checkpoint_refused(model, tmp_path, damage):
    arrays, meta, _ = model
    path = str(tmp_path / "bad")
    t_io.save_ensemble(path, torch_packed(arrays, meta))
    with open(path + ".npz", "r+b") as f:
        if damage == "flip":
            f.seek(120)
            byte = f.read(1)
            f.seek(120)
            f.write(bytes([byte[0] ^ 0xFF]))
        else:
            f.truncate(300)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        t_io.load_ensemble(path, device="cpu")
    with pytest.raises(ValueError, match="corrupt or truncated"):
        j_io.load_ensemble(path)


def test_unported_and_foreign_sidecars_refused(model, tmp_path):
    """A quantized sidecar (ported now) loads as a ``QuantizedEnsemble``
    with the JAX tables; a sidecar of no ensemble is refused."""
    from repro.core.types import quantize_ensemble

    arrays, meta, _ = model
    qpath = str(tmp_path / "q8")
    jq = quantize_ensemble(jax_packed(arrays, meta), 8)
    j_io.save_ensemble(qpath, jq)
    tq = t_io.load_ensemble(qpath, device="cpu")
    assert tq.bits == 8
    for f in ("feature", "threshold", "leaf_q", "leaf_scale"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)))
    ppath = str(tmp_path / "tree")
    j_io.save_pytree(ppath, {"a": jnp.zeros(3)})
    with pytest.raises(ValueError, match="not a packed-ensemble"):
        t_io.load_ensemble(ppath, device="cpu")
