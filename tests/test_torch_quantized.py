"""Port vs JAX package: the quantized serving tier on the CPU.

``quantize_stats`` and ``quantize_ensemble`` draw the JAX package's
stochastic-rounding uniforms from the same key (``core/prng.py``), or take
them as an input; the int8/int16 tables must be the JAX tables bit for bit (nearest and stochastic rounding, 8 and
16 bits, K = 1 and 3), and quantized margins the JAX margins bit for bit on
every impl.  ``margin_delta_bound`` is a float32 sum in XLA's reduction
order, which torch does not follow: it is held at rtol 1e-6.  The
committed JAX-quantized copies of the reference checkpoint load, serve and
reproduce.

Regenerate the committed files (uses JAX; a few seconds on a CPU): the
JAX package's int8 and int16 copies of ``dynamic_fedgbf_r20``
(``quantize_ensemble(checkpoint, bits, key=PRNGKey(0))``, saved by its
``save_ensemble`` as ``dynamic_fedgbf_r20_q8`` and ``_q16``) and
``dynamic_fedgbf_r20_quantized.npz``: ``uniform``, the (78, 8, 1)
stochastic-rounding uniforms both tables were drawn with; ``margin_q8``
and ``margin_q16``, the JAX ``impl="fused"`` margins on the first 4,096
requests of the seed-0 request stream; ``bound_q8`` and ``bound_q16``,
their ``margin_delta_bound``.

    PYTHONPATH=src python tests/test_torch_quantized.py
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as j_io
from repro.core import boosting as j_boosting
from repro.core import types as j_types
from repro.data import synthetic as j_synthetic
from repro.federation import compress as j_compress
from repro_torch.checkpoint import io as t_io
from repro_torch.core import boosting as t_boosting
from repro_torch.core import prng
from repro_torch.core import types as t_types
from repro_torch.data import synthetic as t_synthetic
from repro_torch.federation import compress as t_compress
from repro_torch.launch import serve_fedgbf as t_serve
from test_torch_reference import CKPT, N_SCORED, request_stream
from torch_parity import (hard_rows, jax_packed, random_packed_arrays,
                          torch_packed)

TESTDATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "testdata"
QDATA = TESTDATA / "dynamic_fedgbf_r20_quantized.npz"
QUANTIZED_FIELDS = ("feature", "threshold", "leaf_q", "leaf_scale",
                    "tree_scale", "bin_edges")
KEY = jax.random.PRNGKey(0)


def quantized_path(bits: int) -> Path:
    return TESTDATA / f"dynamic_fedgbf_r20_q{bits}"


def _jax_quantized():
    """{bits: the JAX QuantizedEnsemble} and the reference data, computed
    afresh."""
    packed = j_io.load_ensemble(str(CKPT))
    x = jnp.asarray(request_stream(
        j_synthetic.load("default_credit_card").x_test, N_SCORED))
    shape = tuple(packed.leaf_weight.shape) + (1,)
    models, data = {}, {"uniform": _uniform(shape)}
    for bits in (8, 16):
        q = j_types.quantize_ensemble(packed, bits=bits, key=KEY)
        models[bits] = q
        data[f"margin_q{bits}"] = np.asarray(
            j_boosting.predict(q, x, impl="fused"))
        data[f"bound_q{bits}"] = np.float64(j_types.margin_delta_bound(q))
    return models, data


def _uniform(shape):
    return np.array(jax.random.uniform(KEY, shape))


def _assert_tables_equal(t_q, j_q):
    assert t_q.bits == j_q.bits
    assert t_q.round_offsets == tuple(j_q.round_offsets)
    for f in QUANTIZED_FIELDS:
        got, want = getattr(t_q, f).numpy(), np.asarray(getattr(j_q, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_stats_equals_jax(bits, stochastic):
    """The codec on (node, feature, B, C) stats with an all-zero slice and
    exact halves: q and scale bit-equal, and the dequantized stats too."""
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(3, 4, 16, 3)).astype(np.float32)
    x[1, 2] = 0.0
    x[0, 0, :, 0] = np.arange(16) - 7.5      # half-way cases for round()
    jq, js = j_compress.quantize_stats(jnp.asarray(x), bits, KEY,
                                       stochastic=stochastic)
    tq, ts = t_compress.quantize_stats(
        torch.from_numpy(x), bits, prng.PRNGKey(0), stochastic=stochastic)
    assert tq.numpy().dtype == np.asarray(jq).dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        t_compress.dequantize_stats(tq, ts).numpy(),
        np.asarray(j_compress.dequantize_stats(jq, js)))
    with pytest.raises(ValueError, match="bits"):
        t_compress.quantize_stats(torch.from_numpy(x), 4)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("k", [None, 3])
def test_quantize_ensemble_equals_jax(bits, k):
    """Tables bit-equal for nearest and stochastic rounding, the
    dequantized ensemble equal, the bound within rtol 1e-6; int8
    thresholds up to B = 126, int16 beyond."""
    rng = np.random.default_rng(bits + (k or 0))
    for num_bins in (32, 200):
        arrays, meta = random_packed_arrays(rng, [5, 4, 3, 2], 3, 9,
                                            num_bins=num_bins, k=k)
        jp, tp = jax_packed(arrays, meta), torch_packed(arrays, meta)
        for stochastic in (True, False):
            jq = j_types.quantize_ensemble(jp, bits, key=KEY,
                                           stochastic=stochastic)
            tq = t_types.quantize_ensemble(tp, bits, stochastic=stochastic)
            _assert_tables_equal(tq, jq)
            assert tq.threshold.dtype == (torch.int8 if num_bins <= 126
                                          else torch.int16)
            np.testing.assert_allclose(t_types.margin_delta_bound(tq),
                                       j_types.margin_delta_bound(jq),
                                       rtol=1e-6, atol=0)
            jd, td = j_types.dequantize_ensemble(jq), \
                t_types.dequantize_ensemble(tq)
            for f in ("feature", "threshold", "gain", "leaf_weight"):
                np.testing.assert_array_equal(getattr(td, f).numpy(),
                                              np.asarray(getattr(jd, f)), f)
    bad = dataclasses.replace(tp, feature=tp.feature + 40000)
    with pytest.raises(ValueError, match="int16"):
        t_types.quantize_ensemble(bad, bits)
    with pytest.raises(ValueError, match="bits"):
        t_types.quantize_ensemble(tp, 4)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_margins_equal_jax(bits):
    """Every impl serves the quantized model with the JAX counterpart's
    margins bit for bit (``fused-cuda`` and ``cuda`` are the kernels'
    plain versions here, held against ``fused`` and ``weighted``)."""
    rng = np.random.default_rng(20 + bits)
    arrays, meta = random_packed_arrays(rng, [5, 4, 3, 2, 2], 3, 23)
    jq = j_types.quantize_ensemble(jax_packed(arrays, meta), bits, key=KEY)
    tq = t_types.quantize_ensemble(torch_packed(arrays, meta), bits)
    x = hard_rows(rng, 300, arrays["bin_edges"])
    twins = {"fused": "fused", "fused-cuda": "fused", "weighted": "weighted",
             "cuda": "weighted", "packed": "packed", "loop": "loop"}
    for impl, j_impl in twins.items():
        got = t_boosting.predict(tq, torch.from_numpy(x), impl=impl).numpy()
        want = np.asarray(j_boosting.predict(jq, jnp.asarray(x),
                                             impl=j_impl))
        np.testing.assert_array_equal(got, want, err_msg=impl)
    f32 = t_boosting.predict(torch_packed(arrays, meta), torch.from_numpy(x),
                             impl="fused").numpy()
    finite = np.isfinite(f32)
    assert np.abs(got - f32)[finite].max() <= t_types.margin_delta_bound(tq)


@pytest.fixture(scope="module")
def committed():
    return np.load(QDATA)


@pytest.mark.parametrize("bits", [8, 16])
def test_committed_quantized_checkpoints(bits, committed):
    """The JAX-quantized reference checkpoints load in the port; the
    port's ``quantize_ensemble`` with the committed uniforms gives their
    tables exactly; ``fused`` and ``fused-cuda`` give the committed JAX
    margins bit for bit, within ``margin_delta_bound`` of the f32 ones."""
    q = t_io.load_ensemble(str(TESTDATA / f"dynamic_fedgbf_r20_q{bits}"),
                           device="cpu")
    assert isinstance(q, t_types.QuantizedEnsemble) and q.bits == bits
    f32 = t_io.load_ensemble(str(CKPT), device="cpu")
    mine = t_types.quantize_ensemble(
        f32, bits, uniform=torch.from_numpy(committed["uniform"]))
    for f in QUANTIZED_FIELDS:
        assert torch.equal(getattr(mine, f), getattr(q, f)), f
    np.testing.assert_allclose(t_types.margin_delta_bound(q),
                               committed[f"bound_q{bits}"], rtol=1e-6)
    x = torch.from_numpy(request_stream(
        t_synthetic.load("default_credit_card").x_test, N_SCORED))
    for impl in ("fused", "fused-cuda"):
        np.testing.assert_array_equal(
            t_boosting.predict(q, x, impl=impl).numpy(),
            committed[f"margin_q{bits}"], err_msg=impl)
    delta = np.abs(committed[f"margin_q{bits}"]
                   - t_boosting.predict(f32, x, impl="fused").numpy())
    assert delta.max() <= t_types.margin_delta_bound(q)


def test_jax_reproduces_committed_quantized(committed):
    """The generator below, run afresh, gives the committed files."""
    models, data = _jax_quantized()
    for key, value in data.items():
        np.testing.assert_array_equal(value, committed[key], err_msg=key)
    for bits, q in models.items():
        stored = j_io.load_ensemble(str(quantized_path(bits)))
        for f in QUANTIZED_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(stored, f)),
                                          np.asarray(getattr(q, f)), f)


def test_quantized_checkpoint_roundtrip_both_ways(tmp_path):
    """A port-quantized model saved by the port loads in the JAX package
    as a ``QuantizedEnsemble`` and back, K = 3 included."""
    rng = np.random.default_rng(3)
    arrays, meta = random_packed_arrays(rng, [3, 2], 3, 7, k=3)
    tq = t_types.quantize_ensemble(torch_packed(arrays, meta), 8,
                                   key=prng.PRNGKey(1))
    path = str(tmp_path / "q")
    t_io.save_ensemble(path, tq)
    jq = j_io.load_ensemble(path)
    assert isinstance(jq, j_types.QuantizedEnsemble)
    _assert_tables_equal(tq, jq)
    j_io.save_ensemble(path + "-jax", jq)
    back = t_io.load_ensemble(path + "-jax", device="cpu")
    for f in QUANTIZED_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tq, f)), f
    assert (back.loss, back.max_depth, back.learning_rate) == (
        tq.loss, tq.max_depth, tq.learning_rate)
    assert back.to("cpu").device.type == "cpu"


def test_serve_quantized_cli_and_hot_swap(tmp_path, capsys):
    """``--quantize 8`` quantizes from ``PRNGKey(0)`` (the committed JAX
    int8 tables) and prints the bound;
    a quantized checkpoint serves as it is; ``--metrics-port 0`` prints
    the self-scrape; ``ModelSlot`` swaps in a quantized candidate and
    refuses a corrupt one."""
    t_serve.main(["--checkpoint", str(CKPT), "--device", "cpu",
                  "--requests", "3000", "--batch-size", "1024",
                  "--quantize", "8", "--metrics-port", "0"])
    out = capsys.readouterr().out
    f32 = t_io.load_ensemble(str(CKPT), device="cpu")
    mine = t_types.quantize_ensemble(f32, 8)
    committed_q8 = t_io.load_ensemble(str(quantized_path(8)), device="cpu")
    for f in QUANTIZED_FIELDS:
        assert torch.equal(getattr(mine, f), getattr(committed_q8, f)), f
    assert (f"serving int8 quantized tables: margin error bound "
            f"{t_types.margin_delta_bound(mine):.3e}") in out
    assert "self-scrape http://127.0.0.1:" in out
    assert int(out.split("self-scrape")[1].split(": ")[1].split()[0]) > 10
    q16 = str(TESTDATA / "dynamic_fedgbf_r20_q16")
    t_serve.main(["--checkpoint", q16, "--device", "cpu", "--requests",
                  "2000", "--impl", "cuda", "--quantize", "16"])
    assert "serving int16 quantized tables" in capsys.readouterr().out

    sm = t_serve.StreamMetrics(256)
    slot = t_serve.ModelSlot(f32, "fused-cuda", metrics=sm,
                             warm_sizes=(256,))
    assert slot.try_reload(str(TESTDATA / "dynamic_fedgbf_r20_q8"))
    assert isinstance(slot.packed, t_types.QuantizedEnsemble)
    bad = str(tmp_path / "bad")
    t_io.save_ensemble(bad, mine)
    with open(bad + ".npz", "r+b") as f:
        f.truncate(300)
    assert not slot.try_reload(bad)
    assert slot.packed.bits == 8
    assert (int(sm.reloads.value), int(sm.reload_failures.value)) == (1, 1)


def _regenerate() -> None:
    models, data = _jax_quantized()
    for bits, q in models.items():
        j_io.save_ensemble(str(quantized_path(bits)), q)
    np.savez(QDATA, **data)
    print(f"wrote {quantized_path(8)}, {quantized_path(16)} and {QDATA}")


if __name__ == "__main__":
    _regenerate()
