"""The committed reference model, its golden scores and its training
oracle.

``src/repro_torch/testdata/`` holds a Dynamic FedGBF checkpoint trained by
the JAX package (``serve_fedgbf --dataset default_credit_card --rounds 20``:
78 trees, depth 3, B = 32), the JAX package's scores for the first 4,096
requests of the seed-0 request stream, and the training oracle of the same
run (``dynamic_fedgbf_r20_train.npz``): the 78 sample masks (bit-packed)
and feature masks the scan engine draws up front from ``PRNGKey(0)``, the
per-round train metric matrix and the final train margins.
``chip_smoke.py`` holds the port's GPU scores and its GPU training run
against the same files.

Regenerate all four files (uses JAX; about 45 s on a CPU):

    PYTHONPATH=src python tests/test_torch_reference.py
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTDATA = ROOT / "src" / "repro_torch" / "testdata"
CKPT = TESTDATA / "dynamic_fedgbf_r20"
SCORES = TESTDATA / "dynamic_fedgbf_r20_scores.npz"
TRAIN = TESTDATA / "dynamic_fedgbf_r20_train.npz"
METRIC_KEYS = ("auc", "acc", "f1", "loss")
N_SCORED = 4096
N_PALLAS = 256


def request_stream(x_test: np.ndarray, n: int) -> np.ndarray:
    """``serve_fedgbf.main``'s stream: test rows resampled with seed 0."""
    rng = np.random.default_rng(0)
    return np.asarray(x_test)[rng.integers(0, x_test.shape[0], n)]


def _jax_scores():
    import jax.numpy as jnp

    from repro.checkpoint import io as ckpt_io
    from repro.core import boosting
    from repro.data import synthetic

    pe = ckpt_io.load_ensemble(str(CKPT))
    x = jnp.asarray(request_stream(synthetic.load("default_credit_card").x_test,
                                   N_SCORED))
    return {
        "margin_fused": np.asarray(boosting.predict(pe, x, impl="fused")),
        "proba_fused": np.asarray(boosting.predict_proba(pe, x, impl="fused")),
        "margin_pallas": np.asarray(
            boosting.predict(pe, x[:N_PALLAS], impl="pallas")),
    }


def _jax_train_oracle():
    """The reference run's masks, as the scan engine derives them from
    ``PRNGKey(0)``, and the run's train metric matrix and final margins."""
    import jax
    import jax.numpy as jnp

    from repro.core import boosting
    from repro.data import synthetic
    from torch_parity import jax_step_masks

    ds = synthetic.load("default_credit_card")
    n, d = ds.x_train.shape
    cfg = boosting.dynamic_fedgbf_config(rounds=20)
    smask, fmask = jax_step_masks(cfg, n, d)
    _, hist = boosting.train_fedgbf(
        jnp.asarray(ds.x_train), jnp.asarray(ds.y_train), cfg,
        jax.random.PRNGKey(0))
    return {
        "sample_bits": np.packbits(smask.astype(np.uint8), axis=1),
        "feature": fmask,
        "n": np.int64(n),
        "train_metrics": np.array([[r[k] for k in METRIC_KEYS]
                                   for r in hist.train], np.float32),
        "final_margin": np.asarray(hist.final_margin),
    }


def test_jax_reproduces_committed_train_oracle():
    want = np.load(TRAIN)
    got = _jax_train_oracle()
    assert set(want.files) == set(got)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_jax_reproduces_committed_scores():
    want = np.load(SCORES)
    got = _jax_scores()
    for key in ("margin_fused", "proba_fused", "margin_pallas"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_port_reproduces_committed_scores():
    import torch

    from repro_torch.checkpoint import io as t_io
    from repro_torch.core import boosting as t_boosting
    from repro_torch.data import synthetic as t_synthetic

    want = np.load(SCORES)
    pe = t_io.load_ensemble(str(CKPT), device="cpu")
    assert pe.total_trees == 78 and pe.rounds == 20 and pe.max_depth == 3
    x = torch.from_numpy(request_stream(
        t_synthetic.load("default_credit_card").x_test, N_SCORED))
    # JAX's CPU backend contracts each step ``acc + scale * leaf`` into one
    # FMA (in the scan and in the interpret-mode Pallas kernels alike); the
    # port keeps the TPU kernels' unfused order, product then sum, which
    # ends up within 1e-6 of the JAX margins and bit-equal across the
    # port's own single-pass paths (base_score = 0 here).
    margins = {impl: t_boosting.predict(pe, x, impl=impl).numpy()
               for impl in ("fused", "fused-cuda", "weighted", "cuda",
                            "packed")}
    for impl, got in margins.items():
        np.testing.assert_allclose(got, want["margin_fused"], rtol=0,
                                   atol=1e-6, err_msg=impl)
    for impl in ("fused-cuda", "weighted", "cuda"):
        np.testing.assert_array_equal(margins[impl], margins["fused"],
                                      err_msg=impl)
    np.testing.assert_allclose(margins["cuda"][:N_PALLAS],
                               want["margin_pallas"], rtol=0, atol=1e-6)
    # torch.sigmoid and jax.nn.sigmoid may differ in the last ulp
    np.testing.assert_allclose(
        t_boosting.predict_proba(pe, x, impl="fused-cuda").numpy(),
        want["proba_fused"], rtol=0, atol=1e-6)


def test_stream_prefix_is_stable():
    """chip_smoke compares the first 4,096 scores of a 1M-request stream
    with this file: a longer draw must begin with the shorter one."""
    x = np.arange(9000, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(request_stream(x, 1 << 20)[:N_SCORED],
                                  request_stream(x, N_SCORED))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, import without JAX and
    without any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('modules', sum(k.startswith('repro_torch') for k in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30, out.stdout


def _regenerate() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    TESTDATA.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run(
        [sys.executable, "-m", "repro.launch.serve_fedgbf",
         "--dataset", "default_credit_card", "--rounds", "20",
         "--requests", str(N_SCORED), "--batch-size", str(N_SCORED),
         "--save", str(CKPT)],
        env=env, check=True)
    np.savez(SCORES, **_jax_scores())
    np.savez_compressed(TRAIN, **_jax_train_oracle())
    print(f"wrote {CKPT}.npz, {CKPT}.meta.json, {SCORES} and {TRAIN}")


if __name__ == "__main__":
    _regenerate()
