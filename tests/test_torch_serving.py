"""The port's serving tier on the CPU: admission ladder, hot-swap oracle,
inf-row rejection, the zero-copy clean batch and the CLI, mirroring
``tests/test_serving.py``, plus scores against the JAX service."""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import io as j_io
from repro.launch import serve_fedgbf as j_serve
from repro_torch.checkpoint import io as t_io
from repro_torch.data import synthetic as t_synthetic
from repro_torch.launch import serve_fedgbf as t_serve

CKPT = str(Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "testdata" / "dynamic_fedgbf_r20")


@pytest.fixture(scope="module")
def model_a():
    return t_io.load_ensemble(CKPT, device="cpu")


@pytest.fixture(scope="module")
def x_test():
    return t_synthetic.load("default_credit_card").x_test


@pytest.fixture
def path_b(model_a, tmp_path):
    """A second model: A's trees with other leaves, saved by the port."""
    import dataclasses

    b = dataclasses.replace(model_a, leaf_weight=model_a.leaf_weight * -0.5)
    path = str(tmp_path / "model_b")
    t_io.save_ensemble(path, b)
    return path


def test_ladder_sizes_and_pick_match_jax():
    for max_size, min_size in ((8192, 256), (1000, 256), (64, 256), (1, 1)):
        assert (t_serve.ladder_sizes(max_size, min_size)
                == j_serve.ladder_sizes(max_size, min_size))
    sm = t_serve.StreamMetrics(1024)
    ladder = t_serve.BatchLadder([256, 512, 1024])
    assert ladder.pick(100, None, sm) == 256
    assert ladder.pick(600, None, sm) == 1024
    assert ladder.pick(10_000, None, sm) == 1024
    assert ladder.pick(10_000, 0.005, sm) == 1024
    for _ in range(20):
        sm.rung_latency(1024).observe(0.050)
        sm.rung_latency(512).observe(0.002)
    assert ladder.pick(10_000, 0.005, sm) == 512
    for _ in range(20):
        sm.rung_latency(256).observe(0.010)
    assert ladder.pick(10_000, 1e-6, sm) == 256
    with pytest.raises(ValueError):
        t_serve.BatchLadder([])


def test_adaptive_stream_matches_single_rung(model_a, x_test):
    x = np.array(x_test[:700], np.float32)
    ladder = t_serve.BatchLadder([128, 256, 512])
    ladder.warm(model_a, x.shape[1], "fused-cuda")
    slot = t_serve.ModelSlot(model_a, "fused-cuda")
    out, sm = t_serve.serve_stream(slot, x, ladder=ladder, p99_budget_s=10.0)
    assert len(sm._rung_hists) > 1
    assert int(sm.rows.value) == 700
    ref, _ = t_serve.score_stream(model_a, x, batch_size=512,
                                  impl="fused-cuda")
    np.testing.assert_array_equal(out, ref)


def test_clean_full_batch_not_copied(model_a, x_test):
    x = np.array(x_test[:256], np.float32)
    x[7, 0] = np.inf
    x.setflags(write=False)
    before = x.copy()
    out, sm = t_serve.score_stream(model_a, x, batch_size=128,
                                   impl="fused-cuda")
    np.testing.assert_array_equal(np.asarray(x), before)
    assert int(sm.rows_rejected.value) == 1
    assert np.isnan(out[7]) and np.isfinite(np.delete(out, 7)).all()


def test_mid_stream_swap_scores_match_each_oracle(model_a, path_b, x_test):
    x = np.array(x_test[:512], np.float32)
    sm = t_serve.StreamMetrics(128)
    slot = t_serve.ModelSlot(model_a, "fused-cuda", metrics=sm,
                             warm_sizes=[128])
    out, sm = t_serve.serve_stream(
        slot, x, ladder=t_serve.BatchLadder([128]), metrics=sm,
        swap_plan={2: path_b})
    model_b = t_io.load_ensemble(path_b, device="cpu")
    oracle_a, _ = t_serve.score_stream(model_a, x[:256], 128, "fused-cuda")
    oracle_b, _ = t_serve.score_stream(model_b, x[256:], 128, "fused-cuda")
    np.testing.assert_array_equal(out[:256], oracle_a)
    np.testing.assert_array_equal(out[256:], oracle_b)
    assert not np.array_equal(oracle_a, oracle_b[:256])
    assert int(sm.reloads.value) == 1
    assert int(sm.model_generation.value) == 1
    assert sm.swap_latency.count == 1
    assert sm.occupancy.value == 1.0


def test_occupancy_segments_at_swap(model_a, path_b, x_test):
    x = np.array(x_test[:80], np.float32)
    sm = t_serve.StreamMetrics(32)
    slot = t_serve.ModelSlot(model_a, "fused", metrics=sm, warm_sizes=[32])
    _, sm = t_serve.serve_stream(
        slot, x, ladder=t_serve.BatchLadder([32]), metrics=sm,
        swap_plan={2: path_b})
    assert sm.occupancy.value == 0.5
    assert int(sm.padded_rows.value) == 16


def test_refused_candidate_never_perturbs_serving(model_a, x_test, tmp_path):
    bad = str(tmp_path / "bad")
    t_io.save_ensemble(bad, model_a)
    with open(bad + ".npz", "r+b") as f:
        f.seek(120)
        byte = f.read(1)
        f.seek(120)
        f.write(bytes([byte[0] ^ 0xFF]))
    x = np.array(x_test[:256], np.float32)

    def run(swap_plan):
        sm = t_serve.StreamMetrics(64)
        slot = t_serve.ModelSlot(model_a, "cuda", metrics=sm,
                                 warm_sizes=[64])
        return t_serve.serve_stream(
            slot, x, ladder=t_serve.BatchLadder([64]), metrics=sm,
            swap_plan=swap_plan)

    base_out, base_sm = run(None)
    out, sm = run({2: bad})
    assert int(sm.reload_failures.value) == 1
    assert int(sm.reloads.value) == 0
    np.testing.assert_array_equal(out, base_out)
    assert sm.latency.count == base_sm.latency.count == 4
    assert sm.swap_latency.count == 0
    assert int(sm.model_generation.value) == 0
    assert sm.occupancy.value == base_sm.occupancy.value


def test_scores_match_jax_service(model_a, x_test):
    """Same rows, same checkpoint: the port's fused-cuda stream against the
    JAX fused stream, inf rows rejected alike (1e-6: the margins are equal,
    the sigmoids may differ in the last ulp)."""
    x = np.array(x_test[:600], np.float32)
    x[3, 4] = np.inf
    x[5, :] = np.nan
    x[9, 1] = -np.inf
    got, sm = t_serve.score_stream(model_a, x, batch_size=256,
                                   impl="fused-cuda")
    want, jsm = j_serve.score_stream(j_io.load_ensemble(CKPT), x,
                                     batch_size=256, impl="fused")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isnan(got[[3, 9]]).all() and np.isfinite(got[5])
    assert int(sm.rows_rejected.value) == int(jsm.rows_rejected.value) == 2
    families = {line.split()[2] for line in sm.render().splitlines()
                if line.startswith("# TYPE")}
    assert families == {line.split()[2] for line in jsm.render().splitlines()
                        if line.startswith("# TYPE")}


def test_cli_serves_on_cpu_and_refuses_missing_cuda(tmp_path, capsys,
                                                    monkeypatch):
    metrics = tmp_path / "metrics.prom"
    t_serve.main(["--checkpoint", CKPT, "--device", "cpu", "--requests",
                  "3000", "--batch-size", "1024", "--impl", "cuda",
                  "--reload", CKPT, "--reload-at-batch", "1",
                  "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    assert "impl=cuda on cpu" in out and "swaps=1" in out
    assert "fedgbf_serve_rows_total 3000" in metrics.read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--checkpoint", CKPT, "--requests", "10"])
