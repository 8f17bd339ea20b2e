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
from repro_torch.obs import trace

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


# (row, column, value) written into 600 rows served in batches of 256:
# two full batches, then 88 rows padded to a rung
INF_CASES = {
    "clean": [],
    "pos_inf_mid_batch": [(100, 3, np.inf)],
    "neg_inf_last_row_full_batch": [(511, 22, -np.inf)],
    "inf_in_padded_batch": [(550, 2, np.inf)],
    "two_infs_one_row": [(300, 0, np.inf), (300, 5, -np.inf)],
    "all_nan_row": [(400, slice(None), np.nan)],
    "inf_beside_nan_row": [(400, slice(None), np.nan), (410, 3, np.inf)],
}


@pytest.mark.parametrize("entry", ["score_stream", "serve_stream"])
@pytest.mark.parametrize("case", sorted(INF_CASES))
def test_inf_rows_rejected_as_jax_service(model_a, x_test, case, entry):
    """Only rows holding an inf score NaN and count as rejected, whether the
    batch is full or padded, with the JAX service's scores elsewhere; the
    caller's array is never written."""
    x = np.array(x_test[:600], np.float32)
    for row, col, value in INF_CASES[case]:
        x[row, col] = value
    inf_rows = sorted({row for row, _, value in INF_CASES[case]
                       if np.isinf(value)})
    x.setflags(write=False)
    before = x.copy()
    if entry == "score_stream":
        got, sm = t_serve.score_stream(model_a, x, batch_size=256,
                                       impl="fused-cuda")
    else:
        slot = t_serve.ModelSlot(model_a, "fused-cuda")
        got, sm = t_serve.serve_stream(
            slot, x, ladder=t_serve.BatchLadder([128, 256]))
        assert int(sm.padded_rows.value) == 40
    want, jsm = j_serve.score_stream(j_io.load_ensemble(CKPT), x,
                                     batch_size=256, impl="fused")
    np.testing.assert_array_equal(x, before)
    assert np.isnan(got[inf_rows]).all()
    assert np.isfinite(np.delete(got, inf_rows)).all()
    assert (int(sm.rows_rejected.value) == int(jsm.rows_rejected.value)
            == len(inf_rows))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inf_counter_samples_only_batches_with_inf(model_a, x_test):
    """``serve.admit.inf_rows`` is sampled once a batch that holds an inf,
    with its rejected rows, and never on a clean stream."""
    x = np.array(x_test[:384], np.float32)
    with trace.use(trace.Tracer()) as tracer:
        t_serve.score_stream(model_a, x, batch_size=128, impl="fused-cuda")
    assert not [c for c in tracer.counters if c[0] == "serve.admit.inf_rows"]
    x[5, 1] = np.inf
    x[9, 0] = -np.inf
    x[300, 2] = x[300, 7] = np.inf
    with trace.use(trace.Tracer()) as tracer:
        _, sm = t_serve.score_stream(model_a, x, batch_size=128,
                                     impl="fused-cuda")
    assert [values for name, _, values in tracer.counters
            if name == "serve.admit.inf_rows"] == [{"rows": 2}, {"rows": 1}]
    assert int(sm.rows_rejected.value) == 3


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
