"""Port vs JAX package: quantile edges and bin ids, NaN columns included
(CPU, exact)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as j_binning
from repro_torch.core import binning as t_binning
from repro_torch.data import synthetic as t_synthetic
from torch_parity import hard_rows

CKPT_EDGES = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
              / "testdata" / "dynamic_fedgbf_r20.npz")


def _messy(rng, n, d):
    x = rng.lognormal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.1] = np.nan
    x[:, 1] = np.nan                       # all-NaN column
    x[:, 2] = np.round(x[:, 2])            # heavy ties
    x[:3, 3] = np.inf
    return x


@pytest.mark.parametrize("n,num_bins", [(1, 8), (2, 32), (50, 32),
                                        (1000, 8), (4001, 32), (3000, 256)])
def test_quantile_bin_edges_exact(n, num_bins):
    x = _messy(np.random.default_rng(n + num_bins), n, 6)
    want = np.asarray(j_binning.quantile_bin_edges(jnp.asarray(x), num_bins))
    got = t_binning.quantile_bin_edges(torch.from_numpy(x), num_bins).numpy()
    assert got.shape == (6, num_bins - 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], 0.0)


def test_committed_model_edges_reproduced():
    """The reference checkpoint's edges are the port's edges of the same
    training rows: binning is reproducible across the packages."""
    ds = t_synthetic.load("default_credit_card")
    got = t_binning.quantile_bin_edges(torch.from_numpy(ds.x_train), 32)
    np.testing.assert_array_equal(got.numpy(), np.load(CKPT_EDGES)["leaf_5"])


def test_bin_data_exact_with_nan_and_edges():
    rng = np.random.default_rng(3)
    x = _messy(rng, 700, 6)
    edges = np.array(j_binning.quantile_bin_edges(jnp.asarray(x), 32))
    rows = np.concatenate([x, hard_rows(rng, 300, edges)])
    want = np.asarray(j_binning.bin_data(jnp.asarray(rows),
                                         jnp.asarray(edges)))
    got = t_binning.bin_data(torch.from_numpy(rows), torch.from_numpy(edges))
    assert got.dtype == torch.int32 and got.shape == rows.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[np.isnan(rows)] == t_binning.NAN_BIN).all()
