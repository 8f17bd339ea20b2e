"""Port vs JAX package: the random streams (``repro_torch/core/prng.py``)
and every seeded entry point that draws from them, on the CPU.

The port's threefry keys, ``split``, ``fold_in``, ``random_bits``,
``uniform`` and ``permutation`` are held bit-equal to ``jax.random``
(single and batched keys against ``jax.vmap``; seeds 0, 7, 1000 + p and a
negative int32).  ``normal`` and ``gumbel`` end in XLA's float32
``log1p``/``log``/``erf_inv``, which the port takes operation for
operation: the bound asked for is 4 ulp with at least 90% bit-equal, and
the draws are held bit-equal (ROADMAP §3).  Then the draw sites: the
reference run's 78 masks from ``PRNGKey(0)``, GOSS's weight masks, the
quantized tables at the default key, the q8/q16 transport's rounding from
its seed alone, the gradient-less parties' ``fold_in(rng, p)`` masks, a
resumed seeded run and the serving launcher's sampling (the LM
``init_params`` of the ten smoke configs: ``test_torch_lm_params.py`` and
``test_torch_lm_train.py``).  One torch thread, no subprocess.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forest as j_forest
from repro.core import types as j_types
from repro_torch.checkpoint import io as t_io
from repro_torch.core import backend as t_backend
from repro_torch.core import boosting as t_boosting
from repro_torch.core import forest as t_forest
from repro_torch.core import prng
from repro_torch.core import types as t_types
from repro_torch.data import synthetic as t_synthetic
from repro_torch.federation import compress as t_compress

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_federation import (QUANTIZED_P4, assert_same_build,  # noqa
                                   local_steps, small_config, small_data)
from test_torch_quantized import QUANTIZED_FIELDS, quantized_path  # noqa
from test_torch_reference import CKPT, TRAIN  # noqa: E402
from torch_parity import (jax_config, jax_goss_draws,  # noqa: E402
                          jax_packed, jax_step_masks, one_torch_thread,
                          random_packed_arrays, torch_packed)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SEEDS = (0, 7, 1003, -5)   # the launcher's key, a selftest's, party 3's
LOGITS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "testdata" / "lm_smoke_logits.npz"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _bits_equal(got: torch.Tensor, want) -> None:
    """Equal bit patterns (float32/bfloat16 viewed as integers)."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.view(np.uint16)
        got = got.view(torch.int16).numpy().view(np.uint16)
    elif want.dtype == np.float32:
        want = want.view(np.uint32)
        got = got.numpy().view(np.uint32)
    else:
        got = got.numpy()
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_draws_equal_jax(seed):
    """``PRNGKey``, ``split``, ``fold_in``, ``random_bits`` and ``uniform``
    (float32, a range, bfloat16), one key and a batch of keys (against
    ``jax.vmap``), bit for bit."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _bits_equal(tk, jk)
    _bits_equal(prng.split(tk, 5), jax.random.split(jk, 5))
    _bits_equal(prng.fold_in(tk, 12345), jax.random.fold_in(jk, 12345))
    _bits_equal(prng.random_bits(tk, (3, 7)), jax.random.bits(jk, (3, 7)))
    _bits_equal(prng.uniform(tk, (1000,)), jax.random.uniform(jk, (1000,)))
    _bits_equal(prng.uniform(tk, (500,), -2.0, 3.0),
                jax.random.uniform(jk, (500,), minval=-2.0, maxval=3.0))
    _bits_equal(prng.uniform(tk, (500,), dtype=torch.bfloat16),
                jax.random.uniform(jk, (500,), jnp.bfloat16))
    jkeys = jax.random.split(jk, 4)
    tkeys = prng.as_key(np.asarray(jkeys))
    _bits_equal(prng.fold_in(tkeys, torch.arange(4)),
                jax.vmap(jax.random.fold_in)(jkeys, jnp.arange(4)))
    _bits_equal(prng.split(tkeys, 3), jax.vmap(
        lambda k: jax.random.split(k, 3))(jkeys))
    _bits_equal(prng.random_bits(tkeys, (2, 9)), jax.vmap(
        lambda k: jax.random.bits(k, (2, 9)))(jkeys))
    _bits_equal(prng.uniform(tkeys, (300,)), jax.vmap(
        lambda k: jax.random.uniform(k, (300,)))(jkeys))


@pytest.mark.parametrize("n", [1, 23, 24, 21000, 150000])
def test_permutation_equal_jax(n):
    """``permutation`` for one key and (up to 21,000) a batch of keys: the
    rounds of stable sorts by fresh 32-bit draws (at 21,000 the draws tie,
    and the sort must keep the earlier position first)."""
    jk = jax.random.PRNGKey(n)
    _bits_equal(prng.permutation(prng.PRNGKey(n), n),
                jax.random.permutation(jk, n))
    if n <= 21000:
        jkeys = jax.random.split(jk, 3)
        _bits_equal(prng.permutation(prng.as_key(np.asarray(jkeys)), n),
                    jax.vmap(lambda k: jax.random.permutation(k, n))(jkeys))


def test_normal_equal_jax():
    """``normal``: 200,000 draws a key (and a batch), bit-equal to JAX's —
    inside the bound asked for (4 ulp, 90% bit-equal)."""
    for seed in (0, 5):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (200_000,)))
        got = _np(prng.normal(prng.PRNGKey(seed), (200_000,)))
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4 and (ulp == 0).mean() >= 0.9
        np.testing.assert_array_equal(ulp, 0)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 3)
    _bits_equal(prng.normal(prng.as_key(np.asarray(jkeys)), (50, 40)),
                jax.vmap(lambda k: jax.random.normal(k, (50, 40)))(jkeys))


def test_gumbel_and_categorical_equal_jax():
    """``gumbel`` (float32 and bfloat16) bit for bit, and ``categorical``'s
    draws for float32 and bfloat16 logits."""
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        _bits_equal(prng.gumbel(prng.PRNGKey(2), (64, 100), tdt),
                    jax.random.gumbel(jax.random.PRNGKey(2), (64, 100), dt))
        logits = jnp.asarray(np.random.default_rng(0).normal(
            size=(16, 200)) * 3, dt)
        t_logits = torch.from_numpy(np.asarray(logits, np.float32)).to(tdt)
        for seed in range(4):
            np.testing.assert_array_equal(
                _np(prng.categorical(prng.PRNGKey(seed), t_logits)),
                np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                  logits)))


def test_reference_masks_from_prngkey0():
    """The reference run's 78 (sample, feature) mask pairs, drawn from
    ``PRNGKey(0)`` by the scan engine's key chain in one batched call,
    equal the committed JAX masks."""
    z = np.load(TRAIN)
    ds = t_synthetic.load("default_credit_card")
    masks = t_forest.draw_step_masks(t_boosting.dynamic_fedgbf_config(20),
                                     *ds.x_train.shape, prng.PRNGKey(0))
    np.testing.assert_array_equal(_np(masks.sample), np.unpackbits(
        z["sample_bits"], axis=1, count=int(z["n"])))
    np.testing.assert_array_equal(_np(masks.feature), z["feature"])


@pytest.mark.parametrize("k", [1, 3])
def test_goss_masks_equal_jax(k):
    """``goss_masks`` / ``goss_masks_from_keys`` on the same gradients and
    keys: weight and feature masks bit for bit; the draws equal
    ``jax_goss_draws``."""
    rng = np.random.default_rng(k)
    n, d = 700, 9
    g = rng.normal(size=(n, k) if k > 1 else (n,)).astype(np.float32)
    n_top, n_rand = t_forest.goss_counts(n, 0.3, 0.5)
    want = j_forest.goss_masks(jax.random.PRNGKey(4), jnp.asarray(g), d, 4,
                               n_top, n_rand, 6)
    got = t_forest.goss_masks(prng.PRNGKey(4), torch.from_numpy(g), d, 4,
                              n_top, n_rand, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    cfg = t_boosting.FedGBFConfig(rounds=3, sampling="goss", rho_feat=0.7)
    draws = t_forest.draw_step_masks(cfg, n, d, prng.PRNGKey(k))
    uniform, feature = jax_goss_draws(jax_config(cfg), n, d, seed=k)
    _bits_equal(draws.uniform, uniform)
    np.testing.assert_array_equal(_np(draws.feature), feature)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_ensemble_default_key_equals_jax(bits):
    """``quantize_ensemble`` at its default key (``PRNGKey(0)``): the
    reference checkpoint's tables are the committed JAX tables, and a
    random K = 3 ensemble's equal JAX's at its default key."""
    f32 = t_io.load_ensemble(str(CKPT), device="cpu")
    mine = t_types.quantize_ensemble(f32, bits)
    committed = t_io.load_ensemble(str(quantized_path(bits)), device="cpu")
    for f in QUANTIZED_FIELDS:
        assert torch.equal(getattr(mine, f), getattr(committed, f)), f
    arrays, meta = random_packed_arrays(np.random.default_rng(bits),
                                        [4, 3, 2], 3, 7, k=3)
    tq = t_types.quantize_ensemble(torch_packed(arrays, meta), bits)
    jq = j_types.quantize_ensemble(jax_packed(arrays, meta), bits)
    for f in QUANTIZED_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tq, f)),
                                      np.asarray(getattr(jq, f)), f)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_transport_from_seed_equals_jax(bits):
    """The 4-party ``vfl-histogram-q{bits}`` transport with no draws input
    (its rounding keys from the seed alone): every round's forest build is
    the committed JAX 4-party build, trees and per-tree predictions bit for
    bit, and the noise it draws is the JAX noise."""
    z = np.load(QUANTIZED_P4)
    x, y = small_data()
    cfg = small_config()
    smask, _, steps = local_steps(x, y, cfg)
    np.testing.assert_array_equal(smask, z["smask"])
    bk = t_backend.get_backend(f"vfl-histogram-q{bits}", tree=cfg.tree,
                               num_parties=4)
    for r, (args, rdr) in enumerate(steps):
        want = {f: z[f"q{bits}_{f}_{r}"] for f in ("feature", "threshold",
                                                   "gain", "leaf_weight")}
        assert_same_build(bk.build_forest_per_tree(*args,
                                                   root_delta_rows=rdr),
                          SimpleNamespace(**want),
                          z[f"q{bits}_pred_{r}"])
    # every recorded JAX draw is the port's draw from ``transport_key``
    for name in z:
        if name.startswith(f"q{bits}_u_"):
            level, nodes, party, *shape = map(int, name.split("_")[2:])
            key = torch.tensor(t_compress.transport_key(0, level, nodes,
                                                        party))
            _bits_equal(prng.uniform(key, tuple(shape)), z[name])


def test_gradientless_party_masks_equal_jax():
    """Each gradient-less party fit draws from ``fold_in(rng, p)``: the
    masks equal the JAX scan engine's for that key."""
    cfg = t_boosting.dynamic_fedgbf_config(rounds=3)
    for p in range(3):
        key = prng.fold_in(prng.PRNGKey(0), p)
        masks = t_forest.draw_step_masks(cfg, 300, 4, key)
        smask, fmask = jax_step_masks(jax_config(cfg), 300, 4,
                                      key=jax.random.fold_in(
                                          jax.random.PRNGKey(0), p))
        np.testing.assert_array_equal(_np(masks.sample), smask)
        np.testing.assert_array_equal(_np(masks.feature), fmask)


def test_seeded_resume_equals_uninterrupted():
    """Rounds [0, 2) and then [2, 5) from the same key and the stored
    margins give the uninterrupted seeded run's ensemble byte for byte:
    the window replays the key chain."""
    ds = t_synthetic.load("default_credit_card", n=400)
    cfg = t_boosting.dynamic_fedgbf_config(rounds=5)
    kw = dict(backend="local-cuda", device="cpu")
    full, full_h = t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                           prng.PRNGKey(9), **kw)
    a, ha = t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                    prng.PRNGKey(9), stop_round=2, **kw)
    b, hb = t_boosting.train_fedgbf(ds.x_train, ds.y_train, cfg,
                                    prng.PRNGKey(9), start_round=2,
                                    init_margin=ha.final_margin, **kw)
    for fa, fb in zip(a.forests + b.forests, full.forests, strict=True):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    np.testing.assert_array_equal(hb.final_margin, full_h.final_margin)


def test_sampling_tokens_equal_jax():
    """The serving launcher's decode choices on the committed smoke logits:
    greedy ``argmax`` and, at temperature 0.7, the JAX key stream (one
    split a step, ``categorical`` of the logits over the temperature in
    their dtype), float32 and bfloat16 logits."""
    z = np.load(LOGITS)
    for arch in ("smollm-135m", "gemma2-2b", "rwkv6-7b"):
        logits = z[f"{arch}/logits"]                    # (B, S, V)
        for dt, tdt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
            jl = jnp.asarray(logits, dt)
            tl = torch.from_numpy(np.asarray(jl, np.float32)).to(tdt)
            np.testing.assert_array_equal(
                _np(torch.argmax(tl, dim=-1)), np.asarray(jnp.argmax(jl, -1)))
            jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
            for t in range(logits.shape[1]):
                jkey, jsub = jax.random.split(jkey)
                tkey, tsub = prng.split(tkey).unbind(0)
                want = jax.random.categorical(jsub, jl[:, t] / 0.7)
                got = prng.categorical(tsub, tl[:, t] / torch.tensor(
                    0.7, dtype=tdt))
                np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.cuda
def test_draws_on_card_equal_cpu():
    """On a card: every draw on CUDA tensors ``torch.equal`` to the same
    call on CPU tensors (``chip_smoke.py`` phase 3c at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    keys = prng.split(prng.PRNGKey(3), 3)
    for fn in (lambda k: prng.random_bits(k, (5000,)),
               lambda k: prng.uniform(k, (5000,)),
               lambda k: prng.permutation(k, 21000),
               lambda k: prng.normal(k, (5000,))):
        assert torch.equal(fn(keys.cuda()).cpu(), fn(keys))
