"""Port vs JAX package: the LM substrate's models on the CPU.

Both packages run the same weights — ``convert.lm_numpy_params(cfg, 0)``,
a seeded numpy draw of the JAX parameter tree, loaded by the port through
``lm_params_from_numpy`` — on the same numpy inputs
(``chip_smoke.lm_case_inputs``), in float32 compute: every architecture's
smoke config over 16 positions, and mixtral's at window 8 over 24.  The
forward logits and aux loss, and the logits of token-by-token decode,
must agree within the tolerances stated beside each assertion.  The
port's chunked Mamba2/RWKV6 must match its per-token references, its
ragged MoE its dense dispatch.  (The parameter trees are held in
``tests/test_torch_lm_params.py``.)

``src/repro_torch/testdata/lm_smoke_logits.npz`` holds the JAX logits of
the same cases (the first ``chip_smoke.LM_COLS`` vocabulary columns):
``chip_smoke.py`` holds the port on the card against it, and a test here
holds it current.  Regenerate it (uses JAX; about 20 s on a CPU):

    PYTHONPATH=src python tests/test_torch_lm_model.py
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as j_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as t_moe, ssm as t_ssm

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the LM smoke cases and their inputs)
from torch_parity import jax_model_config, one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CASES = {key: (cfg, seq) for key, cfg, seq in chip_smoke.lm_smoke_cases()}
# logit tolerance, ``chip_smoke.lm_smoke_atol``: 1e-4, measured on the CPU
# (f32, port vs JAX) up to 7.8e-6 forward and 6.4e-6 decode (zamba2;
# logits up to 4.9), torch's and XLA's reductions and einsum orders
# differing in the last bits; RWKV 5e-4, measured 1.8e-4 forward and
# 9.2e-5 decode (logits up to 4.2), since its chunked WKV amplifies them
# (JAX's own chunked forward and per-token decode differ by 7.2e-5)
_JAX: dict = {}


def jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def jax_case(key: str) -> dict:
    """The JAX package's forward logits and aux and its decode logits of a
    case (computed once per test process, jitted)."""
    if key not in _JAX:
        cfg, seq = CASES[key]
        j_cfg = jax_model_config(cfg)
        params = jax_params(convert.lm_numpy_params(cfg,
                                                    chip_smoke.LM_WEIGHT_SEED))
        tokens, stubs = chip_smoke.lm_case_inputs(cfg, seq)
        stubs = {k: jnp.asarray(v) for k, v in stubs.items()}
        fwd = jax.jit(lambda p, t, s: j_model.forward(p, t, j_cfg, **s))
        logits, aux = fwd(params, jnp.asarray(tokens), stubs)
        cache = j_model.init_cache(j_cfg, tokens.shape[0], seq)
        if j_cfg.encoder is not None:
            enc = jax.jit(lambda p, f: j_model.encode(p, f, j_cfg))
            cache = j_model.fill_cross_cache(
                params, cache, enc(params, stubs["frames"]), j_cfg)
        step = jax.jit(lambda p, c, t, pos: j_model.decode_step(
            p, c, t, pos, j_cfg))
        decode = []
        for t in range(seq):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
            decode.append(np.asarray(lg[:, 0]))
        _JAX[key] = {"logits": np.asarray(logits), "aux": np.float32(aux),
                     "decode": np.stack(decode, axis=1)}
    return _JAX[key]


def port_case(key: str):
    """(model on the CPU, torch tokens, torch stubs) of a case."""
    cfg, seq = CASES[key]
    model = convert.lm_params_from_numpy(
        cfg, convert.lm_numpy_params(cfg, chip_smoke.LM_WEIGHT_SEED), "cpu")
    tokens, stubs = chip_smoke.lm_case_inputs(cfg, seq)
    return (model, torch.from_numpy(tokens).long(),
            {k: torch.from_numpy(v) for k, v in stubs.items()})


@torch.no_grad()
def port_decode(model, tokens, stubs) -> torch.Tensor:
    B, S = tokens.shape
    cache = model.init_cache(B, S)
    if model.cfg.encoder is not None:
        cache = model.fill_cross_cache(cache, model.encode(stubs["frames"]))
    out = []
    for t in range(S):
        lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("key", list(CASES))
def test_forward_matches_jax(key):
    """Forward logits (B, S, vocab_padded) and the MoE aux loss."""
    want = jax_case(key)
    model, tokens, stubs = port_case(key)
    with torch.no_grad():
        logits, aux = model(tokens, **stubs)
    assert logits.shape == want["logits"].shape
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=0,
                               atol=chip_smoke.lm_smoke_atol(model.cfg))
    # aux: measured 1.7e-7 relative (1-2 ulp; granite-moe, mixtral); zero
    # elsewhere
    np.testing.assert_allclose(float(aux), want["aux"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("key", list(CASES))
def test_decode_matches_jax(key):
    """Token-by-token decode through the caches (ring buffers, Mamba/RWKV
    states, zamba2's shared-block caches, whisper's cross K/V) against the
    JAX decode; and, but for pixtral (whose stub patches only the forward
    sees), against the port's own forward within the JAX test's 1e-3."""
    want = jax_case(key)
    model, tokens, stubs = port_case(key)
    got = port_decode(model, tokens, stubs)
    np.testing.assert_allclose(got.numpy(), want["decode"], rtol=0,
                               atol=chip_smoke.lm_smoke_atol(model.cfg))
    if model.cfg.frontend != "vision_stub":
        with torch.no_grad():
            full, _ = model(tokens, **stubs)
        assert float((got - full).abs().max()) < 1e-3


def test_committed_logits_are_current():
    """The committed file is what JAX computes now, and the port matches
    it.  XLA's CPU results are deterministic; 1e-5 absorbs a vector-ISA
    change between machines."""
    data = np.load(chip_smoke.LM_LOGITS)
    assert sorted({k.split("/")[0] for k in data.files}) == sorted(CASES)
    cols = chip_smoke.LM_COLS
    for key in CASES:
        want = jax_case(key)
        np.testing.assert_allclose(data[f"{key}/logits"],
                                   want["logits"][..., :cols], atol=1e-5)
        np.testing.assert_allclose(data[f"{key}/decode"],
                                   want["decode"][..., :cols], atol=1e-5)
        np.testing.assert_allclose(data[f"{key}/aux"], want["aux"], atol=1e-7)


def test_bf16_forward_matches_jax():
    """The default compute dtype (bfloat16 activations, float32 params):
    smollm's smoke config.  Both round to bfloat16 at the same places, but
    XLA's bf16 matmuls and torch's accumulate differently.  Measured: max
    abs 0.0117 on logits up to 1.08 (bf16's ulp at 1-2 is 0.0078); held at
    0.05."""
    cfg = get_smoke_config("smollm-135m")
    assert cfg.compute_dtype == "bfloat16"
    tree = convert.lm_numpy_params(cfg, 0)
    tokens, _ = chip_smoke.lm_case_inputs(cfg, 16)
    j_logits, _ = jax.jit(lambda p, t: j_model.forward(
        p, t, jax_model_config(cfg)))(jax_params(tree), jnp.asarray(tokens))
    model = convert.lm_params_from_numpy(cfg, tree, "cpu")
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(j_logits.astype(jnp.float32)),
                               rtol=0, atol=0.05)


def test_mamba_chunked_matches_reference():
    """The port's chunked SSD against its per-token recurrence (the JAX
    test's inputs and tolerance; 64 positions, 4 chunks)."""
    cfg = get_smoke_config("zamba2-7b")
    p = convert.lm_params_from_numpy(cfg, convert.lm_numpy_params(cfg, 3),
                                     "cpu").units[0][0].mamba
    u = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32) * 0.5)
    with torch.no_grad():
        a = t_ssm.mamba_forward(p, u, cfg, cfg.d_model)
        b = t_ssm.mamba_reference(p, u, cfg, cfg.d_model)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_rwkv_chunked_matches_reference():
    """The port's chunked WKV-6 against its per-token recurrence."""
    cfg = get_smoke_config("rwkv6-7b")
    p = convert.lm_params_from_numpy(cfg, convert.lm_numpy_params(cfg, 4),
                                     "cpu").units[0][0].time
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32) * 0.5)
    with torch.no_grad():
        a = t_ssm.rwkv_forward(p, x, cfg, cfg.d_model)
        b = t_ssm.rwkv_reference(p, x, cfg, cfg.d_model)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_moe_dense_matches_ragged_at_ample_capacity():
    """Dense capacity dispatch == grouped dispatch when nothing overflows
    (the JAX test's inputs and tolerance), outputs and gradients."""
    base = get_smoke_config("granite-moe-3b-a800m")
    cfg_r = dataclasses.replace(base, compute_dtype="float32")
    cfg_d = dataclasses.replace(base, compute_dtype="float32", moe=dataclasses
                                .replace(base.moe, impl="dense",
                                         capacity_factor=8.0))
    p = convert.lm_params_from_numpy(cfg_r, convert.lm_numpy_params(cfg_r, 0),
                                     "cpu").units[0][0].moe
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, base.d_model)).astype(np.float32) * 0.3)
    outs = []
    for impl, cfg in (("ragged", cfg_r), ("dense", cfg_d)):
        p.zero_grad(set_to_none=True)
        out, aux = t_moe.moe_ffn_dispatch(p, x, cfg)
        (out.square().sum() + aux).backward()
        outs.append((out.detach(), aux.detach(),
                     [q.grad.clone() for q in p.parameters()]))
    (a, aux_a, ga), (b, aux_b, gb) = outs
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert float(aux_a) == pytest.approx(float(aux_b))
    for x_, y_ in zip(ga, gb):
        np.testing.assert_allclose(x_.numpy(), y_.numpy(), atol=1e-4)


def test_moe_dense_dispatch_drops_as_jax():
    """Past capacity: 1,024 tokens, top-2 of 4 experts at capacity factor
    0.25 (C = 256 slots an expert for 504-528 copies), so half the copies
    are dropped and 49% of the tokens lose both; output and aux equal the
    JAX ``moe_ffn_dense`` (measured max abs 4.5e-8, aux 1 ulp)."""
    from repro.models import moe as j_moe

    base = get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(base, compute_dtype="float32", moe=dataclasses
                              .replace(base.moe, impl="dense",
                                       capacity_factor=0.25))
    tree = convert.lm_numpy_params(cfg, 9)
    p = convert.lm_params_from_numpy(cfg, tree, "cpu").units[0][0].moe
    x = (np.random.default_rng(4).normal(size=(4, 256, base.d_model))
         * 0.3).astype(np.float32)
    with torch.no_grad():
        out, aux = t_moe.moe_ffn_dense(p, torch.from_numpy(x), cfg)
    j_p = jax.tree.map(lambda a: a[0], jax_params(tree["units"][0]["moe"]))
    j_cfg = jax_model_config(cfg)
    j_out, j_aux = jax.jit(lambda q, v: j_moe.moe_ffn_dense(q, v, j_cfg))(
        j_p, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6)
    assert float((out == 0).all(-1).float().mean()) > 0.3  # drops happen


def test_moe_routing_ties_prefer_lower_expert():
    """``lax.top_k`` semantics: equal router probabilities pick the lower
    expert index first."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = t_moe._top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(j_idx).tolist() == idx.tolist()


def test_remat_matches_plain_backward():
    """``cfg.remat`` (each unit under ``torch.utils.checkpoint``) changes
    no loss and no gradient."""
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                                  compute_dtype="float32", remat=remat)
        model = convert.lm_params_from_numpy(cfg, convert.lm_numpy_params(
            cfg, 2), "cpu")
        tokens, _ = chip_smoke.lm_case_inputs(cfg, 16)
        t = torch.from_numpy(tokens).long()
        loss, _ = model.loss({"tokens": t, "labels": t.roll(-1, 1)})
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _regenerate() -> None:
    arrays = {}
    cols = chip_smoke.LM_COLS
    for key in CASES:
        want = jax_case(key)
        arrays[f"{key}/logits"] = want["logits"][..., :cols]
        arrays[f"{key}/decode"] = want["decode"][..., :cols]
        arrays[f"{key}/aux"] = want["aux"]
    np.savez_compressed(chip_smoke.LM_LOGITS, **arrays)
    print(f"wrote {chip_smoke.LM_LOGITS} "
          f"({chip_smoke.LM_LOGITS.stat().st_size:,} bytes)")


if __name__ == "__main__":
    _regenerate()
