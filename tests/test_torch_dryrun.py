"""Port vs JAX package: the dry-run on the CPU (``meta`` tensors).

Input shapes and caches against ``jax.eval_shape``; the counted FLOPs of a
forward against XLA's ``cost_analysis`` of the unrolled JAX forward (MoE:
with XLA's dense charge for ``ragged_dot`` accounted for); the activation
specs a counted step records against a forward's; the MoE count on
``meta`` against a real run's; the collective rule on a hand-worked
SmolLM-135M unit; the selftest and the report's keys.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import shapes as j_shapes
from repro.models import model as j_model
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import costmodel, dryrun, dryrun_selftest, shapes
from repro_torch.launch.mesh import AbstractMesh, make_test_mesh
from repro_torch.models import partition
from repro_torch.models.model import LMModel
from repro_torch.tools import roofline

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import jax_model_config, one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

#: counted (matmul) FLOPs of a forward vs XLA's count of the unrolled JAX
#: forward (smoke configs, 2 x 64, f32): XLA also counts elementwise work,
#: so the port's count is lower, by 0.80% (smollm), 1.03% (gemma2), 1.80%
#: (rwkv6) and 1.89% (zamba2) measured on the CPU; held at 2.5%
FLOPS_RTOL = 0.025


def test_shape_applicability_table():
    runs = {(a, s): shapes.applicable(a, s)[0]
            for a in ARCH_IDS for s in shapes.SHAPES}
    assert sum(runs.values()) == 34      # 10 x 4 minus 6 full-attention
    for arch in ARCH_IDS:
        assert runs[(arch, "long_500k")] == (arch in shapes.LONG_OK)
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert runs[(arch, s)]
        assert (shapes.applicable(arch, "long_500k")
                == j_shapes.applicable(arch, "long_500k"))
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_shapes.SHAPES.items()}


def _leaf(t) -> tuple:
    return tuple(t.shape), str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    """Every applicable shape's inputs (the decode cache in the JAX layout)
    equal ``jax.eval_shape``'s shapes and dtypes."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    for name in shapes.SHAPES:
        if not shapes.applicable(arch, name)[0]:
            continue
        got = shapes.input_specs(cfg, name)
        want = j_shapes.input_specs(j_cfg, name)
        assert sorted(got) == sorted(want)
        for key in got:
            if key == "cache":
                flat = jax.tree_util.tree_flatten_with_path(want[key])[0]
                w = [(tuple(getattr(k, "key", getattr(k, "idx", None))
                            for k in p), _leaf(leaf)) for p, leaf in flat]
                g = [(p, ((len(ts),) + tuple(ts[0].shape),
                          _leaf(ts[0])[1]))
                     for p, ts in LMModel.jax_cache_leaves(got[key])]
                assert g == w, (name, key)
            else:
                assert got[key].device.type == "meta"
                assert _leaf(got[key]) == _leaf(want[key]), (name, key)


def test_dryrun_selftest_passes(capsys):
    assert dryrun_selftest.main() == 0
    out = capsys.readouterr().out
    assert "DRYRUN SELFTEST PASSED" in out
    assert out.count("\nOK ") + out.startswith("OK ") == 18


def _forward_flops(cfg, batch: int, seq: int) -> float:
    model = LMModel(cfg, device="meta")
    stubs = {}
    if cfg.encoder is not None:
        stubs["frames"] = torch.empty(
            (batch, cfg.encoder.num_frames, cfg.d_model), device="meta")
    with torch.no_grad(), roofline.CostCounter() as counter:
        model(torch.empty((batch, seq), dtype=torch.long, device="meta"),
              **stubs)
    return counter.flops


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b", "rwkv6-7b",
                                  "zamba2-7b"])
def test_counted_flops_near_xla(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    j_cfg = dataclasses.replace(jax_model_config(cfg), scan_unroll=True)
    params = jax.eval_shape(lambda k: j_model.init_params(k, j_cfg),
                            jax.random.PRNGKey(0))
    compiled = jax.jit(lambda p, t: j_model.forward(p, t, j_cfg)).lower(
        params, jax.ShapeDtypeStruct((2, 64), jnp.int32)).compile()
    cost = compiled.cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)
                ["flops"])
    port = _forward_flops(cfg, 2, 64)
    assert 0 <= (xla - port) / xla <= FLOPS_RTOL, (xla, port)


#: XLA's CPU cost model charges ``ragged_dot`` (m, k) x (g, k, n) as if
#: every row met all g groups: 2*m*k*n*g plus 1.6% (measured at g = 8),
#: so XLA's count of an MoE forward is the port's plus (E - 1) times the
#: grouped products' hand count 3 * 2*T*K*D*F a layer; the rest differs by
#: 0.99% (granite-moe) and 0.56% (mixtral), held at ``FLOPS_RTOL``
RAGGED_CHARGE_RTOL = 0.025


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)
                 ["flops"])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_counted_flops_vs_xla(arch):
    m, k, n, g = 256, 64, 128, 8
    ragged = _xla_flops(jax.lax.ragged_dot,
                        jax.ShapeDtypeStruct((m, k), jnp.float32),
                        jax.ShapeDtypeStruct((g, k, n), jnp.float32),
                        jax.ShapeDtypeStruct((g,), jnp.int32))
    assert 0 <= ragged / (2 * m * k * n * g) - 1 <= RAGGED_CHARGE_RTOL
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    j_cfg = dataclasses.replace(jax_model_config(cfg), scan_unroll=True)
    params = jax.eval_shape(lambda key: j_model.init_params(key, j_cfg),
                            jax.random.PRNGKey(0))
    xla = _xla_flops(lambda p, t: j_model.forward(p, t, j_cfg), params,
                     jax.ShapeDtypeStruct((2, 64), jnp.int32))
    T, E, K = 2 * 64, cfg.moe.num_experts, cfg.moe.top_k
    grouped = sum(3 * 2 * T * K * p.shape[1] * p.shape[2]
                  for name, p in LMModel(cfg, device="meta").named_parameters()
                  if name.endswith("moe.w_gate"))
    port = _forward_flops(cfg, 2, 64)
    assert grouped > 0
    assert 0 <= (xla - port - (E - 1) * grouped) / xla <= FLOPS_RTOL, (
        xla, port, grouped)


def _spec_fits(shape, spec, axes) -> bool:
    for dim, entry in zip(shape, spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        if dim % math.prod(axes[a] for a in names):
            return False
    return len(shape) == len(spec)


FAMILIES = ["smollm-135m", "gemma2-2b", "zamba2-7b", "rwkv6-7b",
            "granite-moe-3b-a800m", "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILIES + ["granite-moe-3b-a800m@dense"])
def test_step_records_activation_specs(arch):
    """``count_step`` runs the step inside ``partition.recording``: the
    train step places exactly the specs a bare forward places at the same
    shape (held against JAX's in ``test_torch_shardings.py``), the remat
    recompute placing each unit's again; one decode step places specs too,
    each fitting its shape on the mesh."""
    arch, _, impl = arch.partition("@")
    cfg = get_smoke_config(arch)
    if impl:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    mesh = make_test_mesh(8)
    spec = shapes.ShapeSpec("t", "train", 32, 8)
    train = costmodel.count_step(cfg, spec, mesh)
    inputs = shapes.input_specs_for(cfg, spec)
    stubs = {k: v for k, v in inputs.items() if k not in ("tokens", "labels")}
    with torch.no_grad(), partition.recording(mesh.shape) as rec:
        LMModel(cfg, device="meta")(inputs["tokens"].long(), **stubs)
    forward = rec.summary()
    key = [(r["site"], r["shape"], r["spec"]) for r in forward]
    assert [(r["site"], r["shape"], r["spec"])
            for r in train["activation_specs"]] == key
    placed = sum(r["count"] for r in train["activation_specs"])
    once = sum(r["count"] for r in forward)
    assert once < placed <= 2 * once if cfg.remat else placed == once
    decode = costmodel.count_step(cfg, shapes.ShapeSpec("t", "decode", 32, 8),
                                  mesh)
    assert decode["activation_specs"]
    for r in train["activation_specs"] + decode["activation_specs"]:
        assert _spec_fits(r["shape"], r["spec"], mesh.shape), r
    for cost in (train, decode):
        assert cost["flops"] > 0 and cost["collective_bytes"] > 0


def test_moe_meta_count_equals_real_run():
    """Balanced groups on ``meta`` give a real run's FLOPs (the grouped
    products' FLOPs depend on the groups' sum only)."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              compute_dtype="float32")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    real = LMModel(cfg, "cpu")
    with torch.no_grad(), roofline.CostCounter() as counter:
        real(torch.from_numpy(tokens))
    assert _forward_flops(cfg, 2, 32) == counter.flops > 0


def test_collective_rule_hand_worked_smollm_unit():
    """One SmolLM-135M unit (d 576, 9/3 heads of 64, d_ff 1536, f32
    weights, bf16 activations) training on (16, 16) at 256 x 4096, worked
    by hand: every matrix is sharded over "data" (three gathers of its
    1/16 model shard, one reduce-scatter to its 1/256 shard); wo and w_down
    contract over "model" (two all-reduces of the 65,536 local rows x 576
    bf16)."""
    mesh = AbstractMesh({"data": 16, "model": 16})
    mats = {("attn", "wq"): (576, 576), ("attn", "wk"): (576, 192),
            ("attn", "wv"): (576, 192), ("attn", "wo"): (576, 576),
            ("ffn", "w_gate"): (576, 1536), ("ffn", "w_up"): (576, 1536),
            ("ffn", "w_down"): (1536, 576)}
    leaves = [roofline.LeafUse(("units", 0) + k, s, 4, 256 * 4096)
              for k, s in mats.items()]
    leaves += [roofline.LeafUse(("units", 0, n, "scale"), (576,), 4,
                                256 * 4096) for n in ("ln_attn", "ln_ffn")]
    stats = roofline.collective_stats(leaves, mesh, "train", 2)
    gather = 3 * (576 * 576 * 4 // 16 * 2 + 576 * 192 * 4 // 16 * 2
                  + 576 * 1536 * 4 // 16 * 3)
    scatter = (576 * 576 * 4 * 2 + 576 * 192 * 4 * 2
               + 576 * 1536 * 4 * 3) // 256
    reduce = 2 * 2 * (256 * 4096 // 16) * 576 * 2
    assert stats.bytes_by_kind == {"all-gather": gather,
                                   "reduce-scatter": scatter,
                                   "all-reduce": reduce}
    assert (gather, scatter, reduce) == (2_654_208, 55_296, 301_989_888)
    assert stats.count_by_kind == {"all-gather": 21, "reduce-scatter": 7,
                                   "all-reduce": 4}
    # a 1-wide mesh moves nothing
    one = AbstractMesh({"data": 1, "model": 1})
    assert roofline.collective_stats(leaves, one, "train", 2).total_bytes == 0


def test_report_has_jax_keys():
    report = dryrun.run_one("smollm-135m", "decode_32k", False, save=False)
    assert report["status"] == "ok"
    assert {"tag", "arch", "shape", "mesh", "chips", "memory", "roofline",
            "costing", "collectives_program", "activation_specs"} <= set(
                report)
    assert set(report["memory"]) == {
        "argument_bytes_per_device", "temp_bytes_per_device",
        "peak_bytes_per_device"}
    assert set(report["roofline"]) == {
        "flops", "hbm_bytes", "collective_bytes", "chips", "model_flops",
        "compute_s", "memory_s", "collective_s", "dominant",
        "useful_ratio"}
    assert set(report["collectives_program"]) == {"bytes_by_kind",
                                                  "count_by_kind"}
    assert report["chips"] == 256
    assert report["costing"] == "whole-program"
    assert report["activation_specs"]
    cfg = get_config("smollm-135m")
    # argument bytes: params over their shards, the cache over its shards,
    # the token (batch over data) and the position
    want = dryrun.build_step(cfg, shapes.SHAPES["decode_32k"],
                             AbstractMesh({"data": 16, "model": 16}))
    assert report["memory"]["argument_bytes_per_device"] == \
        want.argument_bytes() > 0
    skipped = dryrun.run_one("smollm-135m", "long_500k", True, save=False)
    assert skipped["status"] == "skipped"
    assert "full-attention" in skipped["reason"]
    assert math.isclose(report["roofline"]["model_flops"],
                        2 * cfg.active_params() * 128)
