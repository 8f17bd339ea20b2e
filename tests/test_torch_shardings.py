"""Port vs JAX package: the LM substrate's partition specs on the CPU.

Parameter, train-state, batch and cache specs of the port's
``launch/shardings.py`` against the JAX package's on
``jax.sharding.AbstractMesh`` (no devices) for all ten full configs on the
(16, 16), (2, 16, 16) and (4, 2) meshes, exactly; and the activation specs
the port's ``models/partition.py`` sites record over one forward per block
family against those the JAX sites build (JAX's recorded by stubbing its
mesh lookup and ``with_sharding_constraint`` in the test; nothing under
``src/repro/`` changes).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as j_get_config
from repro.launch import shapes as j_shapes
from repro.launch import shardings as j_shardings
from repro.models import model as j_model
from repro.models import partition as j_partition
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import shardings
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import partition
from repro_torch.models.model import LMModel

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import jax_model_config, one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")))


def meshes():
    """(JAX abstract mesh, the port's) for each of MESHES."""
    for shape, names in MESHES:
        yield (JaxAbstractMesh(shape, names),
               AbstractMesh(dict(zip(names, shape))))


def jax_specs(tree) -> list:
    """The specs of a tree of NamedShardings, in leaf order."""
    return [tuple(s.spec) for s in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    """Every parameter leaf's spec, in the JAX leaf order, on all three
    meshes."""
    for j_mesh, mesh in meshes():
        want = jax_specs(j_shardings.param_shardings(j_get_config(arch),
                                                     j_mesh))
        got = list(shardings.param_shardings(get_config(arch),
                                             mesh).values())
        assert got == want, (arch, mesh)


def test_train_state_specs_equal_jax():
    """params, then the AdamW step (replicated), m and v (mirroring the
    params), for all ten configs on all three meshes."""
    for arch in ARCH_IDS:
        for j_mesh, mesh in meshes():
            want = jax_specs(j_shardings.train_state_shardings(
                j_get_config(arch), j_mesh))
            state = shardings.train_state_shardings(get_config(arch), mesh)
            got = (list(state["params"].values()) + [state["opt"]["step"]]
                   + list(state["opt"]["m"].values())
                   + list(state["opt"]["v"].values()))
            assert got == want, (arch, mesh)


def test_batch_specs_equal_jax():
    for j_mesh, mesh in meshes():
        for batch in (1, 32, 128, 256, None):
            for ndim in (2, 3):
                want = tuple(j_shardings.batch_spec(j_mesh, ndim,
                                                    batch).spec)
                assert shardings.batch_spec(mesh, ndim, batch) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_leaves_and_specs_equal_jax(arch):
    """The cache in the JAX layout (paths, stacked shapes, dtypes) equals
    ``jax.eval_shape(init_cache)``, and its specs JAX's, at decode_32k and
    long_500k on all three meshes."""
    for shape_name in ("decode_32k", "long_500k"):
        spec = j_shapes.SHAPES[shape_name]
        shapes = jax.eval_shape(lambda: j_model.init_cache(
            j_get_config(arch), spec.global_batch, spec.seq_len))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        want = [(tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path), tuple(leaf.shape), str(leaf.dtype))
                for path, leaf in flat]
        got = [(path, shape, str(dtype).split(".")[-1])
               for path, shape, dtype in shardings.cache_leaves(
                   get_config(arch), spec.global_batch, spec.seq_len)]
        assert got == want
        for j_mesh, mesh in meshes():
            want_specs = [tuple(j_shardings.cache_spec(p, leaf, j_mesh).spec)
                          for p, leaf in flat]
            got_specs = list(shardings.cache_shardings(
                get_config(arch), mesh, spec.global_batch,
                spec.seq_len).values())
            assert got_specs == want_specs, (shape_name, mesh)


def test_placements_round_trip():
    """Spec -> ``torch.distributed.tensor`` placements -> spec, for every
    parameter and cache spec of two configs on all three meshes, and the
    placements name the sharded dims."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh({"pod": 2, "data": 16, "model": 16})
    assert shardings.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shardings.placements((), mesh) == (Replicate(),) * 3
    for _, mesh in meshes():
        for arch in ("mixtral-8x22b", "zamba2-7b"):
            cfg = get_config(arch)
            specs = list(shardings.param_shardings(cfg, mesh).values())
            specs += list(shardings.cache_shardings(cfg, mesh, 1,
                                                    524_288).values())
            for spec in specs:
                back = shardings.spec_from_placements(
                    shardings.placements(spec, mesh), mesh, len(spec))
                assert back == spec


# ---------------------------------------------------------------------------
# Activation specs: the partition sites over one forward
# ---------------------------------------------------------------------------
AXES = {"data": 4, "model": 2}
FAMILIES = {
    "dense": ("smollm-135m", {}),
    "local+softcap": ("gemma2-2b", {}),
    "mamba+shared": ("zamba2-7b", {"shared_attn_every": 1}),
    "rwkv": ("rwkv6-7b", {}),
    "moe-ragged": ("granite-moe-3b-a800m", {}),
    "moe-dense": ("granite-moe-3b-a800m", {"impl": "dense"}),
    "enc-dec": ("whisper-large-v3", {}),
}


def one_unit(arch: str, extra: dict):
    """The smoke config cut to one unit (one encoder layer), in f32."""
    cfg = get_smoke_config(arch)
    kw = {"num_layers": len(cfg.pattern), "compute_dtype": "float32"}
    if "shared_attn_every" in extra:
        kw["shared_attn_every"] = extra["shared_attn_every"]
    if "impl" in extra:
        kw["moe"] = dataclasses.replace(cfg.moe, impl=extra["impl"])
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=1)
    return dataclasses.replace(cfg, **kw)


def jax_records(cfg, batch: int, seq: int, monkeypatch) -> list:
    """(shape, spec) of every constraint the JAX forward places (traced
    abstractly, the unit scan unrolled)."""
    records = []

    def record(x, spec):
        records.append((tuple(x.shape), tuple(spec)))
        return x

    monkeypatch.setattr(j_partition, "_mesh_axes", lambda: dict(AXES))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    j_cfg = dataclasses.replace(jax_model_config(cfg), scan_unroll=True)
    params = jax.eval_shape(lambda k: j_model.init_params(k, j_cfg),
                            jax.random.PRNGKey(0))
    stubs = {}
    if cfg.encoder is not None:
        stubs["frames"] = jax.ShapeDtypeStruct(
            (batch, cfg.encoder.num_frames, cfg.d_model), jnp.float32)
    jax.eval_shape(lambda p, t, s: j_model.forward(p, t, j_cfg, **s), params,
                   jax.ShapeDtypeStruct((batch, seq), jnp.int32), stubs)
    return records


@pytest.mark.parametrize("family", list(FAMILIES))
def test_activation_specs_equal_jax(family, monkeypatch):
    """The port's sites, recording over a ``meta`` forward, build JAX's
    specs at JAX's sites, in order."""
    arch, extra = FAMILIES[family]
    cfg = one_unit(arch, extra)
    batch, seq = 8, 16
    model = LMModel(cfg, device="meta")
    tokens = torch.empty((batch, seq), dtype=torch.long, device="meta")
    stubs = {}
    if cfg.encoder is not None:
        stubs["frames"] = torch.empty(
            (batch, cfg.encoder.num_frames, cfg.d_model), device="meta")
    with torch.no_grad(), partition.recording(AXES) as rec:
        model(tokens, **stubs)
    got = [(shape, spec) for _, shape, spec in rec.records]
    want = jax_records(cfg, batch, seq, monkeypatch)
    assert got == want
    assert len(got) >= 5
    # outside the context every site is the identity and records nothing
    x = torch.zeros(8, 4, 6)
    assert partition.shard_ff(x) is x
