"""Port vs JAX package: vertically federated training on the CPU.

The port runs the parties as column blocks of one process
(``repro_torch.federation``); every party's histogram goes through the
histogram kernel's wrapper (its plain version here).  Held here:

* the lossless names (``vfl-histogram``, ``-async``, ``vfl-argmax``,
  ``-topk``) build the trees, leaves and final margins of the port's
  ``local`` run, bit for bit, and every round's forest build equals the
  JAX ``local`` one on the same inputs, bit for bit, at 2 and 4 parties,
  K = 1 and 3, subtraction on and off, shared root on (the JAX federation
  selftest holds the JAX ``vfl-*`` runs equal to JAX ``local``);
* ``pack_bits`` / ``unpack_bits`` bit-equal to the JAX functions;
* ``vfl-histogram-q8`` / ``-q16`` given the JAX rounding draws build the
  JAX quantized forests: at 1 party in process, at 4 parties against the
  committed ``vfl_quantized_p4.npz`` (a 4-party run needs 4 JAX devices);
* the refusals, and the launcher's ``--parties`` / ``--engine`` path.

The wire-byte ledger is held in ``tests/test_torch_protocol.py``.

The quantized builds are compared round by round, on the inputs of the
port's ``local`` run: end to end the inputs drift an ulp apart (ROADMAP
§3).  Regenerate the committed npz (uses JAX with 8 forced host devices,
in a subprocess; about half a minute): the masks, and per bit width every
round's JAX trees and per-tree predictions and every rounding draw.

    PYTHONPATH=src python tests/test_torch_federation.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forest as j_forest
from repro.federation import aggregator as j_aggregator
from repro_torch.convert import masks_from_numpy
from repro_torch.core import backend as t_backend
from repro_torch.core import boosting as t_boosting
from repro_torch.core import prng
from repro_torch.core.types import TreeConfig as TTreeConfig
from repro_torch.data import synthetic as t_synthetic
from repro_torch.federation import aggregator as t_aggregator
from repro_torch.federation import chaos as t_chaos
from repro_torch.federation import compress as t_compress
from repro_torch.federation import mesh_roles, vfl
from repro_torch.launch import train_fedgbf as t_launch
from torch_parity import jax_config, jax_step_masks

ROOT = Path(__file__).resolve().parents[1]
QUANTIZED_P4 = ROOT / "src" / "repro_torch" / "testdata" / \
    "vfl_quantized_p4.npz"
LOSSLESS = ("vfl-histogram", "vfl-histogram-async", "vfl-argmax",
            "vfl-argmax-topk")
TREE = TTreeConfig(max_depth=3, num_bins=16)
D = 8


def small_data(name="default_credit_card"):
    """(x, y) of a small training set: 420 rows, the first 8 columns."""
    ds = t_synthetic.load(name, n=600)
    return (np.ascontiguousarray(np.asarray(ds.x_train)[:, :D]),
            np.asarray(ds.y_train))


def small_config(**kw):
    kw.setdefault("tree", TREE)
    return t_boosting.dynamic_fedgbf_config(rounds=3, **kw)


def train_port(x, y, cfg, smask, fmask, backend):
    return t_boosting.train_fedgbf(
        x, y, cfg, masks=masks_from_numpy(smask, fmask, device="cpu"),
        backend=backend, device="cpu")


def assert_same_model(model, hist, want_model, want_margin):
    """Every tree array and the final margins equal, bit for bit."""
    assert len(model.forests) == len(want_model.forests)
    for tf, wf in zip(model.forests, want_model.forests):
        for f in ("feature", "threshold", "gain", "leaf_weight"):
            assert torch.equal(getattr(tf, f), getattr(wf, f)), f
    np.testing.assert_array_equal(hist.final_margin, want_margin)


CASES = {
    "k1-sub-p4": dict(parties=4),
    "k1-nosub-p2": dict(parties=2, tree=dataclasses.replace(
        TREE, hist_subtraction=False)),
    "k3-sub-p2": dict(parties=2, loss="softmax3", data="credit_risk_tiers"),
    "shared-root-p4": dict(parties=4, shared_root=True),
}


class Recording(t_backend.TreeBackend):
    """The ``local`` backend, keeping every round's forest-build inputs."""

    def __init__(self):
        super().__init__(t_backend.BackendDescriptor(impl="local"))
        object.__setattr__(self, "steps", [])

    def build_forest_per_tree(self, *args, root_delta_rows=0):
        self.steps.append((args, root_delta_rows))
        return super().build_forest_per_tree(
            *args, root_delta_rows=root_delta_rows)


def _jnp(v):
    return jnp.asarray(v.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_lossless_backends_equal_local_and_jax(case):
    """Each lossless vfl-* name: trees, leaves and final margins equal to
    the port's ``local`` run, bit for bit; and every round's forest build,
    given that round's inputs, equal to the JAX ``local`` forest build's
    trees and per-tree predictions, bit for bit.  (End to end, the port's
    ``local`` run is held against the JAX run by ``test_torch_train.py``:
    ROADMAP §3, margins an ulp apart where XLA contracts the update
    differently; at K = 3 on this data that ulp flips a near-tie in round
    3, so the JAX side is compared round by round.)"""
    spec = dict(CASES[case])
    parties = spec.pop("parties")
    x, y = small_data(spec.pop("data", "default_credit_card"))
    if spec.pop("shared_root", False):
        # rho_id >= 0.5 so the shared-root delta path is taken
        cfg = t_boosting.FedGBFConfig(
            rounds=3, n_trees_max=3, n_trees_min=2, rho_id_min=0.6,
            rho_id_max=0.8, tree=dataclasses.replace(TREE, shared_root=True))
        assert any(p[3] for p in t_boosting._plan_segments(cfg, x.shape[0]))
    else:
        cfg = small_config(**spec)
    smask, fmask = jax_step_masks(jax_config(cfg), *x.shape)
    local = Recording()
    lm, lh = train_port(x, y, cfg, smask, fmask, local)
    assert len(local.steps) == cfg.rounds
    backends = [t_backend.get_backend(name, tree=cfg.tree,
                                      num_parties=parties)
                for name in LOSSLESS]
    for bk in backends:
        assert bk.descriptor.is_federated
        assert bk.descriptor.num_parties == parties
        tm, th = train_port(x, y, cfg, smask, fmask, bk)
        assert_same_model(tm, th, lm, lh.final_margin)
    j_tree = jax_config(cfg).tree
    for args, rdr in local.steps:
        binned, g, h, sm, fm, _ = args
        jt, jp = j_forest.build_forest_per_tree(
            _jnp(binned), _jnp(g), _jnp(h), _jnp(sm), _jnp(fm), j_tree,
            root_delta_rows=rdr)
        for bk in backends:
            tt, tp = bk.build_forest_per_tree(*args, root_delta_rows=rdr)
            for f in ("feature", "threshold", "gain", "leaf_weight"):
                np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                              np.asarray(getattr(jt, f)), f)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("shape", [(1, 1), (3, 37), (2, 5, 64), (4, 8)])
def test_pack_bits_equal_jax(shape):
    """Bit-packed routing maps (little-endian within a byte), n a multiple
    of 8 or not: the JAX bytes, and the round trip."""
    rng = np.random.default_rng(sum(shape))
    bits = (rng.random(shape) < 0.5).astype(np.int32)
    got = t_aggregator.pack_bits(torch.from_numpy(bits))
    want = np.asarray(j_aggregator.pack_bits(jnp.asarray(bits)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_aggregator.unpack_bits(got, shape[-1])
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        j_aggregator.unpack_bits(jnp.asarray(want), shape[-1])))
    np.testing.assert_array_equal(back.numpy(), bits)


def jax_draws(seed=0, record=None):
    """The JAX quantized transport's rounding draws
    (``compress.py:401-408``) as a ``compress.Draws``; ``record`` (a dict)
    keeps every draw under its ``draw_key``."""

    def draws(level, num_nodes, party, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
        key = jax.random.fold_in(key, num_nodes)
        key = jax.random.fold_in(key, party)
        u = np.array(jax.random.uniform(key, shape))
        if record is not None:
            record[draw_key(level, num_nodes, party, shape)] = u
        return torch.from_numpy(u)

    return draws


def draw_key(level, num_nodes, party, shape) -> str:
    return "u_" + "_".join(str(v) for v in (level, num_nodes, party,
                                            *shape))


def local_steps(x, y, cfg):
    """(smask, fmask, the port ``local`` run's per-round forest-build
    inputs) with the JAX scan engine's masks."""
    smask, fmask = jax_step_masks(jax_config(cfg), *x.shape)
    local = Recording()
    train_port(x, y, cfg, smask, fmask, local)
    return smask, fmask, local.steps


def assert_same_build(got, trees, per_tree):
    tt, tp = got
    for f in ("feature", "threshold", "gain", "leaf_weight"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(trees, f)), f)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(per_tree))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_one_party_equals_jax(bits):
    """At 1 party (the JAX backend on a 1-device mesh, in process): given
    the JAX draws, round 1's quantized forest build (5 trees, levels 0-2,
    subtraction) is the JAX one, trees and per-tree predictions bit for
    bit; the 4-party test below takes every round."""
    from repro.compat import use_mesh
    from repro.core import backend as j_backend

    x, y = small_data()
    cfg = small_config()
    name = f"vfl-histogram-q{bits}"
    _, _, steps = local_steps(x, y, cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    j_tree = jax_config(cfg).tree
    jbk = j_backend.get_backend(name, mesh=mesh, tree=j_tree)
    tbk = t_backend.get_backend(name, tree=cfg.tree, num_parties=1,
                                draws=jax_draws())
    (args, rdr), = steps[:1]
    with use_mesh(mesh):
        jt, jp = jbk.build_forest_per_tree(
            *(_jnp(a) for a in args[:5]), j_tree, root_delta_rows=rdr)
    assert_same_build(tbk.build_forest_per_tree(
        *args, root_delta_rows=rdr), jt, jp)


@pytest.fixture(scope="module")
def quantized_p4():
    return np.load(QUANTIZED_P4)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_four_parties_equal_committed_jax(bits, quantized_p4):
    """At 4 parties, given the committed JAX draws: every round's forest
    build is the committed JAX build on the same inputs (the port ``local``
    run's), trees and per-tree predictions bit for bit; a whole quantized
    run trains to about the raw run's AUC."""
    z = quantized_p4
    x, y = small_data()
    cfg = small_config()
    smask, fmask, steps = local_steps(x, y, cfg)
    np.testing.assert_array_equal(smask, z["smask"])

    def draws(level, num_nodes, party, shape):
        return torch.from_numpy(
            z[f"q{bits}_" + draw_key(level, num_nodes, party, shape)])

    bk = t_backend.get_backend(f"vfl-histogram-q{bits}", tree=cfg.tree,
                               num_parties=4, draws=draws)
    for r, (args, rdr) in enumerate(steps):
        want = {f: z[f"q{bits}_{f}_{r}"] for f in ("feature", "threshold",
                                                   "gain", "leaf_weight")}
        assert_same_build(bk.build_forest_per_tree(*args,
                                                   root_delta_rows=rdr),
                          SimpleNamespace(**want), z[f"q{bits}_pred_{r}"])
    _, qh = train_port(x, y, cfg, smask, fmask, bk)
    _, rh = train_port(x, y, cfg, smask, fmask, "vfl-histogram")
    assert np.isfinite(qh.final_margin).all()
    assert abs(qh.train[-1]["auc"] - rh.train[-1]["auc"]) < 0.05


def test_native_draws_train_on_any_device_the_same():
    """The transport's rounding draws come from the JAX key chain
    ``fold_in(fold_in(fold_in(PRNGKey(seed), level), num_nodes), party)``:
    ``transport_key`` is JAX's key, its uniforms are the JAX draws (so the
    keys are the same on any device), other keys give other noise, and a
    quantized run repeats itself."""
    want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), 1), 2), 3)
    key = t_compress.transport_key(0, 1, 2, 3)
    assert key == tuple(int(v) for v in np.asarray(want))
    a = prng.uniform(torch.tensor(key), (2, 4))
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), jax_draws()(1, 2, 3, (2, 4)))
    assert key != t_compress.transport_key(0, 1, 2, 2)
    assert key != t_compress.transport_key(1, 1, 2, 3)
    x, y = small_data()
    cfg = small_config()
    smask, fmask = jax_step_masks(jax_config(cfg), *x.shape)
    runs = [train_port(x, y, cfg, smask, fmask, t_backend.get_backend(
        "vfl-histogram-async-q8", tree=cfg.tree, num_parties=4))
        for _ in range(2)]
    assert np.array_equal(runs[0][1].final_margin, runs[1][1].final_margin)


@pytest.mark.parametrize("k", [1, 2, 40])
def test_topk_choose_equals_centralized_with_ties(k):
    """The per-tree top-k chooser picks the centralized split, also when
    equal gains sit in different parties (a column copied into the next
    party): the lower party, as the centralized first maximum."""
    from repro_torch.core import histogram as t_hist
    from repro_torch.core import split as t_split

    rng = np.random.default_rng(k)
    n = 300
    binned = torch.from_numpy(rng.integers(0, 16, (n, D)).astype(np.int32))
    binned[:, 3] = binned[:, 1]           # party 1 repeats party 0's column
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.random(n).astype(np.float32))
    w = torch.ones(n)
    assign = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    hist = t_hist.compute_histogram(binned, g, h, w, assign, 2, 16)
    fmask = torch.ones(D, dtype=torch.bool)
    fmask[6] = False
    want = t_split.choose_splits(hist, fmask, TREE)
    got = t_compress.topk_choose_fn(TREE, k, 4)(hist, fmask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_party_layout_and_blocks():
    """Each party owns contiguous columns; a feature's owner is the party
    whose columns hold it; the federated table's blocks are views of those
    columns; an uneven split is refused."""
    layout = mesh_roles.PartyLayout(4, 8)
    assert mesh_roles.num_parties(layout) == 4
    assert [layout.columns(p) for p in range(4)] == [
        slice(2 * p, 2 * p + 2) for p in range(4)]
    assert layout.party_dims == (2, 2, 2, 2)
    assert [layout.party_index(f) for f in range(8)] == [0, 0, 1, 1, 2, 2,
                                                         3, 3]
    feature = torch.tensor([-1, 0, 1, 2, 3, 7])
    for p in range(4):
        owned, col = layout.local(feature, p)
        assert owned.tolist() == [f >= 0 and layout.party_index(f) == p
                                  for f in feature.tolist()]
        assert col[owned].tolist() == [f - 2 * p
                                       for f in feature[owned].tolist()]
    binned = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    table = mesh_roles.FederatedTable.of(binned, layout)
    assert table.table is binned
    blocks = table.blocks(0)
    assert len(blocks) == 4
    for p, block in enumerate(blocks):
        assert block.data_ptr() == binned[:, 2 * p:].data_ptr()
        assert torch.equal(block, binned[:, 2 * p:2 * p + 2])
    with pytest.raises(ValueError, match="pad"):
        mesh_roles.PartyLayout(3, 8)
    x, y = small_data()
    cfg = small_config()
    bk = vfl.make_vfl_backend(layout, cfg.tree)
    assert bk.descriptor.num_parties == 4
    t_boosting.train_fedgbf(x, y, cfg, backend=bk, device="cpu")
    with pytest.raises(ValueError, match="layout 8"):
        t_boosting.train_fedgbf(np.concatenate([x, x], axis=1), y, cfg,
                                backend=bk, device="cpu")


def test_refusals():
    """``chaos=`` on a name without ``-chaos``, row shards on a name
    without ``-sharded``, an uneven d, a differing tree config, a
    transport the aggregation cannot carry, and ``--engine loop``."""
    for name in ("vfl-histogram-sharded", "vfl-argmax-chaos",
                 "vfl-histogram-async-q8-sharded-chaos"):
        assert name in t_backend.available_backends()
        assert t_backend.get_backend(name, tree=TREE).name == name
    with pytest.raises(ValueError, match="non-chaos"):
        t_backend.get_backend("vfl-histogram-sharded", tree=TREE,
                              chaos=t_chaos.ChaosSpec())
    with pytest.raises(ValueError, match="-sharded backend"):
        t_backend.get_backend("vfl-argmax-chaos", tree=TREE, data_shards=2)
    x, y = small_data()
    cfg = small_config()
    with pytest.raises(ValueError, match="shard evenly"):
        t_boosting.train_fedgbf(x[:, :7], y, cfg, backend=t_backend
                                .get_backend("vfl-histogram", tree=TREE,
                                             num_parties=2), device="cpu")
    with pytest.raises(ValueError, match="built with"):
        t_boosting.train_fedgbf(x, y, cfg, backend=t_backend.get_backend(
            "vfl-argmax", tree=dataclasses.replace(TREE, max_depth=2)),
            device="cpu")
    with pytest.raises(ValueError, match="tree="):
        t_backend.get_backend("vfl-histogram")
    with pytest.raises(ValueError, match="encodes transport"):
        t_backend.get_backend("vfl-histogram-q8", tree=TREE,
                              transport=t_compress.Q16)
    with pytest.raises(ValueError, match="does not apply"):
        t_backend.get_backend("vfl-argmax", tree=TREE,
                              transport=t_compress.Q8)
    with pytest.raises(SystemExit, match="one training engine"):
        t_launch.main(["--engine", "loop", "--device", "cpu"])


def test_launcher_federated_prints_matching_ledger(capsys):
    """``--backend vfl-histogram --parties 4``: 23 features pad to 24, the
    JAX launcher's backend and ledger lines, ``match=True``; the model is
    the ``local`` backend's on the same padded columns."""
    argv = ["--rounds", "3", "--n", "2000", "--device", "cpu"]
    t_launch.main(argv + ["--backend", "vfl-histogram", "--parties", "4"])
    out = capsys.readouterr().out
    assert ("backend=vfl-histogram: 4 parties x 1 data shards, "
            "aggregation=histogram, transport=raw") in out
    assert "1400 x 24 rows" in out
    assert "paillier-model bytes (ledger)" in out
    assert "(match=True)" in out
    fed_test = [ln for ln in out.splitlines() if ln.startswith("TEST:")]
    t_launch.main(argv + ["--backend", "vfl-argmax-topk", "--parties", "3",
                          "--log-json"])
    out = capsys.readouterr().out
    assert "transport=topk" in out and "(match=True)" in out
    assert '"wire_bytes"' in out or "split_candidates" in out
    assert fed_test


def _regenerate() -> None:
    """Write ``vfl_quantized_p4.npz`` from JAX 4-party forest builds (in
    a subprocess with 8 forced host devices): the masks, and per bit width
    every round's trees and per-tree predictions on the port ``local``
    run's inputs, and every rounding draw the port asks for, keyed by
    (level, num_nodes, party, shape)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=8", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    subprocess.run([sys.executable, __file__, "--child"], env=env,
                   check=True)


def _regenerate_child() -> None:
    from repro.compat import use_mesh
    from repro.core import backend as j_backend
    from repro.launch import mesh as j_mesh

    x, y = small_data()
    cfg = small_config()
    smask, fmask, steps = local_steps(x, y, cfg)
    out = {"smask": smask, "fmask": fmask}
    mesh = j_mesh.make_vfl_mesh(4, 1)
    j_tree = jax_config(cfg).tree
    for bits in (8, 16):
        name = f"vfl-histogram-q{bits}"
        jbk = j_backend.get_backend(name, mesh=mesh, tree=j_tree)
        record: dict = {}
        tbk = t_backend.get_backend(name, tree=cfg.tree, num_parties=4,
                                    draws=jax_draws(record=record))
        for r, (args, rdr) in enumerate(steps):
            with use_mesh(mesh):
                jt, jp = jbk.build_forest_per_tree(
                    *(_jnp(a) for a in args[:5]), j_tree,
                    root_delta_rows=rdr)
            for f in ("feature", "threshold", "gain", "leaf_weight"):
                out[f"q{bits}_{f}_{r}"] = np.asarray(getattr(jt, f))
            out[f"q{bits}_pred_{r}"] = np.asarray(jp)
            tbk.build_forest_per_tree(*args, root_delta_rows=rdr)
        out.update({f"q{bits}_{k}": v for k, v in record.items()})
    np.savez_compressed(QUANTIZED_P4, **out)
    print(f"wrote {QUANTIZED_P4} ({len(out)} arrays)")


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _regenerate_child()
    else:
        _regenerate()
