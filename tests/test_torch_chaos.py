"""Port vs JAX package: the chaos transport and secure aggregation on the
CPU.

* ``payload_checksum`` and ``_flip_one_bit`` equal the JAX functions on
  float32, int8, uint8, int16 and int32 payloads (uint32 wraparound
  arithmetic, reduced in int64 mod 2^32 in the port);
* ``plan_for_slot``, ``slot_details``, ``transmissions_for_slot`` and
  ``plan_summary`` equal JAX's (numpy streams, no threefry);
* every ``-chaos`` twin trains the trees of its fault-free twin, bit for
  bit, under injected faults;
* the measured ``retries`` bytes equal the port's ``wire_retry_bytes``
  and the JAX package's (pure arithmetic), and a run's own meter equals
  the plan replayed at the run's tree counts;
* ``secure.pairwise_masks`` equal JAX's from the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federation import chaos as j_chaos
from repro.federation import compress as j_compress
from repro.federation import protocol as j_protocol
from repro.federation import secure as j_secure
from repro_torch.core import backend as t_backend
from repro_torch.core import boosting as t_boosting
from repro_torch.core import dynamic as t_dynamic
from repro_torch.core.types import FedGBFConfig, TreeConfig
from repro_torch.federation import chaos as t_chaos
from repro_torch.federation import compress as t_compress
from repro_torch.federation import protocol as t_protocol
from repro_torch.federation import secure as t_secure

SPEC = dict(drop=0.10, corrupt=0.05, dup=0.05, delay=0.05, seed=7)
#: faults on every slot of a depth-3 histogram build
FAULTY = dict(drop=0.3, corrupt=0.2, dup=0.2, delay=0.1, seed=3)
TREE = TreeConfig(max_depth=3, num_bins=16)


def _payload(dtype, shape=(3, 5, 7), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.uint8, np.int16,
                                   np.int32])
def test_payload_checksum_equals_jax(dtype):
    """Random payloads, a zeroed one and a large one (past 2^32 in the
    unreduced sum): the JAX uint32 checksum, bit for bit."""
    for x in (_payload(dtype), np.zeros((4, 9), dtype),
              _payload(dtype, (64, 33, 31), seed=1)):
        got = int(t_chaos.payload_checksum(torch.from_numpy(x)))
        want = int(j_chaos.payload_checksum(jnp.asarray(x)))
        assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.uint8, np.int32])
def test_flip_one_bit_equals_jax(dtype):
    """The flipped payload's bytes equal JAX's, and the checksum sees the
    flip."""
    x = _payload(dtype, (2, 6))
    for rand in (0, 7, 8, 95, 12345, (1 << 30) - 1):
        got = t_chaos._flip_one_bit(torch.from_numpy(x), rand).numpy()
        want = np.asarray(j_chaos._flip_one_bit(jnp.asarray(x), rand))
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
        assert int(t_chaos.payload_checksum(torch.from_numpy(got))) != \
            int(t_chaos.payload_checksum(torch.from_numpy(x)))


@pytest.mark.parametrize("spec", [SPEC, dict(drop=0.4, corrupt=0.3, seed=3,
                                             max_retries=5), {}])
def test_plans_equal_jax(spec):
    """Slot plans, details and transmissions over 300 slots, and the
    summaries of one forest build's slots, equal the JAX package's."""
    t_spec, j_spec = t_chaos.ChaosSpec(**spec), j_chaos.ChaosSpec(**spec)
    assert t_spec.tag == j_spec.tag and t_spec.zero_fault == \
        j_spec.zero_fault
    for slot in range(300):
        plan = t_chaos.plan_for_slot(t_spec, slot)
        assert plan == j_chaos.plan_for_slot(j_spec, slot)
        assert t_chaos.slot_details(t_spec, slot, 4, len(plan[0])) == \
            j_chaos.slot_details(j_spec, slot, 4, len(plan[0]))
        assert t_chaos.transmissions_for_slot(t_spec, slot) == \
            j_chaos.transmissions_for_slot(j_spec, slot)
    for agg in ("histogram", "argmax"):
        n_slots = t_chaos.n_slots_per_tree(agg, 3)
        assert n_slots == j_chaos.n_slots_per_tree(agg, 3)
        assert t_chaos.plan_summary(t_spec, n_slots) == \
            j_chaos.plan_summary(j_spec, n_slots)
    with pytest.raises(ValueError, match="drop \\+ corrupt"):
        t_chaos.ChaosSpec(drop=0.6, corrupt=0.4)


def _data(n=300, d=8):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + x[:, 0] > 0).astype(np.float32)
    return x, y


CFG = FedGBFConfig(rounds=2, n_trees_max=3, n_trees_min=2, rho_id_min=0.5,
                   rho_id_max=0.8, tree=TREE)


def _train(name, meter=None, **kw):
    model, hist = t_boosting.train_fedgbf(
        *_data(), CFG, backend=t_backend.get_backend(
            name, tree=TREE, num_parties=4, meter=meter, **kw),
        device="cpu")
    return model, hist


@pytest.mark.parametrize("name", ["vfl-histogram", "vfl-histogram-async-q8",
                                  "vfl-argmax-topk"])
def test_chaos_twins_equal_fault_free(name):
    """Zero-fault and faulty ``-chaos`` twins: every tree array and the
    final margins equal the fault-free twin's, bit for bit."""
    base, base_h = _train(name)
    for kw in ({}, {"chaos": t_chaos.ChaosSpec(**FAULTY)}):
        model, hist = _train(name + "-chaos", **kw)
        assert model.forests and len(model.forests) == len(base.forests)
        for a, b in zip(model.forests, base.forests):
            for f in ("feature", "threshold", "gain", "leaf_weight"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        np.testing.assert_array_equal(hist.final_margin,
                                      base_h.final_margin)


@pytest.mark.parametrize("agg,transport", [
    ("histogram", None), ("histogram", "q8"), ("argmax", None),
    ("argmax", "topk")])
def test_retries_equal_wire_model_and_jax(agg, transport):
    """The dry probe's ``retries`` bytes == the port's wire model == the
    JAX package's, and the whole ledger reconciles; a run's own meter
    equals the plan replayed at each round's tree count, its fault counts
    ``plan_summary`` times the rounds."""
    t_tr = {None: None, "q8": t_compress.Q8, "topk": t_compress.TOPK}[
        transport]
    j_tr = {None: None, "q8": j_compress.Q8, "topk": j_compress.TOPK}[
        transport]
    spec = t_chaos.ChaosSpec(**FAULTY)
    ledger = t_compress.reconciled_ledger(
        4, TREE, CFG, aggregation=agg, transport=t_tr, n_samples=300,
        num_features=8, chaos=spec)
    rec = ledger.reconcile()
    assert ledger.matches(), rec
    per_tree = ledger.probe["per_tree"]["retries"]
    assert per_tree == t_protocol.wire_retry_bytes(
        spec, 2, TREE.num_bins, TREE.max_depth, agg, t_tr,
        TREE.hist_subtraction)
    assert per_tree == j_protocol.wire_retry_bytes(
        j_chaos.ChaosSpec(**FAULTY), 2, TREE.num_bins, TREE.max_depth, agg,
        j_tr, TREE.hist_subtraction)
    assert per_tree > 4 * t_chaos.n_slots_per_tree(agg, TREE.max_depth)

    meter = t_compress.MessageMeter()
    name = f"vfl-{agg}" + (f"-{transport}" if transport else "") + "-chaos"
    _train(name, meter=meter, chaos=spec)
    slots = t_protocol._chaos_slot_bytes(2, TREE.num_bins, TREE.max_depth,
                                         agg, t_tr, TREE.hist_subtraction)
    want = 0
    for m in range(1, CFG.rounds + 1):
        n_trees = t_dynamic.n_trees_schedule(CFG, m)
        for s, payload in enumerate(slots):
            tx = t_chaos.transmissions_for_slot(spec, s)
            want += tx * t_chaos.CHECKSUM_BYTES + (tx - 1) * n_trees * payload
    assert meter.phase_totals()["retries"] == want
    plan = t_chaos.plan_summary(spec, len(slots))
    assert meter.events == {k: CFG.rounds * plan[k] for k in (
        "dropped", "corrupted", "duplicated", "delayed", "retries")}


def test_secure_masks_equal_jax():
    """``pairwise_masks`` from the seed alone equal JAX's masks bit for
    bit (the PRF is the JAX package's ``normal`` draw); masking and
    aggregation equal JAX's and the masks cancel."""
    seed, parties, shape = 3, 4, (5, 6)
    got = t_secure.pairwise_masks(seed, parties, shape)
    want = np.asarray(j_secure.pairwise_masks(seed, parties, shape))
    np.testing.assert_array_equal(got.numpy(), want)
    values = np.random.default_rng(1).normal(
        size=(parties,) + shape).astype(np.float32)
    masked = t_secure.mask(torch.from_numpy(values), got)
    j_masked = j_secure.mask(jnp.asarray(values), jnp.asarray(want))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(j_masked))
    np.testing.assert_array_equal(
        t_secure.aggregate(masked).numpy(),
        np.asarray(j_secure.aggregate(j_masked)))
    np.testing.assert_allclose(t_secure.aggregate(masked).numpy(),
                               values.sum(0), atol=1e-5)
    assert got.shape == (parties,) + shape
    np.testing.assert_allclose(t_secure.aggregate(got).numpy(), 0.0,
                               atol=1e-6)
