"""The comparison that decides ``correct`` refuses the control and every
fault a cell can have: whole runs driven on the CPU at a small size, with
the timed path broken underneath (``faults.py``), and the control (the
plain reference in bfloat16 in the program's place)."""

import contextlib
import copy

import pytest
import torch

from fedgbf_bench import bench, faults, spec

SPEC = spec.load()
SMALL = {"credit.train.local": 3000, "credit.train.vfl4": 3000,
         "gmsc.train.vfl10x16": 4096, "credit.serve.b8192": 3000}


def _env(cell, seed=21):
    w = spec.cell(SPEC, cell)
    config = copy.deepcopy(spec.config_data(SPEC, w["config"]))
    config["dataset"]["n"] = SMALL[cell]
    traffic = dict(spec.traffic(w["traffic"]))
    if traffic["kind"] == "train_jobs":
        config["model"]["rounds"] = min(config["model"]["rounds"], 6)
    else:
        traffic.update(stream_rows=4 * 8192, warm_batches=1, check_every=2)
    return bench.environment(SPEC, cell, seed, torch.device("cpu"), config,
                             traffic)


def _run(cell, plant=None):
    env = _env(cell)
    with plant() if plant else contextlib.nullcontext():
        return bench.execute(SPEC, env, 0.01, False, 0.0,
                             spec.limits(cell))


CASES = [(cell, name) for cell in SMALL for name in
         faults.applicable(spec.traffic(spec.cell(SPEC, cell)["traffic"]))]


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_refused(cell, fault):
    traffic = spec.traffic(spec.cell(SPEC, cell)["traffic"])
    r = _run(cell, faults.applicable(traffic)[fault])
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_refused(cell):
    env = _env(cell)
    drv = spec.driver(env.traffic["kind"])
    state = drv.setup(env)
    numbers = drv.control(env, state)
    limits = spec.limits(cell)
    assert any(numbers[k] is not None and numbers[k] > limits[k]
               for k in limits), numbers
