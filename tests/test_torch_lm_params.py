"""Port vs JAX package: the LM substrate's parameter trees on the CPU.

The ten full configs' parameter trees (paths in the JAX leaf order,
shapes, dtypes) must equal ``jax.eval_shape(init_params)`` exactly, with
no allocation on either side, and their counts the JAX
``count_params_analytic``; a smoke config's weights go numpy -> port ->
numpy unchanged; ``init_params(PRNGKey(0))`` draws the JAX package's
tree bit for bit.  (Kept apart from ``tests/test_torch_lm_model.py`` so
that neither file holds more than 30 tests: pytest-xdist queues the files
with the most tests first, and a larger file would push the suite's
longest file behind another long one.)
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.models import model as t_model

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import jax_model_config, one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_tree_equals_jax(arch):
    """The full config's parameter tree (paths in leaf order, shapes and
    dtypes) equals ``jax.eval_shape(init_params)``; parameter counts equal
    ``count_params_analytic`` (MoE active counts too)."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    shapes = jax.eval_shape(lambda k: j_model.init_params(k, j_cfg),
                            jax.random.PRNGKey(0))
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             (tuple(leaf.shape), str(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = list(convert._flatten(convert.lm_param_shapes(cfg)))
    assert got == want
    total = sum(math.prod(s) for _, (s, _) in want)
    assert t_model.count_params_analytic(cfg) == total == cfg.flops_params()
    if cfg.moe is not None:                   # else active == total
        assert cfg.active_params() == j_model.count_params_analytic(
            j_cfg, active_only=True)
    else:
        assert cfg.active_params() == total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_params_round_trip(arch):
    """numpy tree -> port -> numpy tree is the identity, and the port's
    ``count_params`` is the JAX ``count_params`` of the same tree."""
    cfg = get_smoke_config(arch)
    tree = convert.lm_numpy_params(cfg, 1)
    model = convert.lm_params_from_numpy(cfg, tree, "cpu")
    back = convert.lm_params_to_numpy(model)
    a, b = list(convert._flatten(tree)), list(convert._flatten(back))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert model.count_params() == j_model.count_params(tree)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b",
                                  "mixtral-8x22b", "phi4-mini-3.8b",
                                  "pixtral-12b", "granite-20b"])
def test_lm_init_params_equal_jax(arch):
    """``init_params(PRNGKey(0), cfg)`` for the smoke config: every leaf of
    the JAX parameter tree bit for bit (float32 and bfloat16 viewed as
    integers), its dtype too (the other four architectures:
    ``test_torch_lm_train.py``)."""
    cfg = get_smoke_config(arch)
    want = dict(convert._flatten(jax.tree.map(np.asarray, j_model.init_params(
        jax.random.PRNGKey(0), jax_model_config(cfg)))))
    got = dict(convert._flatten(t_model.init_params(prng.PRNGKey(0), cfg)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert str(got[path].dtype).split(".")[-1] == w.dtype.name, path
        if w.dtype.name == "bfloat16":
            got_bits = got[path].view(torch.int16).numpy().view(np.uint16)
            want_bits = w.view(np.uint16)
        else:
            got_bits = got[path].numpy().view(np.uint32)
            want_bits = w.view(np.uint32)
        np.testing.assert_array_equal(got_bits, want_bits, str(path))
