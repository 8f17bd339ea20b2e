"""Port vs JAX package: LM serving on the CPU.

``launch.serve.generate`` (a teacher-forced prefill through the decode path,
then greedy decode) runs in both packages on the same numpy-drawn weights
and prompts in float32 compute: the generated tokens must be equal, and the
teacher-forced logits of the whole generated sequence within the stated
tolerance.  The launcher's CLI and its temperature sampling run too.
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

from repro.launch import serve as j_serve
from repro.models import model as j_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.launch import serve as t_serve

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from torch_parity import jax_model_config, one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PROMPT, GEN = 8, 8


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b",
                                  "whisper-large-v3"])
def test_greedy_generate_matches_jax(arch):
    """Greedy tokens equal; teacher-forced logits over the generated
    sequence measured within 2.7e-6 (whisper; logits up to 3.6), held at
    1e-4 as the model tests hold them."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    j_cfg = jax_model_config(cfg)
    tree = convert.lm_numpy_params(cfg, 7)
    tokens, stubs = chip_smoke.lm_case_inputs(cfg, PROMPT)
    j_params = jax.tree.map(jnp.asarray, tree)
    j_stubs = {k: jnp.asarray(v) for k, v in stubs.items()}
    j_out = np.asarray(j_serve.generate(j_params, j_cfg, jnp.asarray(tokens),
                                        GEN, stubs=j_stubs))

    model = convert.lm_params_from_numpy(cfg, tree, "cpu")
    t_stubs = {k: torch.from_numpy(v) for k, v in stubs.items()}
    out = t_serve.generate(model, torch.from_numpy(tokens).long(), GEN,
                           stubs=t_stubs)
    assert out.shape == (tokens.shape[0], PROMPT + GEN)
    np.testing.assert_array_equal(out.numpy(), j_out)

    j_logits, _ = jax.jit(lambda p, t, s: j_model.forward(p, t, j_cfg, **s))(
        j_params, jnp.asarray(j_out, jnp.int32), j_stubs)
    with torch.no_grad():
        logits, _ = model(out, **t_stubs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=1e-4)


def test_temperature_sampling_draws_from_the_generator():
    """Temperature decode draws from the given key's stream: the same key
    gives the same tokens, every token inside the vocabulary."""
    cfg = get_smoke_config("smollm-135m")
    model = convert.lm_params_from_numpy(cfg, convert.lm_numpy_params(cfg, 8),
                                         "cpu")
    prompts = torch.from_numpy(chip_smoke.lm_case_inputs(cfg, PROMPT)[0]).long()
    runs = [t_serve.generate(model, prompts, GEN, temperature=1.0,
                             key=prng.PRNGKey(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab
    assert torch.equal(runs[0][:, :PROMPT], prompts)


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3",
                                  "zamba2-7b", "rwkv6-7b"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --smoke``: the JAX
    launcher's lines."""
    t_serve.main(["--device", "cpu", "--smoke", "--arch", arch, "--batch",
                  "2", "--prompt-len", "16", "--gen", "8"])
    out = capsys.readouterr().out
    cfg = get_smoke_config(arch)
    assert f"arch={cfg.name} batch=2 steps=24 wall=" in out
    assert "sample token ids:" in out


def test_serve_launcher_refuses_the_cpu_unless_asked():
    """Without a card and without ``--device cpu`` the launcher raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--smoke"])
