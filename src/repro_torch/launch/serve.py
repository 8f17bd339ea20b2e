"""Batched LM serving driver: the counterpart of ``repro/launch/serve.py``
— a teacher-forced prefill through the decode path (which fills every
cache), then greedy or temperature decode, over batched requests.

    # on the card (the default --device cuda): SmolLM-135M at full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --batch 4 --prompt-len 32 --gen 32

    # on the CPU, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch gemma2-2b --smoke --batch 4 --prompt-len 32 --gen 32

Weights are the JAX ``init_params(PRNGKey(0), cfg)`` (``core/prng.py``:
the same bits), drawn on the device; prompts (and whisper's stub frames)
come from ``np.random.default_rng(0)``, as the JAX launcher draws them.
Temperature sampling follows the JAX launcher's key stream: ``PRNGKey(0)``
split once a step, then ``categorical`` on the logits over the
temperature.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.models.model import LMModel


@torch.no_grad()
def generate(model: LMModel, prompts: torch.Tensor, gen_len: int,
             temperature: float = 0.0, stubs: Optional[dict] = None,
             key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """prompts: (B, P) integer ids -> (B, P + gen_len).  Sampling at
    ``temperature > 0`` splits ``key`` (default ``PRNGKey(0)``) once a step
    and draws ``categorical(sub, logits / temperature)``, the division in
    the logits' dtype, as the JAX launcher does."""
    cfg = model.cfg
    B, P = prompts.shape
    max_len = P + gen_len
    cache = model.init_cache(B, max_len)
    if cfg.encoder is not None:
        cache = model.fill_cross_cache(cache, model.encode(stubs["frames"]))
    key = prng.PRNGKey(0) if key is None else prng.as_key(key, "cpu")

    out = [prompts]
    # teacher-forced prefill through the decode path (fills every cache)
    for t in range(P):
        logits, cache = model.decode_step(cache, prompts[:, t:t + 1], t)
    tok = torch.argmax(logits[:, :, :cfg.vocab], dim=-1)
    for t in range(P, max_len):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok, t)
        if temperature > 0:
            # the key chain on the CPU (a split is ~150 tiny ops)
            key, sub = prng.split(key).unbind(0)
            scaled = logits[:, 0, :cfg.vocab] / torch.tensor(
                temperature, dtype=logits.dtype, device=logits.device)
            tok = prng.categorical(sub, scaled)[:, None]
        else:
            tok = torch.argmax(logits[:, :, :cfg.vocab], dim=-1)
    return torch.cat(out, dim=1)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (no silent CPU fallback)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    model = LMModel(cfg, device, prng.PRNGKey(0))
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    stubs = {}
    if cfg.frontend == "audio_stub":
        stubs["frames"] = torch.from_numpy(rng.normal(
            size=(args.batch, cfg.encoder.num_frames, cfg.d_model)
        ).astype(np.float32)).to(device)

    t0 = time.time()
    out = generate(model, prompts, args.gen, temperature=args.temperature,
                   stubs=stubs)
    first = out[0, :24].cpu().numpy()       # waits for the device
    dt = time.time() - t0
    total_steps = args.prompt_len + args.gen
    print(f"arch={cfg.name} batch={args.batch} "
          f"steps={total_steps} wall={dt:.1f}s "
          f"({args.batch * total_steps / dt:.1f} tok/s incl. first call)")
    print("sample token ids:", first)


if __name__ == "__main__":
    main()
