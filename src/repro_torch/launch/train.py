"""End-to-end LM training driver: the counterpart of
``repro/launch/train.py``, with its flags and its printed lines.

    # on the card (the default --device cuda): SmolLM-135M at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 30 --batch 8 --seq 256

    # on the CPU, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch smollm-135m --smoke --steps 20 --batch 4 --seq 64

Weights are the JAX ``init_train_state(PRNGKey(0), cfg)``'s, bit for bit
(``core/prng.py``), drawn on the device; batches are ``MarkovZipfSource``'s,
bit-equal to the JAX launcher's.  ``--ckpt PATH`` saves the params in the
JAX package's ``save_pytree`` layout, so either package loads them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.data import tokens as tokens_mod
from repro_torch.device import resolve
from repro_torch.models import train as train_mod


def add_stubs(batch: dict, cfg, rng: np.random.Generator) -> dict:
    """The frontend stubs of the JAX launcher, drawn from ``rng``."""
    B = batch["tokens"].shape[0]
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors (tokens and labels as int64 indices)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (no silent CPU fallback)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``main`` does; returns ``{"state", "losses", "walls"}``:
    the train state, every step's ce and the host clock (seconds since the
    first step began) after each step, whose ce read waits for the
    device."""
    device = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.flops_params()/1e6:.1f}M")

    state = train_mod.init_train_state(prng.PRNGKey(0), cfg, device)
    step_fn = train_mod.make_train_step(
        cfg, peak_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
        total_steps=args.steps)

    rng = np.random.default_rng(0)
    stream = tokens_mod.batches(cfg.vocab, args.batch, args.seq,
                                num_batches=args.steps)
    t0 = time.time()
    losses, walls = [], []
    for step, raw in enumerate(stream, start=1):
        batch = to_device(add_stubs(dict(raw), cfg, rng), device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["ce"]))
        walls.append(time.time() - t0)
        if step % args.log_every == 0 or step == args.steps:
            dt = walls[-1] / step
            tok_s = args.batch * args.seq / dt
            print(f"step {step:5d} ce={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"{tok_s:,.0f} tok/s")
    print(f"first-10 mean ce={np.mean(losses[:10]):.4f} -> "
          f"last-10 mean ce={np.mean(losses[-10:]):.4f}")
    if args.ckpt:
        ckpt_io.save_lm_params(args.ckpt, state.model)
        print(f"saved params to {args.ckpt}")
    return {"state": state, "losses": losses, "walls": walls}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
