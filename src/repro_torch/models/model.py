"""Model assembly: parameters, full-sequence forward (training), prefill and
decode (serving), loss — all driven by ModelConfig's unit pattern.

The port of ``repro/models/model.py``.  The JAX package stacks each pattern
position's parameters over the units and runs the depth as one
``lax.scan``; here ``LMModel.units[u][i]`` is the block at pattern position
``i`` of unit ``u`` and the depth is a Python loop.  Zamba2's weight-shared
attention block (the JAX ``lax.cond``) fires after unit ``u`` when
``(u + 1) % shared_attn_every == 0``.  ``cfg.remat`` checkpoints each unit
(``torch.utils.checkpoint``) while gradients are recorded.

``jax_leaves`` names every parameter by its path in the JAX parameter tree
(``("units", i, "attn", "wq")``, stacked over the units), in the JAX
package's leaf order: ``convert.lm_params_{from,to}_numpy`` and the
checkpoint files go through it.  ``init_params(key, cfg)`` draws that tree
as the JAX ``init_params`` does, key for key (``core/prng.py``: the same
bits), on the key's device; ``LMModel(cfg, device, key)`` loads it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig


def init_params(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """The JAX ``init_params``: the parameter tree (nested dicts, a list
    over the pattern positions, each leaf stacked over the units) drawn
    from ``key`` on its device."""
    keys = prng.split(key, 8)
    params: dict = {"embed": layers.init_embed(keys[0], cfg)}
    unit_keys = prng.split(keys[1], len(cfg.pattern))
    # jax.vmap over the units' keys: one batched draw a leaf
    params["units"] = [
        blocks.init_block(prng.split(unit_keys[i], cfg.num_units), bt, cfg)
        for i, bt in enumerate(cfg.pattern)]
    params["final_norm"] = layers.init_norm(cfg, cfg.d_model, key)
    if cfg.shared_attn_every > 0:
        params["shared"] = blocks.init_shared_attn(keys[2], cfg)
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": blocks.init_block(
                prng.split(keys[3], cfg.encoder.num_layers), "enc_attn",
                cfg),
            "final_norm": layers.init_norm(cfg, cfg.d_model, key),
        }
    return params


class Encoder(nn.Module):
    """Whisper-style encoder: ``layers`` of ``enc_attn`` blocks and a
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            blocks.Block("enc_attn", cfg, device)
            for _ in range(cfg.encoder.num_layers))
        self.final_norm = layers.Norm(cfg, cfg.d_model, device)


def init_rule(name: str, shape: tuple, cfg: ModelConfig):
    """How the JAX package initialises a parameter leaf called ``name`` of
    (per-unit) ``shape``: ``(base, std)`` for ``base + std * N(0, 1)``.
    ``base`` is a float or a numpy array; ``std`` 0 marks a constant."""
    if name == "tokens":
        return 0.0, 0.02
    if name == "mu":                         # RWKV token-shift weights
        return 0.5, 0.0
    if len(shape) >= 2:                      # every matrix: 1/sqrt(fan-in)
        return 0.0, 1.0 / math.sqrt(shape[-2])
    if name == "u":
        return 0.0, 0.1
    if name == "A_log":
        return np.log(np.linspace(1.0, 16.0, shape[0])).astype(np.float32), 0.0
    if name in ("D", "ln_scale") or (name == "scale"
                                     and cfg.norm_type == "layer"):
        return 1.0, 0.0
    if name == "w0":
        return -1.0, 0.0
    if name in ("scale", "bias", "dt_bias", "norm", "ln_bias"):
        return 0.0, 0.0                      # rms scale is stored as 1 + scale
    raise ValueError(f"no init rule for parameter {name!r}")


def _jax_path(name: str) -> tuple[tuple, Optional[int]]:
    """A ``named_parameters`` name -> (JAX tree path, unit index or None)."""
    parts = name.split(".")
    if parts[0] == "units":
        return ("units", int(parts[2]), *parts[3:]), int(parts[1])
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "layers", *parts[3:]), int(parts[2])
    return tuple(parts), None


class LMModel(nn.Module):
    """The language model of ``cfg``.  Its parameters are the JAX
    ``init_params(key, cfg)`` tree (``key`` default ``PRNGKey(0)``), drawn
    on ``device``, except on the ``meta`` device, which allocates nothing
    (shapes only)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = layers.Embed(cfg, device)
        self.units = nn.ModuleList(
            nn.ModuleList(blocks.Block(bt, cfg, device) for bt in cfg.pattern)
            for _ in range(cfg.num_units))
        self.final_norm = layers.Norm(cfg, cfg.d_model, device)
        if cfg.shared_attn_every > 0:
            self.shared = blocks.SharedAttn(cfg, device)
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, device)
        device = torch.device(device or "cpu")
        if device.type != "meta":
            from repro_torch import convert   # convert imports this module
            key = prng.PRNGKey(0) if key is None else prng.as_key(key)
            convert.load_lm_tree(self, init_params(key.to(device), cfg))

    # -------------------------------------------------------------- JAX tree
    def jax_leaves(self) -> list[tuple[tuple, list[nn.Parameter]]]:
        """[(JAX path, [parameter per unit, or the one parameter])] in the
        JAX package's leaf order (dict keys sorted, lists in order)."""
        grouped: dict[tuple, list] = {}
        for name, p in self.named_parameters():
            path, unit = _jax_path(name)
            grouped.setdefault(path, []).append((unit, p))
        return [(path, [p for _, p in sorted(grouped[path],
                                             key=lambda up: up[0] or 0)])
                for path in sorted(grouped)]

    def count_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -------------------------------------------------------------- forward
    def _unit(self, u: int, x: torch.Tensor, aux: torch.Tensor,
              enc_out: Optional[torch.Tensor]):
        cfg = self.cfg
        for block in self.units[u]:
            x, a = blocks.block_forward(block, x, cfg, enc_out)
            aux = aux + a
        if cfg.shared_attn_every > 0 and (u + 1) % cfg.shared_attn_every == 0:
            x = blocks.shared_attn_forward(self.shared, x, cfg)
        return x, aux

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def _stack(self, x: torch.Tensor, enc_out: Optional[torch.Tensor] = None):
        """Run the unit stack. Returns (x, total_aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for u in range(self.cfg.num_units):
            if self._remat():
                x, aux = checkpoint(self._unit, u, x, aux, enc_out,
                                    use_reentrant=False)
            else:
                x, aux = self._unit(u, x, aux, enc_out)
        return x, aux

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper-style encoder over stubbed frame embeddings (B, F, D)."""
        cfg = self.cfg
        x = frames.to(layers.dtype_of(cfg.compute_dtype))
        x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model,
                                            x.device).to(x.dtype)

        def body(layer, x):
            return blocks.block_forward(layer, x, cfg)[0]

        for layer in self.encoder.layers:
            if self._remat():
                x = checkpoint(body, layer, x, use_reentrant=False)
            else:
                x = body(layer, x)
        return layers.apply_norm(self.encoder.final_norm, x, cfg)

    def forward(self, tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None):
        """Full-sequence forward -> (logits (B, S, vocab_padded), aux_loss)."""
        cfg = self.cfg
        x = layers.embed_tokens(self.embed, tokens, cfg)
        if cfg.frontend == "vision_stub" and patch_embeds is not None:
            # the first num_patches positions carry projected patch
            # embeddings (the ViT + projector is a stub)
            P = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, P:, :]], dim=1)
        enc_out = None
        if cfg.encoder is not None:
            if frames is None:
                raise ValueError("audio arch requires stub frames")
            enc_out = self.encode(frames)
        x, aux = self._stack(x, enc_out)
        x = layers.apply_norm(self.final_norm, x, cfg)
        return layers.lm_logits(self.embed, x, cfg), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross entropy (+ MoE aux). batch: tokens, labels[,
        stubs]."""
        logits, aux = self(batch["tokens"], patch_embeds=batch.get(
            "patch_embeds"), frames=batch.get("frames"))
        labels = batch["labels"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # -------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq_len: int) -> dict:
        """Decode cache: ``blocks[u][i]`` for every block, ``shared[u]`` for
        the shared block's application after unit u, ``cross[u]`` for the
        decoder's cross K/V."""
        cfg = self.cfg
        device = self.final_norm.scale.device
        cache: dict = {"blocks": [
            [blocks.init_block_cache(bt, cfg, batch, seq_len, device)
             for bt in cfg.pattern] for _ in range(cfg.num_units)]}
        if cfg.shared_attn_every > 0:
            cache["shared"] = [
                blocks.init_block_cache("attn", cfg, batch, seq_len, device)
                for _ in range(cfg.num_units)]
        if cfg.encoder is not None:
            shape = (batch, cfg.encoder.num_frames, cfg.n_heads, cfg.hd)
            dt = layers.dtype_of(cfg.compute_dtype)
            cache["cross"] = [
                {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
                for _ in range(cfg.num_units)]
        return cache

    @staticmethod
    def jax_cache_leaves(cache: dict) -> list[tuple[tuple, list]]:
        """[(JAX path, [tensor per unit])] of a decode cache, in the JAX
        package's leaf order: the layout of the JAX ``init_cache``, which
        stacks every leaf over the units (``("blocks", i, "k")`` for pattern
        position ``i``; ``("shared", "k")``; ``("cross", "k")``), as
        ``jax_leaves`` does for parameters."""
        grouped: dict[tuple, list] = {}
        for unit in cache["blocks"]:
            for i, block in enumerate(unit):
                for key, t in block.items():
                    grouped.setdefault(("blocks", i, key), []).append(t)
        for name in ("shared", "cross"):
            for block in cache.get(name, ()):
                for key, t in block.items():
                    grouped.setdefault((name, key), []).append(t)
        return [(path, grouped[path]) for path in sorted(grouped)]

    def fill_cross_cache(self, cache: dict, enc_out: torch.Tensor) -> dict:
        """Populate the per-decoder-layer cross K/V from encoder output."""
        if self.cfg.pattern != ("dec_attn",):
            raise ValueError("cross cache assumes a dec-only pattern")
        return dict(cache, cross=[
            blocks.make_cross_cache(unit[0], enc_out, self.cfg)
            for unit in self.units])

    def decode_step(self, cache: dict, token: torch.Tensor, pos: int):
        """One decode step at absolute position ``pos`` -> (logits (B, 1,
        vocab_padded), new cache).  Attention caches are written in place."""
        cfg = self.cfg
        x = layers.embed_tokens(self.embed, token, cfg, pos_offset=pos)
        new_blocks = []
        shared = list(cache.get("shared", ()))
        for u, unit in enumerate(self.units):
            caches = []
            for i, block in enumerate(unit):
                cc = cache["cross"][u] if block.block_type == "dec_attn" \
                    else None
                x, nc = blocks.block_decode(block, x, cache["blocks"][u][i],
                                            pos, cfg, cross_cache=cc)
                caches.append(nc)
            new_blocks.append(caches)
            if cfg.shared_attn_every > 0 and \
                    (u + 1) % cfg.shared_attn_every == 0:
                x, shared[u] = blocks.shared_attn_decode(self.shared, x,
                                                         shared[u], pos, cfg)
        new_cache = dict(cache, blocks=new_blocks)
        if cfg.shared_attn_every > 0:
            new_cache["shared"] = shared
        x = layers.apply_norm(self.final_norm, x, cfg)
        return layers.lm_logits(self.embed, x, cfg), new_cache

    def prefill(self, tokens: torch.Tensor, **stubs) -> torch.Tensor:
        """Full forward returning the last position's logits."""
        logits, _ = self(tokens, **stubs)
        return logits[:, -1:, :]


# ---------------------------------------------------------------------------
# Parameter accounting (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------
def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the port's parameter shapes (a ``meta`` model,
    no allocation); MoE active-only replaces expert params with the top_k
    fraction."""
    total = LMModel(cfg, device="meta").count_params()
    if active_only and cfg.moe is not None:
        moe_layers = sum(1 for bt in cfg.pattern if bt in blocks.MOE_TYPES)
        moe_layers *= cfg.num_units
        expert_params = cfg.moe.num_experts * 3 * cfg.d_model * cfg.d_ff
        active = cfg.moe.top_k * 3 * cfg.d_model * cfg.d_ff
        total -= moe_layers * (expert_params - active)
    return total
