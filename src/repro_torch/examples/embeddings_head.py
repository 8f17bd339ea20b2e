"""A boosted-forest head on frozen LM embeddings, where the paper's
technique and the LM substrate compose: the port of
``examples/embeddings_head.py``.

Party A (the embedding provider) runs a frozen SmolLM-family model over
text and holds its mean-pooled hidden states; party B (the label holder)
has repayment labels.  FedGBF trains on the vertically joined table.  The
LM's weights are the JAX script's ``init_params(PRNGKey(0), cfg)`` and the
head's masks its ``PRNGKey(2)`` draws (``core/prng.py``); the embeddings
themselves sit within the LM's float tolerance of the JAX script's.

    PYTHONPATH=src python -m repro_torch.examples.embeddings_head \
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import boosting, metrics, prng
from repro_torch.core.types import TreeConfig
from repro_torch.data import tokens as tokens_mod
from repro_torch.device import resolve
from repro_torch.models import layers
from repro_torch.models.model import LMModel


def main(device="cuda", n: int = 2000, seq: int = 32,
         rounds: int = 10) -> dict:
    """Returns the test classification report; raises if its AUC is not
    above 0.7 (the JAX script's check)."""
    device = resolve(device)
    rng = np.random.default_rng(0)

    # --- party A: a frozen LM producing sequence embeddings
    cfg = get_smoke_config("smollm-135m")
    model = LMModel(cfg, device, prng.PRNGKey(0))
    src = tokens_mod.MarkovZipfSource(cfg.vocab, seed=1)
    toks = np.stack([src.sample(rng, seq) for _ in range(n)])

    @torch.no_grad()
    def embed(tokens):
        x = layers.embed_tokens(model.embed, tokens, cfg)
        x, _ = model._stack(x)
        return x.float().mean(dim=1)       # (B, D) mean-pooled

    feats = torch.cat([
        embed(torch.from_numpy(toks[i:i + 256]).long().to(device))
        for i in range(0, n, 256)]).cpu().numpy().astype(np.float32)
    print(f"party A produced {feats.shape} LM embedding features")

    # ground truth: default risk is a noisy nonlinear function of the text
    # through a fixed direction in embedding space (unknown to both)
    z = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    w_true = rng.normal(size=feats.shape[1])
    risk = z @ w_true / np.sqrt(len(w_true)) + 0.3 * np.abs(z[:, 0])
    risk += rng.normal(0, 0.3, n)
    labels = (risk > np.quantile(risk, 0.75)).astype(np.float32)

    # --- party B: labels; the FedGBF head on the vertical join
    k = int(0.7 * n)
    cfg_fg = boosting.dynamic_fedgbf_config(
        rounds=rounds, tree=TreeConfig(max_depth=3, num_bins=16))
    head, _ = boosting.train_fedgbf(feats[:k], labels[:k], cfg_fg,
                                    prng.PRNGKey(2), backend="local-cuda",
                                    device=device)
    x_test = torch.from_numpy(feats[k:]).to(device)
    rep = metrics.classification_report(
        torch.from_numpy(labels[k:]).to(device),
        boosting.predict(head, x_test, impl="fused-cuda"))
    print(f"FedGBF on LM embeddings: test auc={rep['auc']:.4f} "
          f"acc={rep['acc']:.4f} f1={rep['f1']:.4f}")
    if not rep["auc"] > 0.7:
        raise AssertionError("the embedding head should beat chance "
                             f"comfortably: auc {rep['auc']:.4f}")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
