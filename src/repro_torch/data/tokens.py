"""Synthetic token pipeline for the LM substrate: a numpy-only copy of
the JAX package's ``repro/data/tokens.py``, so its batches are bit-equal.

Offline-friendly corpus: a character-level Zipfian Markov source with
long-range copy structure (so the loss actually decreases with context) —
enough signal for the ~100M-model end-to-end driver without external data.
Batches are host-generated numpy; the caller moves them to its device
(launch/train.py).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class MarkovZipfSource:
    """Order-1 Markov chain with Zipf marginals + periodic copy spans."""

    def __init__(self, vocab: int, seed: int = 0, copy_period: int = 64,
                 copy_len: int = 16):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        k = min(vocab, 512)  # dense transition over the frequent head
        base = 1.0 / (np.arange(1, k + 1) ** 1.1)
        self.head = k
        trans = rng.dirichlet(base * 50, size=k)
        self.trans_cum = np.cumsum(trans, axis=1)
        self.copy_period = copy_period
        self.copy_len = copy_len

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        state = int(rng.integers(0, self.head))
        for i in range(length):
            if self.copy_period and i % self.copy_period == 0 and i >= self.copy_len:
                # copy span: repeat a recent window (gives context signal)
                span = out[i - self.copy_len : i]
                end = min(i + self.copy_len, length)
                out[i:end] = span[: end - i]
                if end == length:
                    break
                state = int(out[end - 1]) % self.head
                continue
            u = rng.random()
            state = int(np.searchsorted(self.trans_cum[state], u))
            state = min(state, self.head - 1)
            out[i] = state
        return out


def batches(
    vocab: int,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    num_batches: int | None = None,
) -> Iterator[dict]:
    """Yields {tokens (B,S) int32, labels (B,S) int32} next-token pairs."""
    src = MarkovZipfSource(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    i = 0
    while num_batches is None or i < num_batches:
        seq = np.stack(
            [src.sample(rng, seq_len + 1) for _ in range(batch_size)]
        )
        yield {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        i += 1
