"""Synthetic Criteo-like click batches (long-tail ids, seeded by step).

Port of ``repro.data.recsys`` (numpy only, copied): the same batches,
bit for bit.
"""
from __future__ import annotations

import numpy as np


class ClickStream:
    def __init__(self, vocab_sizes, batch: int, seed: int = 0):
        self.vocab_sizes = np.asarray(vocab_sizes, np.int64)
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        f = len(self.vocab_sizes)
        z = rng.zipf(1.2, size=(self.batch, f)) - 1
        idx = np.minimum(z, self.vocab_sizes[None, :] - 1).astype(np.int32)
        # a weakly learnable label from a hidden hash rule
        h = (idx * np.arange(1, f + 1)[None, :]).sum(-1)
        labels = ((h % 7) < 3).astype(np.float32)
        return {"idx": idx, "labels": labels}
