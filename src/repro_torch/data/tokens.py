"""Deterministic synthetic LM token stream (seeded, resumable by step).

Port of ``repro.data.tokens`` (numpy only, copied): the same batches,
bit for bit.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Zipf-distributed token batches; batch for step i is a pure function
    of (seed, i) so restart-resume replays identically (fault tolerance)."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab, self.batch, self.seq_len, self.seed = (vocab, batch,
                                                           seq_len, seed)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
