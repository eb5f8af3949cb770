"""Synthetic LM data (no real corpora offline): order-2 Markov token
chains over the model vocab, deterministic in (seed, step).

A copy of the JAX package's ``LMDataset``: for the same seed it gives the
same numpy batches, so both packages train on identical tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class LMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse markov transition: each (prev) state prefers ~8 next tokens
        self._k = min(8, self.vocab_size)
        self._table = rng.integers(
            0, self.vocab_size, size=(min(self.vocab_size, 4096), self._k))

    def batch(self, batch_size: int, seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, seed))
        n = self._table.shape[0]
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch_size)
        for t in range(1, self.seq_len + 1):
            prev = toks[:, t - 1] % n
            choice = rng.integers(0, self._k, batch_size)
            nxt = self._table[prev, choice]
            noise = rng.random(batch_size) < 0.05
            nxt = np.where(noise, rng.integers(0, self.vocab_size, batch_size), nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
