"""Synthetic LM data (the reference's ``training/data.py``, kept here so
the port imports nothing of it).

A deterministic, learnable sequence task: tokens follow a sparse
first-order Markov chain over a Zipf-weighted vocabulary (each token has a
small set of likely successors), so a model's training loss falls within a
few hundred steps and the quality evaluation has a trained model to
quantize. The same numpy calls in the same order as the reference's, so
both packages draw the same token arrays bit for bit.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMTask:
    def __init__(self, vocab_size: int, branching: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        # successor table: token → ``branching`` likely next tokens
        self.table = rng.integers(0, vocab_size, size=(vocab_size, branching))
        self.start_probs = self._zipf(vocab_size)
        self.branching = branching

    @staticmethod
    def _zipf(n, s=1.1):
        p = 1.0 / np.arange(1, n + 1) ** s
        return p / p.sum()

    def sample(self, batch: int, length: int, seed: int,
               noise: float = 0.1) -> np.ndarray:
        """(batch, length) int32 token rows: a Zipf start, then each token
        a random one of its successors, or with probability ``noise`` a
        uniform token."""
        rng = np.random.default_rng(seed)
        toks = np.empty((batch, length), np.int32)
        cur = rng.choice(self.vocab, size=batch, p=self.start_probs)
        toks[:, 0] = cur
        for t in range(1, length):
            nxt = self.table[cur, rng.integers(0, self.branching, size=batch)]
            rand = rng.integers(0, self.vocab, size=batch)
            use_rand = rng.random(batch) < noise
            cur = np.where(use_rand, rand, nxt).astype(np.int32)
            toks[:, t] = cur
        return toks

    def batches(self, batch: int, length: int, n_steps: int, seed: int = 0):
        """``n_steps`` batches {"tokens": (B, length-1), "labels": the same
        rows shifted by one}, batch i drawn with seed ``seed + i``."""
        for i in range(n_steps):
            toks = self.sample(batch, length, seed=seed + i)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
