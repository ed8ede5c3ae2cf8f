"""Serving requests and synthetic prompts (the reference's numpy-only
``Request`` and ``make_prompts``, greedy requests only)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

WORKLOADS = ("text", "math", "code")


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus generation and accounting tags.
    Decoding is greedy (temperature 0)."""
    tokens: np.ndarray                   # (prompt_len,) int32
    max_new_tokens: int = 16
    workload: str = "text"
    arrival_s: float = 0.0
    eos_token_id: Optional[int] = None


def _zipf_probs(n: int, s: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def make_prompts(workload: str, vocab_size: int, batch: int, length: int,
                 seed: int = 0) -> np.ndarray:
    """(batch, length) int32 token ids for one workload: Zipf draws over a
    workload-specific third of the vocabulary (the reference's generator,
    so both packages see the same prompts for the same seed)."""
    if workload not in WORKLOADS:
        raise KeyError(f"unknown workload {workload!r}")
    wi = WORKLOADS.index(workload)
    rng = np.random.default_rng(seed + 1000 * wi)
    perm = np.random.default_rng(42).permutation(vocab_size)
    lo = wi * vocab_size // 3
    hi = (wi + 1) * vocab_size // 3
    slice_ids = perm[lo:hi]
    draws = rng.choice(len(slice_ids), size=(batch, length),
                       p=_zipf_probs(len(slice_ids)))
    return slice_ids[draws].astype(np.int32)
