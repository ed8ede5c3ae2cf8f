"""Per-request sampling subsystem: parameters, masking, and a counter-based
PRNG that makes every request's output bit-reproducible.

The port's copy of the reference's numpy-only module. Sampling runs
HOST-side on the float32 logits the forward already returns: the captured
decode graph stays sampling-free (a greedy row ships only its device argmax)
and the randomness never depends on the device, the batch shape or the
library versions.

Determinism is the design center. Every random draw for a request is a pure
function of ``(seed, stream, a, b)`` through a counter-based Philox
bit-generator — there is NO sequential RNG state to advance. The draw that
picks a request's t-th token uses counter ``(STREAM_TOKEN, t, 0)``, so the
sampled output is bit-identical no matter which other requests share the
batch, in what order admission happened, or whether the engine replayed the
stream twice (modulo MoE capacity drops, which are compute-batch-dependent —
the same caveat prefix sharing documents). Speculative decoding draws its
accept/residual/bonus uniforms from separate streams keyed by the request's
verify-round counter, so draft bursts never perturb the sequential stream.

``temperature == 0`` is exact greedy: no PRNG is consulted and the token is
``argmax(logits)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# PRNG stream ids (the first counter word). One stream per independent use
# so no uniform is ever consumed by two different decisions.
STREAM_TOKEN = 0      # sequential sampling: (t, 0) = t-th emitted token
STREAM_ACCEPT = 1     # spec decode: accept test (round, j)
STREAM_RESIDUAL = 2   # spec decode: rejected-position resample (round, j)
STREAM_BONUS = 3      # spec decode: bonus token after full acceptance


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    ``temperature == 0`` ⇒ greedy (top_k/top_p ignored, no randomness).
    ``top_k``: keep only the k highest-probability tokens (None = all).
    ``top_p``: nucleus sampling — keep the smallest probability-sorted set
    whose cumulative mass reaches ``top_p`` (1.0 = all).
    ``seed``: the request's whole entropy source (see module docstring).
    """
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def validate(self) -> None:
        """Raise ``ValueError`` on malformed parameters. The engine calls
        this at ``submit()`` so a bad request fails loudly at the door, not
        deep inside a decode round."""
        t = self.temperature
        if not isinstance(t, (int, float)) or isinstance(t, bool) or \
                math.isnan(t) or math.isinf(t) or t < 0:
            raise ValueError(f"temperature must be a finite float >= 0, "
                             f"got {t!r}")
        if not (0.0 < self.top_p <= 1.0) or math.isnan(self.top_p):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p!r}")
        if self.top_k is not None and (not isinstance(self.top_k, int) or
                                       isinstance(self.top_k, bool) or
                                       self.top_k < 1):
            raise ValueError(f"top_k must be a positive int or None, "
                             f"got {self.top_k!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")


GREEDY = SamplingParams()


def counter_uniform(seed: int, stream: int, a: int, b: int = 0) -> float:
    """One uniform in [0, 1) as a pure function of ``(seed, stream, a, b)``.

    Philox is a counter-based generator: keying it with the seed and placing
    the coordinates in the counter words gives independent draws with no
    sequential state — any draw can be recomputed in isolation."""
    bg = np.random.Philox(key=np.uint64(seed & (2**64 - 1)),
                          counter=[np.uint64(stream), np.uint64(a),
                                   np.uint64(b), np.uint64(0)])
    return float(np.random.Generator(bg).random())


def sampling_probs(logits: np.ndarray, sp: SamplingParams) -> np.ndarray:
    """Masked, temperature-scaled probabilities over the vocab (f64, sums
    to 1). Order of operations: temperature → softmax → top-k mask → top-p
    mask → renormalize. Requires ``temperature > 0``."""
    if sp.temperature <= 0:
        raise ValueError("sampling_probs needs temperature > 0; greedy "
                         "decoding never builds a distribution")
    z = np.asarray(logits, np.float64) / sp.temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if sp.top_k is not None and sp.top_k < p.shape[-1]:
        kth = np.partition(p, -sp.top_k)[-sp.top_k]
        p = np.where(p >= kth, p, 0.0)
    if sp.top_p < 1.0:
        # Nucleus: probability-sorted prefix whose cumulative mass first
        # reaches top_p (the token that crosses the threshold is kept).
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        keep_sorted = np.zeros(p.shape[-1], bool)
        cutoff = int(np.searchsorted(csum, sp.top_p)) + 1
        keep_sorted[:cutoff] = True
        keep = np.zeros_like(keep_sorted)
        keep[order] = keep_sorted
        p = np.where(keep, p, 0.0)
    s = p.sum()
    if s <= 0:                                     # numerically empty mask
        p = np.zeros_like(p)
        p[int(np.argmax(logits))] = 1.0
        return p
    return p / s


def categorical(probs: np.ndarray, u: float) -> int:
    """Inverse-CDF draw: deterministic given (probs, u)."""
    csum = np.cumsum(probs)
    return int(min(np.searchsorted(csum, u * csum[-1], side="right"),
                   probs.shape[-1] - 1))


class RequestSampler:
    """One request's sampling state: the (validated) params plus the two
    counters that key its PRNG streams — the emitted-token index for
    sequential sampling and the speculative-round index for draft bursts.
    Both are derived from the request's own progress, never from batch
    composition, which is what makes outputs reproducible."""

    def __init__(self, sp: Optional[SamplingParams] = None):
        self.sp = sp if sp is not None else GREEDY
        self.spec_round = 0      # bumped once per draft/verify round

    @property
    def greedy(self) -> bool:
        return self.sp.greedy

    def uniform(self, stream: int, a: int, b: int = 0) -> float:
        return counter_uniform(self.sp.seed, stream, a, b)

    def next_token(self, logits: np.ndarray, index: int) -> int:
        """Sample the request's ``index``-th emitted token from one row of
        f32 logits. Greedy params take the exact argmax."""
        if self.sp.greedy:
            return int(np.argmax(logits))
        p = sampling_probs(logits, self.sp)
        return categorical(p, self.uniform(STREAM_TOKEN, index))

    def end_round(self) -> None:
        self.spec_round += 1
