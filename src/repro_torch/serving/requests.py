"""Serving requests and synthetic workloads (the port's copy of the
reference's numpy-only module).

The paper's Fig. 2 shows the hot expert set is disjoint across text / math /
code workloads. Each workload draws tokens Zipf-distributed over a
workload-specific slice of the vocabulary, so both packages see the same
prompts for the same seed. Two granularities:

* ``make_prompts`` / ``mixed_stream`` — fixed-shape token batches;
* ``Request`` / ``RequestStream`` — the serving engine's unit of work:
  variable-length prompts with arrival times, per-request sampling, QoS
  class and deadline, feeding ``InferenceEngine.submit`` / ``replay``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.sampler import SamplingParams

WORKLOADS = ("text", "math", "code")


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus generation and accounting tags.

    ``sampling``: per-request ``SamplingParams`` (temperature / top-k /
    top-p / seed). ``None`` means greedy. Validated at
    ``InferenceEngine.submit``.

    ``qos``: SLO tier (``serving.scheduler.QOS_CLASSES``); ``None``
    resolves to the engine's ``SchedulerConfig.qos_default`` at submit.
    ``deadline_ms``: optional per-request latency target (submit →
    finish) — drives SLO-attainment reporting, and expired *batch*-tier
    requests are dropped from the admission queue instead of served late.
    Both validated loudly at ``InferenceEngine.submit``."""
    tokens: np.ndarray                   # (prompt_len,) int32
    max_new_tokens: int = 16
    workload: str = "text"               # which traffic phase produced it
    arrival_s: float = 0.0               # offset from stream start
    eos_token_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    qos: Optional[str] = None            # batch | standard | premium
    deadline_ms: Optional[float] = None  # submit→finish SLO target


class RequestStream:
    """Request-level arrival process over shifting workload phases.

    ``phases``: sequence of ``(workload, n_requests)`` — the same shifting
    serving mix ``mixed_stream`` yields batch-wise, one ``Request`` at a
    time. Arrivals are Poisson at ``arrival_rate_rps`` (or back-to-back when
    ``None``), with optional extra per-arrival jitter uniform in
    ``[0, arrival_jitter_s]``; prompt lengths jitter uniformly within
    ``prompt_len ± prompt_len_jitter`` so continuous batching sees genuinely
    variable-length work.

    ``qos``: ``None`` (requests carry no class — the engine default
    applies), a fixed class name, or the string ``"workload"`` to map each
    request's workload tag through ``scheduler.WORKLOAD_QOS`` (code →
    premium, text → standard, math → batch). ``deadline_ms`` attaches the
    same submit→finish SLO target to every request.
    """

    def __init__(self, vocab_size: int,
                 phases: Sequence[Tuple[str, int]],
                 prompt_len: int = 32,
                 prompt_len_jitter: int = 0,
                 max_new_tokens: int = 8,
                 arrival_rate_rps: Optional[float] = None,
                 arrival_jitter_s: float = 0.0,
                 seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 qos: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        self.vocab_size = vocab_size
        self.phases = list(phases)
        self.prompt_len = prompt_len
        self.prompt_len_jitter = prompt_len_jitter
        self.max_new_tokens = max_new_tokens
        self.arrival_rate_rps = arrival_rate_rps
        self.arrival_jitter_s = float(arrival_jitter_s)
        self.seed = seed
        # Per-request sampling params: every request in the stream carries
        # its own seed (base seed + request ordinal) so replaying the
        # stream is reproducible while rows stay decorrelated.
        self.sampling = sampling
        if qos is not None and qos != "workload":
            from repro_torch.serving.scheduler import resolve_qos
            resolve_qos(qos, qos)        # loud validation at construction
        self.qos = qos
        self.deadline_ms = deadline_ms

    def __len__(self) -> int:
        return sum(n for _, n in self.phases)

    def __iter__(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        now = 0.0
        ordinal = 0
        for pi, (workload, n_requests) in enumerate(self.phases):
            for j in range(n_requests):
                lo = max(1, self.prompt_len - self.prompt_len_jitter)
                hi = self.prompt_len + self.prompt_len_jitter
                length = int(rng.integers(lo, hi + 1))
                toks = make_prompts(workload, self.vocab_size, 1, length,
                                    seed=self.seed + 1009 * pi + j)[0]
                if self.arrival_rate_rps:
                    now += float(rng.exponential(1.0 / self.arrival_rate_rps))
                if self.arrival_jitter_s:
                    # Monotone jitter: arrivals stay in submit order so the
                    # replay loop never head-of-line blocks on timestamps.
                    now += float(rng.uniform(0.0, self.arrival_jitter_s))
                sampling = None
                if self.sampling is not None:
                    sampling = dataclasses.replace(
                        self.sampling, seed=self.sampling.seed + ordinal)
                if self.qos == "workload":
                    from repro_torch.serving.scheduler import WORKLOAD_QOS
                    qos = WORKLOAD_QOS[workload]
                else:
                    qos = self.qos
                yield Request(tokens=toks, max_new_tokens=self.max_new_tokens,
                              workload=workload, arrival_s=now,
                              sampling=sampling, qos=qos,
                              deadline_ms=self.deadline_ms)
                ordinal += 1


def _zipf_probs(n: int, s: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def make_prompts(workload: str, vocab_size: int, batch: int, length: int,
                 seed: int = 0) -> np.ndarray:
    """(batch, length) int32 token ids for one workload."""
    if workload not in WORKLOADS:
        raise KeyError(f"unknown workload {workload!r}")
    wi = WORKLOADS.index(workload)
    rng = np.random.default_rng(seed + 1000 * wi)
    # Each workload occupies a third of the vocab, shuffled so slices are not
    # trivially ordered; heavy-tailed within the slice.
    perm = np.random.default_rng(42).permutation(vocab_size)
    lo = wi * vocab_size // 3
    hi = (wi + 1) * vocab_size // 3
    slice_ids = perm[lo:hi]
    probs = _zipf_probs(len(slice_ids))
    draws = rng.choice(len(slice_ids), size=(batch, length), p=probs)
    return slice_ids[draws].astype(np.int32)


def mixed_stream(vocab_size: int, batch: int, length: int, phases,
                 seed: int = 0):
    """Yield (workload_name, prompts) per phase — the shifting serving mix."""
    for i, (workload, n_batches) in enumerate(phases):
        for j in range(n_batches):
            yield workload, make_prompts(workload, vocab_size, batch, length,
                                         seed=seed + 17 * i + j)
