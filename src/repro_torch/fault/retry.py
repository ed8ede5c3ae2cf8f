"""Shared retry-with-exponential-backoff policy for transfer sites (the
port's copy of the reference's numpy-only module).

All four retrying sites (promotion copies, host hi/lo loads, lo staging,
streaming shard reads) share one `RetryPolicy`.  Backoff is *modeled* time —
`retry_call` never sleeps, it accumulates the backoff it *would* have waited
and returns it so callers can account it as stall seconds on the virtual
clock.  Jitter comes from the same counter-based Philox generator the
sampler uses, keyed by ``(seed, site, key, attempt)``, so a replayed run
retries with bit-identical delays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.fault.inject import (TransferFault, _counter_uniform,
                                      _site_stream)

_JITTER_OFFSET = 101  # separate the jitter stream from the decision stream


class RetryExhausted(RuntimeError):
    """A transfer failed on every allowed attempt (or blew its deadline).

    Callers degrade gracefully instead of crashing: promotions cancel and
    refund, staging quarantines, demand fetches fall back to host."""

    def __init__(self, site: str, attempts: int, waited_s: float):
        self.site = site
        self.attempts = attempts
        self.waited_s = waited_s
        super().__init__(f"transfer at {site} failed after {attempts} "
                         f"attempt(s), {waited_s:.4f}s modeled backoff")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with a cap and an optional total deadline."""
    max_attempts: int = 3
    base_s: float = 0.002
    cap_s: float = 0.1
    timeout_s: Optional[float] = None

    def delay_s(self, attempt: int, seed: int = 0, site: str = "",
                key: int = 0) -> float:
        """Modeled backoff before retry ``attempt`` (1-based), jittered to
        [0.5, 1.5)× the exponential schedule."""
        d = min(self.cap_s, self.base_s * (2.0 ** (attempt - 1)))
        j = _counter_uniform(seed, _site_stream(site) + _JITTER_OFFSET,
                             key, attempt)
        return d * (0.5 + j)


def retry_call(fn: Callable, policy: RetryPolicy, *, seed: int = 0,
               key: int = 0, site: str = "") -> Tuple[object, int, float]:
    """Run ``fn`` until it stops raising `TransferFault`.

    Returns ``(result, retries, backoff_s)`` where ``backoff_s`` is the total
    modeled backoff accumulated across retries.  Raises `RetryExhausted`
    (chained to the last fault) once ``max_attempts`` attempts failed or the
    modeled deadline is exceeded.  Non-`TransferFault` exceptions — including
    a nested `RetryExhausted` from an inner retried transfer — propagate
    unretried.
    """
    waited = 0.0
    attempt = 0
    while True:
        try:
            return fn(), attempt, waited
        except TransferFault as e:
            attempt += 1
            if attempt >= policy.max_attempts:
                raise RetryExhausted(site, attempt, waited) from e
            d = policy.delay_s(attempt, seed=seed, site=site, key=key)
            waited += d
            if policy.timeout_s is not None and waited > policy.timeout_s:
                raise RetryExhausted(site, attempt, waited) from e
