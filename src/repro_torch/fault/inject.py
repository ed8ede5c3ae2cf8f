"""Seeded, counter-based fault injection for transfer/IO boundaries (the
port's copy of the reference's numpy-only module: the same plan gives the
same schedule in both packages).

A `FaultPlan` is a seed plus an ordered list of `FaultRule`s.  Each rule
targets one injection *site* (a short string naming a transfer boundary) and
describes when it fires (probabilistically per arrival and/or on a fixed
cadence) and what it does:

========== ==================================================================
site       transfer boundary
========== ==================================================================
promo_copy ``TransitionManager._issue_copy`` — the H2D promotion copy
host_hi    ``HostExpertStore.ensure_hi`` — host-tier bf16 row load
host_lo    ``HostExpertStore._lo_rows`` — host-tier quantized row load
stage_lo   ``HostExpertStore.stage_lo[_batch]`` — host→device lo staging
shard_lo   ``ShardSource.lo_layer`` — streaming lo shard read (npz)
shard_hi   ``ShardSource.hi_expert`` — streaming hi shard read (npz)
ep_mig     ``EPCoordinator._migrate`` — expert-parallel ownership swap
host_fetch demand host fetch in ``_observe_residency`` (modeled stall path)
========== ==================================================================

========= ===================================================================
kind      effect at the site
========= ===================================================================
fail      the transfer raises `TransferFault` (retryable)
stall     the transfer succeeds but is slow: promotions stay in flight until
          the injected deadline passes; modeled-stall sites add ``stall_s``
corrupt   the payload lands but is bad — promotions are caught by the
          publish-time integrity check and cancelled; host/shard reads treat
          it as a failed checksum and retry; EP migrations abort mid-swap
========= ===================================================================

Determinism: the decision for the k-th arrival at a site is a pure Philox
counter function of ``(seed, site, k, rule)`` — no sequential RNG state, so
replays (including virtual-clock `engine.replay`) see bit-identical fault
schedules regardless of interleaving.  The harness never sleeps; stalls are
modeled seconds, compatible with the virtual clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

SITES = ("promo_copy", "host_hi", "host_lo", "stage_lo",
         "shard_lo", "shard_hi", "ep_mig", "host_fetch")
KINDS = ("fail", "stall", "corrupt")


class TransferFault(RuntimeError):
    """A transfer failed (injected or real, e.g. a corrupt shard on disk).

    Retryable: ``retry.retry_call`` catches exactly this type."""

    def __init__(self, site: str, kind: str = "fail", seq: int = -1,
                 detail: str = ""):
        self.site = site
        self.kind = kind
        self.seq = seq
        self.detail = detail
        msg = f"transfer fault at {site} (kind={kind}, seq={seq})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _counter_uniform(seed: int, stream: int, a: int, b: int = 0) -> float:
    # Mirrors serving.sampler.counter_uniform (kept local: core/ imports this
    # module, and importing the serving layer from here would be a cycle).
    bg = np.random.Philox(key=np.uint64(seed & (2**64 - 1)),
                          counter=[np.uint64(stream), np.uint64(a),
                                   np.uint64(b), np.uint64(0)])
    return float(np.random.Generator(bg).random())


def _site_stream(site: str) -> int:
    # Stable site → Philox stream word; offset past the sampler's streams 0-3.
    return 16 + (zlib.crc32(site.encode("utf-8")) & 0x7FFFFFFF)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One fault schedule entry.  Fires on the ``every``-th arrivals (0 =
    disabled) and/or with probability ``prob`` per arrival, starting at
    arrival ``start``, at most ``max_fires`` times (0 = unbounded)."""
    site: str
    kind: str = "fail"
    prob: float = 0.0
    every: int = 0
    start: int = 0
    max_fires: int = 0
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


@dataclasses.dataclass
class Fault:
    """A fired fault, handed to the site that asked."""
    site: str
    kind: str
    seq: int            # arrival index at the site (0-based)
    stall_s: float
    rule: int           # index of the rule that fired


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed + ordered rules.  ``parse`` accepts a JSON string or a path to a
    JSON file: ``{"seed": 7, "rules": [{"site": "host_lo", "prob": 0.1}]}``."""
    seed: int = 0
    rules: Tuple[FaultRule, ...] = ()

    @staticmethod
    def parse(text: str, seed: Optional[int] = None) -> "FaultPlan":
        if os.path.exists(text):
            with open(text, "r", encoding="utf-8") as f:
                text = f.read()
        obj = json.loads(text)
        rules = tuple(FaultRule(**r) for r in obj.get("rules", ()))
        return FaultPlan(seed=int(obj.get("seed", 0) if seed is None else seed),
                         rules=rules)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "rules": [dataclasses.asdict(r) for r in self.rules],
        })

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Evaluates a `FaultPlan` at each site arrival.

    Sites call ``fire(site, **ctx)`` once per transfer attempt; a ``Fault``
    comes back when a rule fires (first matching rule wins), else ``None``.
    Holding ``injector = None`` and pointer-checking before the call keeps
    the disabled path at zero cost. ``ctx`` names the transfer (layer,
    expert, ...) in the ``fault_injected`` event a bound flight recorder
    (``tracer``) records; it does not change the decision.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.seed = plan.seed
        self._arrivals: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}        # rule index → times fired
        self.stats = {"injected": 0}
        self.tracer = None                      # bound by obs propagation

    def arrivals(self, site: str) -> int:
        return self._arrivals.get(site, 0)

    def fire(self, site: str, **ctx) -> Optional[Fault]:
        k = self._arrivals.get(site, 0)
        self._arrivals[site] = k + 1
        for ri, rule in enumerate(self.plan.rules):
            if rule.site != site or k < rule.start:
                continue
            if rule.max_fires and self._fires.get(ri, 0) >= rule.max_fires:
                continue
            hit = bool(rule.every) and (k - rule.start) % rule.every == 0
            if not hit and rule.prob > 0.0:
                hit = _counter_uniform(self.seed, _site_stream(site),
                                       k, ri) < rule.prob
            if not hit:
                continue
            self._fires[ri] = self._fires.get(ri, 0) + 1
            self.stats["injected"] += 1
            f = Fault(site=site, kind=rule.kind, seq=k,
                      stall_s=rule.stall_s, rule=ri)
            if self.tracer is not None:
                self.tracer.instant("fault_injected", cat="fault", site=site,
                                    kind=rule.kind, seq=k, **ctx)
            return f
        return None
