"""SLO-tiered QoS scheduling: precision as a quality-of-service knob (the
port's copy of the reference's numpy-only module).

DynaExq treats precision as a budget-constrained runtime resource; this
module turns it into a per-request SERVICE level. Every request carries a
QoS class:

* ``premium`` — highest admission priority, decodes on the mixed-precision
  banks (hi tier + lo fallback) with speculative bursts when the engine's
  SpecDecoder is on, never shed, never downgraded, never preempted;
* ``standard`` — the default; mixed-precision decode, sheds to the lo tier
  only under explicit ``downgrade`` pressure policies;
* ``batch`` — throughput-tier work that decodes on the **all-lo banks**
  (``serving.lobanks.all_lo_banks``: every ``slot_owner`` set to -1, so no
  extra weights; the engine decodes it through a second captured graph),
  yields the queue to higher
  tiers, and is the first work preempted or shed under overload.

The pieces, each consumed by the engine:

* ``TieredQueue`` — drop-in replacement for the engine's admission
  ``deque``: three per-class FIFOs popped by **weighted aging** — effective
  priority = class weight + time-in-queue / ``aging_s`` — so premium work
  jumps the line while aged batch work still drains (no starvation).
* ``SchedulerConfig`` / ``Scheduler`` — policy knobs + the pure decision
  logic: QoS resolution/validation, decode-group planning (which rows run
  on which banks this step), overload detection from the uniform stats
  (queue depth, TPOT EMA, budget headroom), shed/downgrade decisions, and
  preemption victim selection.
* ``SlotSnapshot`` — the host-side state of a preempted request: the valid
  KV lanes (paged) or cache rows (dense), recurrent (mamba) row state, and
  the decode position. Preemption genuinely frees HBM (the ``KVLease``
  closes, blocks return to the pool); resume re-admits through the normal
  admission path, adopting prefix-trie hits where the preempted blocks
  survived and re-uploading only the lanes that did not.

Nothing here touches device state: the scheduler is pure host-side policy,
the engine owns every forward.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: Valid QoS classes, lowest to highest service level.
QOS_CLASSES = ("batch", "standard", "premium")

#: Aging weights: effective priority = weight + age/aging_s. A batch
#: request older than ``aging_s * (QOS_WEIGHT[premium] - QOS_WEIGHT[batch])``
#: seconds outranks a fresh premium one — bounded starvation by design.
QOS_WEIGHT = {"batch": 0.0, "standard": 1.0, "premium": 2.0}

#: Rank for preemption/shedding comparisons (higher = more protected).
QOS_RANK = {q: i for i, q in enumerate(QOS_CLASSES)}

#: Benchmark workload tags → QoS classes: interactive code assistance is
#: latency-critical, bulk math scoring is throughput work, text is the
#: default tier. Opt-in (``RequestStream(qos="workload")`` and the SLO
#: benchmark); requests without an explicit class resolve to
#: ``SchedulerConfig.qos_default``, never through this map.
WORKLOAD_QOS = {"text": "standard", "math": "batch", "code": "premium"}

SHED_POLICIES = ("none", "downgrade", "reject")


@dataclasses.dataclass
class SchedulerConfig:
    """Policy knobs for SLO-tiered serving. The defaults reproduce the
    untiered engine exactly for all-default-class traffic: one FIFO order,
    every row decoding on the mixed banks, no shedding, no preemption
    unless a higher class is actually blocked behind a lower one."""
    qos_default: str = "standard"    # class for requests that carry none
    aging_s: float = 5.0             # seconds of queue age per priority unit
    # Which classes ride speculative bursts when EngineConfig.spec_k > 0.
    # Batch-tier drafting against itself would verify lo-vs-lo — pointless.
    spec_tiers: Tuple[str, ...] = ("standard", "premium")
    # ---- load shedding ------------------------------------------------
    # "none": admit everything. "downgrade": under overload, standard and
    # batch EXECUTE on the all-lo banks (service degrades, nothing drops).
    # "reject": under overload, batch-class submissions are refused
    # (RequestState.SHED) and standard-class ones are downgraded — premium
    # is never touched.
    shed_policy: str = "none"
    shed_queue_depth: int = 8        # queued requests that mean "overload"
    shed_wait_s: float = 2.0         # est. queue wait that means "overload"
    # HBM headroom fraction below which the engine counts as overloaded —
    # byte pressure on the shared envelope (KV blocks + expert hi tier) is
    # an overload signal even with an empty queue: admitting more work
    # would stall on block reclaim / defer every promotion. 0 disables.
    shed_headroom_frac: float = 0.05
    # Queued batch-tier requests whose deadline already passed are dropped
    # at admission time (state SHED) instead of burning decode steps.
    drop_expired_batch: bool = True
    # Residency build-out fraction below which the engine counts as
    # overloaded (streaming cold start: the ladder is still materializing,
    # so batch traffic sheds/downgrades instead of piling onto a queue the
    # engine cannot drain yet). 0 disables — a warm engine always reports
    # ready_frac 1.0, so the default changes nothing.
    shed_min_ready_frac: float = 0.0
    # ---- preemption ---------------------------------------------------
    preemption: bool = True          # evict lower tiers for blocked higher
    max_preempts: int = 2            # per-request eviction cap (liveness)
    # ---- chunked prefill ----------------------------------------------
    # Split prompts longer than this many tokens into chunk-sized suffix
    # prefills interleaved with decode steps (0 = off). Rounded DOWN to a
    # block-aligned bucket of the engine's existing ladder so chunk
    # prefills reuse the already-compiled bucket executables.
    prefill_chunk: int = 0

    def validate(self) -> None:
        if self.qos_default not in QOS_CLASSES:
            raise ValueError(
                f"qos_default={self.qos_default!r}; one of {QOS_CLASSES}")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={self.shed_policy!r}; one of {SHED_POLICIES}")
        for t in self.spec_tiers:
            if t not in QOS_CLASSES:
                raise ValueError(
                    f"spec_tiers entry {t!r}; one of {QOS_CLASSES}")
        if self.aging_s <= 0:
            raise ValueError("aging_s must be > 0")
        if not 0.0 <= self.shed_headroom_frac < 1.0:
            raise ValueError(
                f"shed_headroom_frac={self.shed_headroom_frac} must be in "
                f"[0, 1)")
        if not 0.0 <= self.shed_min_ready_frac <= 1.0:
            raise ValueError(
                f"shed_min_ready_frac={self.shed_min_ready_frac} must be "
                f"in [0, 1]")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")


def resolve_qos(qos: Optional[str], default: str) -> str:
    """Submit-time QoS resolution: ``None`` → the scheduler default;
    unknown classes fail loudly at the door, not mid-schedule."""
    q = default if qos is None else qos
    if q not in QOS_CLASSES:
        raise ValueError(f"unknown QoS class {q!r}; one of {QOS_CLASSES}")
    return q


class TieredQueue:
    """Priority admission queue with weighted aging.

    Deque-compatible where the engine needs it (``append`` / ``popleft`` /
    ``appendleft`` / ``extendleft`` / ``len`` / truthiness / iteration), but
    ``popleft`` returns the handle with the highest **effective priority**:
    its class weight plus its queue age in units of ``aging_s``. Within a
    class the order is strictly FIFO (each class is a real deque), so aging
    never reorders peers — it only decides *which class's head* goes next.

    Handles carry their own ``enqueue_s`` (set by the engine at submit and
    preserved across preempt/re-admit), so requeueing via ``appendleft`` /
    ``extendleft`` keeps original ages — a skipped or preempted request
    keeps climbing, it never resets to the back of the line.
    """

    def __init__(self, clock: Callable[[], float],
                 aging_s: float = 5.0):
        self._clock = clock
        self._aging_s = float(aging_s)
        self._tiers: Dict[str, deque] = {q: deque() for q in QOS_CLASSES}

    @staticmethod
    def _tier_of(handle) -> str:
        q = getattr(handle, "qos", None)
        return q if q in QOS_CLASSES else "standard"

    def append(self, handle) -> None:
        self._tiers[self._tier_of(handle)].append(handle)

    def appendleft(self, handle) -> None:
        self._tiers[self._tier_of(handle)].appendleft(handle)

    def extendleft(self, handles) -> None:
        for h in handles:
            self.appendleft(h)

    def _head_priority(self, q: str, now: float) -> Optional[float]:
        d = self._tiers[q]
        if not d:
            return None
        age = max(0.0, now - getattr(d[0], "enqueue_s", now))
        return QOS_WEIGHT[q] + age / self._aging_s

    def _best_tier(self) -> Optional[str]:
        now = self._clock()
        best, best_p = None, -np.inf
        # Iterate high→low so ties break toward the higher class.
        for q in reversed(QOS_CLASSES):
            p = self._head_priority(q, now)
            if p is not None and p > best_p:
                best, best_p = q, p
        return best

    def peek(self):
        """The handle ``popleft`` would return, without removing it."""
        q = self._best_tier()
        return self._tiers[q][0] if q is not None else None

    def popleft(self):
        q = self._best_tier()
        if q is None:
            raise IndexError("pop from an empty TieredQueue")
        return self._tiers[q].popleft()

    def prune(self, pred) -> List:
        """Remove and return every queued handle matching ``pred`` (used to
        drop expired batch-tier work without disturbing FIFO order)."""
        out: List = []
        for q, d in self._tiers.items():
            keep = deque()
            for h in d:
                (out if pred(h) else keep).append(h)
            self._tiers[q] = keep
        return out

    def depths(self) -> Dict[str, int]:
        """Per-QoS-class queue depth snapshot (metrics sampling)."""
        return {q: len(d) for q, d in self._tiers.items()}

    def __len__(self) -> int:
        return sum(len(d) for d in self._tiers.values())

    def __bool__(self) -> bool:
        return any(self._tiers.values())

    def __iter__(self):
        for q in reversed(QOS_CLASSES):
            yield from self._tiers[q]


@dataclasses.dataclass
class SlotSnapshot:
    """Host-side state of a preempted request — everything needed to resume
    bit-exactly without recompute. ``pos`` is the next decode position; the
    cached span is ``[span_start, pos)`` (full history for full attention,
    the last window for sliding-window rings).

    Paged mode stores per-position KV lanes (``attn_lanes[leaf]``:
    ``(1, n_span, nsb, Hkv, hd)`` — the `_gather_paged_lanes` layout);
    dense mode stores whole cache rows. Mamba rows are whole-state either
    way (recurrent state has no per-position structure)."""
    pos: int
    span_start: int
    attn_lanes: Optional[Dict[str, np.ndarray]] = None   # paged lanes
    attn_rows: Optional[Dict[str, np.ndarray]] = None    # dense rows
    mamba_rows: Optional[Dict[str, np.ndarray]] = None


class Scheduler:
    """Pure policy half of SLO-tiered serving (the engine owns all device
    state and every forward; this object only decides)."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.cfg.validate()

    # -- QoS resolution -------------------------------------------------
    def resolve(self, qos: Optional[str]) -> str:
        return resolve_qos(qos, self.cfg.qos_default)

    # -- decode-group planning -----------------------------------------
    def decode_groups(self, active, spec_on: bool):
        """Partition the active ``(slot, handle)`` rows into per-step
        dispatch groups: ``[(kind, rows), ...]`` with kind ∈
        {"spec", "mixed", "lo"}. Higher tiers dispatch first (their tokens
        emit earlier within the step). One group — the common case when
        every row shares a tier — is exactly the untiered engine."""
        spec_rows, mixed_rows, lo_rows = [], [], []
        for i, h in active:
            tier = getattr(h, "exec_qos", "standard")
            if tier == "batch":
                lo_rows.append((i, h))
            elif spec_on and tier in self.cfg.spec_tiers:
                spec_rows.append((i, h))
            else:
                mixed_rows.append((i, h))
        groups = []
        if spec_rows:
            groups.append(("spec", spec_rows))
        if mixed_rows:
            groups.append(("mixed", mixed_rows))
        if lo_rows:
            groups.append(("lo", lo_rows))
        return groups

    # -- overload / shedding --------------------------------------------
    def overloaded(self, load: Dict[str, float]) -> bool:
        """Overload = the uniform stats say queued work cannot clear in
        time — queue depth past the knob, or estimated queue wait (queued
        decode tokens at the measured TPOT, spread over the slots) past the
        wait knob — OR the shared HBM envelope is nearly exhausted
        (``budget_headroom_frac`` below the headroom knob): byte pressure
        sheds even with an empty queue, since the next admission would
        stall on reclaim and every promotion already defers."""
        if load.get("queue_depth", 0.0) > self.cfg.shed_queue_depth:
            return True
        if load.get("est_wait_s", 0.0) > self.cfg.shed_wait_s:
            return True
        if self.cfg.shed_min_ready_frac and \
                load.get("residency_ready_frac", 1.0) < \
                self.cfg.shed_min_ready_frac:
            return True    # cold start: the ladder is still materializing
        return (load.get("budget_headroom_frac", 1.0) <
                self.cfg.shed_headroom_frac)

    def admit_action(self, qos: str, load: Dict[str, float]) -> str:
        """Submit-time decision: "admit", "downgrade" (execute on the lo
        tier) or "shed" (refuse). Premium is never touched."""
        if self.cfg.shed_policy == "none" or qos == "premium" or \
                not self.overloaded(load):
            return "admit"
        if self.cfg.shed_policy == "downgrade":
            return "downgrade"
        return "shed" if qos == "batch" else "downgrade"

    # -- preemption -----------------------------------------------------
    def pick_victim(self, running, head_qos: str):
        """Choose the running ``(slot, handle)`` to evict for a blocked
        higher-class head: strictly lower class only, lowest class first,
        most remaining work first (evicting nearly-done work wastes the
        most compute), preempt-count capped for liveness. None = nobody
        preemptible."""
        if not self.cfg.preemption:
            return None
        best, key = None, None
        for i, h in running:
            if QOS_RANK[h.qos] >= QOS_RANK[head_qos]:
                continue
            if getattr(h, "preempts", 0) >= self.cfg.max_preempts:
                continue
            rem = h.request.max_new_tokens - len(h.tokens)
            k = (QOS_RANK[h.qos], -rem)
            if key is None or k < key:
                best, key = (i, h), k
        return best
