"""Non-blocking transition pipeline (paper §3.4) on CUDA streams.

* ``request_promotion/request_demotion`` enqueue candidates from the policy.
* ``drain()`` processes demotions first (reclaiming capacity), then admits
  promotions that pass the byte budget (``BudgetTracker.try_reserve``) and
  the per-window migration-rate limit, allocates a slot and issues the hi
  weight copy.
* Copies run from pinned host rows with ``non_blocking=True`` on a side
  CUDA stream, one ``torch.cuda.Event`` per pending promotion; a copy is
  complete when its event has (``event.query()``).
* ``publish_ready()`` publishes completed copies into the host maps and
  pushes the maps to the device arrays on the compute stream.
* ``cancel_stuck(now, deadline_s)`` (the watchdog's hook) cancels every
  promotion whose copy has not completed ``deadline_s`` after it was issued
  (``issue_ts`` on ``clock``, which the engine rebinds to its own): the
  slot frees, the reservation is refunded exactly once, and the expert
  keeps serving lo. The slot was never published, so no forward reads it;
  a later copy into it queues behind the stuck one on the side stream.
* Faults (``injector``, the ``promo_copy`` site of ``fault.inject``): a
  ``fail`` is retried under ``retry`` (modeled backoff, never slept); a
  copy whose attempts (or the host-side ``ensure_hi`` load under it) are
  exhausted is aborted — slot freed, reservation refunded once,
  ``fail_cb`` told — and the expert keeps serving lo. A ``stall`` holds
  publication until ``stall_until`` on ``clock``; a ``corrupt`` copy is
  cancelled at publication and never published. Both ride on the pending
  entry beside its event: nothing sleeps and nothing reads the device.

* Observability (``tracer``, ``publish_hist``; None by default, every hook
  a pointer check): a ``promotion`` async span opens when the copy is
  issued (layer, expert, slot, bytes) and closes where the port publishes,
  after the copy's event reported completion (``published=1``; the
  histogram observes ``clock() − issue_ts``), or at a cancellation
  (``published=0`` with its reason); ``promo_request``, ``demo_request``,
  ``promo_deferred``, ``demotion``, ``fault_cancel``, ``promo_timeout`` and
  the retries are instants, as the reference records them.

The forward never observes a partially written version: a slot is read only
through ``slot_owner``, which names it only after its copy's event
completed. Demotion adds a hazard immutable arrays never had: a freed slot
may still be read by a forward already queued on the compute stream, so
before the side stream writes a reused slot it waits on an event recorded
on the compute stream after that demotion was pushed to the device maps.
On the CPU copies are synchronous and complete at once.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.budget import BudgetTracker
from repro_torch.core.pools import SlotPool
from repro_torch.core.ver import (ExpertBankQ, Residency, publish, unpublish,
                                  write_hi_slot)
from repro_torch.fault.inject import TransferFault
from repro_torch.fault.retry import RetryExhausted, RetryPolicy, retry_call


@dataclasses.dataclass
class PendingPromotion:
    layer: int
    expert: int
    slot: int
    nbytes: int
    event: Optional[torch.cuda.Event] = None   # None: completed (CPU)
    issue_ts: float = 0.0          # ``clock`` when the copy was issued
    seq: int = 0                   # the flight recorder's span id
    cancelled: bool = False        # refunded: a second cancel is a no-op
    # Injected faults: a DMA stall keeps the copy in flight until ``clock``
    # passes ``stall_until``; a corrupt payload fails the publish-time
    # integrity check and is cancelled instead of published.
    stall_until: float = 0.0
    corrupt: bool = False


class TransitionManager:
    def __init__(self, bank: ExpertBankQ, host_hi: Dict[str, torch.Tensor],
                 tracker: BudgetTracker, hi_bytes_per_expert: int,
                 migration_bytes_per_window: int = 0):
        """``host_hi``: name → (L, E, K, N) bf16 host copies of the hi tier
        (pinned when the bank is on the card), indexed ``[layer, expert]``:
        a dict, or a ``HostExpertStore`` (duck-typed on ``ensure_hi``, which
        loads an expert's rows before its copy). ``migration_bytes_per_window``
        0 = unlimited."""
        self.bank = bank
        self.host_hi = host_hi
        self.tracker = tracker
        self.hi_bytes = hi_bytes_per_expert
        self.rate_limit = migration_bytes_per_window
        L, n_hi = bank.slot_owner.shape
        self.pools = [SlotPool(n_hi) for _ in range(L)]
        self.state = np.full((L, bank.num_experts),
                             Residency.RESIDENT_LO.value, np.int8)
        self.update_q: deque = deque()
        self.evict_q: deque = deque()
        self._pending: List[PendingPromotion] = []
        # Host mirrors of the published maps (authoritative; the device
        # arrays are written from them, never read back).
        self.slot_map_h = bank.slot_map.cpu().numpy().copy()
        self.slot_owner_h = bank.slot_owner.cpu().numpy().copy()
        self._dirty = False
        self._cuda = bank.slot_owner.device.type == "cuda"
        self._side = torch.cuda.Stream(device=bank.slot_owner.device) \
            if self._cuda else None
        self._reuse_event: Optional[torch.cuda.Event] = None
        self.stats = {"promoted": 0, "demoted": 0, "deferred": 0,
                      "bytes_moved": 0, "retries": 0, "fault_cancels": 0}
        self.inflight_bytes = 0
        # Promotion ages (the watchdog's input) and injected stalls are read
        # on this clock; the engine rebinds it to its own (virtual under
        # replay).
        self.clock = time.monotonic
        self.injector = None            # fault.inject.FaultInjector
        self.retry = RetryPolicy()
        self.fail_cb = None             # the controller's failure decay
        # Observability, attached by the backend (None: no event is built).
        self.tracer = None              # obs.FlightRecorder
        self.publish_hist = None        # obs Histogram of publish latency

    # -- queue side ------------------------------------------------------
    def request_promotion(self, layer: int, expert: int) -> None:
        if self.state[layer, expert] == Residency.RESIDENT_LO.value:
            self.state[layer, expert] = Residency.PROMOTING.value
            self.update_q.append((layer, expert))
            if self.tracer is not None:
                self.tracer.instant("promo_request", cat="residency",
                                    layer=layer, expert=expert)

    def request_demotion(self, layer: int, expert: int) -> None:
        if self.state[layer, expert] == Residency.RESIDENT_HI.value:
            self.state[layer, expert] = Residency.DEMOTING.value
            self.evict_q.append((layer, expert))
            if self.tracer is not None:
                self.tracer.instant("demo_request", cat="residency",
                                    layer=layer, expert=expert)

    # -- worker side -----------------------------------------------------
    def drain(self) -> None:
        """Process evictions, then admit promotions under both gates."""
        demoted = False
        while self.evict_q:
            l, e = self.evict_q.popleft()
            if self.state[l, e] != Residency.DEMOTING.value:
                continue
            self._demote(l, e)
            demoted = True
        if demoted:
            # Later forwards must not see the freed slots; earlier ones
            # still may, so reused slots wait for this event.
            self._flush_maps()
            if self._cuda:
                self._reuse_event = torch.cuda.Event()
                self._reuse_event.record(torch.cuda.current_stream())
        window = 0
        deferred = deque()
        while self.update_q:
            l, e = self.update_q.popleft()
            if self.state[l, e] != Residency.PROMOTING.value:
                continue
            if self.rate_limit and window + self.hi_bytes > self.rate_limit:
                deferred.append((l, e))
                continue
            if self.pools[l].n_free == 0 or \
                    not self.tracker.try_reserve(self.hi_bytes):
                deferred.append((l, e))     # backpressure: stay queued
                self.stats["deferred"] += 1
                if self.tracer is not None:
                    self.tracer.instant("promo_deferred", cat="residency",
                                        layer=l, expert=e)
                continue
            slot = self.pools[l].alloc(e)
            if self._issue_copy(l, e, slot):
                window += self.hi_bytes
        self.update_q = deferred

    def _issue_copy(self, layer: int, expert: int, slot: int) -> bool:
        """Asynchronous hi-weight copy into the (unpublished) pool slot,
        after the host rows are loaded (``ensure_hi``) and the fault plan
        is consulted. Returns True iff the copy was issued; an exhausted
        transfer aborts the admission (``_abort_issue``)."""
        fault = [None]

        def attempt():
            if self.injector is not None:
                f = self.injector.fire("promo_copy", layer=layer,
                                       expert=expert)
                if f is not None:
                    if f.kind == "fail":
                        raise TransferFault("promo_copy", seq=f.seq)
                    fault[0] = f        # stall / corrupt ride the copy
            ensure = getattr(self.host_hi, "ensure_hi", None)
            if ensure is not None:
                ensure(layer, expert)

        seed = self.injector.seed if self.injector is not None else 0
        try:
            _, retries, _ = retry_call(
                attempt, self.retry, seed=seed, key=(layer << 16) | expert,
                site="promo_copy", tracer=self.tracer)
        except (RetryExhausted, TransferFault) as err:
            self._abort_issue(layer, expert, slot, err)
            return False
        self.stats["retries"] += retries
        event = None
        if self._cuda:
            if self._reuse_event is not None:
                self._side.wait_event(self._reuse_event)
            with torch.cuda.stream(self._side):
                for name, leaf in self.bank.hi.items():
                    write_hi_slot(leaf, layer, slot,
                                  self.host_hi[name][layer, expert])
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            for name, leaf in self.bank.hi.items():
                write_hi_slot(leaf, layer, slot,
                              self.host_hi[name][layer, expert])
        p = PendingPromotion(layer, expert, slot, self.hi_bytes, event,
                             issue_ts=self.clock())
        f = fault[0]
        if f is not None:
            if f.kind == "stall":
                p.stall_until = p.issue_ts + f.stall_s
            else:
                p.corrupt = True
        if self.tracer is not None:
            # The lifecycle span: opens at the copy's issue, closes where
            # the copy is published (or cancelled), on the engine clock.
            p.seq = self.tracer.next_id()
            self.tracer.async_begin("promotion", p.seq, cat="residency",
                                    layer=layer, expert=expert, slot=slot,
                                    bytes=self.hi_bytes)
        self._pending.append(p)
        self.inflight_bytes += self.hi_bytes
        self.stats["bytes_moved"] += self.hi_bytes
        return True

    def _abort_issue(self, layer: int, expert: int, slot: int,
                     err: Exception) -> None:
        """Unwind an admission whose copy never issued: the slot and the
        reservation go back (once), the expert stays lo, and the
        controller's failure decay keeps a flapping expert from livelocking
        the promotion budget."""
        self.pools[layer].free(slot)
        self.tracker.release(self.hi_bytes)
        self.state[layer, expert] = Residency.RESIDENT_LO.value
        self.stats["fault_cancels"] += 1
        if self.fail_cb is not None:
            self.fail_cb(layer, expert)
        if self.tracer is not None:
            self.tracer.instant("fault_cancel", cat="fault", layer=layer,
                                expert=expert, site="promo_copy",
                                reason=type(err).__name__)

    def _demote(self, layer: int, expert: int) -> None:
        """Publish-then-reclaim: redirect the handle to lo, then free."""
        slot = unpublish(self.slot_map_h, self.slot_owner_h, layer, expert)
        if slot >= 0:
            self.pools[layer].free(slot)
            self.tracker.release(self.hi_bytes)
        self._dirty = True
        self.state[layer, expert] = Residency.RESIDENT_LO.value
        self.stats["demoted"] += 1
        if self.tracer is not None:
            self.tracer.instant("demotion", cat="residency", layer=layer,
                                expert=expert, slot=slot)

    def publish_ready(self, wait: bool = False) -> int:
        """Publish every pending promotion whose copy completed (``wait``
        blocks on all of them first). Returns how many were published."""
        still, published = [], 0
        for p in self._pending:
            if not wait and p.stall_until > self.clock():
                still.append(p)         # injected stall: still on the wire
                continue
            if p.event is not None:
                if wait:
                    p.event.synchronize()
                elif not p.event.query():
                    still.append(p)
                    continue
            if self.state[p.layer, p.expert] == Residency.PROMOTING.value:
                if p.corrupt:
                    # The publish-time integrity check: a bad payload is
                    # cancelled, so no forward ever sees it.
                    self._cancel_pending(p, "corrupt")
                    continue
                self.inflight_bytes -= p.nbytes
                publish(self.slot_map_h, self.slot_owner_h, p.layer,
                        p.expert, p.slot)
                self.state[p.layer, p.expert] = Residency.RESIDENT_HI.value
                published += 1
                self.stats["promoted"] += 1
                if self.tracer is not None:
                    # ``published=1``: this copy's own event completed
                    # before its slot was published (on the CPU, at once).
                    self.tracer.async_end("promotion", p.seq,
                                          cat="residency", published=1)
                    if self.publish_hist is not None:
                        self.publish_hist.observe(
                            self.tracer.clock() - p.issue_ts)
            else:
                # Demoted while promoting: reclaim without publishing.
                self._cancel_pending(p, "demoted", fault=False)
            self._dirty = True
        self._pending = still
        self._flush_maps()
        return published

    def _cancel_pending(self, p: PendingPromotion, reason: str = "fault",
                        fault: bool = True) -> None:
        """Cancel an in-flight promotion: free its slot, refund its
        reservation, leave the expert lo. Idempotent: the refund happens
        exactly once however many paths (publish, watchdog) cancel it."""
        if p.cancelled:
            return
        p.cancelled = True
        self.pools[p.layer].free(p.slot)
        self.tracker.release(p.nbytes)
        self.state[p.layer, p.expert] = Residency.RESIDENT_LO.value
        self.inflight_bytes -= p.nbytes
        if fault:
            self.stats["fault_cancels"] += 1
            if self.fail_cb is not None:
                self.fail_cb(p.layer, p.expert)
        if self.tracer is not None:
            self.tracer.async_end("promotion", p.seq, cat="residency",
                                  published=0, reason=reason)

    def cancel_stuck(self, now: float, deadline_s: float) -> int:
        """The watchdog's hook: cancel the promotions whose copy has not
        completed ``deadline_s`` after it was issued (engine-clock age).
        The expert keeps serving lo and the controller may choose it again.
        Returns how many were cancelled."""
        still, n = [], 0
        for p in self._pending:
            done = (p.event is None or p.event.query()) and \
                p.stall_until <= now
            age = now - p.issue_ts
            if not done and age > deadline_s:
                if self.tracer is not None:
                    self.tracer.instant("promo_timeout", cat="fault",
                                        layer=p.layer, expert=p.expert,
                                        age_s=round(age, 6))
                self._cancel_pending(p, "timeout")
                n += 1
            else:
                still.append(p)
        self._pending = still
        return n

    def pending_ages(self, now: float) -> List[tuple]:
        """(layer, expert, age_s) of every in-flight promotion."""
        return [(p.layer, p.expert, round(now - p.issue_ts, 6))
                for p in self._pending]

    def _flush_maps(self) -> None:
        """Push the host handle table to the device arrays, in place, on
        the compute stream (ordered after every forward already queued)."""
        if not self._dirty:
            return
        self.bank.slot_map.copy_(torch.from_numpy(self.slot_map_h))
        self.bank.slot_owner.copy_(torch.from_numpy(self.slot_owner_h))
        self._dirty = False

    # -- introspection ----------------------------------------------------
    def hi_set(self, layer: int) -> set:
        return {int(e) for e in np.nonzero(self.slot_map_h[layer] >= 0)[0]}

    def pending_experts(self, layer: int) -> set:
        return {int(p.expert) for p in self._pending if p.layer == layer}

    def check_invariants(self) -> None:
        """Every published handle resolves to a slot owned by that expert;
        budget and in-flight bytes match the published and pending slots;
        the device maps equal the host maps."""
        L, E = self.slot_map_h.shape
        n_used = 0
        for l in range(L):
            for e in range(E):
                s = self.slot_map_h[l, e]
                if s >= 0:
                    assert self.slot_owner_h[l, s] == e, (l, e, s)
                    assert self.pools[l].owner(int(s)) == e, (l, e, s)
                    n_used += 1
        owners = int((self.slot_owner_h >= 0).sum())
        assert owners == n_used, (owners, n_used)
        open_bytes = sum(p.nbytes for p in self._pending)
        assert self.inflight_bytes == open_bytes, \
            (self.inflight_bytes, open_bytes)
        assert self.tracker.used == (n_used + len(self._pending)) * \
            self.hi_bytes, (self.tracker.used, n_used, len(self._pending))
        assert not any(p.cancelled for p in self._pending)
        assert not self._dirty
        assert np.array_equal(self.bank.slot_owner.cpu().numpy(),
                              self.slot_owner_h)
        assert np.array_equal(self.bank.slot_map.cpu().numpy(),
                              self.slot_map_h)
