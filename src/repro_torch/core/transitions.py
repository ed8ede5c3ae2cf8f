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
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.budget import BudgetTracker
from repro_torch.core.pools import SlotPool
from repro_torch.core.ver import (ExpertBankQ, Residency, publish, unpublish,
                                  write_hi_slot)


@dataclasses.dataclass
class PendingPromotion:
    layer: int
    expert: int
    slot: int
    nbytes: int
    event: Optional[torch.cuda.Event] = None   # None: completed (CPU)


class TransitionManager:
    def __init__(self, bank: ExpertBankQ, host_hi: Dict[str, torch.Tensor],
                 tracker: BudgetTracker, hi_bytes_per_expert: int,
                 migration_bytes_per_window: int = 0):
        """``host_hi``: name → (L, E, K, N) bf16 host copies of the hi tier
        (pinned when the bank is on the card), indexed ``[layer, expert]``.
        ``migration_bytes_per_window`` 0 = unlimited."""
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
                      "bytes_moved": 0}
        self.inflight_bytes = 0

    # -- queue side ------------------------------------------------------
    def request_promotion(self, layer: int, expert: int) -> None:
        if self.state[layer, expert] == Residency.RESIDENT_LO.value:
            self.state[layer, expert] = Residency.PROMOTING.value
            self.update_q.append((layer, expert))

    def request_demotion(self, layer: int, expert: int) -> None:
        if self.state[layer, expert] == Residency.RESIDENT_HI.value:
            self.state[layer, expert] = Residency.DEMOTING.value
            self.evict_q.append((layer, expert))

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
                continue
            slot = self.pools[l].alloc(e)
            self._issue_copy(l, e, slot)
            window += self.hi_bytes
        self.update_q = deferred

    def _issue_copy(self, layer: int, expert: int, slot: int) -> None:
        """Asynchronous hi-weight copy into the (unpublished) pool slot."""
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
        self._pending.append(PendingPromotion(layer, expert, slot,
                                              self.hi_bytes, event))
        self.inflight_bytes += self.hi_bytes
        self.stats["bytes_moved"] += self.hi_bytes

    def _demote(self, layer: int, expert: int) -> None:
        """Publish-then-reclaim: redirect the handle to lo, then free."""
        slot = unpublish(self.slot_map_h, self.slot_owner_h, layer, expert)
        if slot >= 0:
            self.pools[layer].free(slot)
            self.tracker.release(self.hi_bytes)
        self._dirty = True
        self.state[layer, expert] = Residency.RESIDENT_LO.value
        self.stats["demoted"] += 1

    def publish_ready(self, wait: bool = False) -> int:
        """Publish every pending promotion whose copy completed (``wait``
        blocks on all of them first). Returns how many were published."""
        still, published = [], 0
        for p in self._pending:
            if p.event is not None:
                if wait:
                    p.event.synchronize()
                elif not p.event.query():
                    still.append(p)
                    continue
            self.inflight_bytes -= p.nbytes
            if self.state[p.layer, p.expert] == Residency.PROMOTING.value:
                publish(self.slot_map_h, self.slot_owner_h, p.layer,
                        p.expert, p.slot)
                self.state[p.layer, p.expert] = Residency.RESIDENT_HI.value
                published += 1
                self.stats["promoted"] += 1
            else:
                # Demoted while promoting: reclaim without publishing.
                self.pools[p.layer].free(p.slot)
                self.tracker.release(p.nbytes)
                self.state[p.layer, p.expert] = Residency.RESIDENT_LO.value
            self._dirty = True
        self._pending = still
        self._flush_maps()
        return published

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
        assert not self._dirty
        assert np.array_equal(self.bank.slot_owner.cpu().numpy(),
                              self.slot_owner_h)
        assert np.array_equal(self.bank.slot_map.cpu().numpy(),
                              self.slot_map_h)
