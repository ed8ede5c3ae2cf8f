"""Fixed-granularity slot pools (paper §3.3); the port's copy of the
reference's numpy-only module.

The hi pool's device tensors are preallocated once, so fragmentation cannot
occur; what remains is the *slot accounting*: which hi-pool slot is free,
which expert owns which slot. ``SlotPool`` is that free list, host-side,
one per layer.

Allocation is lowest-index-first (a min-heap, O(log n)): occupied hi slots
pack toward the low end of the pool, so after churn the live slots stay a
(mostly) contiguous prefix of the (n_hi, K, N) pool tensors.
"""
from __future__ import annotations

import heapq


class SlotPool:
    """Lowest-index-first free list over ``n_slots`` fixed-granularity
    slots (constant-time membership, log-time alloc/free)."""

    def __init__(self, n_slots: int):
        self._free = list(range(n_slots))     # already a valid min-heap
        self._owner: dict[int, int] = {}      # slot → expert
        self.n_slots = n_slots

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    def alloc(self, expert: int) -> int:
        """Pop the lowest free slot for ``expert``; raises if full (the
        admission check must prevent that)."""
        if not self._free:
            raise RuntimeError("pool exhausted — admission control bug")
        slot = heapq.heappop(self._free)
        self._owner[slot] = expert
        return slot

    def free(self, slot: int) -> None:
        if slot in self._owner:
            del self._owner[slot]
            heapq.heappush(self._free, slot)

    def owner(self, slot: int) -> int | None:
        return self._owner.get(slot)

    def slots_of(self) -> dict[int, int]:
        return dict(self._owner)

