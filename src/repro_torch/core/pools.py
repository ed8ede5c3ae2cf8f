"""Fixed-granularity slot pools (paper §3.3); the port's copy of the
reference's numpy-only module.

The hi pool's device tensors are preallocated once, so fragmentation cannot
occur; what remains is the *slot accounting*: which hi-pool slot is free,
which expert owns which slot. ``SlotPool`` is that free list, host-side,
one per layer; ``ShardedSlotPool`` splits it into per-shard free lists
under expert parallelism.

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



class ShardedSlotPool:
    """Per-shard free lists over one global slot index space.

    Under expert parallelism the hi pool is sharded along the slot dim:
    shard ``j`` holds slots ``[j·per, (j+1)·per)`` on its own device, and
    an expert owned by shard ``j`` may only occupy one of those slots (the
    kernel reads hi weights from local memory). ``alloc`` is therefore per
    shard; free/owner/slots_of stay in the global slot space, so the
    bank's ``slot_map``/``slot_owner`` handles are unchanged.
    ``n_shards=1`` is a ``SlotPool``."""

    def __init__(self, n_slots: int, n_shards: int = 1):
        if n_shards < 1 or n_slots % n_shards:
            raise ValueError(f"n_slots={n_slots} must divide evenly over "
                             f"n_shards={n_shards}")
        self.n_slots = n_slots
        self.n_shards = n_shards
        self.per_shard = n_slots // n_shards
        self._free = [list(range(j * self.per_shard,
                                 (j + 1) * self.per_shard))
                      for j in range(n_shards)]
        self._owner: dict[int, int] = {}

    def shard_of(self, slot: int) -> int:
        return slot // self.per_shard

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - self.n_free

    def n_free_in(self, shard: int) -> int:
        return len(self._free[shard])

    def alloc(self, expert: int, shard: int = 0) -> int:
        """Pop the lowest free slot of ``shard`` for ``expert``; raises if
        that shard's slots are exhausted (admission must prevent it)."""
        if not self._free[shard]:
            raise RuntimeError(
                f"shard {shard} pool exhausted — admission control bug")
        slot = heapq.heappop(self._free[shard])
        self._owner[slot] = expert
        return slot

    def free(self, slot: int) -> None:
        if slot in self._owner:
            del self._owner[slot]
            heapq.heappush(self._free[self.shard_of(slot)], slot)

    def owner(self, slot: int) -> int | None:
        return self._owner.get(slot)

    def slots_of(self) -> dict[int, int]:
        return dict(self._owner)
