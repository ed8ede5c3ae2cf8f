"""Paged KV-cache pool: block accounting for the serving engine (the
port's copy of the reference's numpy-only module).

The engine's KV memory is one preallocated device pool of fixed-size blocks
(``block_tokens`` cache positions each, across every attention layer of the
stack at once — one physical block id addresses the same block index in all
(position, superblock) pools). This module is the HOST-side half of the
subsystem: a constant-time free list, per-block refcounts, copy-on-write
resolution, and byte accounting against the engine's ``BudgetTracker``
(see ``repro_torch.core.budget``), so KV admission and expert hi-tier promotions
draw from one envelope. The DEVICE half (the physical arrays and the
gather-by-block-table attention) lives in ``repro_torch.models.layers`` /
``repro_torch.kernels.ops.flash_decode_paged``.

Admission control is quota-based, the paper's feasibility-by-construction
style: a request reserves its worst-case block count up front
(``try_reserve_quota``); every later allocation — lazy appends during
decode, COW copies when a shared block diverges — draws from that quota and
therefore can never fail mid-request. Physical bytes stay reserved for as
long as a block is referenced by ANY lease or by the prefix trie; freeing
the last reference returns both the block and its bytes.

Block 0 is the **trash block**: permanently allocated, never leased. Vacant
continuous-batching rows (and masked write lanes) scatter into it so the
jitted forwards keep static shapes without corrupting live blocks.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

TRASH_BLOCK = 0


class KVBlockPool:
    """Free list + refcounts + budget ledger over ``n_blocks`` KV blocks."""

    def __init__(self, n_blocks: int, block_tokens: int, block_bytes: int,
                 budget=None, reclaim: Optional[Callable[[int], int]] = None):
        """``budget``: optional BudgetTracker/BudgetView charged
        ``block_bytes`` per in-use block and per outstanding quota block.
        ``reclaim(need)``: callback invoked when the free list runs dry —
        typically the prefix trie's evictor — returning how many blocks it
        freed back into this pool."""
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (trash + one usable)")
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.block_bytes = int(block_bytes)
        self.budget = budget
        self.reclaim = reclaim
        self.refcount = np.zeros(self.n_blocks, np.int64)
        self.refcount[TRASH_BLOCK] = 1          # never leased, never freed
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self.quota_blocks = 0                   # pre-reserved, not yet alloc'd
        self.stats = {"allocs": 0, "frees": 0, "cow": 0, "retains": 0,
                      "reclaimed": 0, "quota_denied": 0, "unwinds": 0}
        if self.budget is not None and \
                not self.budget.try_reserve(self.block_bytes):
            raise MemoryError("KV pool: budget cannot cover the trash block")

    # -- introspection ---------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Leased/shared blocks (excluding the trash block)."""
        return self.n_blocks - 1 - len(self._free)

    @property
    def capacity_bytes(self) -> int:
        return self.n_blocks * self.block_bytes

    @property
    def bytes_in_use(self) -> int:
        """Bytes currently reserved: live blocks + outstanding quota +
        trash."""
        return (self.blocks_in_use + self.quota_blocks + 1) * self.block_bytes

    # -- quota (admission control) ---------------------------------------
    def try_reserve_quota(self, n_blocks: int) -> bool:
        """Reserve bytes for ``n_blocks`` worst-case future allocations.
        This is the admission gate: a granted quota guarantees every later
        ``alloc``/COW for the request succeeds. Under byte pressure the
        prefix cache yields first: blocks held only by the trie are
        reclaimed (freeing their bytes) before admission is refused."""
        need = n_blocks * self.block_bytes
        if self.budget is not None and not self.budget.try_reserve(need):
            if self.reclaim is not None:
                short = -(-max(0, need - self.budget.free)
                          // self.block_bytes)
                self.reclaim(short)
            if not self.budget.try_reserve(need):
                self.stats["quota_denied"] += 1
                return False
        self.quota_blocks += n_blocks
        return True

    def release_quota(self, n_blocks: int) -> None:
        if n_blocks > self.quota_blocks:
            raise RuntimeError("released more quota than reserved")
        self.quota_blocks -= n_blocks
        if self.budget is not None:
            self.budget.release(n_blocks * self.block_bytes)

    # -- block lifecycle -------------------------------------------------
    def alloc(self) -> int:
        """Pop a free block, transferring one quota block's bytes onto it.
        The caller must hold quota (see ``KVLease``)."""
        if self.quota_blocks <= 0:
            raise RuntimeError("alloc without quota — admission control bug")
        if not self._free and self.reclaim is not None:
            self.reclaim(1)
        if not self._free:
            raise RuntimeError(
                "KV pool exhausted with quota outstanding — sizing bug "
                f"(n_blocks={self.n_blocks})")
        blk = self._free.pop()
        self.refcount[blk] = 1
        self.quota_blocks -= 1                  # bytes move quota → block
        self.stats["allocs"] += 1
        return blk

    def retain(self, blk: int) -> None:
        """Add a reference (prefix hit / trie registration)."""
        if blk == TRASH_BLOCK or self.refcount[blk] <= 0:
            raise RuntimeError(f"retain of dead block {blk}")
        self.refcount[blk] += 1
        self.stats["retains"] += 1

    def release(self, blk: int) -> bool:
        """Drop one reference; returns True when the block was freed (its
        bytes return to the budget)."""
        if blk == TRASH_BLOCK:
            raise RuntimeError("release of the trash block")
        if self.refcount[blk] <= 0:
            raise RuntimeError(f"double free of block {blk}")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._free.append(blk)
            if self.budget is not None:
                self.budget.release(self.block_bytes)
            self.stats["frees"] += 1
            return True
        return False

    def check_invariants(self) -> None:
        assert self.refcount[TRASH_BLOCK] == 1
        assert (self.refcount >= 0).all()
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list duplicates"
        for blk in range(1, self.n_blocks):
            assert (self.refcount[blk] == 0) == (blk in free_set), blk
        assert self.quota_blocks >= 0
        if self.budget is not None:
            assert self.budget.used == self.bytes_in_use, \
                (self.budget.used, self.bytes_in_use)


class KVLease:
    """One request's view of the pool: a logical-block → physical-block
    table plus the quota that funds its future allocations.

    ``ensure(j)`` is the single write-side entry point: it returns the
    physical block that logical block ``j`` may be WRITTEN through, resolving
    lazily-unallocated blocks (fresh alloc) and shared blocks (copy-on-write:
    a fresh alloc plus a ``(src, dst)`` device-copy obligation the engine
    batches before the forward).
    """

    def __init__(self, pool: KVBlockPool, n_logical: int, quota_blocks: int):
        self.pool = pool
        self.table = np.full(n_logical, -1, np.int32)
        self.quota = quota_blocks              # lease's share of pool quota
        self.closed = False

    def adopt_prefix(self, blocks: Sequence[int],
                     retained: bool = False) -> None:
        """Map a trie hit: share ``blocks`` as logical blocks 0..len-1.
        ``retained=True`` when the caller already holds the references
        (pinned before a reclaim-capable operation, e.g. the quota
        reservation) — the lease takes ownership of them."""
        for j, blk in enumerate(blocks):
            if self.table[j] != -1:
                raise RuntimeError("adopt over an occupied logical block")
            if not retained:
                self.pool.retain(int(blk))
            self.table[j] = int(blk)

    def _alloc(self) -> int:
        if self.quota <= 0:
            raise RuntimeError("lease quota exhausted — quota sizing bug")
        blk = self.pool.alloc()
        self.quota -= 1
        return blk

    def ensure(self, j: int) -> Tuple[int, int]:
        """Make logical block ``j`` privately writable. Returns
        ``(phys, cow_src)`` where ``cow_src`` is -1 (no copy needed) or the
        physical block whose contents must be copied into ``phys`` before
        the next write."""
        blk = int(self.table[j])
        if blk >= 0 and self.pool.refcount[blk] == 1:
            return blk, -1
        cow_src = -1
        if blk >= 0:                            # shared → copy-on-write
            # Release OUR reference before allocating: if the only other
            # holder is the prefix trie, the allocator may reclaim (evict)
            # this very block and hand it straight back — then the "copy"
            # degenerates to keeping the now-private block, which is
            # exactly right. Allocating first would pin the block behind
            # our own refcount and could exhaust a correctly-sized pool.
            cow_src = blk
            self.pool.release(blk)
            self.pool.stats["cow"] += 1
        new = self._alloc()
        self.table[j] = new
        if new == cow_src:
            cow_src = -1                        # self-copy is a no-op
        return new, cow_src

    def unwind(self, j: int) -> None:
        """Give logical block ``j`` back (speculative-rewind path): the
        block held only REJECTED positions, so it returns to the pool and
        its bytes move back onto this lease's quota — a later write at the
        same position re-allocates without a new admission decision.

        COW-safety: only privately-owned blocks may unwind. A block the
        rewind would release back while shared (adopted prefix, trie
        registration) was never allocated BY the burst in the first place —
        the engine only unwinds blocks it saw ``ensure`` freshly allocate,
        and those always carry exactly one reference."""
        blk = int(self.table[j])
        if blk < 0:
            raise RuntimeError(f"unwind of unallocated logical block {j}")
        if self.pool.refcount[blk] != 1:
            raise RuntimeError(
                f"unwind of shared block {blk} (refcount "
                f"{int(self.pool.refcount[blk])}) — only burst-fresh "
                f"private blocks may rewind")
        self.pool.release(blk)                  # frees the block's bytes
        self.table[j] = -1
        # Re-fund the quota with the bytes the release just returned; this
        # cannot fail — the budget has at least block_bytes free now.
        if self.pool.budget is not None and \
                not self.pool.budget.try_reserve(self.pool.block_bytes):
            raise RuntimeError("unwind could not re-reserve quota bytes")
        self.pool.quota_blocks += 1
        self.quota += 1
        self.pool.stats["unwinds"] += 1

    def blocks(self) -> List[int]:
        return [int(b) for b in self.table if b >= 0]

    def close(self) -> None:
        """Release every reference and the unspent quota."""
        if self.closed:
            return
        for j, blk in enumerate(self.table):
            if blk >= 0:
                self.pool.release(int(blk))
                self.table[j] = -1
        if self.quota:
            self.pool.release_quota(self.quota)
            self.quota = 0
        self.closed = True
