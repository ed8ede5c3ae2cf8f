"""Token-prefix trie over KV pool blocks: cross-request prefix sharing (the
port's copy of the reference's numpy-only module).

Requests that share a prompt prefix (system prompts, few-shot headers) map
the same physical KV blocks instead of recomputing them. The trie is keyed
by whole ``block_tokens``-sized token chunks: a node holds the physical
block carrying the KV of one chunk GIVEN its ancestors (KV at position p
depends on all tokens ≤ p, so a chunk's cache content is only reusable
under the exact same prefix — which is precisely what a trie path encodes).

Each registered node holds one pool reference of its own, so cached
prefixes survive the request that computed them; blocks whose only
remaining reference is the trie are reclaimable — ``evict`` walks leaves
in LRU order and hands blocks back to the pool when it runs dry. Writers
never mutate a registered block in place: the pool's refcount (> 1 while
the trie or any other lease holds it) forces copy-on-write in the engine,
so trie contents stay pristine even for ring (sliding-window) caches whose
decode wraps back over prefix slots.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kvpool import KVBlockPool


class _Node:
    __slots__ = ("children", "parent", "chunk", "block", "last_used")

    def __init__(self, parent: Optional["_Node"], chunk, block: int):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.chunk = chunk          # key in parent.children (None for root)
        self.block = block          # physical pool block (-1 for root)
        self.last_used = 0


class PrefixTrie:
    """Chunk-granular prefix index over physical KV blocks."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.bt = pool.block_tokens
        self.root = _Node(None, None, -1)
        self._clock = itertools.count(1)
        self.n_nodes = 0
        self.stats = {"hit_blocks": 0, "miss_blocks": 0, "registered": 0,
                      "evicted": 0}

    # -- lookup ----------------------------------------------------------
    def _chunks(self, tokens: np.ndarray) -> List[Tuple[int, ...]]:
        toks = np.asarray(tokens).reshape(-1)
        n = toks.shape[0] // self.bt
        return [tuple(int(t) for t in toks[i * self.bt:(i + 1) * self.bt])
                for i in range(n)]

    def match(self, tokens: np.ndarray,
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest chain of whole-chunk matches for ``tokens``; returns the
        physical block ids (NOT retained — the caller adopts them into a
        lease while still on the hook for this host thread). Touches the
        path's LRU clocks."""
        chunks = self._chunks(tokens)
        if max_blocks is not None:
            chunks = chunks[:max_blocks]
        node, out = self.root, []
        now = next(self._clock)
        for chunk in chunks:
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = now
            out.append(child.block)
            node = child
        self.stats["hit_blocks"] += len(out)
        self.stats["miss_blocks"] += len(chunks) - len(out)
        return out

    # -- registration ----------------------------------------------------
    def insert(self, tokens: np.ndarray, blocks: Sequence[int]) -> int:
        """Register ``blocks[j]`` as the cache of chunk j of ``tokens``.
        Existing nodes keep their block (first writer wins — a concurrent
        duplicate computation stays private to its lease); new nodes retain
        one pool reference each. Returns the number of nodes created."""
        chunks = self._chunks(tokens)[:len(blocks)]
        node, created = self.root, 0
        now = next(self._clock)
        for j, chunk in enumerate(chunks):
            child = node.children.get(chunk)
            if child is None:
                blk = int(blocks[j])
                if blk < 0:
                    break                       # unallocated tail — stop
                self.pool.retain(blk)
                child = _Node(node, chunk, blk)
                node.children[chunk] = child
                self.n_nodes += 1
                created += 1
                self.stats["registered"] += 1
            child.last_used = now
            node = child
        return created

    # -- eviction ----------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self.root:
                out.append(n)
            stack.extend(kids)
        return out

    def _nodes(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _drop(self, node: _Node) -> bool:
        """Unlink ``node`` and release its pool reference; True if the
        block actually returned to the free list."""
        del node.parent.children[node.chunk]
        self.n_nodes -= 1
        self.stats["evicted"] += 1
        return self.pool.release(node.block)

    def evict(self, need: int) -> int:
        """Reclaim ≥ ``need`` blocks into the pool's free list if possible,
        LRU-leaf-first; only trie-exclusive references (refcount == 1) free
        a block, so blocks still mapped by live leases are never yanked.
        When no leaf is directly freeable but a trie-exclusive block hides
        BEHIND lease-shared descendants (a COWed ancestor of a still-leased
        chunk), the LRU leaf is unlinked anyway — dropping only the trie's
        reference — to unwind the chain toward the reclaimable interior.
        Returns the number of blocks actually freed."""
        freed = 0
        while freed < need:
            leaves = self._leaves()
            if not leaves:
                break
            cands = [n for n in leaves if self.pool.refcount[n.block] == 1]
            if cands:
                if self._drop(min(cands, key=lambda n: n.last_used)):
                    freed += 1
                continue
            if not any(self.pool.refcount[n.block] == 1
                       for n in self._nodes()):
                break                # nothing trie-exclusive anywhere
            self._drop(min(leaves, key=lambda n: n.last_used))
        self.pool.stats["reclaimed"] += freed
        return freed

    def clear(self) -> int:
        """Drop every node (shutdown / tests); returns blocks freed."""
        freed = 0
        while True:
            leaves = self._leaves()
            if not leaves:
                break
            for n in leaves:
                freed += bool(self._drop(n))
        return freed
