"""Global cross-layer, cross-tier residency allocation; the port's copy of
the reference's numpy-only allocator (its outputs are held to the
reference's exactly).

The paper's top-n rule solves L independent per-layer knapsacks; this module
solves ONE. Every (layer-row, expert) cell competes for

* a global **hi budget** (``total_hi`` expert-slots across all rows — the
  same byte envelope the per-layer rule spreads uniformly), and
* optionally a global **lo-residency budget** (``lo_resident_total`` cells;
  everything below the cut lives in the host-DRAM tier and pays a modeled
  demand-fetch stall when routed).

Cells are ranked by *sensitivity-weighted hotness* (``value = hotness ×
sensitivity``; the port has no sensitivity weights yet, so its backend
passes the hotness alone): a hot-but-robust expert can lose its hi slot to
a cooler-but-fragile one, and a hot layer can hold more hi slots than a
cold layer — the cross-layer reallocation the per-layer rule cannot
express. Feasibility is structural:

* ``sum(|hi_l|) <= total_hi`` and ``|hi_l| <= slots_per_layer`` (the
  physical per-row pool ceiling),
* the hi target is always a subset of the lo-resident target (the ladder is
  ordered: hi ⊆ lo ⊆ host),
* hysteresis (``margin``/``lo_margin``) mirrors the per-layer rule: a cell
  only displaces a current resident if its value clears the resident's by
  the margin, so near-tie oscillation produces zero transitions.

Host-side numpy over (rows, E) arrays — same O(L·E log) cost class as the
per-layer policy, far off the token critical path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

Cell = Tuple[int, int]   # (row, expert) — row is a global layer index


@dataclasses.dataclass(frozen=True)
class AllocatorConfig:
    total_hi: int                 # global hi budget, in expert-slots
    slots_per_layer: int          # physical per-row hi pool ceiling
    margin: float = 0.0           # hysteresis on weighted value (hi tier)
    max_transitions: int = 0      # global per-window promotion cap (0 = inf)
    lo_resident_total: int = 0    # 0 = no host tier (all cells lo-resident)
    lo_margin: float = 0.0        # hysteresis at the lo ↔ host boundary

    def validate(self) -> None:
        if self.total_hi < 0 or self.slots_per_layer < 0:
            raise ValueError("hi budgets must be >= 0")
        if self.margin < 0 or self.lo_margin < 0:
            raise ValueError("margins must be >= 0")
        if self.lo_resident_total < 0:
            raise ValueError("lo_resident_total must be >= 0")


@dataclasses.dataclass
class TierAssignment:
    """One allocation window's output. ``promotions`` are ordered
    hottest-first and ``demotions`` coldest-first (the transition pipeline's
    admission order under rate limits); the lo lists are ``None`` when no
    host tier is configured."""
    hi: List[Set[int]]
    promotions: List[Cell]
    demotions: List[Cell]
    lo: Optional[List[Set[int]]] = None
    lo_promotions: Optional[List[Cell]] = None
    lo_demotions: Optional[List[Cell]] = None


class GlobalAllocator:
    """One knapsack over all (row, expert) cells, greedy by value with
    per-row ceilings — optimal for unit-size items under a cardinality
    budget, which is exactly what fixed-granularity expert slots are."""

    def __init__(self, cfg: AllocatorConfig):
        cfg.validate()
        self.cfg = cfg

    # -- internals --------------------------------------------------------
    @staticmethod
    def _order(value: np.ndarray) -> List[Cell]:
        R, E = value.shape
        flat = np.argsort(-value.reshape(-1), kind="stable")
        return [(int(i) // E, int(i) % E) for i in flat]

    @staticmethod
    def _caps(row_caps, R: int, default: int) -> np.ndarray:
        if row_caps is None:
            return np.full(R, default, np.int64)
        caps = np.asarray(row_caps, np.int64)
        if caps.shape != (R,):
            raise ValueError(f"row_caps shape {caps.shape} != ({R},)")
        return caps

    def _greedy(self, value: np.ndarray, K: int, caps: np.ndarray,
                pinned: Optional[Sequence[Set[int]]] = None
                ) -> List[Set[int]]:
        """Descending-value fill of K cells subject to per-row ceilings.
        ``pinned`` cells are seated first and count against K (they may
        overdraw it — the caller guarantees |pinned| <= K)."""
        R, E = value.shape
        target: List[Set[int]] = [set() for _ in range(R)]
        counts = np.zeros(R, np.int64)
        total = 0
        if pinned is not None:
            for r in range(R):
                for e in pinned[r]:
                    target[r].add(int(e))
                counts[r] = len(target[r])
            total = int(counts.sum())
        for r, e in self._order(value):
            if total >= K:
                break
            if e in target[r] or counts[r] >= caps[r]:
                continue
            target[r].add(e)
            counts[r] += 1
            total += 1
        return target

    def _hysteresis(self, value: np.ndarray, current: List[Set[int]],
                    target: List[Set[int]], margin: float,
                    caps: np.ndarray,
                    pinned: Optional[List[Set[int]]] = None) -> None:
        """Cancel churn: pair the strongest entrant with the weakest leaver;
        once a pair fails to clear ``margin``, cancel it and every weaker
        pair (the per-layer rule's swap loop, globalized). Mutates
        ``target`` in place. A cancel whose leaver cannot re-seat (its row
        was filled to the ceiling by stronger entrants) keeps the swap —
        feasibility beats stability on that edge."""
        entrants = sorted(
            ((r, e) for r in range(len(target)) for e in target[r]
             if e not in current[r]
             and not (pinned is not None and e in pinned[r])),
            key=lambda c: -value[c])
        leavers = sorted(
            ((r, e) for r in range(len(current)) for e in current[r]
             if e not in target[r]),
            key=lambda c: value[c])
        counts = np.array([len(t) for t in target], np.int64)
        cancelling = False
        for ent, lv in zip(entrants, leavers):
            if not cancelling and value[ent] > value[lv] + margin:
                continue           # clear winner — the swap stands
            cancelling = True
            re_, ee = ent
            rl, el = lv
            counts[re_] -= 1       # entrant steps back out…
            if counts[rl] < caps[rl]:
                target[re_].discard(ee)
                target[rl].add(el)  # …and the incumbent keeps its seat
                counts[rl] += 1
            else:
                counts[re_] += 1   # infeasible cancel: keep the swap

    # -- public -----------------------------------------------------------
    def allocate(self, value: np.ndarray,
                 current_hi: Sequence[Set[int]],
                 current_lo: Optional[Sequence[Set[int]]] = None,
                 row_caps=None) -> TierAssignment:
        """One window: ``value`` is the (rows, E) sensitivity-weighted
        hotness; ``current_hi`` (and ``current_lo`` when a host tier is on)
        are the published-or-pending residency sets. Rows from several MoE
        positions may be stacked — that is the point."""
        value = np.asarray(value, np.float64)
        R, E = value.shape
        if len(current_hi) != R:
            raise ValueError(f"{len(current_hi)} current sets != {R} rows")
        caps = self._caps(row_caps, R, min(self.cfg.slots_per_layer, E))
        current = [set(int(e) for e in s) for s in current_hi]

        K = self.cfg.total_hi
        target = self._greedy(value, K, caps)
        if any(current):
            self._hysteresis(value, current, target, self.cfg.margin, caps)
        promotions = sorted(
            ((r, e) for r in range(R) for e in target[r]
             if e not in current[r]), key=lambda c: -value[c])
        demotions = sorted(
            ((r, e) for r in range(R) for e in current[r]
             if e not in target[r]), key=lambda c: value[c])

        if self.cfg.max_transitions:
            k = self.cfg.max_transitions
            promotions = promotions[:k]
            n_cur = sum(len(s) for s in current)
            overflow = max(0, n_cur + len(promotions) - K)
            demotions = demotions[:max(overflow, min(len(demotions), k))]
            target = [set(s) for s in current]
            for r, e in demotions:
                target[r].discard(e)
            for r, e in promotions:
                target[r].add(e)
            # Ceiling fix-up: a trimmed demotion list may leave a row over
            # its physical pool — force-demote its coldest members.
            for r in range(R):
                while len(target[r]) > caps[r]:
                    coldest = min(target[r], key=lambda e: value[r, e])
                    target[r].discard(coldest)
                    if (r, coldest) not in demotions:
                        demotions.append((r, coldest))
                    promotions = [c for c in promotions if c != (r, coldest)]

        lo = lo_promos = lo_demos = None
        if self.cfg.lo_resident_total:
            K_lo = max(self.cfg.lo_resident_total,
                       sum(len(s) for s in target))
            cur_lo = [set(int(e) for e in s) for s in current_lo] \
                if current_lo is not None else [set(range(E))
                                               for _ in range(R)]
            full = np.full(R, E, np.int64)
            lo = self._greedy(value, K_lo, full, pinned=target)
            if any(cur_lo):
                self._hysteresis(value, cur_lo, lo, self.cfg.lo_margin,
                                 full, pinned=target)
            # The ladder is ordered: hi residency implies lo residency.
            for r in range(R):
                lo[r] |= target[r]
            lo_promos = sorted(
                ((r, e) for r in range(R) for e in lo[r]
                 if e not in cur_lo[r]), key=lambda c: -value[c])
            lo_demos = sorted(
                ((r, e) for r in range(R) for e in cur_lo[r]
                 if e not in lo[r]), key=lambda c: value[c])

        return TierAssignment(hi=target, promotions=promotions,
                              demotions=demotions, lo=lo,
                              lo_promotions=lo_promos,
                              lo_demotions=lo_demos)
