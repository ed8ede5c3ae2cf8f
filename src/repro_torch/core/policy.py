"""Budget-feasible top-n selection with hysteresis (paper §3.5); the
port's copy of the reference's numpy-only policy.

Given per-layer hotness scores and the fixed per-layer capacity ``n_hi,l``,
the target hi set is TopN — but an expert only *enters* if its score exceeds
the weakest current member by ``margin``, and only *leaves* if it falls below
the strongest outsider by the same margin. This bounds churn under near-tie
routing fluctuations (stability constraint C3) without ever violating the
budget (the set size never exceeds n_hi).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    n_hi: int                  # per-layer hi capacity (budget-derived)
    margin: float = 0.0        # additive hysteresis threshold on scores
    max_transitions_per_layer: int = 0   # 0 = unlimited (rate limiting is
                                         # additionally enforced at admission)


def select_hi_set(scores: np.ndarray, current: set[int],
                  cfg: PolicyConfig) -> tuple[set[int], list[int], list[int]]:
    """One layer. Returns (target_set, promotions, demotions), promotions
    ordered hottest-first and demotions coldest-first (eviction priority)."""
    E = scores.shape[0]
    n = min(cfg.n_hi, E)
    if n == 0:
        return set(), [], sorted(current, key=lambda e: scores[e])
    order = np.argsort(-scores, kind="stable")
    top = order[:n]
    top_set = set(int(e) for e in top)

    if not current:
        target = top_set
    else:
        target = set(current)
        # Hysteresis: rank everyone, then swap in only clear winners.
        in_sorted = sorted(current, key=lambda e: scores[e])          # weakest first
        out_sorted = [int(e) for e in order if int(e) not in current]  # strongest first
        i = j = 0
        while i < len(in_sorted) and j < len(out_sorted):
            weakest_in, strongest_out = in_sorted[i], out_sorted[j]
            if scores[strongest_out] > scores[weakest_in] + cfg.margin:
                target.discard(weakest_in)
                target.add(strongest_out)
                i += 1
                j += 1
            else:
                break
        # Capacity change (re-planned budget) still applies.
        while len(target) > n:
            target.discard(min(target, key=lambda e: scores[e]))
        if len(target) < n:
            for e in order:
                if len(target) >= n:
                    break
                target.add(int(e))

    promotions = sorted(target - current, key=lambda e: -scores[e])
    demotions = sorted(current - target, key=lambda e: scores[e])
    if cfg.max_transitions_per_layer:
        k = cfg.max_transitions_per_layer
        promotions = promotions[:k]
        # Keep the set consistent: only demote as many as we promote over cap.
        overflow = max(0, len(current) + len(promotions) - n)
        demotions = demotions[:max(overflow, min(len(demotions), k))]
        target = (current - set(demotions)) | set(promotions)
    return target, promotions, demotions
