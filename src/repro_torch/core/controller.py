"""DynaExq control loop (paper Fig. 4): hotness estimator → budget-feasible
per-layer top-n policy (or the global allocator's plan, ``apply_plan``) →
transition pipeline. Host-side and O(L·E), off the token critical path."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.budget import BudgetTracker
from repro_torch.core.hotness import HotnessEstimator
from repro_torch.core.policy import PolicyConfig, select_hi_set
from repro_torch.core.transitions import TransitionManager
from repro_torch.core.ver import ExpertBankQ


@dataclasses.dataclass
class ControllerConfig:
    update_interval_s: float = 1.0      # T_u
    alpha: float = 0.8                  # EMA
    margin: float = 0.0                 # hysteresis
    migration_bytes_per_window: int = 0
    max_transitions_per_layer: int = 0


class DynaExqController:
    def __init__(self, bank: ExpertBankQ, host_hi: Dict[str, torch.Tensor],
                 n_hi_per_layer: int, hi_bytes_per_expert: int,
                 cfg: Optional[ControllerConfig] = None, tracker=None):
        """``tracker``: optional byte ledger (e.g. a view of the engine's
        shared envelope); defaults to a private tracker capped at the hi
        pool's own size."""
        cfg = cfg if cfg is not None else ControllerConfig()
        L, E = bank.slot_map.shape
        self.cfg = cfg
        self.hotness = HotnessEstimator(L, E, alpha=cfg.alpha)
        self.policy = PolicyConfig(
            n_hi=n_hi_per_layer, margin=cfg.margin,
            max_transitions_per_layer=cfg.max_transitions_per_layer)
        self.tracker = tracker if tracker is not None else \
            BudgetTracker(n_hi_per_layer * L * hi_bytes_per_expert)
        self.tm = TransitionManager(
            bank, host_hi, self.tracker, hi_bytes_per_expert,
            migration_bytes_per_window=cfg.migration_bytes_per_window)
        self._last_update = time.monotonic()
        # Failure decay: an (L, E) multiplier on the folded hotness, halved
        # each time an expert's promotion copy fails and recovering toward
        # 1 every window, so a flapping expert is re-candidated but cannot
        # livelock the promotion budget.
        self._fail_penalty = np.ones((L, E))
        self.fail_decay = 0.5
        self.fail_recover = 0.5
        self.tm.fail_cb = self.note_promotion_failure

    def note_promotion_failure(self, layer: int, expert: int) -> None:
        self._fail_penalty[layer, expert] *= self.fail_decay

    def folded_scores(self) -> np.ndarray:
        """Fold the hotness EMA and apply (then partly recover) the failure
        decay: what every policy path ranks on, the per-layer ``update()``
        and the global allocator alike."""
        scores = self.hotness.fold() * self._fail_penalty
        self._fail_penalty += (1.0 - self._fail_penalty) * self.fail_recover
        return scores

    @property
    def bank(self) -> ExpertBankQ:
        return self.tm.bank

    def observe(self, counts) -> None:
        self.hotness.observe(counts)

    def maybe_update(self, now: Optional[float] = None,
                     force: bool = False) -> bool:
        now = now if now is not None else time.monotonic()
        if not force and now - self._last_update < self.cfg.update_interval_s:
            self.tm.publish_ready()     # publish copies that completed
            return False
        self._last_update = now
        self.update()
        return True

    def update(self) -> None:
        """One policy window: fold EMA → per-layer top-n with hysteresis →
        enqueue transitions → drain → publish completed."""
        scores = self.folded_scores()
        for l in range(scores.shape[0]):
            current = self.tm.hi_set(l) | self.tm.pending_experts(l)
            _, promos, demos = select_hi_set(scores[l], current, self.policy)
            for e in demos:
                self.tm.request_demotion(l, int(e))
            for e in promos:
                self.tm.request_promotion(l, int(e))
        self.tm.drain()
        self.tm.publish_ready()

    def apply_plan(self, promotions, demotions) -> None:
        """Enqueue an externally computed transition plan (the global
        allocator's) and run one drain/publish window. The lists are
        (layer, expert) pairs, promotions hottest-first and demotions
        coldest-first: the admission order ``update()`` derives per layer,
        through the same pipeline (budget gates, rate limit,
        publish-then-switch)."""
        for l, e in demotions:
            self.tm.request_demotion(int(l), int(e))
        for l, e in promotions:
            self.tm.request_promotion(int(l), int(e))
        self.tm.drain()
        self.tm.publish_ready()

    def flush(self) -> None:
        """Block on all in-flight transitions and publish."""
        self.tm.drain()
        self.tm.publish_ready(wait=True)
        self.tm.drain()
        self.tm.publish_ready(wait=True)
