"""DynaExq control loop (paper Fig. 4): hotness estimator → budget-feasible
per-layer top-n policy (or the global allocator's plan, ``apply_plan``) →
transition pipeline. Host-side and O(L·E), off the token critical path.

``EPCoordinator`` is the expert-parallel ownership rebalancer: it relabels
experts across shards when traffic skews onto one shard. Under a
distribution context every rank runs the same coordinator on the same
(all-reduced) counts, and the one relabel step that moves data, the lo
rows and the host masters of the swapped pair, is a pairwise exchange
over the model axis that every rank enters (``launch.dist.exchange``;
on a (data × model) grid each data row exchanges within its own model
group)."""
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
from repro_torch.core.ver import (ExpertBankQ, Residency, swap_expert_rows,
                                  swap_router_cols)
from repro_torch.fault.inject import TransferFault
from repro_torch.launch import dist as D


@dataclasses.dataclass
class ControllerConfig:
    update_interval_s: float = 1.0      # T_u
    alpha: float = 0.8                  # EMA
    margin: float = 0.0                 # hysteresis
    migration_bytes_per_window: int = 0
    max_transitions_per_layer: int = 0


@dataclasses.dataclass
class RebalanceConfig:
    """Cadence and thresholds of the EP expert-ownership rebalancer."""
    interval_s: float = 2.0             # coordinator window
    skew_threshold: float = 1.5         # max/min shard hotness ratio trigger
    max_migrations_per_window: int = 2  # per MoE position


class DynaExqController:
    def __init__(self, bank: ExpertBankQ, host_hi: Dict[str, torch.Tensor],
                 n_hi_per_layer: int, hi_bytes_per_expert: int,
                 cfg: Optional[ControllerConfig] = None, tracker=None,
                 ep_shards: int = 1, shard_trackers=None, dist=None):
        """``tracker``: optional byte ledger (e.g. a view of the engine's
        shared envelope); defaults to a private tracker capped at the hi
        pool's own size. ``ep_shards``/``shard_trackers``/``dist``: expert
        parallelism: the hi pool's slots are owned per shard and each
        shard's promotions bill its own tracker (``TransitionManager``)."""
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
            migration_bytes_per_window=cfg.migration_bytes_per_window,
            n_shards=ep_shards, shard_trackers=shard_trackers, dist=dist)
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


class EPCoordinator:
    """Hotness-aware expert-ownership rebalancer for expert-parallel
    serving (the reference's ``EPCoordinator``).

    Shard ``j`` owns expert positions ``[j·E/n, (j+1)·E/n)``: position IS
    placement. When traffic skews onto one shard, its hi slots saturate
    while others idle. Each window the coordinator reads the per-shard
    hotness (the counts are summed over every rank inside the MoE layer)
    and relabels: it swaps the hottest expert of the most loaded shard
    with the coldest of the least loaded one. A relabel swaps the pair's
    router columns, lo rows, host rows and hotness history; the forward
    is invariant under it (the router swap compensates the weight swap),
    so it applies between engine steps. Both experts must be RESIDENT_LO:
    hi residents are demoted first, since their slots live on their
    shard's device and cannot move.

    ``n_shards`` shards; ``cfg`` the cadence; ``dist`` this rank's
    distribution context (None: one process holds every shard's rows)."""

    def __init__(self, n_shards: int, cfg: Optional[RebalanceConfig] = None,
                 dist=None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if dist is not None and dist.model_size != n_shards:
            raise ValueError(f"{n_shards} shards under a group of "
                             f"{dist.model_size} ranks")
        self.n_shards = n_shards
        self.cfg = cfg if cfg is not None else RebalanceConfig()
        self.dist = dist
        self._entries = []   # (controller, moe params dict, placement (L, E))
        self.stats = {"migrations": 0, "windows": 0, "bytes_moved": 0,
                      "deferred_migrations": 0, "aborted_migrations": 0}
        self._last = time.monotonic()
        self.tracer = None      # obs.FlightRecorder, bound by the backend
        self.injector = None    # fault.inject.FaultInjector, ditto

    def register(self, ctl: DynaExqController, moe_params: Dict) -> None:
        """Track one MoE position: its controller and the live params dict
        holding its ``router`` leaf (swapped in place on migration)."""
        L, E = ctl.tm.state.shape
        if E % self.n_shards:
            raise ValueError(f"E={E} not divisible by "
                             f"n_shards={self.n_shards}")
        placement = np.tile(np.arange(E), (L, 1))   # position → expert
        self._entries.append((ctl, moe_params, placement))

    # -- policy ----------------------------------------------------------
    def shard_loads(self, scores_row: np.ndarray) -> np.ndarray:
        """(E,) per-expert hotness → (n_shards,) per-shard load."""
        return scores_row.reshape(self.n_shards, -1).sum(axis=1)

    def maybe_rebalance(self, now: Optional[float] = None,
                        force: bool = False) -> int:
        """Run a window once ``cfg.interval_s`` passed since the last on
        ``now`` (the engine's agreed clock under a distribution context,
        so every rank takes the same decision)."""
        now = now if now is not None else time.monotonic()
        if not force and now - self._last < self.cfg.interval_s:
            return 0
        self._last = now
        return self.rebalance()

    def rebalance(self) -> int:
        """One window: per layer, swap hottest-on-max-shard with
        coldest-on-min-shard while the skew ratio exceeds the threshold and
        the swap strictly lowers the max shard load."""
        self.stats["windows"] += 1
        if self.n_shards < 2:
            return 0
        total = 0
        for ctl, moe_params, placement in self._entries:
            # The unfolded EMA plus the counts since the last fold: the
            # freshest view, without moving the fold cadence.
            hot = ctl.hotness.scores + ctl.hotness.counts
            L, E = hot.shape
            e_per = E // self.n_shards
            moved = 0
            for l in range(L):
                while moved < self.cfg.max_migrations_per_window:
                    loads = self.shard_loads(hot[l])
                    donor, recv = int(loads.argmax()), int(loads.argmin())
                    if donor == recv or loads[donor] <= \
                            self.cfg.skew_threshold * max(loads[recv], 1e-9):
                        break
                    d0, r0 = donor * e_per, recv * e_per
                    e = d0 + int(hot[l, d0:d0 + e_per].argmax())
                    f = r0 + int(hot[l, r0:r0 + e_per].argmin())
                    if hot[l, e] <= hot[l, f]:
                        break
                    # Only a swap that strictly shrinks the max shard load:
                    # the descent terminates, and one red-hot expert never
                    # ping-pongs between shards within a window.
                    delta = hot[l, e] - hot[l, f]
                    if max(loads[donor] - delta, loads[recv] + delta) >= \
                            loads[donor]:
                        break
                    if not self._migrate(ctl, moe_params, placement, l, e, f):
                        break
                    hot[l, [e, f]] = hot[l, [f, e]]
                    moved += 1
                    total += 1
        self.stats["migrations"] += total
        return total

    # -- mechanism -------------------------------------------------------
    def _swap_rows(self, leaf: torch.Tensor, E: int, l: int, e: int,
                   f: int) -> None:
        """Swap the rows of experts ``e`` and ``f`` at layer ``l`` of
        ``leaf``, (L, held experts, ...): every expert's without a context,
        both rows here. Under one, rank j holds experts ``[j·E/N,
        (j+1)·E/N)``, and the ranks holding the two exchange them pairwise
        in one collective over the model axis that every rank enters (the
        others with nothing to send)."""
        if self.dist is None:
            swap_expert_rows(leaf, l, e, f)
            return
        e_per = E // self.n_shards
        se, sf = e // e_per, f // e_per
        j = self.dist.rank
        if se == sf:                    # both rows on one rank: no exchange
            if j == se:
                swap_expert_rows(leaf, l, e - se * e_per, f - sf * e_per)
            return
        send = [None] * self.n_shards
        like = [None] * self.n_shards
        if j == se:
            send[sf] = leaf[l, e - se * e_per]
            like[sf] = send[sf]
        elif j == sf:
            send[se] = leaf[l, f - sf * e_per]
            like[se] = send[se]
        got = D.exchange(send, like, self.dist)
        if j == se:
            leaf[l, e - se * e_per] = got[sf]
        elif j == sf:
            leaf[l, f - sf * e_per] = got[se]

    def _swap_expert(self, bank: ExpertBankQ, host: Dict, name: str, l: int,
                     e: int, f: int) -> int:
        """Swap weight ``name``'s lo rows (codes and scales) and host
        masters (``host``: name → the held (L, n, K, N) rows; empty: none)
        of experts ``e`` and ``f`` at layer ``l``; returns the bytes of one
        expert's lo rows (what the relabel is priced at)."""
        qt = bank.lo[name]
        L, n_held = qt.packed.shape[:2]
        for leaf in (qt.packed, qt.scales) + \
                ((host[name],) if name in host else ()):
            self._swap_rows(leaf, bank.num_experts, l, e, f)
        return (qt.packed.nbytes + qt.scales.nbytes) // (L * n_held)

    def _migrate(self, ctl: DynaExqController, moe_params: Dict,
                 placement: np.ndarray, l: int, e: int, f: int) -> bool:
        """Relabel experts ``e`` and ``f`` at layer ``l``. Returns False when
        either could not be brought to RESIDENT_LO (a promotion in flight),
        the window's transfer budget is spent, or the fault plan failed the
        swap: the pair is tried again at a later window."""
        tm = ctl.tm
        bank = ctl.bank
        # A relabel ships both experts' lo rows across the interconnect:
        # priced into the same per-window budget the promotions draw from.
        relabel_bytes = 2 * sum(
            (qt.packed.nbytes + qt.scales.nbytes)
            // (qt.packed.shape[0] * qt.packed.shape[1])
            for qt in bank.lo.values())
        if not tm.try_consume_window(relabel_bytes):
            self.stats["deferred_migrations"] += 1
            return False
        lo_val = Residency.RESIDENT_LO.value
        if tm.state[l, e] != lo_val or tm.state[l, f] != lo_val:
            tm.request_demotion(l, e)
            tm.request_demotion(l, f)
            tm.drain()
            tm.publish_ready(wait=True)
        if tm.state[l, e] != lo_val or tm.state[l, f] != lo_val:
            return False
        fault = None
        if self.injector is not None:
            fault = self.injector.fire("ep_mig", layer=l, expert=e, peer=f)
        if fault is not None and fault.kind == "fail":
            # Abort before any change: refund the window's bytes, so the
            # budget prices only transfers that landed.
            tm.refund_window(relabel_bytes)
            self.stats["aborted_migrations"] += 1
            return False
        moved = 0
        applied = []
        host = _held_rows(tm.host_hi)
        try:
            for i_leaf, name in enumerate(list(bank.lo)):
                moved += self._swap_expert(bank, host, name, l, e, f)
                applied.append(name)
                if fault is not None and i_leaf == 0:
                    # An injected mid-swap failure: some leaves relabeled,
                    # the rest (and the router) not yet: the partial state
                    # that must roll back.
                    raise TransferFault("ep_mig", kind=fault.kind,
                                        seq=fault.seq)
        except TransferFault:
            # Swapping the same pair again restores every applied leaf bit
            # for bit; the router swap comes only after every leaf landed,
            # so the forward stayed invariant throughout.
            for name in applied:
                self._swap_expert(bank, host, name, l, e, f)
            tm.refund_window(relabel_bytes)
            self.stats["aborted_migrations"] += 1
            if self.tracer is not None:
                self.tracer.instant("fault_cancel", cat="fault",
                                    site="ep_mig", layer=l, expert=e,
                                    peer=f)
            return False
        swap_router_cols(moe_params["router"], l, e, f)
        swap_masks = getattr(tm.host_hi, "swap_experts", None)
        if swap_masks is not None:      # HostExpertStore: its presence and
            swap_masks(l, e, f)         # residency masks follow too
        ctl.hotness.swap(l, e, f)
        placement[l, [e, f]] = placement[l, [f, e]]
        # Both directions of the pairwise exchange cross the interconnect.
        self.stats["bytes_moved"] += 2 * moved
        if self.tracer is not None:
            self.tracer.instant("ep_migration", cat="ep", layer=l, expert=e,
                                peer=f, bytes=2 * moved)
        return True


def _held_rows(host_hi) -> Dict[str, torch.Tensor]:
    """name → the host masters a relabel swaps: a ``HostExpertStore``'s
    held rows, or a plain mapping of (L, E, K, N) tensors."""
    held = getattr(host_hi, "held_rows", None)
    return held() if held is not None else dict(host_hi.items())
