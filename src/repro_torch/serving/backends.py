"""Expert-residency backends of the port's serving engine.

* ``Fp16Backend`` — dense bf16 experts, all on the device (the paper's
  quality reference).
* ``StaticPTQBackend`` — every expert serves from the always-resident lo
  tier (the paper's static baseline).
* ``DynaExqBackend`` — the paper's system: a hi bf16 slot pool per layer,
  hotness → one global cross-layer allocation (the reference's default on
  one device; ``global_alloc=False``: the per-layer top-n rule) →
  promotion copies from pinned host masters → publish. (No host tier,
  streaming, sensitivity weights, fault injection or expert parallelism in
  this port yet.)
* ``OffloadBackend`` — the offloading/prefetch baseline: an LRU cache of
  experts per layer in front of host memory, its misses and prefetches
  priced by ``FetchModel`` as a modeled stall (it computes dense on the
  device, as the reference does: no real host transfers).

Protocol, as the reference's: ``materialize_banks`` builds the device
tiers and returns {MoE position: ExpertBankQ}, or None when the forwards
read the dense experts from ``params`` (fp16, offload); ``observe`` takes
one forward's router counts (row-resolved counts are scrubbed by
``row_valid`` first) and returns the forward's modeled stall in seconds;
``tick`` runs the policy window; ``stats`` returns exactly ``STAT_KEYS +
STAT_EXTRAS``; ``flush`` waits for in-flight transitions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.allocator import AllocatorConfig, GlobalAllocator
from repro_torch.core.budget import BudgetTracker, plan_budget
from repro_torch.core.controller import ControllerConfig, DynaExqController
from repro_torch.core.hotness import mask_row_counts
from repro_torch.core.ver import (build_bank, expert_hi_nbytes,
                                  expert_lo_nbytes)
from repro_torch.models.config import ArchConfig
from repro_torch.serving.hoststore import FetchModel

#: Keys every backend's ``stats()`` returns (zeros where N/A) — the
#: reference's uniform schema.
STAT_KEYS = ("ttft_s", "tpot_s", "stall_s", "bytes_moved",
             "promotions", "demotions",
             "accept_rate", "draft_tokens", "verified_tokens", "spec_rounds",
             "active_experts", "dispatch_pad_ratio",
             "preemptions", "resumes", "shed_requests", "downgraded",
             "host_fetches", "retries", "fault_cancels")

GiB = 1 << 30
#: Bytes an ``hbm_gb`` envelope holds back for activations (the
#: reference's default ``activation_slack_bytes``).
ACTIVATION_SLACK_BYTES = 64 << 20
#: Physical hi slots per layer over the uniform share n_hi under the
#: global allocator (the reference's default ``slots_slack``).
SLOTS_SLACK = 2.0


class _BackendBase:
    name = "base"
    STAT_EXTRAS: Tuple[str, ...] = ()

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ttft: list = []
        self._tpot: list = []
        self._counts_sum: Dict[str, np.ndarray] = {}
        self.cfg: Optional[ArchConfig] = None
        self.budget = None
        self.moe_positions: list = []

    def materialize_banks(self, cfg: ArchConfig, params: Dict,
                          kv_bytes: int, budget=None) -> Dict:
        self.cfg = cfg
        self.budget = budget
        self.moe_positions = [p for p, _ in enumerate(
            cfg.superblock_or_default()) if cfg.ffn_kind(p) == "moe"]
        return self._materialize(cfg, params, kv_bytes)

    def _materialize(self, cfg, params, kv_bytes) -> Dict:
        raise NotImplementedError

    def observe(self, counts: Dict, compute_s: float = 0.0,
                prefill: bool = False,
                row_valid: Optional[np.ndarray] = None) -> float:
        cleaned = {}
        for k, c in counts.items():
            c = mask_row_counts(c, row_valid)
            cleaned[k] = c
            acc = self._counts_sum.get(k)
            self._counts_sum[k] = c.copy() if acc is None else acc + c
        stall = self._observe_residency(cleaned, compute_s)
        (self._ttft if prefill else self._tpot).append(compute_s + stall)
        return stall

    def _observe_residency(self, counts: Dict, compute_s: float) -> float:
        """Residency accounting of one forward; returns its modeled stall
        (seconds the forward would have waited on transfers)."""
        return 0.0

    def tick(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def router_counts(self) -> Dict[str, np.ndarray]:
        return dict(self._counts_sum)

    def device_bytes(self) -> int:
        raise NotImplementedError

    def stats(self) -> Dict[str, float]:
        out = {k: 0.0 for k in STAT_KEYS + self.STAT_EXTRAS}
        if self._ttft:
            out["ttft_s"] = float(np.mean(self._ttft))
        if self._tpot:
            out["tpot_s"] = float(np.mean(self._tpot))
        out.update(self._residency_stats())
        return out

    def _residency_stats(self) -> Dict[str, float]:
        return {}


def _shapes(experts: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in experts.items()}


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()


def _device_experts(params: Dict, pos, device) -> Dict[str, torch.Tensor]:
    """Position ``pos``'s dense (L, E, K, N) experts, moved onto ``device``
    in ``params`` (a no-op where they already are)."""
    moe = params["blocks"][str(pos)]["moe"]
    moe["experts"] = {k: v.to(device) for k, v in moe["experts"].items()}
    return moe["experts"]


def envelope_fixed_bytes(params: Dict, kv_bytes: int) -> int:
    """The fixed bytes of an ``hbm_gb`` envelope as the reference counts
    them: the parameters outside ``blocks`` (embedding, LM head, final
    norm; attention weights and routers are not counted), the KV cache
    and ``ACTIVATION_SLACK_BYTES``."""
    return _param_bytes({k: v for k, v in params.items()
                         if k != "blocks"}) + kv_bytes + \
        ACTIVATION_SLACK_BYTES


class Fp16Backend(_BackendBase):
    """Dense bf16 experts, fully device-resident: the quality/latency
    reference (and the compute substrate the offload model prices). The
    forwards read the experts from ``params`` (``materialize_banks``
    returns None): the ragged FFN's all-hi mode, or the padded dispatch's
    batched SwiGLU."""

    name = "fp16"

    def __init__(self, device=None):
        super().__init__(device)
        self._dense_bytes = 0

    def _materialize(self, cfg, params, kv_bytes):
        self._dense_bytes = sum(
            _param_bytes(_device_experts(params, p, self.device))
            for p in self.moe_positions)
        return None

    def device_bytes(self) -> int:
        return self._dense_bytes


class StaticPTQBackend(_BackendBase):
    """Uniform static PTQ: every expert serves from the lo tier; no hi
    pool, no transfers."""

    name = "static"

    def __init__(self, lo_bits: int = 4, group_size: int = 64, device=None):
        super().__init__(device)
        self.lo_bits = lo_bits
        self.group_size = group_size
        self.banks: Dict = {}
        self._lo_bytes = 0

    def _materialize(self, cfg, params, kv_bytes):
        for pos in self.moe_positions:
            moe = params["blocks"][str(pos)]["moe"]
            experts = moe["experts"]
            L, E = experts["w_gate"].shape[:2]
            self._lo_bytes += expert_lo_nbytes(
                _shapes(experts), self.lo_bits, self.group_size) * L * E
            self.banks[str(pos)] = build_bank(
                {k: v.to(self.device) for k, v in experts.items()}, n_hi=0,
                lo_bits=self.lo_bits, group_size=self.group_size)
            moe["experts"] = None       # the bank is the only residency now
        return self.banks

    def device_bytes(self) -> int:
        return self._lo_bytes


class DynaExqBackend(_BackendBase):
    """The paper's system: a hi pool per MoE position, the always-resident
    int ``lo_bits`` tier, and promotions that copy pinned bf16 host masters
    on a side stream and publish once their copy completed. The host store
    is a dict of (L, E, K, N) bf16 tensors indexed ``[layer, expert]``.

    ``global_alloc`` (None = on, the reference's default on one device):
    ONE ``GlobalAllocator`` knapsack over every layer of every position
    replaces the per-layer top-n rule, so a hot layer may hold more hi
    slots than a cold one at the same total: ``n_hi·L`` slots per position,
    each layer's physical pool ``ceil(n_hi·SLOTS_SLACK)`` slots (at most
    E). ``global_alloc=False`` is the paper's per-layer rule.

    ``n_hi`` per layer: ``n_hi_per_layer``, else what ``plan_budget``
    leaves for the hi tier in an ``hbm_gb`` envelope, else E // 8.
    ``hi_bits`` < 16 (the paper's Int4-hi tier) prices a hi expert at
    packed int ``hi_bits`` in the budget and ``device_bytes()``; the slots
    still hold the bf16 masters, as in the reference."""

    name = "dynaexq"
    STAT_EXTRAS = ("deferred", "lo_resident_frac", "hi_loads",
                   "residency_ready_frac", "migrations", "quarantined")

    def __init__(self, lo_bits: int = 4, hi_bits: int = 16,
                 group_size: int = 64,
                 n_hi_per_layer: Optional[int] = None,
                 hbm_gb: Optional[float] = None,
                 controller: Optional[ControllerConfig] = None,
                 global_alloc: Optional[bool] = None,
                 device=None):
        super().__init__(device)
        self.lo_bits = lo_bits
        self.hi_bits = hi_bits
        self.group_size = group_size
        self.n_hi_per_layer = n_hi_per_layer
        self.hbm_gb = hbm_gb
        self.controller_cfg = controller
        self.global_alloc = True if global_alloc is None else \
            bool(global_alloc)
        self.controllers: Dict[str, DynaExqController] = {}
        self.banks: Dict = {}
        self.host_hi: Dict[str, Dict[str, torch.Tensor]] = {}
        self.allocator: Optional[GlobalAllocator] = None
        self._global_root: Optional[BudgetTracker] = None
        self._row_caps: Optional[np.ndarray] = None
        self._row_pos: list = []            # global row → (pos, layer)
        self._row_offsets: Dict[str, int] = {}
        self._lo_b: Dict[str, int] = {}
        self._hi_b: Dict[str, int] = {}
        self._last_global = time.monotonic()
        # (layer, expert) cells routed while published hi: every such cell
        # was computed from its hi slot (a hi tile of the ragged kernels,
        # or the bf16 overlay of the padded dispatch).
        self.hi_routed = 0

    # -- materialization ---------------------------------------------------
    def _derive_n_hi(self, params, kv_bytes, L, E, hi_b, lo_b) -> int:
        if self.n_hi_per_layer is not None:
            return self.n_hi_per_layer
        if self.hbm_gb is not None:
            return plan_budget(
                m_total=int(self.hbm_gb * GiB),
                m_fixed=envelope_fixed_bytes(params, kv_bytes),
                lo_bytes_total=lo_b * L * E, hi_bytes_per_expert_layer=hi_b,
                n_layers=L, num_experts=E).n_hi_per_layer
        return max(1, E // 8)

    def _materialize(self, cfg, params, kv_bytes):
        # Phase 1, a metadata prepass: slot counts and byte prices of every
        # position before anything is built, so the global envelope and the
        # knapsack's budget are sums over the whole model.
        metas = []
        for pos in self.moe_positions:
            pos = str(pos)
            experts = params["blocks"][pos]["moe"]["experts"]
            shapes = _shapes(experts)
            hi_b = expert_hi_nbytes(shapes, hi_bits=self.hi_bits,
                                    group_size=self.group_size)
            lo_b = expert_lo_nbytes(shapes, self.lo_bits, self.group_size)
            L, E = experts["w_gate"].shape[:2]
            n_hi = self._derive_n_hi(params, kv_bytes, L, E, hi_b, lo_b)
            metas.append((pos, experts, L, E, hi_b, lo_b, n_hi))
        self._build_global_structures(metas)
        pin = self.device.type == "cuda"
        for pos, experts, L, E, hi_b, lo_b, n_hi in metas:
            self._lo_b[pos] = lo_b
            self._hi_b[pos] = hi_b
            host = {}
            for k, v in experts.items():
                h = v.to("cpu")
                host[k] = h.pin_memory() if pin else h.clone()
            self.host_hi[pos] = host
            bank = build_bank({k: v.to(self.device)
                               for k, v in experts.items()},
                              n_hi=self._slots(n_hi, E),
                              lo_bits=self.lo_bits,
                              group_size=self.group_size,
                              hi_bits=self.hi_bits)
            self.banks[pos] = bank
            if n_hi > 0:
                self.controllers[pos] = DynaExqController(
                    bank, host, n_hi_per_layer=n_hi,
                    hi_bytes_per_expert=hi_b, cfg=self.controller_cfg,
                    tracker=self._tracker_for(pos, n_hi, L, hi_b))
            params["blocks"][pos]["moe"]["experts"] = None
        return self.banks

    def _slots(self, n_hi: int, E: int) -> int:
        """Physical hi slots per layer: under the global allocator, room
        over the uniform share for it to skew slots toward hot layers (the
        byte accounting stays at n_hi·L·hi_b: extra slots are capacity,
        not budget)."""
        if not (self.global_alloc and n_hi > 0):
            return n_hi
        return min(E, max(n_hi, math.ceil(n_hi * SLOTS_SLACK)))

    def _build_global_structures(self, metas) -> None:
        """Global mode: the cross-layer knapsack (a row is one layer of one
        position), its per-row slot ceilings and the shared byte
        envelope."""
        if not self.global_alloc:
            return
        rows = [(pos, L, E, n_hi, hi_b)
                for pos, _, L, E, hi_b, _, n_hi in metas if n_hi > 0]
        if not rows:
            return
        Es = {E for _, _, E, _, _ in rows}
        if len(Es) != 1:
            raise ValueError(
                f"global allocation needs a uniform expert count across "
                f"MoE positions, got {sorted(Es)}")
        total_hi = sum(n_hi * L for _, L, _, n_hi, _ in rows)
        total_cap = sum(n_hi * L * hi_b for _, L, _, n_hi, hi_b in rows)
        caps = []
        for pos, L, E, n_hi, _ in rows:
            self._row_offsets[pos] = len(self._row_pos)
            for l in range(L):
                self._row_pos.append((pos, l))
                caps.append(self._slots(n_hi, E))
        self._row_caps = np.asarray(caps, np.int64)
        ctl_cfg = self.controller_cfg if self.controller_cfg is not None \
            else ControllerConfig()
        max_tr = ctl_cfg.max_transitions_per_layer * len(self._row_pos) \
            if ctl_cfg.max_transitions_per_layer else 0
        self.allocator = GlobalAllocator(AllocatorConfig(
            total_hi=total_hi, slots_per_layer=int(self._row_caps.max()),
            margin=ctl_cfg.margin, max_transitions=max_tr))
        # One byte envelope for the whole hi tier: the engine's shared
        # tracker (promotions contend with KV admission) or a private one
        # at the summed cap. The per-position accounts carry no cap of
        # their own: the global slot budget is the allocator's to spend.
        self._global_root = self.budget if self.budget is not None \
            else BudgetTracker(total_cap)

    def _tracker_for(self, pos, n_hi, L, hi_b):
        if self.allocator is not None:
            return self._global_root.view(f"hi:{pos}")
        if self.budget is not None:
            # Per-layer rule under the engine's envelope: the classic
            # n_hi·L·hi_b cap, every reservation also gated by the shared
            # envelope KV blocks draw from.
            return self.budget.view(f"hi:{pos}", cap=n_hi * L * hi_b)
        return None

    # -- per-forward hook and windows --------------------------------------
    def _observe_residency(self, counts, compute_s):
        for k, ctl in self.controllers.items():
            c = counts.get(k)
            if c is None:
                continue
            ctl.observe(c)
            self.hi_routed += int(((c > 0) & (ctl.tm.slot_map_h >= 0)).sum())
        return 0.0

    def tick(self) -> None:
        if self.allocator is not None:
            self._global_tick()
        else:
            for ctl in self.controllers.values():
                ctl.maybe_update()

    def _global_tick(self) -> bool:
        now = time.monotonic()
        # The cadence is read live from the controllers: callers freeze or
        # retune the policy by replacing ``ctl.cfg``, as the per-layer
        # ``maybe_update`` honours it.
        cadence = min(ctl.cfg.update_interval_s
                      for ctl in self.controllers.values())
        if now - self._last_global < cadence:
            for ctl in self.controllers.values():
                ctl.tm.publish_ready()      # copies completed since
            return False
        self._last_global = now
        self._global_update()
        return True

    def _global_update(self) -> None:
        """One global window: stack every position's folded hotness into
        one (R, E) value matrix, solve the knapsack once, and hand each
        position's controller its slice of the plan (globally ordered, so
        under a rate limit the hottest promotions anywhere go first)."""
        R = len(self._row_pos)
        if R == 0:
            return
        E = self.banks[self._row_pos[0][0]].num_experts
        value = np.zeros((R, E))
        cur_hi = [set() for _ in range(R)]
        for pos, off in self._row_offsets.items():
            ctl = self.controllers[pos]
            L = ctl.tm.state.shape[0]
            value[off:off + L] = ctl.folded_scores()
            for l in range(L):
                cur_hi[off + l] = ctl.tm.hi_set(l) | \
                    ctl.tm.pending_experts(l)
        asn = self.allocator.allocate(value, cur_hi,
                                      row_caps=self._row_caps)
        promos: Dict[str, list] = {p: [] for p in self.controllers}
        demos: Dict[str, list] = {p: [] for p in self.controllers}
        for r, e in asn.promotions:
            pos, l = self._row_pos[r]
            promos[pos].append((l, e))
        for r, e in asn.demotions:
            pos, l = self._row_pos[r]
            demos[pos].append((l, e))
        for pos, ctl in self.controllers.items():
            ctl.apply_plan(promos[pos], demos[pos])

    def force_update(self) -> None:
        if self.allocator is not None:
            self._global_update()
        else:
            for ctl in self.controllers.values():
                ctl.update()

    def flush(self) -> None:
        for ctl in self.controllers.values():
            ctl.flush()

    # -- introspection -----------------------------------------------------
    def hi_sets(self) -> Dict[str, list]:
        return {k: [sorted(ctl.tm.hi_set(l))
                    for l in range(ctl.tm.slot_map_h.shape[0])]
                for k, ctl in self.controllers.items()}

    def device_bytes(self) -> int:
        """Expert bytes on the device, hi residents priced at ``hi_bits``."""
        total = 0
        for pos, bank in self.banks.items():
            L, E = bank.slot_map.shape
            ctl = self.controllers.get(pos)
            n_hi_res = int((ctl.tm.slot_owner_h >= 0).sum()) if ctl else 0
            total += self._lo_b[pos] * L * E + n_hi_res * self._hi_b[pos]
        return total

    def _residency_stats(self):
        agg = {"bytes_moved": 0.0, "promotions": 0.0, "demotions": 0.0,
               "deferred": 0.0, "lo_resident_frac": 1.0,
               "residency_ready_frac": 1.0}
        for ctl in self.controllers.values():
            agg["bytes_moved"] += ctl.tm.stats["bytes_moved"]
            agg["promotions"] += ctl.tm.stats["promoted"]
            agg["demotions"] += ctl.tm.stats["demoted"]
            agg["deferred"] += ctl.tm.stats["deferred"]
        return agg


class LRUSet:
    """O(1) LRU set over expert ids (``move_to_end`` on a hit,
    ``popitem(last=False)`` on eviction)."""

    def __init__(self, size: int, init: Optional[Iterable[int]] = None):
        self.size = size
        self._od: "OrderedDict[int, None]" = OrderedDict()
        for e in init or ():
            self.add(int(e))

    def __contains__(self, e: int) -> bool:
        return e in self._od

    def __len__(self) -> int:
        return len(self._od)

    def hit(self, e: int) -> bool:
        """Refresh ``e`` if cached; returns whether it was a hit."""
        if e in self._od:
            self._od.move_to_end(e)
            return True
        return False

    def add(self, e: int) -> None:
        """Insert ``e`` as most recent, evicting the LRU entry on
        overflow."""
        self._od[e] = None
        self._od.move_to_end(e)
        while len(self._od) > self.size:
            self._od.popitem(last=False)

    def touch(self, e: int) -> bool:
        """Hit or insert; returns True on a hit."""
        if self.hit(e):
            return True
        self.add(e)
        return False

    def order(self) -> List[int]:
        """Entries, least recent first."""
        return list(self._od)


@dataclasses.dataclass
class OffloadConfig:
    cache_experts_per_layer: int = 16
    # PCIe gen4 x16, the paper's A6000; give the card's own pinned
    # host→device copy rate to price this card's link.
    pcie_gbps: float = 16.0
    prefetch: bool = True


class OffloadBackend(_BackendBase):
    """ExpertFlow-like offloading/prefetch baseline (the paper's §5.3
    comparator). Experts live in host memory; the device keeps an LRU
    cache of ``cache_experts_per_layer`` bf16 experts per layer. Each
    forward's routed set is held against the cache: misses are fetched on
    the critical path, priced by ``FetchModel`` (bytes / ``pcie_gbps``),
    and that modeled stall is added to the measured compute time, so the
    comparison reflects transfer volume, not host noise. Prefetch: before
    each step the previous step's routed set is fetched; those bytes hide
    under ``compute_s`` and only their spill stalls.

    As in the reference, residency is modeled: the forwards compute with
    the dense experts on the device (``params``), and nothing is copied."""

    name = "offload"
    STAT_EXTRAS = ("hits", "misses")

    def __init__(self, ocfg: Optional[OffloadConfig] = None, device=None):
        super().__init__(device)
        self.ocfg = ocfg if ocfg is not None else OffloadConfig()
        self.fetch = FetchModel(gbps=self.ocfg.pcie_gbps)
        self.expert_bytes = 0
        self.n_moe_layers = 0
        self.lru: Dict[int, LRUSet] = {}
        self.prev_active: Dict[int, set] = {}
        self._acct = {"hits": 0, "misses": 0, "stall_s": 0.0,
                      "bytes_moved": 0}

    def _materialize(self, cfg, params, kv_bytes):
        for p in self.moe_positions:
            _device_experts(params, p, self.device)
        # bf16 bytes of one expert (w_gate + w_up + w_down).
        self.expert_bytes = 3 * cfg.d_model * cfg.moe.d_ff_expert * 2
        self.n_moe_layers = len(self.moe_positions) * cfg.n_superblocks()
        self.lru = {l: LRUSet(self.ocfg.cache_experts_per_layer)
                    for l in range(self.n_moe_layers)}
        self.prev_active = {l: set() for l in range(self.n_moe_layers)}
        return None

    def _observe_residency(self, counts, compute_s):
        activated: Dict[int, np.ndarray] = {}
        li = 0
        for pos in self.moe_positions:
            c = np.asarray(counts[str(pos)])       # (L, E)
            for l in range(c.shape[0]):
                activated[li] = np.nonzero(c[l] > 0)[0]
                li += 1
        miss_bytes = prefetched_bytes = 0
        for l, acts in activated.items():
            lru = self.lru[l]
            if self.ocfg.prefetch:
                for e in self.prev_active[l]:
                    if e not in lru:
                        prefetched_bytes += self.expert_bytes
                    lru.touch(int(e))
            for e in acts:
                if lru.touch(int(e)):
                    self._acct["hits"] += 1
                else:
                    self._acct["misses"] += 1
                    miss_bytes += self.expert_bytes
            self.prev_active[l] = set(int(x) for x in acts)
        stall = self.fetch.stall_s(miss_bytes, prefetched_bytes, compute_s)
        self._acct["stall_s"] += stall
        self._acct["bytes_moved"] += miss_bytes + prefetched_bytes
        return stall

    def device_bytes(self) -> int:
        """The device-resident cache under the offload budget."""
        return (self.n_moe_layers * self.ocfg.cache_experts_per_layer *
                self.expert_bytes)

    def _residency_stats(self):
        return {"stall_s": self._acct["stall_s"],
                "bytes_moved": float(self._acct["bytes_moved"]),
                "hits": float(self._acct["hits"]),
                "misses": float(self._acct["misses"]),
                "host_fetches": float(self._acct["misses"])}


BACKENDS = {"fp16": Fp16Backend, "static": StaticPTQBackend,
            "dynaexq": DynaExqBackend, "offload": OffloadBackend}


def make_backend(name: str, **kwargs):
    """Registry factory: ``make_backend("dynaexq", n_hi_per_layer=2)``.
    Runs on ``cuda`` unless ``device="cpu"`` is passed."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"one of {sorted(BACKENDS)}") from None
    return cls(**kwargs)
