"""Expert-residency backends of the port's serving engine.

* ``Fp16Backend`` — dense bf16 experts, all on the device (the paper's
  quality reference).
* ``StaticPTQBackend`` — every expert serves from the always-resident lo
  tier (the paper's static baseline).
* ``DynaExqBackend`` — the paper's system on the full residency ladder: a
  hi bf16 slot pool per layer, the lo tier and an optional host-DRAM tier
  (``serving.hoststore``), hotness (weighted by sensitivity) → one global
  cross-layer allocation (the reference's default on one device;
  ``global_alloc=False``: the per-layer top-n rule) → promotion copies
  from pinned host rows → publish; a streaming cold start from expert
  shards (``serving.streaming``) and fault injection with retries and
  quarantine (``fault``). (No expert parallelism in this port yet.)
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

Observability, as the reference's: ``attach_obs(tracer, metrics)`` binds
the engine's flight recorder and metrics registry (``None``: every site is
a pointer check); ``observe`` then records one ``moe_forward`` event per
forward, the tier split of its active (layer, expert) cells from the
counts the engine already holds on the host (``_tier_counts``);
``obs_meta`` gives the cost model its byte prices and ``residency_mix``
the per-step census of cells by tier.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.allocator import AllocatorConfig, GlobalAllocator
from repro_torch.core.budget import BudgetTracker, plan_budget
from repro_torch.core.controller import ControllerConfig, DynaExqController
from repro_torch.core.hotness import mask_row_counts
from repro_torch.core.ver import (build_bank, build_bank_empty,
                                  expert_hi_nbytes, expert_lo_nbytes)
from repro_torch.fault.inject import FaultInjector, FaultPlan
from repro_torch.fault.retry import RetryExhausted, RetryPolicy
from repro_torch.models.config import ArchConfig
from repro_torch.quant.sensitivity import load_sensitivity, normalize
from repro_torch.serving.hoststore import FetchModel, HostExpertStore
from repro_torch.serving.streaming import ShardSource, hotness_stage_order

#: Keys every backend's ``stats()`` returns (zeros where N/A) — the
#: reference's uniform schema.
STAT_KEYS = ("ttft_s", "tpot_s", "stall_s", "bytes_moved",
             "promotions", "demotions",
             "accept_rate", "draft_tokens", "verified_tokens", "spec_rounds",
             "active_experts", "dispatch_pad_ratio",
             "preemptions", "resumes", "shed_requests", "downgraded",
             "host_fetches", "retries", "fault_cancels")

GiB = 1 << 30
#: Bytes an ``hbm_gb`` envelope holds back for activations by default
#: (the reference's default ``activation_slack_bytes``).
ACTIVATION_SLACK_BYTES = 64 << 20
#: Physical hi slots per layer over the uniform share n_hi under the
#: global allocator by default (the reference's default ``slots_slack``).
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
        self.tracer = None              # obs.FlightRecorder | None
        self.metrics = None             # obs.MetricsRegistry | None

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Bind the engine's flight recorder and metrics registry (subclasses
        pass them on to the components they own); ``None`` detaches."""
        self.tracer = tracer
        self.metrics = metrics

    def obs_meta(self) -> Dict[str, int]:
        """The byte prices the trace cost model replays against:
        ``{"lo_bytes", "hi_bytes"}`` per expert-layer cell (0 where the tier
        does not exist under this backend)."""
        return {}

    def _tier_counts(self, cleaned: Dict) -> Tuple[int, int, int, int]:
        """One forward's ``(active_hi, active_lo, active_host,
        published_hi)`` cell counts: here every active cell serves from an
        always-resident lo tier."""
        act = sum(int((c > 0).sum()) for c in cleaned.values())
        return 0, act, 0, 0

    def residency_mix(self) -> Dict[str, int]:
        """The (layer, expert) cells by tier: ``{"hi", "lo", "host"}``."""
        return {"hi": 0, "lo": 0, "host": 0}

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
        if self.tracer is not None:
            # The per-forward traffic record the cost model replays: counts
            # only (no durations), so virtual-clock traces are byte-stable.
            hi, lo, host, pub = self._tier_counts(cleaned)
            self.tracer.instant(
                "moe_forward", cat="engine",
                routed=int(sum(int(c.sum()) for c in cleaned.values())),
                layers=int(sum(c.shape[0] for c in cleaned.values())),
                active_hi=hi, active_lo=lo, active_host=host,
                published_hi=pub, prefill=int(prefill))
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


def envelope_fixed_bytes(params: Dict, kv_bytes: int,
                         slack: int = ACTIVATION_SLACK_BYTES) -> int:
    """The fixed bytes of an ``hbm_gb`` envelope as the reference counts
    them: the parameters outside ``blocks`` (embedding, LM head, final
    norm; attention weights and routers are not counted), the KV cache
    and the activation slack."""
    return _param_bytes({k: v for k, v in params.items()
                         if k != "blocks"}) + kv_bytes + slack


def _dense_tier_counts(cleaned: Dict) -> Tuple[int, int, int, int]:
    """``_tier_counts`` of the backends that compute with dense bf16
    experts: every active cell streams at full precision, every cell
    counts as published hi."""
    act = sum(int((c > 0).sum()) for c in cleaned.values())
    cells = sum(int(c.size) for c in cleaned.values())
    return act, 0, 0, cells


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
        self._cells = 0
        self._cell_bytes = 0

    def _materialize(self, cfg, params, kv_bytes):
        experts = [_device_experts(params, p, self.device)
                   for p in self.moe_positions]
        self._dense_bytes = sum(_param_bytes(x) for x in experts)
        self._cells = sum(int(np.prod(x["w_gate"].shape[:2]))
                          for x in experts)
        self._cell_bytes = self._dense_bytes // max(1, self._cells)
        return None

    _tier_counts = staticmethod(_dense_tier_counts)

    def residency_mix(self) -> Dict[str, int]:
        return {"hi": self._cells, "lo": 0, "host": 0}

    def obs_meta(self) -> Dict[str, int]:
        return {"lo_bytes": 0, "hi_bytes": self._cell_bytes}

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
        self._cells = 0
        self._lo_per = 0

    def _materialize(self, cfg, params, kv_bytes):
        for pos in self.moe_positions:
            moe = params["blocks"][str(pos)]["moe"]
            experts = moe["experts"]
            L, E = experts["w_gate"].shape[:2]
            self._lo_per = expert_lo_nbytes(
                _shapes(experts), self.lo_bits, self.group_size)
            self._lo_bytes += self._lo_per * L * E
            self._cells += L * E
            self.banks[str(pos)] = build_bank(
                {k: v.to(self.device) for k, v in experts.items()}, n_hi=0,
                lo_bits=self.lo_bits, group_size=self.group_size)
            moe["experts"] = None       # the bank is the only residency now
        return self.banks

    def residency_mix(self) -> Dict[str, int]:
        return {"hi": 0, "lo": self._cells, "host": 0}

    def obs_meta(self) -> Dict[str, int]:
        return {"lo_bytes": self._lo_per, "hi_bytes": 0}

    def device_bytes(self) -> int:
        return self._lo_bytes


class DynaExqBackend(_BackendBase):
    """The paper's system, extended to the full residency ladder: a hi bf16
    slot pool per MoE position, the int ``lo_bits`` tier, and optionally a
    host-DRAM third tier, governed by ONE ``GlobalAllocator`` knapsack
    across every layer of every position. Promotions copy pinned bf16 host
    rows (``HostExpertStore``) on a side stream and publish once their
    copy completed; ``observe`` feeds hotness (and prices host-tier demand
    fetches), ``tick`` runs the allocation window.

    ``global_alloc`` (None = on, the reference's default on one device):
    one cross-layer allocation replaces the per-layer top-n rule, so a hot
    layer may hold more hi slots than a cold one at the same total:
    ``n_hi·L`` slots per position, each layer's physical pool
    ``ceil(n_hi·slots_slack)`` slots (at most E). ``global_alloc=False``
    is the paper's per-layer rule.

    ``n_hi`` per layer: ``n_hi_per_layer``, else what ``plan_budget``
    leaves for the hi tier in an ``hbm_gb`` envelope (fixed bytes: the
    parameters outside ``blocks``, the KV cache and
    ``activation_slack_bytes``), else E // 8. ``hi_bits`` < 16 (the
    paper's Int4-hi tier) prices a hi expert at packed int ``hi_bits`` in
    the budget and ``device_bytes()``; the slots still hold the bf16
    masters, as in the reference.

    ``lo_resident_total`` enables the host tier: only that many (layer,
    expert) cells count as device-lo-resident; the rest live in host DRAM
    and pay a ``fetch``-modeled demand stall when routed (accounting: the
    device rows stay, as in the reference). ``sensitivity`` (a dict
    position → (L, E), or a ``.npz`` path from ``quant.sensitivity``)
    reweights hotness so fragile experts win hi slots at lower traffic.

    ``stream`` (a ``streaming.ShardSource`` or its path) turns on the
    streaming cold start: banks are built EMPTY, ``serving_ready()`` stays
    False while ``tick`` stages lo rows from the checkpoint shards
    (``stream_experts_per_tick`` per window, hottest-first when a
    ``hotness_path`` snapshot from a previous run exists), and the hi/host
    tiers materialize lazily behind promotions.

    ``fault`` (a ``FaultPlan``, a ``FaultInjector``, or a JSON string or
    path) injects faults at the transfer sites; ``retry`` is the shared
    ``RetryPolicy``. Expert parallelism (``ep_shards > 1``, ``rebalance``)
    is not ported."""

    name = "dynaexq"
    STAT_EXTRAS = ("deferred", "lo_resident_frac", "hi_loads",
                   "residency_ready_frac", "migrations", "quarantined")

    def __init__(self, lo_bits: int = 4, hi_bits: int = 16,
                 group_size: int = 64,
                 n_hi_per_layer: Optional[int] = None,
                 hbm_gb: Optional[float] = None,
                 activation_slack_bytes: int = ACTIVATION_SLACK_BYTES,
                 controller: Optional[ControllerConfig] = None,
                 ep_shards: int = 1,
                 rebalance=None,
                 global_alloc: Optional[bool] = None,
                 slots_slack: float = SLOTS_SLACK,
                 sensitivity=None,
                 lo_resident_total: Optional[int] = None,
                 fetch: Optional[FetchModel] = None,
                 hotness_path: Optional[str] = None,
                 stream=None,
                 stream_experts_per_tick: int = 16,
                 fault=None,
                 retry: Optional[RetryPolicy] = None,
                 device=None):
        super().__init__(device)
        if ep_shards < 1:
            raise ValueError("ep_shards must be >= 1")
        if ep_shards > 1 or rebalance is not None:
            raise NotImplementedError(
                "expert parallelism (ep_shards > 1, rebalance) is not "
                "ported yet: ROADMAP.md Queue 1, item 7")
        if global_alloc is None:
            global_alloc = True
        if (stream is not None or lo_resident_total) and not global_alloc:
            raise ValueError(
                "the host tier and streaming cold start require the "
                "global allocator (single-shard serving)")
        if slots_slack < 1.0:
            raise ValueError("slots_slack must be >= 1.0")
        if lo_resident_total is not None and lo_resident_total < 1:
            raise ValueError("lo_resident_total must be >= 1")
        self.lo_bits = lo_bits
        self.hi_bits = hi_bits
        self.group_size = group_size
        self.n_hi_per_layer = n_hi_per_layer
        self.hbm_gb = hbm_gb
        self.activation_slack_bytes = activation_slack_bytes
        self.controller_cfg = controller
        self.global_alloc = bool(global_alloc)
        self.slots_slack = float(slots_slack)
        self.sensitivity = sensitivity      # dict pos → (L, E) | .npz path
        self.lo_resident_total = lo_resident_total
        self.fetch = fetch if fetch is not None else FetchModel()
        self.hotness_path = hotness_path
        self.stream = stream                # ShardSource | path | None
        self.stream_experts_per_tick = int(stream_experts_per_tick)
        self.controllers: Dict[str, DynaExqController] = {}
        self.banks: Dict = {}
        self.stores: Dict[str, HostExpertStore] = {}
        self.allocator: Optional[GlobalAllocator] = None
        self._global_root: Optional[BudgetTracker] = None
        self._row_caps: Optional[np.ndarray] = None
        self._row_pos: list = []            # global row → (pos, layer)
        self._row_offsets: Dict[str, int] = {}
        self._sens: Dict[str, np.ndarray] = {}
        self._lo_b: Dict[str, int] = {}
        self._hi_b: Dict[str, int] = {}
        self._pump_queue: deque = deque()
        self._lo_quota_left = lo_resident_total or 0
        self._serving_ready = True
        self._last_global = time.monotonic()
        self._cadence = (controller if controller is not None
                         else ControllerConfig()).update_interval_s
        self._host_acct = {"host_fetches": 0, "host_fetch_bytes": 0,
                           "hotness_restored": 0}
        if fault is None or isinstance(fault, FaultInjector):
            self.injector = fault
        elif isinstance(fault, FaultPlan):
            self.injector = fault.injector()
        else:
            self.injector = FaultPlan.parse(fault).injector()
        self.retry = retry if retry is not None else RetryPolicy()
        self._fault_acct = {"retries": 0}
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
                m_fixed=envelope_fixed_bytes(params, kv_bytes,
                                             self.activation_slack_bytes),
                lo_bytes_total=lo_b * L * E, hi_bytes_per_expert_layer=hi_b,
                n_layers=L, num_experts=E).n_hi_per_layer
        return max(1, E // 8)

    def _materialize(self, cfg, params, kv_bytes):
        src = None
        if self.stream is not None:
            src = self.stream if hasattr(self.stream, "lo_layer") \
                else ShardSource(self.stream)
            self.stream = src
        sens = self.sensitivity
        if isinstance(sens, str):
            sens = load_sensitivity(sens)
        # Phase 1, a metadata prepass: slot counts and byte prices of every
        # position before anything is built, so the global envelope and the
        # knapsack's budget are sums over the whole model.
        metas = []
        for pos in self.moe_positions:
            pos = str(pos)
            experts = params["blocks"][pos]["moe"]["experts"]
            if experts is not None:
                shapes = _shapes(experts)
            elif src is not None:
                shapes = src.shapes(pos)
            else:
                raise ValueError(
                    f"position {pos}: experts are None and no stream "
                    f"source configured")
            hi_b = expert_hi_nbytes(shapes, hi_bits=self.hi_bits,
                                    group_size=self.group_size)
            lo_b = expert_lo_nbytes(shapes, self.lo_bits, self.group_size)
            L, E = next(iter(shapes.values()))[:2]
            n_hi = self._derive_n_hi(params, kv_bytes, L, E, hi_b, lo_b)
            metas.append((pos, experts, shapes, L, E, hi_b, lo_b, n_hi))
        self._build_global_structures(metas, sens)
        pin = self.device.type == "cuda"
        for pos, experts, shapes, L, E, hi_b, lo_b, n_hi in metas:
            self._lo_b[pos] = lo_b
            self._hi_b[pos] = hi_b
            streaming = experts is None
            if streaming:
                bank = build_bank_empty(shapes, n_hi=self._slots(n_hi, E),
                                        lo_bits=self.lo_bits,
                                        group_size=self.group_size,
                                        device=self.device)
                store = HostExpertStore(
                    shapes,
                    hi_loader=lambda l, e, p=pos: src.hi_expert(p, l, e),
                    lo_loader=lambda l, p=pos: src.lo_layer(p, l),
                    lo_valid_init=False, device=self.device)
            else:
                host = {}
                for k, v in experts.items():
                    if pin:
                        # One copy, straight into pinned memory (a pageable
                        # copy pinned afterwards copies twice).
                        host[k] = torch.empty(
                            v.shape, dtype=v.dtype,
                            pin_memory=True).copy_(v)
                    else:
                        host[k] = v.to("cpu").clone()
                bank = build_bank({k: v.to(self.device)
                                   for k, v in experts.items()},
                                  n_hi=self._slots(n_hi, E),
                                  lo_bits=self.lo_bits,
                                  group_size=self.group_size,
                                  hi_bits=self.hi_bits)
                store = HostExpertStore(shapes, hi=host, device=self.device)
            self.banks[pos] = bank
            self.stores[pos] = store
            if n_hi > 0:
                ctl = DynaExqController(
                    bank, store, n_hi_per_layer=n_hi,
                    hi_bytes_per_expert=hi_b, cfg=self.controller_cfg,
                    tracker=self._tracker_for(pos, n_hi, L, hi_b))
                self.controllers[pos] = ctl
                store.side = ctl.tm._side   # staging beside promotions
                self._restore_hotness(pos, ctl)
            if streaming:
                self._serving_ready = False
            params["blocks"][pos]["moe"]["experts"] = None
        if not self._serving_ready:
            self._build_pump_queue()
        self._propagate_faults()
        self._propagate_obs()           # components built after attach_obs
        return self.banks

    def _slots(self, n_hi: int, E: int) -> int:
        """Physical hi slots per layer: under the global allocator, room
        over the uniform share for it to skew slots toward hot layers (the
        byte accounting stays at n_hi·L·hi_b: extra slots are capacity,
        not budget)."""
        if not (self.global_alloc and n_hi > 0):
            return n_hi
        return min(E, max(n_hi, math.ceil(n_hi * self.slots_slack)))

    def _build_global_structures(self, metas, sens) -> None:
        """Global mode: the cross-layer knapsack (a row is one layer of one
        position), its per-row slot ceilings, the shared byte envelope and
        the normalized sensitivity weights."""
        if not self.global_alloc:
            return
        rows = [(pos, L, E, n_hi, hi_b)
                for pos, _, _, L, E, hi_b, _, n_hi in metas if n_hi > 0]
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
            margin=ctl_cfg.margin, max_transitions=max_tr,
            lo_resident_total=self.lo_resident_total or 0,
            lo_margin=ctl_cfg.margin))
        # One byte envelope for the whole hi tier: the engine's shared
        # tracker (promotions contend with KV admission) or a private one
        # at the summed cap. The per-position accounts carry no cap of
        # their own: the global slot budget is the allocator's to spend.
        self._global_root = self.budget if self.budget is not None \
            else BudgetTracker(total_cap)
        if sens:
            for pos, L, E, _, _ in rows:
                s = sens.get(pos)
                if s is None:
                    continue
                s = np.asarray(s, np.float64)
                if s.shape != (L, E):
                    raise ValueError(
                        f"sensitivity for position {pos} has shape "
                        f"{s.shape}, expected ({L}, {E})")
                self._sens[pos] = normalize(s)

    def _tracker_for(self, pos, n_hi, L, hi_b):
        if self.allocator is not None:
            return self._global_root.view(f"hi:{pos}")
        if self.budget is not None:
            # Per-layer rule under the engine's envelope: the classic
            # n_hi·L·hi_b cap, every reservation also gated by the shared
            # envelope KV blocks draw from.
            return self.budget.view(f"hi:{pos}", cap=n_hi * L * hi_b)
        return None

    def _restore_hotness(self, pos, ctl) -> None:
        if not self.hotness_path:
            return
        path = f"{self.hotness_path}_p{pos}.npz"
        if not os.path.exists(path):
            return
        try:
            ctl.hotness.load(path)
            self._host_acct["hotness_restored"] += 1
        except ValueError:
            pass    # resized model: a stale prior must not crash serving

    def _build_pump_queue(self) -> None:
        """Round-robin merge of per-position staging orders (hottest-first
        under a restored hotness prior, row-major otherwise), so positions
        backfill evenly."""
        per_pos = []
        for pos, store in self.stores.items():
            ctl = self.controllers.get(pos)
            scores = ctl.hotness.scores if ctl is not None else None
            order = hotness_stage_order(scores, store.L, store.E)
            per_pos.append([(pos, l, e) for l, e in order])
        for group in zip(*per_pos) if per_pos else []:
            self._pump_queue.extend(group)

    def _propagate_faults(self) -> None:
        """Push the injector and retry policy into every transfer-plane
        component (transition managers, host stores, the shard source)."""
        for ctl in self.controllers.values():
            ctl.tm.injector = self.injector
            ctl.tm.retry = self.retry
        for store in self.stores.values():
            store.injector = self.injector
            store.retry = self.retry
        if self.stream is not None and hasattr(self.stream, "lo_layer"):
            self.stream.injector = self.injector

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None) -> None:
        super().attach_obs(tracer, metrics)
        self._propagate_obs()

    def _propagate_obs(self) -> None:
        """Push the recorder and registry into the transition managers, the
        host stores and the injector. Idempotent: runs at attach time and
        at the end of ``_materialize``, whichever comes second sees all."""
        hist = self.metrics.histogram(
            "promotion_publish_latency_seconds",
            "copy issue -> publish latency of hi promotions") \
            if self.metrics is not None else None
        for ctl in self.controllers.values():
            ctl.tm.tracer = self.tracer
            ctl.tm.publish_hist = hist
        for store in self.stores.values():
            store.tracer = self.tracer
        if self.injector is not None:
            self.injector.tracer = self.tracer
        if self.tracer is not None:
            # Issue stamps and publish latencies on ONE clock (the engine
            # rebinds the recorder's clock to its own).
            for ctl in self.controllers.values():
                ctl.tm.clock = self.tracer.clock

    def obs_meta(self) -> Dict[str, int]:
        if not self._lo_b:
            return {}
        return {"lo_bytes": int(next(iter(self._lo_b.values()))),
                "hi_bytes": int(next(iter(self._hi_b.values())))}

    def _tier_counts(self, cleaned):
        hi = lo = host = pub = 0
        for k, c in cleaned.items():
            act = c > 0
            ctl = self.controllers.get(k)
            hi_mask = ctl.tm.slot_map_h >= 0 if ctl is not None \
                else np.zeros(c.shape, bool)
            store = self.stores.get(k)
            if store is not None and self.lo_resident_total:
                host_mask = ~store.lo_resident & store.lo_valid
            else:
                host_mask = np.zeros(c.shape, bool)
            if store is not None:
                host_mask = host_mask | store.quarantined
            pub += int(hi_mask.sum())
            hi += int((act & hi_mask).sum())
            host += int((act & ~hi_mask & host_mask).sum())
            lo += int((act & ~hi_mask & ~host_mask).sum())
        return hi, lo, host, pub

    # -- per-forward hook and windows --------------------------------------
    def _observe_residency(self, counts, compute_s):
        stall = 0.0
        for k, ctl in self.controllers.items():
            c = counts.get(k)
            if c is None:
                continue
            ctl.observe(c)
            self.hi_routed += int(((c > 0) & (ctl.tm.slot_map_h >= 0)).sum())
            store = self.stores.get(k)
            if store is None:
                continue
            # Routed experts whose lo residency was ceded to the host tier
            # pay a demand fetch on the critical path (modeled: their
            # device rows are valid). Quarantined cells are ALWAYS
            # host-served (their device rows are unreal).
            miss = np.zeros(c.shape, bool)
            if self.lo_resident_total:
                miss = ~store.lo_resident & store.lo_valid
            miss = (c > 0) & (miss | store.quarantined)
            n = int(miss.sum())
            if n:
                demand = n * self._lo_b[k]
                self._host_acct["host_fetches"] += n
                self._host_acct["host_fetch_bytes"] += demand
                s = self.fetch.stall_s(demand)
                if self.injector is not None:
                    f = self.injector.fire("host_fetch", pos=k, experts=n)
                    if f is not None:
                        # A failed (or slow) demand fetch is retried on the
                        # critical path: one more full transfer plus any
                        # injected stall; only latency is lost.
                        extra = s + (f.stall_s if f.kind == "stall" else 0.0)
                        s += extra
                        self._fault_acct["retries"] += 1
                        if self.tracer is not None:
                            self.tracer.instant("retry", cat="fault",
                                                site="host_fetch", pos=k,
                                                backoff_s=round(extra, 9))
                stall += s
                if self.tracer is not None:
                    # A modeled stall (from bytes): byte-stable in replays.
                    self.tracer.instant("host_fetch", cat="host", pos=k,
                                        experts=n, bytes=demand, stall_s=s)
        return stall

    def tick(self) -> None:
        if not self._serving_ready:
            self._pump()
            return
        if self.allocator is not None:
            self._global_tick()
        else:
            for ctl in self.controllers.values():
                ctl.maybe_update()
        self._heal_quarantined()
        for store in self.stores.values():
            store.publish_lo()

    def _pump(self) -> None:
        """One streaming-cold-start window: stage up to
        ``stream_experts_per_tick`` experts' lo rows, publish completed
        copies, and open serving once every cell is materialized."""
        staged = 0
        batch: Dict[Tuple[str, int], Tuple[list, list]] = {}
        while self._pump_queue and staged < self.stream_experts_per_tick:
            pos, l, e = self._pump_queue.popleft()
            if self.stores[pos].lo_valid[l, e]:
                continue
            resident = True
            if self.lo_resident_total is not None:
                resident = self._lo_quota_left > 0
                if resident:
                    self._lo_quota_left -= 1
            ex, res = batch.setdefault((pos, l), ([], []))
            ex.append(e)
            res.append(resident)
            staged += 1
        for (pos, l), (ex, res) in batch.items():
            try:
                self.stores[pos].stage_lo_batch(self.banks[pos], l, ex, res)
            except RetryExhausted:
                # The staging source exhausted its retries: quarantine the
                # batch (served from host, healed by later re-stages) so one
                # unreadable shard never holds ``serving_ready()`` back, and
                # refund the residency quota it reserved.
                self.stores[pos].quarantine(l, ex)
                if self.lo_resident_total is not None:
                    self._lo_quota_left += sum(res)
        for store in self.stores.values():
            store.publish_lo()
        if not self._pump_queue:
            for store in self.stores.values():
                store.publish_lo(wait=True)
            if all(s.lo_complete for s in self.stores.values()):
                self._serving_ready = True

    def _global_tick(self) -> bool:
        now = time.monotonic()
        # The cadence is read live from the controllers: callers freeze or
        # retune the policy by replacing ``ctl.cfg``, as the per-layer
        # ``maybe_update`` honours it.
        cadence = min((ctl.cfg.update_interval_s
                       for ctl in self.controllers.values()),
                      default=self._cadence)
        if now - self._last_global < cadence:
            for ctl in self.controllers.values():
                ctl.tm.publish_ready()      # copies completed since
            return False
        self._last_global = now
        self._global_update()
        return True

    def _global_update(self) -> None:
        """One global window: fold every position's hotness, weight it by
        sensitivity, stack all layers into one (R, E) value matrix, solve
        the knapsack once, apply the lo quota's demotions and promotions,
        and hand each controller its slice of the hi plan (globally
        ordered, so under a rate limit the hottest promotions anywhere go
        first)."""
        R = len(self._row_pos)
        if R == 0:
            return
        E = self.stores[self._row_pos[0][0]].E
        value = np.zeros((R, E))
        cur_hi = [set() for _ in range(R)]
        use_lo = bool(self.lo_resident_total)
        cur_lo = [set() for _ in range(R)] if use_lo else None
        for pos, off in self._row_offsets.items():
            ctl = self.controllers[pos]
            w = ctl.folded_scores()     # fold + failure-decay penalty
            s = self._sens.get(pos)
            if s is not None:
                w = w * s
            L = ctl.tm.state.shape[0]
            value[off:off + L] = w
            store = self.stores[pos]
            for l in range(L):
                cur_hi[off + l] = ctl.tm.hi_set(l) | \
                    ctl.tm.pending_experts(l)
                if use_lo:
                    cur_lo[off + l] = set(
                        np.nonzero(store.lo_resident[l])[0].tolist())
        asn = self.allocator.allocate(value, cur_hi, cur_lo,
                                      row_caps=self._row_caps)
        if use_lo:
            for r, e in asn.lo_demotions:
                pos, l = self._row_pos[r]
                self.stores[pos].lo_resident[l, e] = False
            for r, e in asn.lo_promotions:
                pos, l = self._row_pos[r]
                store = self.stores[pos]
                if store.lo_valid[l, e]:
                    store.lo_resident[l, e] = True
                else:
                    try:
                        store.stage_lo(self.banks[pos], l, e, resident=True)
                    except RetryExhausted:
                        # The cell stays host-resident (paying the modeled
                        # fetch stall when routed); the allocator chooses
                        # it again next window.
                        continue
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
        if not self._serving_ready:
            self.flush()
        if self.allocator is not None:
            self._global_update()
        else:
            for ctl in self.controllers.values():
                ctl.update()

    def flush(self) -> None:
        """Finish a cold start, wait for every in-flight transition and
        staging, publish, and check the stores' invariants."""
        while not self._serving_ready:
            self._pump()
        for ctl in self.controllers.values():
            ctl.flush()
        for store in self.stores.values():
            store.publish_lo(wait=True)
            store.check_invariants()

    # -- readiness, quarantine, persistence --------------------------------
    def serving_ready(self) -> bool:
        """False only during a streaming cold start: the engine holds
        admission and keeps ticking the backend."""
        return self._serving_ready

    def ready_frac(self) -> float:
        """Residency build-out progress in [0, 1] (1.0 once serving)."""
        if self._serving_ready or not self.stores:
            return 1.0
        return float(np.mean([s.lo_valid.mean()
                              for s in self.stores.values()]))

    def degraded_cells(self) -> Dict[str, np.ndarray]:
        """Position → (L, E) quarantine mask, positions with none omitted:
        the engine flags requests routed through these as degraded."""
        return {pos: s.quarantined for pos, s in self.stores.items()
                if s.quarantined.any()}

    def _heal_quarantined(self, per_tick: int = 2) -> None:
        """Re-stage quarantined cells, a bounded number per window; a
        staging that lands clears the flag at publication. Repeated
        failures just keep the cell quarantined."""
        healed = 0
        for pos, store in self.stores.items():
            if not store.quarantined.any():
                continue
            for l, e in zip(*np.nonzero(store.quarantined)):
                if healed >= per_tick:
                    return
                resident = True
                if self.lo_resident_total is not None:
                    resident = self._lo_quota_left > 0
                    if resident:
                        self._lo_quota_left -= 1
                try:
                    store.stage_lo(self.banks[pos], int(l), int(e),
                                   resident=resident)
                except RetryExhausted:
                    if resident and self.lo_resident_total is not None:
                        self._lo_quota_left += 1
                    continue
                healed += 1

    def save_hotness(self, path: Optional[str] = None) -> None:
        """Persist every position's traffic history (``hotness_path``
        prefix by default): the next cold start stages hottest-first and
        the allocator opens with a warm prior."""
        prefix = path if path is not None else self.hotness_path
        if not prefix:
            raise ValueError("no hotness path configured")
        for pos, ctl in self.controllers.items():
            ctl.hotness.save(f"{prefix}_p{pos}.npz")

    # -- the watchdog's hooks ---------------------------------------------
    def bind_clock(self, clock) -> None:
        """Read promotion ages and injected stalls on the engine clock
        (virtual under replay): the time base of the watchdog's deadline."""
        for ctl in self.controllers.values():
            ctl.tm.clock = clock

    def cancel_stuck_promotions(self, now: float, deadline_s: float) -> int:
        """Cancel the promotions whose copy has not completed
        ``deadline_s`` after it was issued (slot freed, reservation
        refunded once, the expert keeps serving lo)."""
        return sum(ctl.tm.cancel_stuck(now, deadline_s)
                   for ctl in self.controllers.values())

    def pending_promotions(self, now: float) -> list:
        """(position, layer, expert, age_s) of every in-flight promotion."""
        return [(pos, l, e, a) for pos, ctl in self.controllers.items()
                for l, e, a in ctl.tm.pending_ages(now)]

    # -- introspection -----------------------------------------------------
    def hi_sets(self) -> Dict[str, list]:
        return {k: [sorted(ctl.tm.hi_set(l))
                    for l in range(ctl.tm.slot_map_h.shape[0])]
                for k, ctl in self.controllers.items()}

    def residency_mix(self) -> Dict[str, int]:
        """The (layer, expert) cells by tier: published hi, lo-resident and
        host-resident (valid but ceded)."""
        hi = lo = host = 0
        for ctl in self.controllers.values():
            hi += int((ctl.tm.slot_map_h >= 0).sum())
        for store in self.stores.values():
            lo += int(store.lo_resident.sum())
            host += int((~store.lo_resident & store.lo_valid).sum())
        return {"hi": hi, "lo": lo, "host": host}

    def device_bytes(self) -> int:
        """Expert bytes on the device: the lo-resident cells (all cells
        without a host tier) and the hi residents priced at ``hi_bits``."""
        total = 0
        for pos, bank in self.banks.items():
            L, E = bank.slot_map.shape
            store = self.stores.get(pos)
            n_lo = int(store.lo_resident.sum()) \
                if store is not None and self.lo_resident_total else L * E
            ctl = self.controllers.get(pos)
            n_hi_res = int((ctl.tm.slot_owner_h >= 0).sum()) if ctl else 0
            total += self._lo_b[pos] * n_lo + n_hi_res * self._hi_b[pos]
        return total

    def _residency_stats(self):
        # Every STAT_EXTRAS key gets a value, whatever the configuration.
        agg = {"stall_s": 0.0, "bytes_moved": 0.0,
               "promotions": 0.0, "demotions": 0.0, "deferred": 0.0,
               "lo_resident_frac": 1.0, "hi_loads": 0.0, "migrations": 0.0,
               "host_fetches": float(self._host_acct["host_fetches"]),
               "retries": float(self._fault_acct["retries"]),
               "fault_cancels": 0.0, "quarantined": 0.0}
        for ctl in self.controllers.values():
            agg["bytes_moved"] += ctl.tm.stats["bytes_moved"]
            agg["promotions"] += ctl.tm.stats["promoted"]
            agg["demotions"] += ctl.tm.stats["demoted"]
            agg["deferred"] += ctl.tm.stats["deferred"]
            agg["retries"] += ctl.tm.stats["retries"]
            agg["fault_cancels"] += ctl.tm.stats["fault_cancels"]
        agg["bytes_moved"] += self._host_acct["host_fetch_bytes"]
        if self.stores:
            agg["lo_resident_frac"] = float(np.mean(
                [s.lo_resident.mean() for s in self.stores.values()]))
            agg["hi_loads"] = float(sum(
                s.stats["hi_loads"] for s in self.stores.values()))
            agg["bytes_moved"] += sum(
                s.stats["lo_bytes_staged"] for s in self.stores.values())
            agg["retries"] += sum(
                s.stats["retries"] for s in self.stores.values())
            # A live gauge: cells host-served now because their staging
            # source kept failing.
            agg["quarantined"] = float(sum(
                int(s.quarantined.sum()) for s in self.stores.values()))
        agg["residency_ready_frac"] = self.ready_frac()
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

    _tier_counts = staticmethod(_dense_tier_counts)

    def residency_mix(self) -> Dict[str, int]:
        hi = sum(len(lru) for lru in self.lru.values())
        E = self.cfg.moe.num_experts if self.cfg is not None else 0
        return {"hi": hi, "lo": 0,
                "host": max(0, self.n_moe_layers * E - hi)}

    def obs_meta(self) -> Dict[str, int]:
        return {"lo_bytes": 0, "hi_bytes": self.expert_bytes}

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
