"""Expert-residency backends of the port's serving engine.

* ``StaticPTQBackend`` — every expert serves from the always-resident lo
  tier (the paper's static baseline).
* ``DynaExqBackend`` — the paper's system with its per-layer rule: a hi
  bf16 slot pool per layer, hotness → top-n policy → promotion copies from
  pinned host masters → publish. (No host tier, streaming, fault injection
  or expert parallelism in this port yet.)

Protocol, as the reference's: ``materialize_banks`` builds the device
tiers and returns {MoE position: ExpertBankQ}; ``observe`` takes one
forward's router counts (row-resolved counts are scrubbed by ``row_valid``
first); ``tick`` runs the policy window; ``stats`` returns exactly
``STAT_KEYS + STAT_EXTRAS``; ``flush`` waits for in-flight transitions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.controller import ControllerConfig, DynaExqController
from repro_torch.core.hotness import mask_row_counts
from repro_torch.core.ver import (build_bank, expert_hi_nbytes,
                                  expert_lo_nbytes)
from repro_torch.models.config import ArchConfig

#: Keys every backend's ``stats()`` returns (zeros where N/A) — the
#: reference's uniform schema.
STAT_KEYS = ("ttft_s", "tpot_s", "stall_s", "bytes_moved",
             "promotions", "demotions",
             "accept_rate", "draft_tokens", "verified_tokens", "spec_rounds",
             "active_experts", "dispatch_pad_ratio",
             "preemptions", "resumes", "shed_requests", "downgraded",
             "host_fetches", "retries", "fault_cancels")


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
        self._observe_residency(cleaned)
        (self._ttft if prefill else self._tpot).append(compute_s)
        return 0.0

    def _observe_residency(self, counts: Dict) -> None:
        pass

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
    """DynaExq with the paper's per-layer rule: each layer keeps the top
    ``n_hi_per_layer`` experts by hotness in bf16, the rest serve int
    ``lo_bits``; promotions copy from pinned host masters on a side stream
    and publish once their copy completed. The host store is a dict of
    (L, E, K, N) bf16 tensors indexed ``[layer, expert]``."""

    name = "dynaexq"
    STAT_EXTRAS = ("deferred", "lo_resident_frac", "hi_loads",
                   "residency_ready_frac", "migrations", "quarantined")

    def __init__(self, lo_bits: int = 4, group_size: int = 64,
                 n_hi_per_layer: Optional[int] = None,
                 controller: Optional[ControllerConfig] = None,
                 device=None):
        super().__init__(device)
        self.lo_bits = lo_bits
        self.group_size = group_size
        self.n_hi_per_layer = n_hi_per_layer
        self.controller_cfg = controller
        self.controllers: Dict[str, DynaExqController] = {}
        self.banks: Dict = {}
        self.host_hi: Dict[str, Dict[str, torch.Tensor]] = {}
        self._lo_b: Dict[str, int] = {}
        self._hi_b: Dict[str, int] = {}
        # (layer, expert) cells routed while published hi: every such cell
        # was computed from its hi slot (a hi tile of the ragged kernels,
        # or the bf16 overlay of the padded dispatch).
        self.hi_routed = 0

    def _materialize(self, cfg, params, kv_bytes):
        pin = self.device.type == "cuda"
        for pos in self.moe_positions:
            pos = str(pos)
            moe = params["blocks"][pos]["moe"]
            experts = moe["experts"]
            shapes = _shapes(experts)
            L, E = experts["w_gate"].shape[:2]
            n_hi = self.n_hi_per_layer if self.n_hi_per_layer is not None \
                else max(1, E // 8)
            hi_b = expert_hi_nbytes(shapes)
            self._hi_b[pos] = hi_b
            self._lo_b[pos] = expert_lo_nbytes(shapes, self.lo_bits,
                                               self.group_size)
            host = {}
            for k, v in experts.items():
                h = v.to("cpu")
                host[k] = h.pin_memory() if pin else h.clone()
            self.host_hi[pos] = host
            bank = build_bank({k: v.to(self.device)
                               for k, v in experts.items()}, n_hi=n_hi,
                              lo_bits=self.lo_bits,
                              group_size=self.group_size)
            self.banks[pos] = bank
            tracker = None
            if self.budget is not None:
                tracker = self.budget.view(f"hi:{pos}", cap=n_hi * L * hi_b)
            if n_hi > 0:
                self.controllers[pos] = DynaExqController(
                    bank, host, n_hi_per_layer=n_hi,
                    hi_bytes_per_expert=hi_b, cfg=self.controller_cfg,
                    tracker=tracker)
            moe["experts"] = None
        return self.banks

    def _observe_residency(self, counts):
        for k, ctl in self.controllers.items():
            c = counts.get(k)
            if c is None:
                continue
            ctl.observe(c)
            self.hi_routed += int(((c > 0) & (ctl.tm.slot_map_h >= 0)).sum())

    def tick(self) -> None:
        for ctl in self.controllers.values():
            ctl.maybe_update()

    def force_update(self) -> None:
        for ctl in self.controllers.values():
            ctl.update()

    def flush(self) -> None:
        for ctl in self.controllers.values():
            ctl.flush()

    def hi_sets(self) -> Dict[str, list]:
        return {k: [sorted(ctl.tm.hi_set(l))
                    for l in range(ctl.tm.slot_map_h.shape[0])]
                for k, ctl in self.controllers.items()}

    def device_bytes(self) -> int:
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


BACKENDS = {"static": StaticPTQBackend, "dynaexq": DynaExqBackend}


def make_backend(name: str, **kwargs):
    """Registry factory: ``make_backend("dynaexq", n_hi_per_layer=2)``.
    Runs on ``cuda`` unless ``device="cpu"`` is passed."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"one of {sorted(BACKENDS)}") from None
    return cls(**kwargs)
