"""HBM budget admission control (paper §3.3); the port's copy of the
reference's numpy-only ledger and its one-shot envelope planner
(``plan_budget``; the three-tier ``plan_hierarchy`` comes with the host
tier).

``BudgetTracker`` is the runtime admission gate: every promotion must
``try_reserve`` its bytes before it may enter the transition pipeline, so the
hi pool can never overflow — budget feasibility by construction.

A tracker can be split into named **accounts** (``tracker.view("kv")``):
every view reserves against the one shared envelope — so KV-cache block
admission and expert hi-tier promotions genuinely contend for the same
bytes — while each view's ``used``/``cap`` report only its own account
(per-subsystem invariants stay checkable). ``UNBOUNDED`` is the sentinel
cap for "no global envelope configured".
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

#: Sentinel cap for a tracker that never binds (no device envelope given).
UNBOUNDED = 1 << 62


class BudgetExceeded(Exception):
    pass


class BudgetTracker:
    """Thread-safe byte reservation ledger over one shared envelope.

    Reservations are tagged with an ``account`` name (default ``"default"``)
    so several subsystems can draw from the same cap while keeping their own
    books; ``view(account)`` wraps one account behind the classic
    try_reserve/release/used/free interface.
    """

    def __init__(self, cap_bytes: int):
        if cap_bytes < 0:
            raise ValueError("cap must be >= 0")
        self.cap = int(cap_bytes)
        self._used = 0
        self._accounts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        return self._used

    @property
    def free(self) -> int:
        return self.cap - self._used

    def headroom_frac(self) -> float:
        """Fraction of the envelope still free, as a load signal (the QoS
        scheduler's shed policy keys on it). An unbounded tracker always
        reports full headroom — no envelope, no byte pressure."""
        if self.cap >= UNBOUNDED:
            return 1.0
        return self.free / max(1, self.cap)

    def used_by(self, account: str) -> int:
        return self._accounts.get(account, 0)

    def try_reserve(self, nbytes: int, account: str = "default",
                    account_cap: Optional[int] = None) -> bool:
        with self._lock:
            if self._used + nbytes > self.cap:
                return False
            held = self._accounts.get(account, 0)
            if account_cap is not None and held + nbytes > account_cap:
                return False
            self._used += nbytes
            self._accounts[account] = held + nbytes
            return True

    def release(self, nbytes: int, account: str = "default") -> None:
        with self._lock:
            held = self._accounts.get(account, 0) - nbytes
            if held < 0:
                raise BudgetExceeded(
                    f"account {account!r} released more than reserved")
            self._accounts[account] = held
            self._used -= nbytes
            if self._used < 0:
                raise BudgetExceeded("released more than reserved")

    def view(self, account: str, cap: Optional[int] = None) -> "BudgetView":
        """An account-scoped handle with the classic tracker interface."""
        return BudgetView(self, account, cap)


class BudgetView:
    """One account of a shared ``BudgetTracker``.

    Duck-types the tracker interface (``try_reserve``/``release``/``used``/
    ``free``/``cap``): ``used`` reports only this account's bytes (so e.g.
    ``TransitionManager.check_invariants`` stays exact), while every
    reservation is gated by the PARENT envelope too — pressure from sibling
    accounts (KV blocks vs hi-tier experts) defers admission here.
    """

    def __init__(self, parent: BudgetTracker, account: str,
                 cap: Optional[int] = None):
        self.parent = parent
        self.account = account
        self._cap = cap

    @property
    def cap(self) -> int:
        return self._cap if self._cap is not None else self.parent.cap

    @property
    def used(self) -> int:
        return self.parent.used_by(self.account)

    @property
    def free(self) -> int:
        """Bytes this account could still reserve — the tighter of its own
        cap and the shared envelope's headroom."""
        return min(self.cap - self.used, self.parent.free)

    def try_reserve(self, nbytes: int) -> bool:
        return self.parent.try_reserve(nbytes, account=self.account,
                                       account_cap=self._cap)

    def release(self, nbytes: int) -> None:
        self.parent.release(nbytes, account=self.account)


@dataclasses.dataclass(frozen=True)
class BudgetPlan:
    m_total: int          # usable device bytes
    m_fixed: int          # non-expert params + KV cache + activations
    m_lo: int             # always-resident lo-pool bytes
    m_hi_cap: int         # hi-pool envelope
    n_hi_per_layer: int   # derived per-layer hi capacity (experts)

    def check(self):
        if self.m_fixed + self.m_lo + self.m_hi_cap > self.m_total:
            raise BudgetExceeded(
                f"infeasible: fixed {self.m_fixed} + lo {self.m_lo} + hi "
                f"{self.m_hi_cap} > total {self.m_total}")


def plan_budget(m_total: int, m_fixed: int, lo_bytes_total: int,
                hi_bytes_per_expert_layer: int, n_layers: int,
                num_experts: int, align: int = 1) -> BudgetPlan:
    """Budget initialization: everything left after fixed + lo goes to the hi
    pool, expressed as a per-layer expert count (the paper's n_hi,l).

    ``align``: round n_hi down to a multiple (e.g. the model-parallel degree,
    so each shard owns an integer number of hi slots).
    """
    if m_fixed + lo_bytes_total > m_total:
        raise BudgetExceeded(
            f"lo tier alone does not fit: fixed {m_fixed} + lo "
            f"{lo_bytes_total} > total {m_total}")
    remaining = m_total - m_fixed - lo_bytes_total
    n_hi = remaining // (hi_bytes_per_expert_layer * n_layers)
    n_hi = min(int(n_hi), num_experts)
    if align > 1:
        n_hi = n_hi // align * align
    plan = BudgetPlan(
        m_total=m_total, m_fixed=m_fixed, m_lo=lo_bytes_total,
        m_hi_cap=n_hi * hi_bytes_per_expert_layer * n_layers,
        n_hi_per_layer=int(n_hi))
    plan.check()
    return plan
