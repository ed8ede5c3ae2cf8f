"""Engine-step-driven watchdog for stuck promotions and stuck requests (the
port's copy of the reference's ``repro.fault.watchdog``; numpy-free, no
device work).

``InferenceEngine.step()`` calls ``scan(engine)`` once per step, only when
a deadline is configured. Two sweeps:

* **Promotions** in flight longer than ``promo_deadline_s`` (engine-clock
  age since their copy was issued) are cancelled through the backend's
  ``cancel_stuck_promotions``: the slot frees, the reservation is refunded
  exactly once, and the expert keeps serving lo.
* **Requests** RUNNING with no token appended for ``no_progress_s`` are
  preempted back to the front of their QoS tier (the snapshot resume is
  bit-exact: the request is requeued, not failed).

Every age is read on the engine clock, so a virtual-clock replay takes the
same watchdog decisions as a run on the wall clock.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    promo_deadline_s: Optional[float] = None
    no_progress_s: Optional[float] = None


class Watchdog:
    def __init__(self, cfg: WatchdogConfig):
        self.cfg = cfg
        self.stats = {"promo_timeouts": 0, "request_requeues": 0}

    def scan(self, engine) -> int:
        """One sweep over in-flight promotions and RUNNING requests.
        Returns the number of cancels and requeues."""
        now = engine._now()
        n = 0
        if self.cfg.promo_deadline_s is not None:
            cancel = getattr(engine.backend, "cancel_stuck_promotions", None)
            if cancel is not None:
                k = cancel(now, self.cfg.promo_deadline_s)
                self.stats["promo_timeouts"] += k
                n += k
        if self.cfg.no_progress_s is not None:
            for h in list(engine.slots):
                # Only requests that emitted a token carry a progress
                # stamp; younger ones are the admission-stall check's.
                if h is None or not h.last_progress_s:
                    continue
                if h.state.value != "running":
                    continue
                if now - h.last_progress_s <= self.cfg.no_progress_s:
                    continue
                engine.preempt(h)
                h.last_progress_s = now
                engine.counters["watchdog_cancels"] += 1
                self.stats["request_requeues"] += 1
                n += 1
        return n
