"""Fault injection and fault tolerance of the port's transfer plane: seeded
counter-based fault plans (``inject``), the shared retry policy whose
backoff is modeled, never slept (``retry``), and the engine-step watchdog
(``watchdog``)."""
from repro_torch.fault.inject import (Fault, FaultInjector, FaultPlan,
                                      FaultRule, TransferFault)
from repro_torch.fault.retry import RetryExhausted, RetryPolicy, retry_call
from repro_torch.fault.watchdog import Watchdog, WatchdogConfig

__all__ = ["Fault", "FaultInjector", "FaultPlan", "FaultRule",
           "RetryExhausted", "RetryPolicy", "TransferFault", "Watchdog",
           "WatchdogConfig", "retry_call"]
