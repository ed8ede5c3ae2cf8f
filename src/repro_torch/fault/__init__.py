"""Fault tolerance of the port: the engine-step watchdog (``watchdog``)."""
from repro_torch.fault.watchdog import Watchdog, WatchdogConfig

__all__ = ["Watchdog", "WatchdogConfig"]
