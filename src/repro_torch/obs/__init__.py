"""Observability of the port: flight-recorder tracing, metrics, the trace
cost model (the port's copy of the reference's ``obs`` package, which
imports no JAX: the same events give the same trace bytes in both).

``Observability`` bundles the two live components the serving engine
threads through the stack:

* ``tracer`` — a ``FlightRecorder`` (bounded typed-event ring buffer,
  Chrome trace-event export) whose clock the engine rebinds to its own
  ``_now()`` so virtual-clock replays trace deterministically;
* ``metrics`` — a ``MetricsRegistry`` (counters/gauges/histograms,
  Prometheus text exposition, optional JSONL per-step sink).

Both are optional and independently disableable; a ``None`` observability
object (the default everywhere) keeps every instrumentation site a pointer
check — the decode hot path is untouched.

``obs.costmodel`` replays a recorded trace offline into measured
bytes/token and validates ``launch/roofline.py``'s analytic model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.trace import (  # noqa: F401
    FlightRecorder, TraceEvent, load_chrome_trace)


@dataclasses.dataclass
class ObsConfig:
    trace: bool = True               # flight recorder on?
    trace_capacity: int = 1 << 16    # ring-buffer events
    metrics: bool = True             # metrics registry on?
    metrics_jsonl: Optional[str] = None   # per-step JSONL sink path
    sample_every: int = 1            # metrics sampling cadence (steps)


class Observability:
    """The engine-facing bundle: construct once, pass to
    ``InferenceEngine(..., obs=...)``."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg if cfg is not None else ObsConfig()
        self.tracer: Optional[FlightRecorder] = \
            FlightRecorder(self.cfg.trace_capacity) if self.cfg.trace \
            else None
        self.metrics: Optional[MetricsRegistry] = \
            MetricsRegistry(self.cfg.metrics_jsonl) if self.cfg.metrics \
            else None

    def save_trace(self, path: str) -> None:
        if self.tracer is None:
            raise ValueError("tracing disabled (ObsConfig.trace=False)")
        self.tracer.save(path)

    def summary(self) -> Dict:
        """Shutdown one-liner material: promotion publish percentiles and
        the roofline residual (from the live recorder) plus the metrics
        snapshot."""
        out: Dict = {}
        if self.tracer is not None:
            from repro_torch.obs import costmodel
            out.update(costmodel.report(self.tracer))
            out["trace_events"] = len(self.tracer)
            out["trace_dropped"] = self.tracer.dropped
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        return out

    def close(self) -> None:
        if self.metrics is not None:
            self.metrics.close()


__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
    "ObsConfig", "Observability", "TraceEvent", "load_chrome_trace",
]
