"""Counters / gauges / histograms registry with per-step sampling (the
port's copy of the reference's numpy-only module).

The registry complements the flight recorder: where the trace records
*events*, metrics record *levels* — per-step gauges (active experts, pad
ratio, residency mix, budget headroom, queue depths, acceptance EMA),
monotone counters, and latency histograms (promotion publish latency).

Two sinks:

* ``to_prometheus()`` — Prometheus text exposition (scrape or dump);
* a JSONL sink — ``sample(**row)`` appends one flat JSON object per engine
  step, the easy input for pandas/jq and the obs benchmark.

Everything here is plain host-side Python; like the recorder, the engine
only touches it behind ``metrics is not None`` guards.
"""
from __future__ import annotations

import json
from typing import Dict, IO, List, Optional, Sequence

import numpy as np

_DEF_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)


class Counter:
    """Monotone counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += v


class Gauge:
    """Last-write-wins level."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Cumulative-bucket histogram that also keeps a bounded raw sample so
    exact percentiles (promotion publish p50/p95) stay available without a
    bucket-interpolation fudge."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = _DEF_BUCKETS,
                 max_samples: int = 1 << 16):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +inf bucket
        self.total = 0
        self.sum = 0.0
        self._samples: List[float] = []
        self._max_samples = max_samples

    def observe(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), p))


class MetricsRegistry:
    """Name-keyed metric store + samplers. Metric creation is memoized, so
    instrumentation sites call ``registry.gauge("x").set(v)`` unconditionally
    without registration ceremony."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._metrics: Dict[str, object] = {}
        self._jsonl: Optional[IO] = None
        self.jsonl_path = jsonl_path
        if jsonl_path:
            self._jsonl = open(jsonl_path, "w")

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = _DEF_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets)

    # -- sinks -------------------------------------------------------------
    def sample(self, **row) -> None:
        """Append one JSONL record (no-op without a configured sink).
        Callers pass the per-step values explicitly — the record is the
        step's snapshot, not the registry dump."""
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(row, sort_keys=True) + "\n")

    def snapshot(self) -> Dict[str, float]:
        """Flat name → value view (histograms export count/sum/p50/p95)."""
        out: Dict[str, float] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.total)
                out[f"{name}_sum"] = m.sum
                out[f"{name}_p50"] = m.percentile(50)
                out[f"{name}_p95"] = m.percentile(95)
            else:
                out[name] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                kind = "counter"
            elif isinstance(m, Gauge):
                kind = "gauge"
            else:
                kind = "histogram"
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.total}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.total}")
            else:
                lines.append(f"{name} {m.value:g}")
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
