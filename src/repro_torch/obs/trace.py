"""Flight recorder: a bounded ring buffer of typed serving events (the
port's copy of the reference's pure-Python module: the same events save to
the same bytes).

The recorder is the serving stack's black box. Every interesting host-side
transition — engine steps, admissions, preemptions, the promotion pipeline's
``issue → copy → publish`` phases, EP ownership migrations, host-tier demand
fetches, speculative rounds, shed/downgrade decisions — lands here as a
typed event stamped on the **engine clock** (``InferenceEngine._now``):
wall time normally, the virtual clock under ``replay(realtime=False)``, so
CI replays produce byte-identical trace files while realtime runs produce
perfetto-viewable timelines.

Design constraints, in order:

* **Zero cost when absent.** No recorder instance ⇒ no event objects, no
  dict building, nothing — every instrumentation site guards on
  ``tracer is not None`` before touching arguments. The decode hot path is
  identical with observability disabled.
* **Bounded.** The buffer is a ``deque(maxlen=capacity)``; overflow drops
  the oldest events and counts them (``dropped``) instead of growing.
* **Deterministic export.** ``save()`` emits Chrome trace-event JSON with
  sorted keys and no wall-clock metadata, so two runs with identical event
  streams write identical bytes.

Event vocabulary (``name`` / ``cat``):

========================  ==========  =========================================
name                      cat         args
========================  ==========  =========================================
``step``                  engine      step, active, queued, active_experts,
                                      hi/lo/host residency cells, headroom
``moe_forward``           moe         routed, layers, active, active_hi,
                                      active_lo, active_host, published_hi,
                                      tokens, prefill — the cost model's input
``submit``/``shed``/      sched       rid, qos
``downgrade``/
``shed_expired``
``admit``/``finish``/     sched       rid, slot (…)
``preempt``/``resume``
``promo_request``/        residency   layer, expert (…)
``demo_request``/
``demotion``/
``promo_deferred``
``promotion``             residency   async span: begin at copy issue
                                      (layer/expert/slot/bytes), end at
                                      publish (published=1) or cancellation
``ep_migration``          ep          layer, expert, peer, bytes (an
                                      expert-parallel ownership swap)
``host_fetch``            host        pos, n, bytes, stall_s
``host_stage``/           host        layer(s), n, bytes
``lo_publish``
``spec_round``            spec        rows, drafted, accepted
``fault_injected``        fault       site, kind, seq (injector fired)
``retry``                 fault       site, attempt, backoff_s — includes
                                      host demand-fetch re-reads
``fault_cancel``          fault       layer, expert, reason (promotion or
                                      migration aborted after retries)
``promo_timeout``         fault       layer, expert, age_s (watchdog
                                      cancelled a stuck promotion)
``watchdog_cancel``       fault       rid, idle_s (no-progress request
                                      preempted and requeued)
``quarantine``            fault       layer, n, experts served from host
                                      until their lo rows re-stage
========================  ==========  =========================================
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceEvent:
    """One flight-recorder entry. ``ph`` follows the Chrome trace-event
    phase vocabulary: ``i`` instant, ``B``/``E`` duration span,
    ``b``/``e`` async span (paired by ``id``)."""

    ts: float                       # seconds on the engine clock
    ph: str
    name: str
    cat: str = ""
    id: Optional[int] = None        # async-span correlation id
    args: Optional[Dict] = None


class FlightRecorder:
    """Bounded typed-event ring buffer with a span API and Chrome export.

    ``clock`` is injected by the engine (``engine._now``) so replay runs
    under the virtual clock produce deterministic timestamps; standalone
    use falls back to ``time.perf_counter``.
    """

    def __init__(self, capacity: int = 1 << 16,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock: Callable[[], float] = clock or time.perf_counter
        self._events: deque[TraceEvent] = deque(maxlen=self.capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        #: Run-level metadata (model/dispatch constants) exported with the
        #: trace — the cost-model replayer reads its byte prices from here.
        self.meta: Dict = {}

    # -- recording --------------------------------------------------------
    def _push(self, ev: TraceEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        self._push(TraceEvent(self.clock(), "i", name, cat,
                              args=args or None))

    def begin(self, name: str, cat: str = "", **args) -> None:
        self._push(TraceEvent(self.clock(), "B", name, cat,
                              args=args or None))

    def end(self, name: str, cat: str = "", **args) -> None:
        self._push(TraceEvent(self.clock(), "E", name, cat,
                              args=args or None))

    def next_id(self) -> int:
        """Fresh correlation id for an async span (promotion lifecycle)."""
        return next(self._ids)

    def async_begin(self, name: str, span_id: int, cat: str = "",
                    **args) -> None:
        self._push(TraceEvent(self.clock(), "b", name, cat, id=span_id,
                              args=args or None))

    def async_end(self, name: str, span_id: int, cat: str = "",
                  **args) -> None:
        self._push(TraceEvent(self.clock(), "e", name, cat, id=span_id,
                              args=args or None))

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def instants(self, name: str) -> List[TraceEvent]:
        return [e for e in self._events if e.ph == "i" and e.name == name]

    def spans(self, name: str) -> List[Tuple[TraceEvent, TraceEvent]]:
        """Completed async spans of ``name``, paired by correlation id, in
        begin order. Unmatched begins (still in flight, or whose partner
        fell off the ring) are omitted."""
        begins: Dict[int, TraceEvent] = {}
        out: List[Tuple[TraceEvent, TraceEvent]] = []
        for e in self._events:
            if e.name != name or e.id is None:
                continue
            if e.ph == "b":
                begins[e.id] = e
            elif e.ph == "e" and e.id in begins:
                out.append((begins.pop(e.id), e))
        return out

    # -- export -----------------------------------------------------------
    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON object (perfetto / chrome://tracing).
        Timestamps convert to microseconds; the category doubles as the
        track (pid=0, tid=cat) so each subsystem gets its own lane."""
        evs = []
        for e in self._events:
            d: Dict = {"name": e.name, "ph": e.ph, "cat": e.cat or "misc",
                       "ts": round(e.ts * 1e6, 3), "pid": 0,
                       "tid": e.cat or "misc"}
            if e.id is not None:
                d["id"] = e.id
            if e.args:
                d["args"] = e.args
            evs.append(d)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": dict(self.meta, dropped_events=self.dropped)}

    def save(self, path: str) -> None:
        """Write the Chrome trace JSON. Deterministic: sorted keys, fixed
        separators, no wall-clock metadata — under the virtual clock two
        identical replays produce byte-identical files."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, sort_keys=True,
                      separators=(",", ":"))
            f.write("\n")


def load_chrome_trace(path: str) -> Dict:
    """Read a trace written by ``FlightRecorder.save`` (or any Chrome
    trace-event JSON object with a ``traceEvents`` list)."""
    with open(path) as f:
        return json.load(f)
