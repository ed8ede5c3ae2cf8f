"""Pinned host-DRAM expert store — the third tier of the residency ladder
(the port's counterpart of the reference's ``serving/hoststore.py``).

The ladder is hi-bf16 ↔ lo-int4/int2 ↔ host-DRAM, all governed by the global
allocator (``core.allocator``). This module owns everything host-side:

* the **hi source** rows ``TransitionManager`` copies from on promotion:
  bf16 rows indexed ``[layer, expert]`` per weight name, either pinned
  (L, E, K, N) tensors materialized up front (the dense experts, the
  classic path) or filled lazily from checkpoint shards through
  ``hi_loader`` (streaming cold start: a promotion's ``ensure_hi`` reads
  its expert's shard, so the hi and host tiers backfill in hotness order).
  Under expert parallelism a rank's materialized rows are those of the
  experts it owns (``owned``, its model rank's ``[j·E/N, (j+1)·E/N)``):
  only it copies them into its slots, and the union over a model group
  is the one host copy the reference's single controller keeps (a
  streaming store serves one shard, and holds every expert).
  A lazy store pins each expert's rows when they load (``_LazyHiRows``):
  pinned memory is committed and page-locked when allocated, so an
  (L, E, K, N) buffer up front would hold the whole hi tier in host RAM
  before serving opens. The reference keeps float32 here; the shards hold
  bf16 values widened to float32, so narrowing them back is exact and the
  port's host tier takes half the memory;
* the **lo staging pipeline**: host→lo promotion and cold-start backfill
  copy the packed lo rows from pinned host buffers with
  ``non_blocking=True`` on the side stream promotions use, in place into
  the bank (``ver.write_lo_rows``), and record one event per pending
  entry. ``publish_lo`` flips the residency masks of an entry only once
  ITS event has completed (publish-then-switch, as for hi slots). Before
  the side stream overwrites rows, it waits on an event recorded on the
  compute stream: a forward already queued may read those rows (a
  quarantined cell being healed; its requests are flagged degraded until
  the heal publishes). The cold-start pump writes rows no forward reads
  yet (the engine holds admission until ``lo_complete``);
* the residency masks: ``lo_valid`` (device lo rows hold real weights —
  monotone under serving, the cold-start gate) and ``lo_resident`` (the
  allocator's accounting: a valid-but-nonresident cell has been demoted to
  the host tier and pays a modeled demand-fetch stall when routed);
* the ``FetchModel`` transfer-cost model shared with ``OffloadBackend``.

The store duck-types the ``host_hi`` mapping interface (``items`` /
``__getitem__`` / ``__setitem__``) that ``TransitionManager`` speaks, plus
``ensure_hi`` for lazy shard loads. Host loads and staging retry under
``retry`` and consult ``injector`` (``fault.inject``); a cell whose staging
exhausts its retries is quarantined: served from the host tier (the device
rows stay unreal, routed requests are flagged degraded) until a later
staging lands and heals it. On the CPU every copy completes at once.
A flight recorder bound by the backend (``tracer``) records the reference's
``host_stage``, ``lo_publish`` and ``quarantine`` events and the retries.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.ver import ExpertBankQ, write_lo_expert, write_lo_rows
from repro_torch.fault.inject import TransferFault
from repro_torch.fault.retry import RetryExhausted, RetryPolicy, retry_call
from repro_torch.launch.dist import all_true


@dataclasses.dataclass
class FetchModel:
    """Deterministic host↔device transfer-cost model: bytes over ``gbps``
    (16.0, PCIe gen4 x16, is the paper's A6000; give the card's measured
    pinned copy rate to price this card's link). Layered on measured
    compute so backend comparisons reflect transfer volume, not noise."""

    gbps: float = 16.0

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9

    def stall_s(self, demand_bytes: int, overlap_bytes: int = 0,
                compute_s: float = 0.0) -> float:
        """Critical-path seconds: demand fetches always stall; overlapped
        (prefetch) bytes hide under ``compute_s`` and only their spill
        stalls."""
        spill = max(0.0, overlap_bytes - compute_s * self.bytes_per_s)
        return (demand_bytes + spill) / self.bytes_per_s


@dataclasses.dataclass
class _PendingLo:
    layer: int
    experts: np.ndarray       # (n,) staged experts of ``layer``
    resident: np.ndarray      # (n,) reserve-accounted (vs transient)
    nbytes: int
    event: Optional[torch.cuda.Event]   # None: completed (CPU)
    src: tuple                # the pinned sources, alive until published


class _LazyHiRows:
    """One weight's host hi rows of a streaming store: ``[layer, expert]``
    → a (K, N) bf16 tensor, pinned on a card, present once ``ensure_hi``
    loaded the expert."""

    def __init__(self, shape: tuple):
        self.shape = tuple(shape)
        self.rows: Dict[tuple, torch.Tensor] = {}

    def __getitem__(self, idx) -> torch.Tensor:
        layer, expert = idx
        return self.rows[(int(layer), int(expert))]


class _OwnedRows:
    """One weight's materialized host hi rows: the (L, n, K, N) rows
    ``held`` of experts ``[lo, lo + n)``, read by global expert id."""

    def __init__(self, held: torch.Tensor, lo: int = 0):
        self.held = held
        self.lo = int(lo)

    def __getitem__(self, idx) -> torch.Tensor:
        layer, expert = idx
        n = self.held.shape[1]
        if not self.lo <= expert < self.lo + n:
            raise KeyError(f"expert {expert}'s host rows are held by its "
                           f"owner; this store holds [{self.lo}, "
                           f"{self.lo + n})")
        return self.held[layer, expert - self.lo]


class HostExpertStore:
    def __init__(self, shapes: Dict[str, tuple],
                 hi: Optional[Dict[str, torch.Tensor]] = None,
                 hi_loader: Optional[Callable[[int, int],
                                              Dict[str, np.ndarray]]] = None,
                 lo_loader: Optional[Callable[[int],
                                              Dict[str, np.ndarray]]] = None,
                 lo_valid_init: bool = True, device="cpu",
                 owned: Optional[slice] = None):
        """``shapes``: name → (L, E, K, N) dense shapes. ``hi``: the
        materialized bf16 host rows, (L, n_owned, K, N), of the experts
        ``owned`` (None: every expert; pinned when ``device`` is a card).
        ``hi_loader(l, e)``: lazy per-expert source (streaming), float32
        numpy rows, narrowed to bf16 and pinned one expert at a time.
        ``lo_loader(l)``: per-layer packed lo rows, keys
        ``f"{name}.packed"`` (uint8) / ``f"{name}.scales"`` (float32) with
        leading dim E. ``device``: the banks' device; on a card the staging
        copies run on ``side`` (the promotions' stream, bound by the
        backend; a stream of its own otherwise)."""
        first = next(iter(shapes.values()))
        self.L, self.E = int(first[0]), int(first[1])
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if hi is None and hi_loader is None:
            raise ValueError("need materialized hi rows or a hi_loader")
        self.owned = owned if owned is not None else slice(0, self.E)
        if hi is not None:
            n_owned = self.owned.stop - self.owned.start
            for n, t in hi.items():
                if tuple(t.shape[:2]) != (self.L, n_owned):
                    raise ValueError(f"{n}: host rows {tuple(t.shape)} for "
                                     f"the {n_owned} owned experts of "
                                     f"{self.L} layers")
        self.hi = {n: _OwnedRows(t, self.owned.start) for n, t in hi.items()} \
            if hi is not None else {
                n: _LazyHiRows(s) for n, s in sorted(shapes.items())}
        # The grid's book, the same on every rank: an expert's rows are
        # present once its owner holds them.
        self.hi_present = np.full((self.L, self.E), hi is not None, bool)
        self._hi_loader = hi_loader
        self._lo_loader = lo_loader
        self._lo_cache: tuple = (None, None)
        self.lo_valid = np.full((self.L, self.E), lo_valid_init, bool)
        self.lo_resident = self.lo_valid.copy()
        self._staging: List[_PendingLo] = []
        self.side: Optional[torch.cuda.Stream] = None
        self.stats = {"hi_loads": 0, "hi_bytes_loaded": 0,
                      "lo_staged": 0, "lo_bytes_staged": 0,
                      "retries": 0, "retry_stall_s": 0.0, "quarantines": 0}
        self.injector = None    # fault.inject.FaultInjector
        self.retry = RetryPolicy()
        self.tracer = None      # obs.FlightRecorder, bound by the backend
        # launch.dist.DistContext, bound by the backend: a staging publishes
        # once it completed on every rank of the grid.
        self.dist = None
        self.quarantined = np.zeros((self.L, self.E), bool)

    # -- host_hi mapping interface (TransitionManager, EPCoordinator) -----
    def items(self):
        return self.hi.items()

    def __getitem__(self, name: str):
        return self.hi[name]

    def __setitem__(self, name: str, arr) -> None:
        self.hi[name] = arr

    def held_rows(self) -> Dict[str, torch.Tensor]:
        """name → the (L, n_owned, K, N) materialized rows this store holds
        (what an expert-parallel relabel exchanges)."""
        return {n: a.held for n, a in self.hi.items()}

    def pinned_bytes(self) -> int:
        """Bytes of the bf16 hi rows this store holds on the host."""
        total = 0
        for a in self.hi.values():
            rows = [a.held] if isinstance(a, _OwnedRows) else a.rows.values()
            total += sum(t.numel() * t.element_size() for t in rows)
        return total

    def swap_experts(self, layer: int, e: int, f: int) -> None:
        """An expert-parallel relabel: the residency and presence masks
        follow their expert (the coordinator moves the hi rows between
        their owners, ``held_rows``)."""
        for m in (self.hi_present, self.lo_valid, self.lo_resident,
                  self.quarantined):
            m[layer, [e, f]] = m[layer, [f, e]]

    # -- fault plumbing ---------------------------------------------------
    def _seed(self) -> int:
        return self.injector.seed if self.injector is not None else 0

    def _fire(self, site: str, **ctx) -> None:
        """Evaluate the fault plan at a host-transfer site. ``stall`` is
        absorbed as modeled stall seconds; ``fail`` raises a retryable
        `TransferFault`; ``corrupt`` is a failed checksum — also retried."""
        if self.injector is None:
            return
        f = self.injector.fire(site, **ctx)
        if f is None:
            return
        if f.kind == "stall":
            self.stats["retry_stall_s"] += f.stall_s
            return
        raise TransferFault(site, kind=f.kind, seq=f.seq)

    def _retry(self, fn, site: str, key: int):
        """Run one host transfer under the shared retry policy, accounting
        retries + modeled backoff. `RetryExhausted` propagates to the
        caller's graceful-degradation path."""
        try:
            out, retries, waited = retry_call(
                fn, self.retry, seed=self._seed(), key=key, site=site,
                tracer=self.tracer)
        except RetryExhausted as e:
            # The attempts were still made (and their backoff modeled).
            self.stats["retries"] += e.attempts - 1
            self.stats["retry_stall_s"] += e.waited_s
            raise
        if retries:
            self.stats["retries"] += retries
            self.stats["retry_stall_s"] += waited
        return out

    # -- hi tier (host side) ----------------------------------------------
    def ensure_hi(self, layer: int, expert: int) -> None:
        """Materialize one expert's host hi rows (lazy shard read). Called
        by ``TransitionManager._issue_copy`` right before the copy, so hi
        backfill follows promotion order, i.e. hotness."""
        if self.hi_present[layer, expert]:
            return
        if self._hi_loader is None:
            raise RuntimeError(
                f"expert ({layer}, {expert}) absent from the host store "
                f"and no hi_loader configured")

        def attempt():
            self._fire("host_hi", layer=layer, expert=expert)
            return self._hi_loader(layer, expert)

        rows = self._retry(attempt, "host_hi", (layer << 16) | expert)
        nbytes = 0
        for name, arr in self.hi.items():
            r = np.asarray(rows[name])
            t = torch.from_numpy(r).to(torch.bfloat16)
            arr.rows[(layer, expert)] = t.pin_memory() if self._cuda else t
            nbytes += r.nbytes
        self.hi_present[layer, expert] = True
        self.stats["hi_loads"] += 1
        self.stats["hi_bytes_loaded"] += nbytes

    # -- lo tier (device staging) -----------------------------------------
    def _lo_rows(self, layer: int) -> Dict[str, torch.Tensor]:
        """One layer's packed lo rows as host tensors (pinned on a card;
        scales narrowed to the bank's bf16, exactly), cached for the layer
        last read."""
        if self._lo_loader is None:
            raise RuntimeError("no lo_loader configured for lo staging")
        cl, rows = self._lo_cache
        if cl != layer:
            def attempt():
                self._fire("host_lo", layer=layer)
                return self._lo_loader(layer)
            raw = self._retry(attempt, "host_lo", layer)
            rows = {}
            for k, a in raw.items():
                t = torch.from_numpy(np.ascontiguousarray(a))
                if k.endswith(".scales"):
                    t = t.to(torch.bfloat16)
                rows[k] = t.pin_memory() if self._cuda else t
            self._lo_cache = (layer, rows)
        return rows

    def stage_lo(self, bank: ExpertBankQ, layer: int, expert: int,
                 resident: bool = True) -> int:
        """Issue the asynchronous write of one expert's packed lo rows into
        the bank; returns the bytes in flight. The rows stay unreferenced
        as valid (``lo_valid`` unflipped) until ``publish_lo`` sees the
        copy's own event complete."""
        def fetch():
            self._fire("stage_lo", layer=layer, experts=1)
            return self._lo_rows(layer)
        rows = self._retry(fetch, "stage_lo", (layer << 16) | expert)
        nbytes = sum((q.packed.nbytes + q.scales.nbytes) // (self.L * self.E)
                     for q in bank.lo.values())
        self._stage(bank, layer, np.asarray([expert]),
                    np.asarray([resident], bool), rows, nbytes,
                    lambda leaf, src: write_lo_expert(leaf, layer, expert,
                                                      src[expert]))
        if self.tracer is not None:
            self.tracer.instant("host_stage", cat="host", layer=layer,
                                experts=1, bytes=nbytes)
        return nbytes

    def stage_lo_batch(self, bank: ExpertBankQ, layer: int, experts,
                       resident) -> int:
        """Bulk-stage several experts of one layer: one copy per run of
        consecutive experts per bank leaf (the cold-start pump's path).
        ``resident`` is a per-expert bool sequence; publication is as if
        ``stage_lo`` were issued per cell."""
        idx = np.asarray(list(experts), np.int64)
        res = np.asarray(list(resident), bool)

        def fetch():
            self._fire("stage_lo", layer=layer, experts=int(idx.size))
            return self._lo_rows(layer)

        rows = self._retry(fetch, "stage_lo", layer)
        nbytes = sum((q.packed.nbytes + q.scales.nbytes) * idx.size
                     // (self.L * self.E) for q in bank.lo.values())
        self._stage(bank, layer, idx, res, rows, nbytes,
                    lambda leaf, src: write_lo_rows(leaf, layer, idx, src))
        if self.tracer is not None:
            self.tracer.instant("host_stage", cat="host", layer=layer,
                                experts=int(idx.size), bytes=nbytes)
        return nbytes

    def _stage(self, bank, layer, idx, res, rows, nbytes, write) -> None:
        """One staging: ``write(leaf, rows)`` per bank leaf, in place (on
        the side stream on a card), and its pending entry."""
        srcs, event = [], None
        ctx = contextlib.nullcontext()
        if self._cuda:
            if self.side is None:
                self.side = torch.cuda.Stream(device=self.device)
            # Forwards already queued may read these rows (a quarantined
            # cell being healed): the copy starts after them.
            queued = torch.cuda.Event()
            queued.record(torch.cuda.current_stream(self.device))
            self.side.wait_event(queued)
            ctx = torch.cuda.stream(self.side)
        with ctx:
            for name, qt in bank.lo.items():
                for leaf, key in ((qt.packed, f"{name}.packed"),
                                  (qt.scales, f"{name}.scales")):
                    write(leaf, rows[key])
                    srcs.append(rows[key])
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self.side)
        self._staging.append(_PendingLo(layer, idx, res, nbytes, event,
                                        tuple(srcs)))
        self.stats["lo_staged"] += int(idx.size)
        self.stats["lo_bytes_staged"] += nbytes

    def publish_lo(self, wait: bool = False) -> int:
        """Flip the residency masks of completed stagings (window
        boundary); ``wait`` blocks on every pending copy first. Each entry
        is probed on ITS OWN event (under a distribution context, on every
        rank's: an AND over the grid)."""
        if not self._staging:
            return 0
        done = []
        for p in self._staging:
            if p.event is not None and wait:
                p.event.synchronize()
            done.append(p.event is None or wait or p.event.query())
        if self.dist is not None:
            done = all_true(done, self.dist)
        still: List[_PendingLo] = []
        published = 0
        for p, ok in zip(self._staging, done):
            if not ok:
                still.append(p)
                continue
            self.lo_valid[p.layer, p.experts] = True
            self.lo_resident[p.layer, p.experts[p.resident]] = True
            # Healing: real rows just landed for these cells.
            self.quarantined[p.layer, p.experts] = False
            published += int(p.experts.size)
        self._staging = still
        if published and self.tracer is not None:
            self.tracer.instant("lo_publish", cat="host", experts=published)
        return published

    @property
    def staging_inflight(self) -> int:
        return len(self._staging)

    @property
    def lo_complete(self) -> bool:
        """Every expert's device lo rows hold real weights (or the cell is
        quarantined and served from host): the serving gate of a streaming
        cold start. Quarantine keeps one unreadable shard from holding
        ``serving_ready()`` back forever."""
        return bool((self.lo_valid | self.quarantined).all()) \
            and not self._staging

    def quarantine(self, layer: int, experts) -> int:
        """Mark cells whose staging source exhausted its retries: they are
        served from the host tier (demand-fetch pricing, requests routed to
        them flagged degraded) and re-staged until a copy lands and heals
        them. Returns the cells newly quarantined."""
        ex = np.atleast_1d(np.asarray(experts, np.int64))
        ex = ex[~self.lo_valid[layer, ex]]      # valid cells need no rescue
        fresh = ex[~self.quarantined[layer, ex]]
        self.quarantined[layer, fresh] = True
        n = int(fresh.size)
        self.stats["quarantines"] += n
        if n and self.tracer is not None:
            self.tracer.instant("quarantine", cat="fault", layer=layer,
                                experts=n)
        return n

    def check_invariants(self) -> None:
        """Residency-ladder invariants: a lo-resident cell must be valid
        (accounting never outruns materialization), and a quarantined cell
        is neither valid nor resident."""
        assert (self.lo_valid | ~self.lo_resident).all(), \
            "lo_resident cell with invalid device rows"
        assert not (self.quarantined & self.lo_valid).any(), \
            "quarantined cell marked lo_valid"
        assert not (self.quarantined & self.lo_resident).any(), \
            "quarantined cell counted lo_resident"
        if self._hi_loader is None:
            assert self.hi_present.all()
