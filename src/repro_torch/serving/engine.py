"""Request-level continuous-batching engine of the port (greedy).

``submit(request)`` queues a request; ``step()`` admits queued requests
into free slots with bucketed, masked prefills and advances every running
request by one greedy token; ``drain()`` runs until the queue empties.

* **Admission** is FIFO: the queue head picks a length bucket
  (``bucket_base``·2^i, capped at ``max_len``); same-bucket requests behind
  it join, up to ``prefill_rows`` rows and the free slots, each reserving
  its worst-case KV blocks from the shared budget first.
* **KV** (``EngineConfig.paged``, default True) lives in one block pool
  per attention position (see ``serving.kvpool``): rows lease blocks
  through block tables; decode appends lazily; block 0 takes vacant rows'
  writes. With ``paged=False`` every slot owns a dense (Hkv, max_len, hd)
  row: an admission prefills fresh row caches and copies them into the
  slots' rows, and decode writes each row at ``pos % max_len``.
* **MoE dispatch** (``EngineConfig.moe_dispatch``): "ragged" (None, the
  default) or "padded", on either KV layout.
* **Decode** runs one step for all slots; vacant rows ride along masked out
  of MoE dispatch and every count. The step's inputs live in static
  buffers (``serving.graphs.StaticInputs``) that one host→device copy
  rewrites per step; on the card the step runs as one CUDA graph, captured
  at the first decode (``serving.graphs.DecodeGraph``; op by op only inside
  ``eager()``), on the CPU op by op. Greedy argmax stays on the device and
  one transfer per step brings the (B,) tokens and the per-row router
  counts to the host, which go to ``backend.observe`` with the row mask.
  Prefill stays eager: its shapes vary by (rows, bucket).
* **Modeled stalls**: ``observe`` returns the seconds a forward would have
  waited on transfers (the offload baseline's misses; 0 elsewhere), never
  slept. The engine charges them as the reference does: a decode step's
  latency is its measured time plus its stall (``decode_times``, TPOT,
  each request's ``step_times``), and a request's TTFT adds every stall
  since its submission (``_stall_clock``).

Not ported yet: prefix sharing, speculation, sampling, the QoS scheduler,
chunked prefill, preemption, the watchdog, per-row MoE capacity
(``row_capacity_norm``) and the dense path's sliding-window rings.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.budget import UNBOUNDED, BudgetTracker
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (decode_step, decode_step_paged,
                                      init_caches, init_paged_caches,
                                      prefill, prefill_paged)
from repro_torch.models.moe import DISPATCHES, RAGGED_BM, moe_capacity
from repro_torch.serving.graphs import DecodeGraph, StaticInputs, eager
from repro_torch.serving.kvpool import KVBlockPool, KVLease
from repro_torch.serving.requests import Request

#: Engine keys ``stats()`` adds to the backend's (the reference's schema;
#: counters of features not ported stay 0).
ENGINE_STAT_KEYS = (
    "steps", "prefills", "admitted", "finished", "prefill_tokens",
    "prefix_hit_tokens", "kv_cow_copies", "preemptions", "resumes",
    "shed_requests", "downgraded", "chunk_prefills",
    "prefill_compiles", "kv_blocks_in_use", "kv_bytes_in_use",
    "prefix_trie_nodes", "spec_row_rounds", "watchdog_cancels")

__all__ = ["ENGINE_STAT_KEYS", "EngineConfig", "InferenceEngine",
           "RequestHandle", "RequestState", "eager"]


@dataclasses.dataclass
class EngineConfig:
    """The reference's field names, the subset this engine implements (no
    prefix sharing, speculation or scheduler)."""
    max_slots: int = 4
    max_len: int = 512
    capacity_factor: float = 2.0
    bucket_base: int = 32
    prefill_rows: Optional[int] = None       # None → min(4, max_slots)
    paged: bool = True                       # False: dense KV rows
    block_tokens: int = 16
    # Envelope shared by KV block reservations and the expert hi tier
    # (None = unbounded).
    hbm_budget_bytes: Optional[int] = None
    # MoE token layout: "ragged", "padded", or None (ragged).
    moe_dispatch: Optional[str] = None


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


class RequestHandle:
    def __init__(self, rid: int, request: Request):
        self.id = rid
        self.request = request
        self.state = RequestState.QUEUED
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.submit_s = 0.0
        self.stall_at_submit = 0.0     # the engine's stall clock at submit
        self.ttft_s = 0.0
        self.finish_s = 0.0
        self.lease: Optional[KVLease] = None
        self.expert_counts: Optional[Dict[str, np.ndarray]] = None
        self.step_times: List[float] = []     # decode latency, stall incl.

    def token_array(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


class InferenceEngine:
    """Continuous-batching serving loop over a residency backend, on
    ``device`` (``cuda`` unless ``device="cpu"`` is passed)."""

    def __init__(self, cfg: ArchConfig, params: Dict, backend,
                 ecfg: Optional[EngineConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.backend = backend
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        e = self.ecfg
        if backend.device != self.device:
            raise ValueError(f"backend on {backend.device}, engine on "
                             f"{self.device}")
        n = e.max_slots
        self.moe_dispatch = "ragged" if e.moe_dispatch is None \
            else e.moe_dispatch
        if self.moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch={e.moe_dispatch!r}; one of "
                             f"{DISPATCHES}")
        self._bt = e.block_tokens
        self._C_pad = -(-e.max_len // self._bt) * self._bt
        self._nb = self._C_pad // self._bt
        a = cfg.attn
        # KV bytes of one cache position across every layer (K and V).
        pos_bytes = 2 * a.n_kv_heads * a.head_dim * 2 * cfg.n_superblocks()
        self.budget = BudgetTracker(UNBOUNDED if e.hbm_budget_bytes is None
                                    else e.hbm_budget_bytes)
        self.pool: Optional[KVBlockPool] = None
        if e.paged:
            n_blocks = 1 + n * self._nb    # trash block + every slot full
            self.pool = KVBlockPool(n_blocks, self._bt, self._bt * pos_bytes,
                                    budget=self.budget.view("kv"))
            self.banks = backend.materialize_banks(
                cfg, params, self.pool.capacity_bytes, budget=self.budget)
            self.caches = init_paged_caches(cfg, n_blocks, self._bt,
                                            self.device)
        else:
            self.banks = backend.materialize_banks(
                cfg, params, pos_bytes * n * e.max_len, budget=self.budget)
            self.caches = init_caches(cfg, n, e.max_len, self.device)
        self.slots: List[Optional[RequestHandle]] = [None] * n
        self.pos = np.zeros(n, np.int64)
        self.tokens = np.zeros(n, np.int64)     # vacant rows replay token 0
        self.queue: deque = deque()
        self._ids = itertools.count()
        ladder, v = [], e.bucket_base
        while v < e.max_len:
            ladder.append(v)
            v *= 2
        ladder.append(e.max_len)
        self.buckets = tuple(ladder)
        self._prefill_rows = e.prefill_rows if e.prefill_rows is not None \
            else min(4, n)
        self.prefill_shapes: set = set()
        self.last_row_counts: Dict[str, np.ndarray] = {}  # last forward
        self.ttfts: List[float] = []
        self.decode_times: List[float] = []     # per step, stall included
        # Cumulative modeled stall seconds (returned by the backend, never
        # slept): TTFT charges the stalls of the work that ran ahead of a
        # request.
        self._stall_clock = 0.0
        self._tpot_sum = 0.0
        self._tpot_tokens = 0
        self._disp_active_sum = 0.0
        self._disp_pad_sum = 0.0
        self._disp_layers = 0
        self.counters = {k: 0 for k in ("steps", "prefills", "admitted",
                                        "finished", "prefill_tokens")}
        # The decode step: static inputs, rewritten in place every step,
        # and the step over them (one CUDA graph on the card).
        fields = [("tokens", (n,), torch.int64), ("pos", (n,), torch.int64)]
        if e.paged:
            fields += [("wblk", (n,), torch.int64),
                       ("woff", (n,), torch.int64),
                       ("table", (n, self._nb), torch.int32)]
        fields.append(("row_valid", (n,), torch.bool))
        # The graph holds its engine weakly: a reference cycle would keep
        # the engine's device memory until the collector ran.
        engine = weakref.ref(self)
        self.decode_graph = DecodeGraph(
            lambda: engine()._decode_fn(), StaticInputs(fields, self.device),
            self.device)
        self._count_shapes: Dict[str, tuple] = {}
        self._out_host: Optional[torch.Tensor] = None
        self.capture_s = 0.0           # set-up: warm-up and capture
        self.last_logits: Optional[torch.Tensor] = None   # last decode step

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        plen = int(np.asarray(request.tokens).shape[-1])
        if plen > self.buckets[-1]:
            raise ValueError(f"prompt of {plen} tokens exceeds the largest "
                             f"prefill bucket {self.buckets[-1]}")
        worst = 0 if self.pool is None else self.pool.block_bytes * \
            (1 + self._quota_blocks(plen, request.max_new_tokens))
        if worst > self.budget.cap:
            raise ValueError(f"request needs {worst} bytes of KV worst-case "
                             f"but the envelope caps at {self.budget.cap}")
        h = RequestHandle(next(self._ids), request)
        h.submit_s = time.perf_counter()
        h.stall_at_submit = self._stall_clock
        self.queue.append(h)
        return h

    def _quota_blocks(self, plen: int, max_new: int) -> int:
        return -(-min(self.ecfg.max_len, plen + max_new) // self._bt)

    def _bucket_len(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        raise ValueError(f"prompt of {plen} tokens exceeds every bucket")

    def _dev(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _fetch(self, amax: torch.Tensor, counts: Dict[str, torch.Tensor]):
        """ONE device→host transfer: the (B,) greedy tokens and the
        per-row router counts of every MoE position."""
        return _unpack(_pack(amax, counts).cpu().numpy(), amax.shape[0],
                       {k: tuple(v.shape) for k, v in counts.items()})

    # ------------------------------------------------------------------
    def _admit(self, finished: List[RequestHandle]) -> None:
        while self.queue:
            free = [i for i, h in enumerate(self.slots) if h is None]
            if not free:
                return
            R = self._prefill_rows
            limit = min(len(free), R)
            group, skipped, bucket = [], [], None
            while self.queue and len(group) < limit:
                h = self.queue.popleft()
                plen = int(np.asarray(h.request.tokens).reshape(-1).shape[0])
                b = self._bucket_len(plen)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    skipped.append(h)
                    continue
                if self.pool is not None:
                    quota = self._quota_blocks(plen,
                                               h.request.max_new_tokens)
                    if not self.pool.try_reserve_quota(quota):
                        skipped.append(h)
                        if not group:
                            break
                        continue
                    h.lease = KVLease(self.pool, self._nb, quota)
                group.append(h)
            self.queue.extendleft(reversed(skipped))
            if not group:
                return
            self._prefill_group(group, free, bucket, finished)

    def _prefill_group(self, group, free, bucket, finished) -> None:
        R, G = self._prefill_rows, len(group)
        lengths = np.zeros(R, np.int64)
        toks = np.zeros((R, bucket), np.int64)
        for r, h in enumerate(group):
            p = np.asarray(h.request.tokens).reshape(-1)
            lengths[r] = p.shape[0]
            toks[r, :p.shape[0]] = p
        kw = dict(bank=self.banks, capacity_factor=self.ecfg.capacity_factor,
                  per_row_counts=True, moe_dispatch=self.moe_dispatch)
        t0 = time.perf_counter()
        if self.pool is not None:
            tables = np.full((R, self._nb), -1, np.int32)
            for r, h in enumerate(group):
                for j in range(-(-int(lengths[r]) // self._bt)):
                    h.lease.ensure(j)
                tables[r] = h.lease.table
            logits, counts = prefill_paged(
                self.params, self.cfg, self._dev(toks), self.caches,
                self._dev(tables, torch.int32), self._dev(np.zeros(R)),
                self._dev(lengths), **kw)
        else:
            # Fresh row caches, then a copy into the slots' rows.
            rows = init_caches(self.cfg, R, self.ecfg.max_len, self.device)
            logits, counts = prefill(self.params, self.cfg, self._dev(toks),
                                     rows, self._dev(lengths), **kw)
            slots = self._dev(free[:G])
            for pos, c in rows.items():
                self.caches[pos].k[:, slots] = c.k[:, :G]
                self.caches[pos].v[:, slots] = c.v[:, :G]
        amax, counts_np = self._fetch(torch.argmax(logits, -1), counts)
        dt = time.perf_counter() - t0
        self.prefill_shapes.add((R, bucket))
        self.last_row_counts = counts_np
        row_valid = np.zeros(R, bool)
        row_valid[:G] = True
        stall = self.backend.observe(counts_np, dt, prefill=True,
                                     row_valid=row_valid)
        self._stall_clock += stall
        now = time.perf_counter()
        for r, h in enumerate(group):
            slot = free[r]
            tok = int(amax[r])
            h.tokens.append(tok)
            h.ttft_s = now - h.submit_s + self._stall_clock - \
                h.stall_at_submit
            self.ttfts.append(h.ttft_s)
            h.state = RequestState.RUNNING
            h.slot = slot
            h.expert_counts = {k: v[:, r].astype(np.int64)
                               for k, v in counts_np.items()}
            self.slots[slot] = h
            self.pos[slot] = lengths[r]
            self.tokens[slot] = tok
            self.counters["admitted"] += 1
            self.counters["prefill_tokens"] += int(lengths[r])
            if self._done(h):
                self._finish(h, finished)
        self.counters["prefills"] += 1

    def _done(self, h: RequestHandle) -> bool:
        req = h.request
        if req.eos_token_id is not None and h.tokens and \
                h.tokens[-1] == req.eos_token_id:
            return True
        if len(h.tokens) >= req.max_new_tokens:
            return True
        return int(self.pos[h.slot]) >= self.ecfg.max_len

    def _finish(self, h: RequestHandle, finished) -> None:
        h.state = RequestState.FINISHED
        h.finish_s = time.perf_counter()
        self.slots[h.slot] = None
        if h.lease is not None:
            h.lease.close()
        self.counters["finished"] += 1
        finished.append(h)

    # ------------------------------------------------------------------
    def step(self) -> List[RequestHandle]:
        finished: List[RequestHandle] = []
        self._admit(finished)
        active = [(i, h) for i, h in enumerate(self.slots) if h is not None]
        if active:
            self._decode(active, finished)
        self.backend.tick()
        return finished

    def _decode_fn(self):
        """The decode step over the static inputs: (logits (B, V) float32,
        one int32 buffer of the greedy tokens and the per-row counts)."""
        d = self.decode_graph.inputs.dev
        kw = dict(bank=self.banks, capacity_factor=self.ecfg.capacity_factor,
                  row_valid=d["row_valid"], per_row_counts=True,
                  moe_dispatch=self.moe_dispatch)
        if self.pool is None:
            logits, counts = decode_step(self.params, self.cfg, d["tokens"],
                                         d["pos"], self.caches, **kw)
        else:
            logits, counts = decode_step_paged(
                self.params, self.cfg, d["tokens"], d["pos"], self.caches,
                d["table"], d["wblk"], d["woff"], **kw)
        self._count_shapes = {k: tuple(v.shape) for k, v in counts.items()}
        return logits, _pack(torch.argmax(logits, -1), counts)

    def _fill_step(self, active) -> np.ndarray:
        """Write the decode step's inputs into the host mirror of the
        static buffers; returns the row mask. Rows not in ``active`` are
        vacant: masked out of dispatch and counts, they replay their last
        token at their position and write its K/V to the trash block (on
        the pool) or to their own row at ``pos % max_len`` (dense): for a
        row that is running, the slot its next step writes first."""
        h = self.decode_graph.inputs.host
        h["tokens"][:] = self.tokens
        h["pos"][:] = self.pos
        h["row_valid"][:] = False
        if self.pool is not None:
            h["wblk"][:] = 0
            h["woff"][:] = 0
            h["table"][:] = -1
        for i, r in active:
            h["row_valid"][i] = True
            if self.pool is not None:
                s = int(self.pos[i]) % self._C_pad
                phys, cow = r.lease.ensure(s // self._bt)
                assert cow < 0, "copy-on-write needs prefix sharing"
                h["wblk"][i], h["woff"][i] = phys, s % self._bt
                h["table"][i] = r.lease.table
        return h["row_valid"].copy()

    def _decode(self, active, finished) -> None:
        if self.decode_graph.needs_capture:
            # Warm-up and capture with every row vacant: no count, and
            # K/V only where nothing reads them before the next real step
            # writes (``_fill_step``).
            t0 = time.perf_counter()
            self._fill_step([])
            self.decode_graph.capture()
            self.capture_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        row_valid = self._fill_step(active)
        logits, packed = self.decode_graph.run()
        if self._out_host is None:
            self._out_host = torch.empty(
                packed.shape, dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        self._out_host.copy_(packed)
        amax, counts_np = _unpack(self._out_host.numpy().copy(),
                                  self.ecfg.max_slots, self._count_shapes)
        dt = time.perf_counter() - t0
        self.last_logits = logits
        self.last_row_counts = counts_np
        self._note_dispatch(counts_np)
        stall = self.backend.observe(counts_np, dt, prefill=False,
                                     row_valid=row_valid)
        self._stall_clock += stall
        latency = dt + stall
        self.decode_times.append(latency)
        self._tpot_sum += latency * len(active)
        self._tpot_tokens += len(active)
        for i, h in active:
            tok = int(amax[i])
            h.tokens.append(tok)
            h.step_times.append(latency)
            for k, v in counts_np.items():
                h.expert_counts[k] += v[:, i]
            self.tokens[i] = tok
            self.pos[i] += 1
            if self._done(h):
                self._finish(h, finished)
        self.counters["steps"] += 1

    def _note_dispatch(self, counts_np: Dict[str, np.ndarray]) -> None:
        """Host mirror of the dispatch gauges: active experts per layer and
        the padding of the configured layout (intra-tile slack of the
        ragged layout, or empty rows of the padded (E, C) buffer)."""
        E = self.cfg.moe.num_experts
        C = moe_capacity(self.ecfg.max_slots, self.cfg.moe,
                         self.ecfg.capacity_factor)
        for v in counts_np.values():
            per = v.sum(axis=1).reshape(-1, E).astype(np.float64)
            routed = per.sum(axis=1)
            live = routed > 0
            if not live.any():
                continue
            per, routed = per[live], routed[live]
            if self.moe_dispatch == "ragged":
                tiles = np.ceil(per / RAGGED_BM).sum(axis=1)
                pad = 1.0 - routed / np.maximum(tiles * RAGGED_BM, 1.0)
            else:
                pad = 1.0 - np.minimum(per, C).sum(axis=1) / max(E * C, 1)
            self._disp_active_sum += float((per > 0).sum())
            self._disp_pad_sum += float(pad.sum())
            self._disp_layers += int(per.shape[0])

    def drain(self) -> List[RequestHandle]:
        done: List[RequestHandle] = []
        idle = 0
        while self.queue or any(h is not None for h in self.slots):
            before = len(self.queue)
            done.extend(self.step())
            running = any(h is not None for h in self.slots)
            idle = idle + 1 if (not running and
                                len(self.queue) == before) else 0
            if idle > 256:
                raise RuntimeError("admission stalled: queued requests "
                                   "cannot reserve KV under the envelope")
        return done

    def flush(self) -> None:
        self.backend.flush()

    def stats(self) -> Dict[str, float]:
        out = dict(self.backend.stats())
        out.update({k: 0.0 for k in ENGINE_STAT_KEYS})
        if self.ttfts:
            out["ttft_s"] = float(np.mean(self.ttfts))
        if self._tpot_tokens:
            out["tpot_s"] = self._tpot_sum / self._tpot_tokens
        out.update({k: float(v) for k, v in self.counters.items()})
        out["prefill_compiles"] = float(len(self.prefill_shapes))
        if self._disp_layers:
            out["active_experts"] = self._disp_active_sum / self._disp_layers
            out["dispatch_pad_ratio"] = self._disp_pad_sum / \
                self._disp_layers
        if self.pool is not None:
            out["kv_blocks_in_use"] = float(self.pool.blocks_in_use)
            out["kv_bytes_in_use"] = float(self.pool.bytes_in_use)
        return out

    def device_bytes(self) -> int:
        return self.backend.device_bytes()


def _pack(amax: torch.Tensor, counts: Dict[str, torch.Tensor]):
    """One int32 device buffer: the (B,) greedy tokens, then the per-row
    router counts of every MoE position in key order."""
    return torch.cat([amax.to(torch.int32).reshape(-1)] +
                     [counts[k].to(torch.int32).reshape(-1)
                      for k in sorted(counts)])


def _unpack(flat: np.ndarray, B: int, shapes: Dict[str, tuple]):
    """``_pack``'s buffer on the host → ((B,) tokens, {position: counts})."""
    out, off = {}, B
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        out[k] = flat[off:off + n].reshape(shapes[k])
        off += n
    return flat[:B], out
