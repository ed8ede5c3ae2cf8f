"""Request-level continuous-batching engine of the port, with a paged,
prefix-shared KV cache and SLO-tiered scheduling.

``submit(request)`` queues a request; ``step()`` sheds expired batch work,
admits queued requests into free slots, preempts for a blocked higher
class, advances chunked prefills by one chunk and advances every running
request by one token; ``drain()`` runs until nothing is queued or running;
``replay(stream)`` serves an arrival-timed stream (wall clock, or a
virtual clock for deterministic runs); ``generate`` is the whole-batch
shim over submit + drain. Tokens are drawn on the host by each request's
own ``SamplingParams`` (``serving.sampler``; greedy by default).

* **Admission** goes through the SLO-tiered ``TieredQueue``
  (``serving.scheduler``; FIFO for traffic of one class): the queue head
  picks a length bucket (``bucket_base``·2^i, capped at ``max_len``);
  same-bucket requests behind it join, up to ``prefill_rows`` rows and the
  free slots, each reserving its worst-case KV blocks from the shared
  budget first. Preempted requests resume and long prompts begin their
  chunked prefill from the head position only.
* **KV** (``EngineConfig.paged``, default True) lives in one block pool
  per attention position (``serving.kvpool``): rows lease blocks through
  block tables; a token-prefix trie (``serving.prefix``) maps shared
  prompt prefixes onto the SAME physical blocks, so admission adopts trie
  hits and prefills only the suffix (over the cached prefix); decode
  appends lazily and copies a shared block on write (``_ensure_write``,
  the copies run on the device before the step); block 0 takes vacant
  rows' writes. With ``paged=False`` every slot owns a dense
  (Hkv, max_len, hd) row (no trie or chunking there).
* **MoE dispatch** (``EngineConfig.moe_dispatch``): "ragged" (None, the
  default) or "padded", on either KV layout.
* **Decode** runs one step per tier group (``Scheduler.decode_groups``):
  premium/standard rows on the served banks, batch-tier rows on the
  all-lo view (``serving.lobanks``); rows of the other group ride along
  vacant, masked out of MoE dispatch and every count. The step's inputs
  live in static buffers (``serving.graphs.StaticInputs``) that one
  host→device copy rewrites per step; on the card each group's step runs
  as one CUDA graph (two graphs over one set of inputs and one memory
  pool, each captured at its first use; op by op only inside
  ``eager()``), on the CPU op by op. Greedy argmax stays on the device and
  one transfer per step brings the (B,) tokens and the per-row router
  counts to the host; only rows that sample ship their (V,) logits,
  gathered on the device.
* **Self-speculative decoding** (``EngineConfig.spec_k > 0``,
  ``serving.spec``): the scheduler's ``spec`` rows advance by a draft of up
  to ``spec_k`` tokens on the all-lo view and its verify on the served
  banks, one CUDA graph each per ladder width; a round emits 1 … k+1
  tokens per row, and at temperature 0 the same tokens as plain decode.
* **Preemption**: a blocked higher-class head evicts one lower-class
  running request. On the pool its valid K/V lanes go to the host, its
  lease closes (blocks and quota return to the pool, its full chunks stay
  in the trie), and resume adopts the trie hits and uploads only the lanes
  the trie lost; on dense rows its whole row goes to the host and comes
  back into any free slot. The continuation is the uninterrupted one.
* **Watchdogs** (``promo_deadline_s``, ``watchdog_no_progress_s``;
  ``fault.watchdog``): before each step, promotions whose copy has not
  completed past the deadline are cancelled (the expert keeps serving lo),
  and RUNNING requests that emitted no token for too long are preempted
  and requeued.
* **Per-row MoE capacity** (``row_capacity_norm``): the drop rule of every
  MoE layer becomes per request row, so whether a token's assignment drops
  does not depend on the other rows of the batch.
* **Residency ladder**: while the backend's ``serving_ready()`` is False (a
  streaming cold start), ``step()`` only ticks the backend, which stages
  the lo tier; requests queue and no forward runs. A request whose forward
  routed through a quarantined expert cell (``backend.degraded_cells()``)
  is flagged ``degraded``, from the per-row counts the step already
  brought to the host.
* **Modeled stalls**: ``observe`` returns the seconds a forward would have
  waited on transfers (the offload baseline's misses; 0 elsewhere), never
  slept. A decode step's latency is its measured time plus its stall
  (``decode_times``, TPOT, each request's ``step_times``), and a request's
  TTFT adds every stall since its submission (``_stall_clock``).
* **Clock**: submit, TTFT, finish, queue aging and deadlines read the
  engine clock ``_now`` (wall time, or ``replay``'s virtual clock);
  compute latencies read ``perf_counter``.
* **Observability** (``obs=Observability(...)``, ``repro_torch.obs``): the
  flight recorder's clock is rebound to ``_now``, so a virtual-clock
  replay traces byte-identically; the engine records the scheduling
  events (submit, shed, downgrade, admit, finish, preempt, resume) and one
  ``step`` event with the per-step gauges after each step, samples the
  metrics every ``sample_every`` steps, and the backend records the
  residency events. Every value is a count the host already holds or a
  modeled stall: nothing is read from the device for it and nothing is
  added to a captured graph. With ``obs=None`` (the default) every site is
  a pointer check. ``RequestHandle.stall_exposure_s`` sums the modeled
  stalls of the forwards a request was resident for.

* **Hybrid stacks** (Mamba/attention super-blocks, e.g. Jamba): the
  pool and the KV bytes cover the attention positions only; every Mamba
  position keeps per-slot recurrent rows (``models.ssm.MambaCache``).
  Admission prefills fresh rows from a zero state and copies them into
  the admitted slots only; the decode step updates them in place for its
  valid rows only, so rows of another decode group keep their state (the
  reference's ``guard_ssm`` merge); preemption snapshots and restores a
  slot's rows. The prefix trie and chunked prefill are off on such
  stacks (recurrent state is not leased), and every prefill bucket is a
  multiple of the SSD chunk. Speculative decoding rolls each row back to
  its last accepted step (``serving.spec``). A pure Mamba stack has no
  attention position: no pool even under ``paged=True`` (dense rows), and
  0 KV bytes.
* **Dense stacks** (no MoE position): every FFN is the dense SwiGLU, the
  router counts are empty, and the backends hold no expert bytes.
* **Expert parallelism** (``dist=``, a ``launch.dist.DistContext`` of a
  model-only group or of a (data × model) grid; one engine per rank,
  every rank of the grid serving the same requests in the same order):
  the backend materializes this rank's experts only (the same on every
  data row), and every forward (prefill, decode, the speculative
  decoder's) runs inside ``dist_ctx``, where the MoE layers take their
  sharded regimes. The collectives (gloo, host-staged) cannot be
  captured in a CUDA graph, so under a context the decode steps run op
  by op on the card too (``engine.graphed`` is False; the launcher's
  line says so). Every clock reading a decision is taken on is the
  grid's first rank's: ``_now()`` steps on one ``agree``d reading per
  step (and per submit), as ``replay`` steps on its virtual clock, and
  the measured latencies are rank 0's.
* **Sliding windows**: KV capacity is ``min(max_len, window)`` (a ring,
  slot = position % C) on either layout; chunked prefill takes a windowed
  prompt only while it fits the window, and only prompts that fit it are
  offered to the trie.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.budget import UNBOUNDED, BudgetTracker
from repro_torch.launch.dist import agree, dist_ctx
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (attn_capacity, attn_logical_capacity,
                                      attn_positions,
                                      decode_step, decode_step_paged,
                                      init_caches, init_mamba_rows,
                                      init_paged_caches, mamba_positions,
                                      prefill, prefill_paged)
from repro_torch.fault.watchdog import Watchdog, WatchdogConfig
from repro_torch.models.moe import DISPATCHES, RAGGED_BM, moe_capacity
from repro_torch.serving.graphs import DecodeGraph, StaticInputs, eager
from repro_torch.serving.kvpool import KVBlockPool, KVLease
from repro_torch.serving.lobanks import all_lo_banks
from repro_torch.serving.prefix import PrefixTrie
from repro_torch.serving.requests import Request
from repro_torch.serving.sampler import RequestSampler
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           SlotSnapshot, TieredQueue)

#: Engine keys ``stats()`` adds to the backend's (the reference's schema;
#: the counters of features not ported stay 0).
ENGINE_STAT_KEYS = (
    "steps", "prefills", "admitted", "finished", "prefill_tokens",
    "prefix_hit_tokens", "kv_cow_copies", "preemptions", "resumes",
    "shed_requests", "downgraded", "chunk_prefills",
    "prefill_compiles", "kv_blocks_in_use", "kv_bytes_in_use",
    "prefix_trie_nodes", "spec_row_rounds", "watchdog_cancels")

#: Keys ``load_snapshot()`` returns (the shed policy's input).
LOAD_SNAPSHOT_KEYS = ("queue_depth", "tpot_ema_s", "est_wait_s",
                      "budget_headroom_frac", "residency_ready_frac")

__all__ = ["ENGINE_STAT_KEYS", "LOAD_SNAPSHOT_KEYS", "EngineConfig",
           "EngineStallError", "InferenceEngine", "RequestHandle",
           "RequestState", "eager"]


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields and defaults."""
    max_slots: int = 4
    max_len: int = 512
    capacity_factor: float = 2.0
    pad_token_id: int = 0            # fed to never-yet-occupied decode rows
    bucket_base: int = 32
    prefill_rows: Optional[int] = None       # None → min(4, max_slots)
    paged: bool = True                       # False: dense KV rows
    block_tokens: int = 16
    # Physical blocks; None → the trash block + max_slots full sequences.
    kv_blocks: Optional[int] = None
    prefix_sharing: bool = True              # the prefix trie (paged only)
    # Envelope shared by KV block reservations and the expert hi tier
    # (None = unbounded).
    hbm_budget_bytes: Optional[int] = None
    # Self-speculative decoding: the most draft tokens per round (0 = off)
    # and whether the depth adapts per request from its acceptance EMA
    # over a power-of-two ladder (False: always spec_k).
    spec_k: int = 0
    spec_adaptive: bool = True
    # MoE token layout: "ragged", "padded", or None (ragged).
    moe_dispatch: Optional[str] = None
    # Per-row MoE capacity: the drop rule under a tight capacity_factor
    # becomes per request row.
    row_capacity_norm: bool = False
    # SLO-tiered scheduling; None → SchedulerConfig() (the untiered engine
    # for traffic of the default class).
    scheduler: Optional[SchedulerConfig] = None
    # The watchdogs (None = off): cancel promotions whose copy has not
    # completed this long after it was issued (engine-clock seconds), and
    # requeue RUNNING requests that emitted no token for this long.
    promo_deadline_s: Optional[float] = None
    watchdog_no_progress_s: Optional[float] = None


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"     # chunked prefill in flight (owns a slot)
    RUNNING = "running"
    FINISHED = "finished"
    SHED = "shed"                 # refused by the load-shedding policy


class EngineStallError(RuntimeError):
    """The engine went idle with queued work it could not admit and nothing
    in flight left to free bytes. ``snapshot`` carries the queue depths
    per tier, the budget and the counters."""

    def __init__(self, snapshot: Dict[str, object]):
        self.snapshot = snapshot
        super().__init__(
            f"admission stalled: {snapshot.get('queued_total', 0)} queued "
            f"request(s) cannot reserve KV under the shared HBM envelope "
            f"and no in-flight work remains to free bytes (queue depths "
            f"{snapshot.get('queue_depths', {})}, envelope used "
            f"{snapshot.get('budget_used', 0)}/"
            f"{snapshot.get('budget_cap', 0)})")


class RequestHandle:
    def __init__(self, rid: int, request: Request):
        self.id = rid
        self.request = request
        self.state = RequestState.QUEUED
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.sampler = RequestSampler(request.sampling)
        self.submit_s = 0.0            # engine clock at submit
        self.stall_at_submit = 0.0     # the engine's stall clock at submit
        self.ttft_s = 0.0
        self.first_token_s = 0.0
        self.finish_s = 0.0
        self.qos = "standard"          # resolved SLO class
        self.exec_qos = "standard"     # execution tier (after downgrades)
        self.enqueue_s = 0.0           # queue-aging reference time
        self.preempts = 0
        self._snapshot: Optional[SlotSnapshot] = None   # while evicted
        self._chunk_pos = 0            # prompt tokens prefilled so far
        self.lease: Optional[KVLease] = None
        self.prefix_hit_tokens = 0     # prompt tokens served from the trie
        self.expert_counts: Optional[Dict[str, np.ndarray]] = None
        self.step_times: List[float] = []     # decode latency, stall incl.
        # The request's own speculative acceptance EMA (its draft depth).
        self.spec_ema = 0.75
        # Engine clock at the last emitted token (the watchdog's input).
        self.last_progress_s = 0.0
        # True once a forward of this request routed through a quarantined
        # (host-served) expert cell: it completes, at degraded quality.
        self.degraded = False
        self._eos_scanned = 0          # tokens already checked for EOS
        # Modeled stall seconds of the forwards this request was resident
        # for (prefill, decode, speculative rounds): exposure, not a share
        # (concurrent residents each record the whole stall of a step).
        self.stall_exposure_s = 0.0

    def prompt(self) -> np.ndarray:
        return np.asarray(self.request.tokens, np.int64).reshape(-1)

    def token_array(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


class InferenceEngine:
    """Continuous-batching serving loop over a residency backend, on
    ``device`` (``cuda`` unless ``device="cpu"`` is passed), observed by
    ``obs`` (an ``obs.Observability``; None: no recorder, no registry),
    one rank of an expert-parallel group or (data × model) grid under
    ``dist`` (a ``launch.dist.DistContext``; None: one device)."""

    def __init__(self, cfg: ArchConfig, params: Dict, backend,
                 ecfg: Optional[EngineConfig] = None, device=None,
                 obs=None, dist=None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "InferenceEngine serves decoder-only stacks; encoder-decoder "
                "architectures go through the batch prefill/decode entry "
                "points in repro_torch.models.model directly.")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.backend = backend
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        e = self.ecfg
        self._clock: Optional[float] = None     # replay's virtual clock
        self.dist = dist
        # Under a context: rank 0's clock, agreed once per step.
        self._step_clock = agree(time.perf_counter(), dist) \
            if dist is not None else 0.0
        if backend.device != self.device:
            raise ValueError(f"backend on {backend.device}, engine on "
                             f"{self.device}")
        n = e.max_slots
        self.moe_dispatch = "ragged" if e.moe_dispatch is None \
            else e.moe_dispatch
        if self.moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch={e.moe_dispatch!r}; one of "
                             f"{DISPATCHES}")
        self.sched = Scheduler(e.scheduler)
        self._attn_pos = attn_positions(cfg)
        self._mamba_pos = mamba_positions(cfg)
        self._bt = e.block_tokens
        # Logical KV capacity: max_len, or the sliding window's ring.
        self._C_attn = attn_capacity(cfg, e.max_len)
        self._C_pad = attn_logical_capacity(cfg, e.max_len, self._bt)
        self._nb = self._C_pad // self._bt
        # KV bytes of one cache position across every attention layer (K
        # and V); 0 on a stack without attention.
        pos_bytes = 0 if not self._attn_pos else \
            2 * cfg.attn.n_kv_heads * cfg.attn.head_dim * 2 * \
            len(self._attn_pos) * cfg.n_superblocks()
        self.budget = BudgetTracker(UNBOUNDED if e.hbm_budget_bytes is None
                                    else e.hbm_budget_bytes)
        # Observability: the recorder stamps events on the engine clock.
        self.obs = obs
        self.tracer = obs.tracer if obs is not None else None
        self.metrics = obs.metrics if obs is not None else None
        self._sample_every = max(1, obs.cfg.sample_every) \
            if obs is not None else 1
        self._obs_prev = (0.0, 0.0, 0)  # dispatch sums at the last step
        if self.tracer is not None:
            self.tracer.clock = self._now
        if obs is not None:
            backend.attach_obs(self.tracer, self.metrics)
        self.pool: Optional[KVBlockPool] = None
        self.trie: Optional[PrefixTrie] = None
        # Nothing to page without attention: such a stack keeps dense rows.
        if e.paged and self._attn_pos:
            n_blocks = e.kv_blocks if e.kv_blocks is not None \
                else 1 + n * self._nb    # trash block + every slot full
            if self._nb > n_blocks - 1:
                raise ValueError(
                    f"kv_blocks={n_blocks} cannot hold even one sequence "
                    f"({self._nb} logical blocks + the trash block)")
            self.pool = KVBlockPool(n_blocks, self._bt, self._bt * pos_bytes,
                                    budget=self.budget.view("kv"),
                                    reclaim=self._reclaim_blocks)
            # Recurrent (Mamba) state cannot be leased from a cache: mixed
            # stacks run the pool without the trie.
            if e.prefix_sharing and not self._mamba_pos:
                self.trie = PrefixTrie(self.pool)
            with dist_ctx(dist):
                self.banks = backend.materialize_banks(
                    cfg, params, self.pool.capacity_bytes, budget=self.budget)
            self.caches = init_paged_caches(cfg, n_blocks, self._bt,
                                            self.device, batch=n)
        else:
            with dist_ctx(dist):
                self.banks = backend.materialize_banks(
                    cfg, params, pos_bytes * n * self._C_attn,
                    budget=self.budget)
            self.caches = init_caches(cfg, n, e.max_len, self.device)
        if self.tracer is not None:
            # What the cost model (``obs.costmodel``) replays against:
            # dispatch, router shape, byte prices.
            self.tracer.meta.update(
                moe_dispatch=self.moe_dispatch,
                num_experts=cfg.moe.num_experts if cfg.is_moe else 0,
                top_k=cfg.moe.top_k if cfg.is_moe else 1,
                lo_bytes=0, hi_bytes=0, backend=backend.name)
            self.tracer.meta.update(backend.obs_meta())
        # Promotion ages (the watchdog's input) on the engine clock.
        bind = getattr(backend, "bind_clock", None)
        if bind is not None:
            bind(self._now)
        self._degraded_fn = getattr(backend, "degraded_cells", None)
        self._ready_fn = getattr(backend, "serving_ready", None)
        self._watchdog = None
        if e.promo_deadline_s is not None or \
                e.watchdog_no_progress_s is not None:
            self._watchdog = Watchdog(WatchdogConfig(
                promo_deadline_s=e.promo_deadline_s,
                no_progress_s=e.watchdog_no_progress_s), tracer=self.tracer)
        # Per-row MoE capacity: the decode steps' row cap (the prefills'
        # depends on the length bucket, ``_row_cap_prefill``).
        self._row_cap_decode = moe_capacity(1, cfg.moe, e.capacity_factor) \
            if e.row_capacity_norm and cfg.is_moe else None
        # The batch tier's banks: the same buffers, every hi slot disowned.
        self._lo_owner_cache: Dict = {}
        self.lo_banks = all_lo_banks(self.banks, self._lo_owner_cache)
        self.slots: List[Optional[RequestHandle]] = [None] * n
        self.pos = np.zeros(n, np.int64)
        self.tokens = np.full(n, e.pad_token_id, np.int64)
        self.queue = TieredQueue(self._now, self.sched.cfg.aging_s)
        self._ids = itertools.count()
        # SSD prefill takes whole chunks: with Mamba positions every bucket
        # is a multiple of the chunk.
        m = cfg.ssm.chunk if self._mamba_pos else 1
        cap = (e.max_len // m) * m
        if cap <= 0:
            raise ValueError(f"max_len={e.max_len} below the SSD chunk "
                             f"multiple {m}; no prefill bucket fits")
        ladder, v = [], max(1, -(-e.bucket_base // m) * m)
        while v < cap:
            ladder.append(v)
            v *= 2
        ladder.append(cap)
        self.buckets = tuple(ladder)
        self._prefill_rows = e.prefill_rows if e.prefill_rows is not None \
            else min(4, n)
        # Chunked prefill: the largest block-aligned bucket not above the
        # knob, so every chunk prefills at a bucket shape.
        self._chunk_tokens = 0
        pc = self.sched.cfg.prefill_chunk
        if pc > 0 and self.pool is not None and not self._mamba_pos:
            fits = [b for b in self.buckets if b <= pc and b % self._bt == 0]
            if fits:
                self._chunk_tokens = fits[-1]
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
        self._tpot_ema = 0.0
        self._disp_active_sum = 0.0
        self._disp_pad_sum = 0.0
        self._disp_layers = 0
        self.counters = {k: 0 for k in (
            "steps", "prefills", "admitted", "finished", "prefill_tokens",
            "prefix_hit_tokens", "kv_cow_copies", "preemptions", "resumes",
            "shed_requests", "downgraded", "chunk_prefills",
            "watchdog_cancels")}
        # The decode steps: static inputs, rewritten in place every step,
        # and one step over them per bank view (one CUDA graph each on the
        # card, sharing a memory pool), updating the caches in place.
        fields = [("tokens", (n,), torch.int64), ("pos", (n,), torch.int64)]
        if self.pool is not None:
            fields += [("wblk", (n,), torch.int64),
                       ("woff", (n,), torch.int64),
                       ("table", (n, self._nb), torch.int32)]
        fields.append(("row_valid", (n,), torch.bool))
        inputs = StaticInputs(fields, self.device)
        pool = self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        # The graphs hold their engine weakly: a reference cycle would keep
        # the engine's device memory until the collector ran.
        engine = weakref.ref(self)
        state = [t for c in self.caches.values() for t in c]
        # A step under a distribution context calls collectives that a
        # CUDA graph cannot capture: it runs op by op, on the card too.
        self.graphed = dist is None
        self.decode_graph = DecodeGraph(
            lambda: engine()._decode_fn(lo=False), inputs, self.device, pool,
            state=state, graphed=self.graphed)
        self.lo_graph = DecodeGraph(
            lambda: engine()._decode_fn(lo=True), inputs, self.device, pool,
            state=state, graphed=self.graphed)
        self._count_shapes: Dict[str, tuple] = {}
        self._out_host: Optional[torch.Tensor] = None
        self.capture_s = 0.0           # set-up: warm-up and capture
        self.last_logits: Optional[torch.Tensor] = None   # last decode step
        self._spec = None
        if e.spec_k > 0:
            from repro_torch.serving.spec import SpecDecoder
            self._spec = SpecDecoder(self)

    # ------------------------------------------------------------------
    def _now(self) -> float:
        """The engine's accounting clock: wall time, or the virtual clock
        ``replay(realtime=False)`` installs; under a distribution context
        rank 0's wall time as agreed at the start of the step (or the
        submit)."""
        if self._clock is not None:
            return self._clock
        if self.dist is not None:
            return self._step_clock
        return time.perf_counter()

    def _agree_clock(self) -> None:
        """Under a distribution context, take rank 0's wall time as the
        clock of what follows (a collective: every rank calls it at the
        same point)."""
        if self.dist is not None:
            self._step_clock = agree(time.perf_counter(), self.dist)

    def _elapsed(self, t0: float) -> float:
        """perf_counter seconds since ``t0``; rank 0's under a distribution
        context, so that every rank's latencies, stats and load snapshot
        (the shed policy's input) are the same."""
        dt = time.perf_counter() - t0
        return dt if self.dist is None else agree(dt, self.dist)

    def submit(self, request: Request) -> RequestHandle:
        """Queue a request; returns its handle at once. The QoS class is
        resolved and the request validated here (unknown classes, bad
        deadlines or sampling parameters, prompts beyond the largest
        bucket, KV beyond the envelope fail loudly). Under an active shed
        policy an overloaded engine may return the handle ``SHED`` or
        downgrade its execution tier to the all-lo banks."""
        qos = self.sched.resolve(request.qos)
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms={request.deadline_ms} must be > 0 (or None)")
        plen = int(np.asarray(request.tokens).shape[-1])
        if plen > self.buckets[-1]:
            raise ValueError(f"prompt of {plen} tokens exceeds the largest "
                             f"prefill bucket {self.buckets[-1]}")
        if request.sampling is not None:
            request.sampling.validate()
        if self.pool is not None:
            worst = self.pool.block_bytes * \
                (1 + self._quota_blocks(plen, 0, request.max_new_tokens))
            if worst > self.budget.cap:
                raise ValueError(f"request needs {worst} bytes of KV "
                                 f"worst-case but the envelope caps at "
                                 f"{self.budget.cap}")
        h = RequestHandle(next(self._ids), request)
        h.qos = h.exec_qos = qos
        self._agree_clock()
        h.submit_s = h.enqueue_s = self._now()
        h.stall_at_submit = self._stall_clock
        if self.tracer is not None:
            self.tracer.instant("submit", cat="sched", rid=h.id, qos=qos,
                                prompt=plen)
        action = self.sched.admit_action(qos, self.load_snapshot())
        if action == "shed":
            h.state = RequestState.SHED
            self.counters["shed_requests"] += 1
            if self.tracer is not None:
                self.tracer.instant("shed", cat="sched", rid=h.id, qos=qos,
                                    reason="overload")
            return h
        if action == "downgrade" and h.exec_qos != "batch":
            h.exec_qos = "batch"
            self.counters["downgraded"] += 1
            if self.tracer is not None:
                self.tracer.instant("downgrade", cat="sched", rid=h.id,
                                    qos=qos)
        self.queue.append(h)
        return h

    def _quota_blocks(self, plen: int, start: int, max_new: int) -> int:
        """Worst-case blocks a request allocates. Full attention: the
        logical blocks from its (block-aligned) prefix hit ``start`` to
        its sequence cap. A sliding-window ring can wrap a write onto any
        logical block: one allocation per logical block it writes, plus
        one per trie-registrable prompt chunk (a block it computes, shares,
        then copies on a later wrap)."""
        seq_cap = min(self.ecfg.max_len, plen + max_new)
        if self.cfg.attn.sliding_window is None:
            return -(-seq_cap // self._bt) - start // self._bt
        n_write = -(-min(self._C_pad, seq_cap) // self._bt)
        n_reg = plen // self._bt \
            if (self.trie is not None and plen <= self._C_attn) else 0
        return n_write + n_reg

    def _row_cap_prefill(self, bucket: int) -> Optional[int]:
        """The per-row MoE capacity of a prefill at this length bucket
        (None when ``row_capacity_norm`` is off): it depends only on the
        request's own length, never on the rows beside it."""
        if self._row_cap_decode is None:
            return None
        return moe_capacity(bucket, self.cfg.moe, self.ecfg.capacity_factor)

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

    @staticmethod
    def _gather_sampling_rows(logits: torch.Tensor,
                              rows: List[int]) -> Dict[int, np.ndarray]:
        """The (V,) float32 logits of only the given rows, gathered on the
        device and shipped in one transfer: row → numpy array."""
        if not rows:
            return {}
        idx = torch.as_tensor(rows, dtype=torch.int64).to(logits.device)
        sub = logits[idx].float().cpu().numpy()
        return {r: sub[j] for j, r in enumerate(rows)}

    # -- paged-mode helpers --------------------------------------------
    def _reclaim_blocks(self, need: int) -> int:
        return self.trie.evict(need) if self.trie is not None else 0

    def _apply_copies(self, cows: List[Tuple[int, int]]) -> None:
        """The copy-on-write obligations (src, dst) as block copies on the
        device, in every layer of every pool, before the forward that
        writes them (on the current stream, outside any capture). Every
        source is gathered before any destination is written."""
        if not cows:
            return
        src = self._dev([s for s, _ in cows])
        dst = self._dev([d for _, d in cows])
        for p in self._attn_pos:
            c = self.caches[p]
            for a in (c.k, c.v):
                a[:, dst] = a[:, src]
        self.counters["kv_cow_copies"] += len(cows)

    def _ensure_write(self, lease: KVLease, pos: int,
                      cows: List[Tuple[int, int]]) -> Tuple[int, int]:
        """The physical (block, offset) a write at position ``pos`` goes
        to, collecting any copy-on-write obligation."""
        s = pos % self._C_pad
        phys, cow = lease.ensure(s // self._bt)
        if cow >= 0:
            cows.append((cow, phys))
        return phys, s % self._bt

    def _write_span_blocks(self, start: int, end: int) -> List[int]:
        """Logical blocks whose slots the positions [start, end) write."""
        if end - start >= self._C_pad:
            return list(range(self._nb))
        s0, s1 = start % self._C_pad, (end - 1) % self._C_pad
        if s0 <= s1:
            return list(range(s0 // self._bt, s1 // self._bt + 1))
        return sorted(set(range(0, s1 // self._bt + 1)) |
                      set(range(s0 // self._bt, self._nb)))

    def _pin_hits(self, toks: np.ndarray, max_blocks: int) -> List[int]:
        """Trie hits for ``toks``, retained at once: the quota reservation
        that follows may reclaim trie-only blocks, and a bare match holds
        no reference."""
        if self.trie is None:
            return []
        hits = self.trie.match(toks, max_blocks=max_blocks)
        for blk in hits:
            self.pool.retain(blk)
        return hits

    def _unpin(self, hits: List[int]) -> None:
        for blk in hits:
            self.pool.release(blk)

    def _headroom(self, extra: int = 0) -> bool:
        """Physically room for one more sequence beside the running ones
        (and ``extra`` being admitted): default sizing always has it."""
        running = sum(s is not None for s in self.slots) + extra
        return (running + 1) * self._nb <= self.pool.n_blocks - 1

    def _lease(self, h: RequestHandle, plen: int, start: int, max_new: int,
               hits: List[int]) -> Optional[KVLease]:
        """The quota gate and the lease, the pinned hits adopted; None (the
        hits unpinned) when the envelope cannot fund the request yet."""
        quota = self._quota_blocks(plen, start, max_new)
        if not self.pool.try_reserve_quota(quota):
            self._unpin(hits)
            return None
        lease = KVLease(self.pool, self._nb, quota)
        if hits:
            lease.adopt_prefix(hits, retained=True)
        return lease

    def _register(self, toks: np.ndarray, lease: KVLease, n: int) -> None:
        """Offer the first ``n // block_tokens`` whole blocks of ``toks``
        to the trie, when all ``n`` tokens fit the logical cache (a ring's
        later wraps would leave stale chunks in the trie)."""
        if self.trie is not None and n // self._bt and n <= self._C_attn:
            self.trie.insert(toks[:n], [int(lease.table[j])
                                        for j in range(n // self._bt)])

    # -- load signals ------------------------------------------------------
    def load_snapshot(self) -> Dict[str, float]:
        """The shed policy's inputs: queue depth, the decode TPOT EMA, the
        queue wait they imply, the envelope's headroom, residency
        readiness."""
        queued = sum(h.request.max_new_tokens +
                     max(0, len(h.prompt()) - h._chunk_pos)
                     for h in self.queue)
        frac = getattr(self.backend, "ready_frac", None)
        return {"queue_depth": float(len(self.queue)),
                "tpot_ema_s": float(self._tpot_ema),
                "est_wait_s": float(queued * self._tpot_ema /
                                    max(1, self.ecfg.max_slots)),
                "budget_headroom_frac": float(self.budget.headroom_frac()),
                "residency_ready_frac":
                    float(frac()) if frac is not None else 1.0}

    def _shed_expired(self) -> None:
        """Drop queued batch-tier work whose deadline already passed."""
        if not self.sched.cfg.drop_expired_batch or not self.queue:
            return
        now = self._now()

        def expired(h):
            d = h.request.deadline_ms
            return h.qos == "batch" and d is not None and \
                (now - h.submit_s) * 1e3 > d

        for h in self.queue.prune(expired):
            h.state = RequestState.SHED
            self.counters["shed_requests"] += 1
            if self.tracer is not None:
                self.tracer.instant("shed", cat="sched", rid=h.id,
                                    qos=h.qos, reason="deadline")

    # ------------------------------------------------------------------
    def _admit(self, finished: List[RequestHandle]) -> None:
        """Fill free slots from the queue: resumes and chunked admissions
        from the head position, else one bucketed, masked prefill of up to
        ``prefill_rows`` same-bucket requests (in paged mode the bucket of
        the SUFFIX after the trie hit)."""
        while self.queue:
            free = [i for i, h in enumerate(self.slots) if h is None]
            if not free:
                return
            head = self.queue.peek()
            if head._snapshot is not None or self._chunk_eligible(head):
                self.queue.popleft()
                if head._snapshot is None:
                    ok = self._begin_chunked(head, free[0])
                elif self.pool is None:
                    ok = self._resume_dense(head, free[0])
                else:
                    ok = self._resume_paged(head, free[0])
                if not ok:
                    # Blocked on quota/headroom — back to the head.
                    self.queue.appendleft(head)
                    return
                continue
            limit = min(len(free), self._prefill_rows)
            group: List[Tuple[RequestHandle, Optional[KVLease], int]] = []
            skipped: List[RequestHandle] = []
            bucket = None
            while self.queue and len(group) < limit:
                h = self.queue.popleft()
                if h._snapshot is not None or self._chunk_eligible(h):
                    skipped.append(h)
                    continue
                toks = h.prompt()
                plen = toks.shape[0]
                if self.pool is None:
                    if bucket is None:
                        bucket = self._bucket_len(plen)
                    if self._bucket_len(plen) != bucket:
                        skipped.append(h)
                        continue
                    group.append((h, None, 0))
                    continue
                hits = self._pin_hits(toks, min((plen - 1) // self._bt,
                                                self._nb))
                start = len(hits) * self._bt
                b = self._bucket_len(plen - start)
                if bucket is None:
                    bucket = b
                lease = None
                if b == bucket and self._headroom(len(group)):
                    lease = self._lease(h, plen, start,
                                        h.request.max_new_tokens, hits)
                else:
                    self._unpin(hits)
                if lease is None:
                    skipped.append(h)
                    if not group and b == bucket:
                        break          # head blocked — retry next step
                    continue
                h.prefix_hit_tokens = start
                group.append((h, lease, start))
            self.queue.extendleft(reversed(skipped))
            if not group:
                return
            self._prefill_group(group, free, bucket, finished)

    def _prefill_group(self, group, free, bucket, finished) -> None:
        R, G = self._prefill_rows, len(group)
        lengths = np.zeros(R, np.int64)          # TOTAL prompt lengths
        starts = np.zeros(R, np.int64)
        toks = np.full((R, bucket), self.ecfg.pad_token_id, np.int64)
        for r, (h, _, start) in enumerate(group):
            p = h.prompt()
            lengths[r], starts[r] = p.shape[0], start
            toks[r, :p.shape[0] - start] = p[start:]
        kw = dict(bank=self.banks, capacity_factor=self.ecfg.capacity_factor,
                  per_row_counts=True, moe_dispatch=self.moe_dispatch,
                  row_capacity=self._row_cap_prefill(bucket))
        if self.pool is not None:
            tables = np.full((R, self._nb), -1, np.int32)
            cows: List[Tuple[int, int]] = []
            for r, (h, lease, start) in enumerate(group):
                for j in self._write_span_blocks(start, int(lengths[r])):
                    phys, cow = lease.ensure(j)
                    if cow >= 0:
                        cows.append((cow, phys))
                tables[r] = lease.table
                h.lease = lease
            self._apply_copies(cows)
            t0 = time.perf_counter()
            # Mamba positions prefill into fresh rows from a zero state.
            rows = init_mamba_rows(self.cfg, R, self.device)
            logits, counts = prefill_paged(
                self.params, self.cfg, self._dev(toks),
                {**self.caches, **rows}, self._dev(tables, torch.int32),
                self._dev(starts), self._dev(lengths),
                has_prefix=bool((starts > 0).any()), **kw)
        else:
            # Fresh row caches, then a copy into the slots' rows.
            t0 = time.perf_counter()
            rows = init_caches(self.cfg, R, self.ecfg.max_len, self.device)
            logits, counts = prefill(self.params, self.cfg, self._dev(toks),
                                     rows, self._dev(lengths), **kw)
        # The admitted slots' rows only, in place: every other slot keeps
        # its state.
        slots = self._dev(free[:G])
        for pos, c in rows.items():
            for dst, src in zip(self.caches[pos], c):
                dst[:, slots] = src[:, :G]
        amax, counts_np = self._fetch(torch.argmax(logits, -1), counts)
        dt = self._elapsed(t0)
        self.prefill_shapes.add((R, bucket))
        self._note_degraded(counts_np, [(r, h) for r, (h, _, _)
                                        in enumerate(group)])
        for h, lease, _ in group:
            if lease is not None:
                self._register(h.prompt(), lease, h.prompt().shape[0])
        samp = self._gather_sampling_rows(
            logits, [r for r, (h, _, _) in enumerate(group)
                     if not h.sampler.greedy])
        stall = self._observe_prefill(counts_np, dt, G)
        for r, (h, _, start) in enumerate(group):
            slot = free[r]
            h.stall_exposure_s += stall
            if self.tracer is not None:
                self.tracer.instant("admit", cat="sched", rid=h.id, slot=slot,
                                    qos=h.exec_qos)
            h.slot = slot
            # Per-request attribution needs row-resolved counts: a padded
            # regime whose rows do not tile over data gives only (nsb, E).
            h.expert_counts = {k: v[:, r].astype(np.int64)
                               for k, v in counts_np.items() if v.ndim == 3}
            self.slots[slot] = h
            self.counters["admitted"] += 1
            self.counters["prefill_tokens"] += int(lengths[r]) - start
            self.counters["prefix_hit_tokens"] += start
            self._first_token(h, slot, int(lengths[r]), r, amax, samp,
                              finished)
        self.counters["prefills"] += 1

    def _observe_prefill(self, counts_np, dt: float, G: int) -> float:
        """A prefill's counts (its first ``G`` rows real) to the backend;
        its modeled stall onto the stall clock. Returns the stall. Under a
        distribution context the clock is agreed again here, so that the
        first tokens' time stamps count the prefill."""
        self._agree_clock()
        self.last_row_counts = counts_np
        row_valid = np.zeros(self._prefill_rows, bool)
        row_valid[:G] = True
        stall = self.backend.observe(counts_np, dt, prefill=True,
                                     row_valid=row_valid)
        self._stall_clock += stall
        return stall

    def _first_token(self, h: RequestHandle, slot: int, plen: int, r: int,
                     amax, samp, finished) -> None:
        """A prefill's last forward emitted row ``r``: the request's first
        token (emission index 0), TTFT, and the slot's decode state."""
        tok = int(amax[r]) if r not in samp else \
            h.sampler.next_token(samp[r], 0)
        h.tokens.append(tok)
        h.first_token_s = h.last_progress_s = self._now()
        h.ttft_s = h.first_token_s - h.submit_s + self._stall_clock - \
            h.stall_at_submit
        self.ttfts.append(h.ttft_s)
        h.state = RequestState.RUNNING
        self.pos[slot] = plen
        self.tokens[slot] = tok
        if self._done(h):
            self._finish(h, finished)

    def _done(self, h: RequestHandle) -> bool:
        req = h.request
        if req.eos_token_id is not None:
            # A speculative round can accept a burst with EOS in the
            # middle: check every token not yet checked and truncate the
            # output at the first EOS.
            toks = h.tokens
            for t in range(h._eos_scanned, len(toks)):
                if toks[t] == req.eos_token_id:
                    del toks[t + 1:]
                    h._eos_scanned = len(toks)
                    return True
            h._eos_scanned = len(toks)
        if len(h.tokens) >= req.max_new_tokens:
            return True
        return int(self.pos[h.slot]) >= self.ecfg.max_len

    def _finish(self, h: RequestHandle, finished) -> None:
        h.state = RequestState.FINISHED
        h.finish_s = self._now()
        self.slots[h.slot] = None
        if h.lease is not None:
            # Trie-registered blocks keep the trie's own reference.
            h.lease.close()
        self.counters["finished"] += 1
        if self.tracer is not None:
            self.tracer.instant("finish", cat="sched", rid=h.id,
                                tokens=len(h.tokens))
        finished.append(h)

    # ------------------------------------------------------------------
    # Preemption: on the pool the evicted request's valid K/V lanes go to
    # the host and its lease closes; resume re-admits through the same
    # gates as a fresh request, adopting the trie hits and uploading only
    # the lanes the trie lost. On dense rows its whole row goes to the host
    # and resume writes it into any free slot (a row is indexed by
    # position, not bound to its slot). Cached tokens = seq[:pos] and the
    # next input is tokens[-1], and sampling is keyed by the request's own
    # counters, so the resumed continuation is the uninterrupted one.
    # ------------------------------------------------------------------
    def preempt(self, h: RequestHandle) -> None:
        """Evict a RUNNING request and requeue it at the front of its QoS
        tier (its queue age kept)."""
        if h.state is not RequestState.RUNNING:
            raise ValueError(f"preempt of a {h.state.value} request (only "
                             f"RUNNING requests hold evictable state)")
        slot, pos = h.slot, int(self.pos[h.slot])
        # What attention can still read: the whole history, or a ring's
        # last window (distinct slots, one lane each).
        snap = SlotSnapshot(pos=pos, span_start=max(0, pos - self._C_attn))
        # Host copies (``copy=True``: on the CPU a bare ``.cpu()`` would
        # alias the slot's rows, which the next admission rewrites).
        if self._mamba_pos:
            snap.mamba_rows = {p: tuple(t[:, slot].to("cpu", copy=True)
                                        for t in self.caches[p])
                               for p in self._mamba_pos}
        if self.pool is None:
            snap.attn_rows = {p: tuple(t[:, slot].to("cpu", copy=True)
                                       for t in self.caches[p])
                              for p in self._attn_pos}
        else:
            span = np.arange(snap.span_start, pos) % self._C_pad
            snap.attn_lanes = self._gather_lanes(
                h.lease.table[span // self._bt], span % self._bt)
            # The full blocks stay warm in the trie (its own reference): an
            # early resume adopts them instead of uploading.
            seq = np.concatenate([h.prompt(),
                                  np.asarray(h.tokens, np.int64)])
            self._register(seq, h.lease, pos)
            h.lease.close()
            h.lease = None
        self.slots[slot] = None
        self.tokens[slot] = self.ecfg.pad_token_id
        h.slot = None
        h.state = RequestState.QUEUED
        h._snapshot = snap
        h.preempts += 1
        self.counters["preemptions"] += 1
        if self.tracer is not None:
            self.tracer.instant("preempt", cat="sched", rid=h.id, slot=slot,
                                pos=pos)
        self.queue.appendleft(h)

    def _gather_lanes(self, blk: np.ndarray, off: np.ndarray):
        """Host copies of the K/V at the physical lanes (blk[i], off[i]) of
        every layer: {position: (k, v)}, each (W, nsb, Hkv, hd)."""
        b, o = self._dev(blk), self._dev(off)
        return {p: (self.caches[p].k[:, b, :, o].cpu(),
                    self.caches[p].v[:, b, :, o].cpu())
                for p in self._attn_pos}

    def _restore_lanes(self, lanes, sel: np.ndarray, blk: np.ndarray,
                       off: np.ndarray) -> None:
        """Upload snapshot lanes ``sel`` into physical lanes (blk, off)."""
        b, o = self._dev(blk), self._dev(off)
        s = torch.as_tensor(sel, dtype=torch.int64)
        for p in self._attn_pos:
            c = self.caches[p]
            k, v = lanes[p]
            c.k[:, b, :, o] = k[s].to(self.device)
            c.v[:, b, :, o] = v[s].to(self.device)

    def _maybe_preempt(self) -> None:
        """After admission: a higher-class head still queued behind
        strictly lower-class running work evicts one victim."""
        if not self.sched.cfg.preemption or not self.queue:
            return
        head = self.queue.peek()
        running = [(i, h) for i, h in enumerate(self.slots)
                   if h is not None and h.state is RequestState.RUNNING]
        victim = self.sched.pick_victim(running, head.qos)
        if victim is not None:
            self.preempt(victim[1])

    def _resume_dense(self, h: RequestHandle, slot: int) -> bool:
        """Write the snapshot's whole rows into ``slot``'s row. Cannot be
        blocked: dense rows are preallocated and hold no quota."""
        for p, (k, v) in h._snapshot.attn_rows.items():
            self.caches[p].k[:, slot] = k.to(self.device)
            self.caches[p].v[:, slot] = v.to(self.device)
        self._finish_resume(h, slot)
        return True

    def _finish_resume(self, h: RequestHandle, slot: int) -> None:
        """The slot's Mamba rows from the snapshot (whole state: it has no
        per-position structure), then the slot's decode state."""
        for p, rows in (h._snapshot.mamba_rows or {}).items():
            for dst, src in zip(self.caches[p], rows):
                dst[:, slot] = src.to(self.device)
        pos = h._snapshot.pos
        self.slots[slot] = h
        h.slot = slot
        h.state = RequestState.RUNNING
        self.pos[slot] = pos
        self.tokens[slot] = h.tokens[-1]
        h._snapshot = None
        self.counters["resumes"] += 1
        if self.tracer is not None:
            self.tracer.instant("resume", cat="sched", rid=h.id, slot=slot,
                                pos=pos)

    def _resume_paged(self, h: RequestHandle, slot: int) -> bool:
        """The admission gates of a fresh request (trie match → pin,
        headroom, quota), then the upload of the lanes the trie does not
        cover. False: blocked."""
        snap = h._snapshot
        pos = snap.pos
        seq = np.concatenate([h.prompt(), np.asarray(h.tokens, np.int64)])
        hits = self._pin_hits(seq[:pos], min(pos // self._bt, self._nb)) \
            if pos <= self._C_attn else []
        start = len(hits) * self._bt
        if not self._headroom():
            self._unpin(hits)
            return False
        lease = self._lease(h, pos, start,
                            h.request.max_new_tokens - len(h.tokens), hits)
        if lease is None:
            return False
        span = np.arange(max(start, snap.span_start), pos)
        if span.size:
            slot_of = span % self._C_pad
            cows: List[Tuple[int, int]] = []
            for j in sorted({int(x) // self._bt for x in slot_of}):
                phys, cow = lease.ensure(j)
                if cow >= 0:
                    cows.append((cow, phys))
            self._apply_copies(cows)
            self._restore_lanes(snap.attn_lanes, span - snap.span_start,
                                lease.table[slot_of // self._bt],
                                slot_of % self._bt)
        h.lease = lease
        self._finish_resume(h, slot)
        return True

    # ------------------------------------------------------------------
    # Chunked prefill: a long prompt takes its slot, lease and whole quota
    # at once but prefills one chunk per step, each a suffix prefill over
    # the blocks before it, at a bucket shape.
    # ------------------------------------------------------------------
    def _chunk_eligible(self, h: RequestHandle) -> bool:
        """Prompts longer than a chunk; a windowed prompt only while it
        fits the window (a ring wrap mid-prompt would change which
        positions a later chunk may overwrite)."""
        plen = len(h.prompt())
        return bool(self._chunk_tokens) and plen > self._chunk_tokens and \
            (self.cfg.attn.sliding_window is None or plen <= self._C_attn)

    def _begin_chunked(self, h: RequestHandle, slot: int) -> bool:
        """Trie match and quota gate as a normal admission, no forward yet:
        the request turns PREFILLING. False: blocked."""
        toks = h.prompt()
        plen = toks.shape[0]
        hits = self._pin_hits(toks, min((plen - 1) // self._bt, self._nb))
        start = len(hits) * self._bt
        if not self._headroom():
            self._unpin(hits)
            return False
        lease = self._lease(h, plen, start, h.request.max_new_tokens, hits)
        if lease is None:
            return False
        h.prefix_hit_tokens = start
        h.lease = lease
        h._chunk_pos = start
        h.state = RequestState.PREFILLING
        h.slot = slot
        self.slots[slot] = h
        self.pos[slot] = 0
        self.tokens[slot] = self.ecfg.pad_token_id
        self.counters["admitted"] += 1
        self.counters["prefix_hit_tokens"] += start
        return True

    def _advance_chunk_prefills(self, finished) -> None:
        """One batched suffix prefill over the next chunk of up to
        ``prefill_rows`` same-bucket chunking requests. A final chunk emits
        the request's first token and turns it RUNNING."""
        chunking = [(i, h) for i, h in enumerate(self.slots)
                    if h is not None and h.state is RequestState.PREFILLING]
        if not chunking:
            return

        def next_chunk(h):
            return min(self._chunk_tokens, len(h.prompt()) - h._chunk_pos)

        R = self._prefill_rows
        bucket = self._bucket_len(next_chunk(chunking[0][1]))
        group = [(i, h) for i, h in chunking
                 if self._bucket_len(next_chunk(h)) == bucket][:R]
        lengths = np.zeros(R, np.int64)      # prefix + chunk
        starts = np.zeros(R, np.int64)
        tables = np.full((R, self._nb), -1, np.int32)
        toks = np.full((R, bucket), self.ecfg.pad_token_id, np.int64)
        cows: List[Tuple[int, int]] = []
        for r, (_, h) in enumerate(group):
            cpos, clen = h._chunk_pos, next_chunk(h)
            starts[r], lengths[r] = cpos, cpos + clen
            toks[r, :clen] = h.prompt()[cpos:cpos + clen]
            for j in self._write_span_blocks(cpos, cpos + clen):
                phys, cow = h.lease.ensure(j)
                if cow >= 0:
                    cows.append((cow, phys))
            tables[r] = h.lease.table
        self._apply_copies(cows)
        t0 = time.perf_counter()
        logits, counts = prefill_paged(
            self.params, self.cfg, self._dev(toks), self.caches,
            self._dev(tables, torch.int32), self._dev(starts),
            self._dev(lengths), bank=self.banks,
            capacity_factor=self.ecfg.capacity_factor, per_row_counts=True,
            has_prefix=True, moe_dispatch=self.moe_dispatch,
            row_capacity=self._row_cap_prefill(bucket))
        amax, counts_np = self._fetch(torch.argmax(logits, -1), counts)
        dt = self._elapsed(t0)
        self.prefill_shapes.add((R, bucket))
        stall = self._observe_prefill(counts_np, dt, len(group))
        for _, h in group:
            h.stall_exposure_s += stall
        self._note_degraded(counts_np, [(r, h) for r, (_, h)
                                        in enumerate(group)])
        samp = self._gather_sampling_rows(
            logits, [r for r, (_, h) in enumerate(group)
                     if not h.sampler.greedy and
                     int(lengths[r]) == len(h.prompt())])
        for r, (i, h) in enumerate(group):
            h._chunk_pos = int(lengths[r])
            self.counters["prefill_tokens"] += int(lengths[r] - starts[r])
            sub = {k: v[:, r].astype(np.int64)
                   for k, v in counts_np.items() if v.ndim == 3}
            if h.expert_counts is None:
                h.expert_counts = sub
            else:
                for k, v in sub.items():
                    if k in h.expert_counts:
                        h.expert_counts[k] += v
            plen = len(h.prompt())
            if h._chunk_pos < plen:
                continue                     # more chunks to go
            self._register(h.prompt(), h.lease, plen)
            self._first_token(h, i, plen, r, amax, samp, finished)
        self.counters["prefills"] += 1
        self.counters["chunk_prefills"] += 1

    # ------------------------------------------------------------------
    def step(self) -> List[RequestHandle]:
        """Run the watchdogs, shed expired batch work, admit, preempt for a
        blocked higher class, advance chunked prefills by one chunk, then
        advance every running request, one decode per tier group (with
        ``spec_k`` the premium and standard rows by a speculative round,
        else by one token on the served banks; then the batch tier on the
        all-lo view). Returns the handles that finished. Under a
        distribution context the whole step runs inside it, on one agreed
        clock reading."""
        if self.dist is None:
            return self._step()
        self._agree_clock()
        with dist_ctx(self.dist):
            return self._step()

    def _step(self) -> List[RequestHandle]:
        finished: List[RequestHandle] = []
        if self._watchdog is not None:
            # Before this step makes progress: a request wedged in earlier
            # steps still carries its stale stamp, and a cancelled
            # promotion's slot can be taken again this step.
            self._watchdog.scan(self)
        if self._ready_fn is not None and not self._ready_fn():
            # Streaming cold start: the ladder is still materializing, so
            # only its staging windows run; requests queue, and no forward
            # may read a partially materialized expert.
            self.backend.tick()
            return finished
        self._shed_expired()
        self._admit(finished)
        self._maybe_preempt()
        self._advance_chunk_prefills(finished)
        active = [(i, h) for i, h in enumerate(self.slots)
                  if h is not None and h.state is RequestState.RUNNING]
        if active:
            for kind, rows in self.sched.decode_groups(
                    active, self._spec is not None):
                # A speculative round falls back to the one-token step
                # when no row has draft headroom (one token left).
                if kind == "spec" and self._spec.round(rows, finished):
                    continue
                self._decode_one(rows, finished, lo=kind == "lo")
        self.backend.tick()
        if self.obs is not None:
            self._step_obs()
        return finished

    def _step_obs(self) -> None:
        """The step's ``step`` event with the per-step gauges, and the
        metrics at their sampling cadence. Every value is a count or a
        modeled quantity, never a duration, so virtual-clock replays trace
        byte-identically."""
        a0, p0, l0 = self._obs_prev
        self._obs_prev = (self._disp_active_sum, self._disp_pad_sum,
                          self._disp_layers)
        d_lay = self._disp_layers - l0
        active = (self._disp_active_sum - a0) / d_lay if d_lay else 0.0
        pad = (self._disp_pad_sum - p0) / d_lay if d_lay else 0.0
        mix = self.backend.residency_mix()
        headroom = float(self.budget.headroom_frac())
        depths = self.queue.depths()
        running = sum(h is not None for h in self.slots)
        step = self.counters["steps"]
        if self.tracer is not None:
            self.tracer.instant(
                "step", cat="engine", step=step,
                active_experts=round(active, 4), pad_ratio=round(pad, 4),
                hi=mix["hi"], lo=mix["lo"], host=mix["host"],
                headroom=round(headroom, 6), queued=len(self.queue),
                running=running)
        if self.metrics is not None and step % self._sample_every == 0:
            m = self.metrics
            m.gauge("engine_active_experts",
                    "mean experts with routed tokens per layer-step").set(
                        active)
            m.gauge("engine_dispatch_pad_ratio",
                    "padding fraction of the MoE dispatch layout").set(pad)
            m.gauge("residency_hi_cells").set(mix["hi"])
            m.gauge("residency_lo_cells").set(mix["lo"])
            m.gauge("residency_host_cells").set(mix["host"])
            m.gauge("budget_headroom_frac",
                    "shared HBM envelope headroom").set(headroom)
            for q, d in depths.items():
                m.gauge(f"queue_depth_{q}").set(d)
            if self._spec is not None:
                m.gauge("spec_accept_rate").set(
                    self._spec.accepted_total /
                    max(1, self._spec.draft_total))
            m.sample(step=step, active_experts=round(active, 4),
                     pad_ratio=round(pad, 4), hi=mix["hi"], lo=mix["lo"],
                     host=mix["host"], headroom=round(headroom, 6),
                     **{f"queued_{q}": d for q, d in depths.items()})

    def _decode_fn(self, lo: bool):
        """The decode step over the static inputs, on the served banks or
        (``lo``) the all-lo view: (logits (B, V) float32, one int32 buffer
        of the greedy tokens and the per-row counts)."""
        d = self.decode_graph.inputs.dev
        kw = dict(bank=self.lo_banks if lo else self.banks,
                  capacity_factor=self.ecfg.capacity_factor,
                  row_valid=d["row_valid"], per_row_counts=True,
                  moe_dispatch=self.moe_dispatch,
                  row_capacity=self._row_cap_decode)
        if self.pool is None:
            logits, counts = decode_step(self.params, self.cfg, d["tokens"],
                                         d["pos"], self.caches, **kw)
        else:
            logits, counts = decode_step_paged(
                self.params, self.cfg, d["tokens"], d["pos"], self.caches,
                d["table"], d["wblk"], d["woff"], **kw)
        self._count_shapes = {k: tuple(v.shape) for k, v in counts.items()}
        return logits, _pack(torch.argmax(logits, -1), counts)

    def _fill_step(self, active, cows: List[Tuple[int, int]]) -> np.ndarray:
        """Write the decode step's inputs into the host mirror of the
        static buffers, collecting copy-on-write obligations; returns the
        row mask. Rows not in ``active`` are vacant: masked out of dispatch
        and counts, they replay their last token at their position and
        write its K/V to the trash block (on the pool) or to their own row
        at ``pos % C`` (dense; C the row's capacity): for a row that is
        running, the slot its next step writes first."""
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
                h["wblk"][i], h["woff"][i] = self._ensure_write(
                    r.lease, int(self.pos[i]), cows)
                h["table"][i] = r.lease.table
        return h["row_valid"].copy()

    def _decode_one(self, active, finished, lo: bool = False) -> None:
        """Advance ``active`` rows by one token through the step on the
        served banks, or (``lo``) on the all-lo view."""
        graph = self.lo_graph if lo else self.decode_graph
        if graph.needs_capture:
            # Warm-up and capture with every row vacant: no count, and
            # K/V only where nothing reads them before the next real step
            # writes (``_fill_step``).
            t0 = time.perf_counter()
            self._fill_step([], [])
            graph.capture()
            self.capture_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        cows: List[Tuple[int, int]] = []
        row_valid = self._fill_step(active, cows)
        self._apply_copies(cows)
        logits, packed = graph.run()
        if self._out_host is None:
            self._out_host = torch.empty(
                packed.shape, dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        self._out_host.copy_(packed)
        amax, counts_np = _unpack(self._out_host.numpy().copy(),
                                  self.ecfg.max_slots, self._count_shapes)
        dt = self._elapsed(t0)
        samp = self._gather_sampling_rows(
            logits, [i for i, h in active if not h.sampler.greedy])
        self.last_logits = logits
        self.last_row_counts = counts_np
        self._note_dispatch(counts_np)
        self._note_degraded(counts_np, active)
        stall = self.backend.observe(counts_np, dt, prefill=False,
                                     row_valid=row_valid)
        self._stall_clock += stall
        if stall:
            for _, h in active:
                h.stall_exposure_s += stall
        latency = dt + stall
        self.decode_times.append(latency)
        self._tpot_sum += latency * len(active)
        self._tpot_tokens += len(active)
        self._tpot_ema = latency if self._tpot_ema == 0.0 else \
            0.9 * self._tpot_ema + 0.1 * latency
        now = self._now()
        for i, h in active:
            tok = int(amax[i]) if i not in samp else \
                h.sampler.next_token(samp[i], len(h.tokens))
            h.tokens.append(tok)
            h.step_times.append(latency)
            h.last_progress_s = now
            for k, v in counts_np.items():
                if v.ndim == 3 and k in h.expert_counts:
                    h.expert_counts[k] += v[:, i]
            self.tokens[i] = tok
            self.pos[i] += 1
            if self._done(h):
                self._finish(h, finished)
        self.counters["steps"] += 1

    def _note_degraded(self, counts_np: Dict[str, np.ndarray], rows) -> None:
        """Flag the requests whose forward routed through a quarantined
        expert cell. ``counts_np``: the forward's per-row counts (nsb, R, E)
        already on the host; ``rows``: (row, handle) pairs."""
        if self._degraded_fn is None:
            return
        cells = self._degraded_fn()
        for pos, q in cells.items():
            v = counts_np.get(pos)
            if v is None or v.ndim != 3:
                continue
            hit = ((v > 0) & q[:, None, :]).any(axis=(0, 2))
            for r, h in rows:
                if hit[r]:
                    h.degraded = True

    def _note_dispatch(self, counts_np: Dict[str, np.ndarray]) -> None:
        """Host mirror of the dispatch gauges: active experts per layer and
        the padding of the configured layout (intra-tile slack of the
        ragged layout, or empty rows of the padded (E, C) buffer). Counts
        are (nsb, B, E) per decode step, or (W, nsb, B, E) per speculative
        verify (one entry per step and layer)."""
        if not self.cfg.is_moe or not counts_np:
            return
        E = self.cfg.moe.num_experts
        if self._row_cap_decode is not None:
            C = self.ecfg.max_slots * self._row_cap_decode
        else:
            C = moe_capacity(self.ecfg.max_slots, self.cfg.moe,
                             self.ecfg.capacity_factor)
        for v in counts_np.values():
            # (W, nsb, B, E) and (nsb, B, E) sum their rows; (nsb, E)
            # aggregated counts (a padded regime's rows not tiling) as is.
            per = (v.sum(axis=-2) if v.ndim >= 3 else v).reshape(
                -1, E).astype(np.float64)
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

    # ------------------------------------------------------------------
    def drain(self) -> List[RequestHandle]:
        """Run ``step()`` until nothing is queued or running; returns the
        handles finished meanwhile. Raises ``EngineStallError`` when the
        engine idles for hundreds of steps with queued work it cannot
        admit."""
        done: List[RequestHandle] = []
        stalled = 0
        while self.queue or any(h is not None for h in self.slots):
            before = len(self.queue)
            done.extend(self.step())
            stalled = self._check_admission_stall(stalled, before)
        return done

    def _check_admission_stall(self, stalled: int, queue_before: int) -> int:
        if self._ready_fn is not None and not self._ready_fn():
            return 0    # a cold start still staging: queueing is progress
        idle = not any(h is not None for h in self.slots)
        if self.queue and idle and len(self.queue) == queue_before:
            stalled += 1
            if stalled > 256:
                raise EngineStallError(self._stall_snapshot())
            return stalled
        return 0

    def _stall_snapshot(self) -> Dict[str, object]:
        return {
            "queued_total": len(self.queue),
            "queue_depths": self.queue.depths(),
            "running": sum(1 for h in self.slots if h is not None),
            "budget_used": int(self.budget.used),
            "budget_cap": int(self.budget.cap),
            "budget_headroom_frac": float(self.budget.headroom_frac()),
            "residency_ready_frac": self.load_snapshot()[
                "residency_ready_frac"],
            "pending_promotions": self._pending_promotions(),
            "counters": dict(self.counters),
        }

    def _pending_promotions(self) -> List[Dict[str, object]]:
        pend = getattr(self.backend, "pending_promotions", None)
        if pend is None:
            return []
        return [{"pos": str(p), "layer": int(l), "expert": int(e),
                 "age_s": float(a)} for p, l, e, a in pend(self._now())]

    def replay(self, stream, realtime: bool = True,
               virtual_step_s: float = 2e-3) -> List[RequestHandle]:
        """Serve an arrival-timed request stream (e.g. ``RequestStream``).

        ``realtime=True``: each request is submitted once the wall clock,
        from the start of the replay, passes its ``arrival_s``; an idle
        engine skips ahead to the next arrival. ``realtime=False``: a
        virtual clock replaces the wall clock for every engine time stamp;
        it advances ``virtual_step_s`` per step and jumps idle gaps, so the
        interleaving of arrivals and admissions (and every token) is
        deterministic. Returns the handles in arrival order, all finished
        (or shed)."""
        requests = list(stream)
        handles: List[RequestHandle] = []
        i, now, stalled = 0, 0.0, 0
        t0 = time.perf_counter()
        try:
            if not realtime:
                self._clock = now
            while i < len(requests) or self.queue or \
                    any(h is not None for h in self.slots):
                if realtime:
                    now = time.perf_counter() - t0
                    if self.dist is not None:
                        now = agree(now, self.dist)
                while i < len(requests) and requests[i].arrival_s <= now:
                    handles.append(self.submit(requests[i]))
                    i += 1
                if i < len(requests) and not self.queue and \
                        all(h is None for h in self.slots):
                    if not realtime:
                        now = requests[i].arrival_s
                        self._clock = now
                    handles.append(self.submit(requests[i]))
                    i += 1
                before = len(self.queue)
                self.step()
                if i >= len(requests):
                    stalled = self._check_admission_stall(stalled, before)
                if not realtime:
                    now += virtual_step_s
                    self._clock = now
        finally:
            self._clock = None
        return handles

    def generate(self, batch: Dict, n_tokens: int, sampling=None, qos=None,
                 deadline_ms=None):
        """Whole-batch shim over submit + drain: ``batch`` {"tokens": (B,
        S)} with B ≤ ``max_slots``. Returns (tokens (B, n_tokens) int32
        numpy, mean TTFT, the decode steps' latencies). Token-only: image
        or audio embeddings go through ``models.model.prefill`` /
        ``decode_step`` directly."""
        extra = set(batch) - {"tokens"}
        if extra:
            raise NotImplementedError(f"the engine serves token-only "
                                      f"requests; got {sorted(extra)}")
        toks = np.asarray(batch["tokens"])
        B = toks.shape[0]
        if B > self.ecfg.max_slots:
            raise ValueError(f"batch {B} > max_slots={self.ecfg.max_slots}")
        if toks.shape[1] + n_tokens - 1 > self.ecfg.max_len:
            raise ValueError(f"{toks.shape[1]}-token prompts + {n_tokens} "
                             f"new tokens exceed max_len="
                             f"{self.ecfg.max_len}")
        handles = [self.submit(Request(tokens=toks[i],
                                       max_new_tokens=n_tokens,
                                       sampling=sampling, qos=qos,
                                       deadline_ms=deadline_ms))
                   for i in range(B)]
        n_before = len(self.decode_times)
        self.drain()
        out = np.stack([h.token_array() for h in handles], 0)
        ttft = float(np.mean([h.ttft_s for h in handles]))
        return out, ttft, self.decode_times[n_before:]

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
        if self._spec is not None:
            out.update(self._spec.stats())
        if self._disp_layers:
            out["active_experts"] = self._disp_active_sum / self._disp_layers
            out["dispatch_pad_ratio"] = self._disp_pad_sum / \
                self._disp_layers
        if self.pool is not None:
            out["kv_blocks_in_use"] = float(self.pool.blocks_in_use)
            out["kv_bytes_in_use"] = float(self.pool.bytes_in_use)
        if self.trie is not None:
            out["prefix_trie_nodes"] = float(self.trie.n_nodes)
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
