"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only card,build,kernels
    python3 chip_smoke.py --only card,build,kernels,serving
    python3 chip_smoke.py --only card,build,model,requests
    python3 chip_smoke.py --only card,build,spec
    python3 chip_smoke.py --only card,build,ladder
    python3 chip_smoke.py --only card,build,obs
    python3 chip_smoke.py --only card,build,hybrid [--parent DIR]
    python3 chip_smoke.py --only card,build,families
    python3 chip_smoke.py --only card,build,multimodal
    python3 chip_smoke.py --only card,build,train
    python3 chip_smoke.py --only card,build,ep
    python3 chip_smoke.py --only card,build,ep,dryrun

Phases (each prints one line; any failure exits non-zero):

1. card     — name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — each of the eight kernels (the six TPU kernels' and the
              ragged FFN's all-hi mode) against its plain PyTorch version on
              the card at the paths' shapes (Qwen3-30B-A3B width), with
              times, the bound and the library yardstick; the two
              decode-attention kernels over several cases each (batch 8 and
              1, long rows, masked holes), timed both by an event loop
              (``ms``) and by CUDA-graph replay (``graph_ms``) in turns with
              SDPA (``library_graph_ms``); the quantized GEMMs (ragged
              FFN over five cases, grouped over six, plain at M = 1, 13
              and 128 × bits 2/4/8) by both as well, with the wrapper's
              host time per call at their main case; and the flagship
              Qwen3-80B-A3B's shapes: the ragged FFN at 512 experts top-10,
              int2, hi tiles from a 128-slot pool (decode B=8, prefill
              512), paged attention at H 16, Hkv 2, hd 256; the all-hi
              (dense bf16) mode at decode B=8 and prefill 512 of both
              models and a skewed 30B prefill (expert 0 in every top-8),
              each beside one ``torch._grouped_mm`` over the segments (its
              yardstick), and the 30B prefill's tile map shuffled and with
              one expert in two places, held to the plain version; both
              decode-attention kernels also at the families' heads
              (Danube hd 120 rep 4 past a wrap of its 4096 ring, DeepSeek
              rep 1, Llama rep 3, LLaVA rep 7) and the dense one at
              Whisper's cross-attention (1500 frames, every one valid,
              contiguous rows); with ``--parent DIR`` both against the
              parent's kernels at the 30B's, the flagship's and Jamba's
              heads (bit-equal, device ms in turns);
   splits   — both decode-attention kernels at their main shapes under
              forced split counts, each held against its plain version,
              with device (graph) and host time per call;
   gemms    — both quantized GEMMs at their main shapes under forced NT
              (8-row chunks per warp pass), K splits across CTAs and pieces
              per CTA, each held against its plain version, with device
              (graph) time: the data behind ``ops.gemm_plan``;
   dense    — (only when named) the all-hi kernels on the kernels phase's
              five cases under forced grids, run lengths, consumer warps
              and ring slots, bit-equal to the default launch, with
              device time: the data behind ``ops.DENSE_PLAN``; with
              ``--parent DIR`` (a ``git archive`` of the parent commit)
              also the parent's all-hi and quantized ragged kernels
              against this tree's in turns (the all-hi ones on this
              tree's tensor maps, at the parent's own default grid), and
              their registers and HMMA counts (``cuobjdump``);
4. model    — a 2-layer full-width model, same seeded weights on the CPU
              (plain versions) and on the card (kernels): one 32-token
              prefill and 4 teacher-forced decode steps, logits compared,
              for the paged/ragged and the dense/padded path; then padded
              against ragged dispatch on the card; then 1 full-width layer
              of the flagship (its shared expert, int2 lo) on paged/ragged;
              then the suffix prefill over cached blocks (2 layers,
              drop-free): a 96-token prompt whole, and its first 64 tokens
              then the last 32 with ``has_prefix``, pool K/V per layer and
              row and the logits against the CPU and split against whole
              on the card, and a 768-token prompt whole against three
              256-token chunks on the card, wherever every expert they
              depend on agrees. The CPU halves of these checks, of the
              hybrid phase's and the multimodal twins run in one process
              started before the build (``_CpuRefs``: nice 19, it draws
              their weights on the card first), beside the phases;
5. serving  — the SERVE_LAYERS full-width model served by ``static`` and
              ``dynaexq`` (8 requests, 64–256-token prompts, 32 new tokens)
              on each path: paged KV with ragged dispatch, and dense KV rows
              with padded dispatch; each backend four times on fresh
              engines, in turns with the decode step as one CUDA graph and
              op by op under ``engine.eager()`` (graph, eager, eager,
              graph; ``dynaexq`` flushed after every step): tokens and
              launch counts must agree; TTFT, TPOT, tok/s and the ms per
              graph replay (CUDA events); then ``dynaexq`` graphed with no
              flush until the end, its hi copies in flight while later
              replays run (finite logits, promotions served from hi,
              invariants after the flush); then the flagship on 4 of 48
              full-width layers, paged/ragged, ``static`` int2 and the
              default ``dynaexq`` (global allocator, int2 lo, int4-priced
              hi, an ``hbm_gb`` envelope for n_hi = 64), graphed then eager
              (tokens and launches must agree; the shared expert ran; a
              layer held more than n_hi hi experts). The paper's baselines
              ``fp16`` and ``offload`` (its pcie_gbps this card's measured
              pinned copy rate) on both 30B paths, graph then eager
              (identical tokens and launches, the all-hi kernels once per
              layer of every forward on the ragged path, no quantized
              kernel), ``fp16`` on the flagship graphed; and the paper's
              comparison at batch 32 on the main path: ``static``,
              ``dynaexq``, ``fp16`` and ``offload`` (its cache sized to
              dynaexq's device bytes) in turns, graphed: tokens/s (the
              modeled stall counted), TPOT, TTFT, stall, hits and misses,
              ``device_bytes()``;
   requests — the request front on the main path (SERVE_LAYERS layers,
              8 slots, max_len 1024): 24 requests x 32 tokens through
              ``replay(realtime=False)`` — 12 standard sharing a
              160-token prefix, 8 batch of 64-256 tokens, 4 premium of 768
              tokens arriving last, 4 of them sampled — served by
              ``static`` with prefix sharing, chunked prefill (256) and
              preemption on, again with all three off fed the first
              run's tokens (per position: another token only where the
              flip is rounding-sized, greedy and sampled; the share of
              positions that would pass one reported and bounded), every
              run drop-free, by ``dynaexq`` (promotions while
              the batch tier decodes on the all-lo view through the second
              graph), ``static`` eager (tokens and launches identical to
              the graphed run) and once on the wall clock
              (``realtime=True``, uninstrumented): prefill tokens computed
              against submitted, prefill ms whole and over a
              cached prefix, ms per replay of each graph, TPOT, TTFT per
              tier, the counters, pool invariants after every run;
   spec     — self-speculative decoding on the main path (8 full-width
              layers, graphed, 8 slots, 8 greedy requests of 64-256
              tokens, 32 new, all admitted in the first step): ``static``
              int4 and ``dynaexq`` (n_hi 16, hi sets from one window after
              a warm-up, then fixed) with spec off, ``spec_k=4`` adaptive
              and ``spec_k=4`` fixed: tokens identical to spec off (or
              each difference explained by routing), the backend's
              observed counts those of the accepted steps in every round,
              rounds, drafted/accepted/emitted tokens, the draft and verify
              graphs' ms per replay by width (CUDA events), TPOT per
              emitted token against spec off; then on the dense/padded
              path (4 layers): ``spec_k=2`` with ``row_capacity_norm``
              against spec off, one preemption (the resumed row read back
              bit for bit) and one ``watchdog_no_progress_s`` requeue
              against an undisturbed run, and promotion copies held behind
              a spin on the side stream, cancelled by ``promo_deadline_s``
              on the virtual clock (each refunded once);
   ladder   — the residency ladder on the main path (graphed, greedy,
              drop-free, the spec phase's 8 requests; policy frozen
              where tokens are compared): (a) a streaming cold start at
              full width and 2 of 48 layers from expert shards written
              to a temporary directory (~8 GB: the reference's float32
              hi rows) — tokens equal the engine built from the
              in-memory params, staged lo rows equal ``build_bank``'s
              byte for byte, seconds to ``serving_ready``, bytes read
              before serving against full materialization, the staging
              rate, TTFT, hi shards read by promotions — then a cold
              start with one lo shard unreadable (quarantine, degraded
              requests, healed); (b) at SERVE_LAYERS, ``model_sensitivity``
              on the card and ``dynaexq`` with the host tier
              (``lo_resident_total`` = L·E/2, priced at the card's
              pinned rate) and sensitivity weights: host fetches, the
              modeled stall, tokens equal without the host tier, hi
              sets against plain ``dynaexq``'s after the same window;
              (c) the same configuration under a fault plan (promotion copies
              failing, stalled on the virtual clock, corrupt; host
              fetches failing): invariants, no stalled copy published
              before its stall expired, no corrupt copy published,
              refunds once, tokens equal the fault-free run's;
   obs      — observability and the serving launcher: the reference
              launcher's default model (granite-moe-1b-a400m: d 1024, 32
              experts top-8, hd 64) checked on 2 full-width layers, CPU
              against the card; then (a) ``repro_torch.launch.serve.main``
              in this process at ``--full`` (24 of 24 layers), 8 requests of
              64 tokens, 32 new, with ``dynaexq`` (speculation on, the
              launcher's defaults) and ``static --no-spec``: the ragged FFN
              and paged attention kernels ran, the saved trace loads and
              the cost model folds it, its published promotion spans are
              the backend's promotions, one metrics row per step; (b) the
              30B main path at SERVE_LAYERS, ``static`` graphed with the
              recorder and registry off, on, on, off on fresh engines:
              identical tokens and launches, TPOT, replay ms and host ms
              per step; (c) ``dynaexq`` observed on the wall clock, a
              window every step, no flush until the end: every published
              promotion span ends after its copy's event completed, the
              publish latency and the bytes/token residual by bucket;
   hybrid   — the hybrid family, Jamba-v0.1-52B at full width (d 4096,
              16 experts x 14336 top-2, SSD, window 8192) on 8 of its 32
              layers (one super-block; the host's free memory read
              first): (a) the ragged FFN kernels at its shapes (int4, a
              4-slot hi pool; down walks K = 14336 in two pieces of
              shared memory), decode B=8 top-2 and prefill 512, their
              all-hi mode at both beside ``torch._grouped_mm``, and the
              paged decode attention (H 32, Hkv 8, hd 128) on rows past a
              ring's wrap, each held against its plain version; with
              ``--parent`` the quantized ragged kernels of the parent tree
              and this one in turns at the 30B's and the 80B's decode
              shapes (bit-equal), with registers and HMMA instructions;
              (b) the model check, CPU against the card, with the window
              cut to 128: a 192-token prompt that wraps the ring and a
              48-token one, 4 decode steps, the card on paged/ragged and
              on dense rows/padded, each held to the one CPU run by
              routing first (the CPU's forwards from the CPU process,
              held at the run's end; its prefill on the padded
              layout); (c)
              8 requests
              (64-256 tokens, 32 new, 8 slots)
              on paged/ragged, graphed: ``static`` (graph = eager),
              ``dynaexq`` under an ``hbm_gb`` envelope of 4 hi slots per
              MoE layer (observed: each published promotion after its
              copy's event), ``fp16`` and ``offload`` (cache sized to
              dynaexq's device bytes; tokens = fp16's), then ``static``
              on dense rows/padded (graph = eager; tokens against the
              paged run's by routing: at least half the requests route
              alike, and those agree), then a forced preemption and
              resume (tokens = the uninterrupted run's); (d) the window
              cut to 256: 8 requests of 300-380 tokens on both layouts,
              held to each other by routing as in (c); (e) ``dynaexq``
              with spec off and ``spec_k`` 3 on paged/ragged, graphed:
              tokens identical (or each difference explained by
              routing), each row's Mamba state rolled back to its last
              accepted step; (d') the residency ladder's options on a
              ring run at 2 layers (Mamba; attention with the MoE;
              window 64): expert shards written to a temporary
              directory (~15.5 GB), ``dynaexq`` streamed from them
              (cold start, 10 of 16 cells lo-resident, the rest on the
              host tier, every third lo staging and the first 4
              promotion copies failing), one forced window, 2 requests
              of 72-96 tokens, 8 new, on paged/ragged: promotions
              landed and cancelled, hi served, host fetches; the same
              from the same shards in the CPU process, fed the card's
              tokens, with the same reads, hi sets, residency and
              stats, held position by position (the families' rule);
   families — the dense and pure-SSM families at full width and depth
              (Llama-3.2-3B, DeepSeek-7B, Phi-4-mini, H2O-Danube3-4B,
              Mamba2-130m; seeded weights drawn on the card): 8 greedy
              requests (64-256 tokens, 32 new, 8 slots) with ``fp16`` on
              paged KV and dense rows, graphed (Llama also op by op:
              tokens and launches equal), dense rows fed the paged
              run's tokens and held to it position by position (at least
              half the positions held, near ties at most half of them,
              flips within 3 bf16 steps), the decode-attention kernel of
              each layout
              launched and nothing else of the port (Mamba2: no kernel),
              Mamba2 with ``spec_k`` 4 = spec off, Danube's 4608-token
              chunked prefill (its layer 0 against the whole masked
              attention on the card), the launcher at ``--full``; TTFT,
              TPOT, replay ms, the bytes a step reads and their bound;
   multimodal — the encoder-decoder and VLM families at full width
              (seeded weights drawn on the card): Whisper-tiny at full
              depth (4 + 4 layers, 1500 stub frames) through ``prefill``
              and 31 ``decode_step`` calls on dense rows, op by op (8
              rows, 4-64-token prompts, 32 greedy tokens; the engine
              refuses the family), row 5 launched exactly twice per layer
              and step; LLaVA-NeXT-34B at all 60 layers (68.8 GB):
              ``fp16`` graphed on paged KV and dense rows as the families
              phase runs them (rows 3 and 5 the only kernels), the step's
              products timed alone, then 8 rows of 576 stub patches and
              16-64 text tokens through ``prefill(image_embeds=...)`` and
              32 decode steps; then LLaVA at 2 of 60 layers (2 rows, the
              image prefix, 4 steps); Whisper and the 2-layer LLaVA held
              to CPU twins fed the card's tokens (every position's logits
              within ``MODEL_TOL``, tokens under the families' margin
              rule), run by the CPU process and held at the run's end;
              encoder ms,
              TTFT, TPOT, replay ms, the step's bytes and bound, peak
              device memory;
   train    — training on the card: (a) ``repro_torch.launch.train.main``
              in this process on granite-moe-1b-a400m at ``--full`` (24
              layers, 1.33 B parameters), 20 AdamW steps of 16 x 64
              tokens (the padded dispatch's plain products, remat), the
              loss falling by ``TRAIN_DROP``, the held-out perplexity on
              the all-hi kernels (row 7, one launch per layer and batch,
              and no other kernel: no step reached one); the median step
              ms of the last 10 (CUDA events), tokens/s, peak memory;
              (b) a twin: one step at full width and 2 layers on the card
              and on the CPU's plain path, same weights and batch, in bf16
              (the card's step three times) and in float32: the loss, each
              gradient leaf and each update held to the CPU's (the CPU's
              steps run beside (c) and (d));
              (c) held-out perplexity of (a)'s weights with no bank, a
              static int4 bank and int2 lo with a hot bf16 quarter from
              router counts, on the ragged kernels (rows 1-2, 7) against
              the padded layout (row 4), perplexity and every position's
              logits; (d) (a)'s parameters and optimizer state saved in
              the reference's checkpoint layout and loaded back bit-equal;
   ep       — expert parallelism over torch.distributed: 4 ranks (gloo,
              host-staged collectives) on the one card, each holding E/N
              of the 30B's experts at full width, 1 of 48 layers, started
              by ``repro_torch.launch.mesh.spawn`` while one eager process
              here serves the same weights: (a) ``dynaexq`` at N = 4 and
              2, ``static`` and ``fp16`` at N = 2 (8 requests x 16 tokens,
              8 slots, frozen timers, drop-free): tokens and the last
              step's logits bit-equal to the one process, every MoE call
              in the all-to-all regime, rows 1-3 (7 for fp16) launched by
              every rank; (b) at N = 4 a forced promotion window
              (shard-correct slots, rows landed, invariants on every
              rank), a rebalance after a skew (migrations, the layer's
              output held to before, counts permuted) and ``ep_mig``
              faults rolled back bit for bit; (c) the padded regime at
              T = 63 (row 4 on each rank) held to one process; (d) each
              rank's bytes per decode layer against the reference's model
              2(N-1)·S·d, its expert bytes, device memory and host RSS,
              the eager TPOT; (e), (f) the data axis's 2 x 2 and 1 x 3 grids; and
              under the planner's specs on the 2 x 2 grid, each rank
              holding only its shards: (g) the 30B at 2 layers with a
              static int4 bank, 8 rows (over data x model) and 2 rows
              (the caches' sequence over model, row 5 with its
              log-sum-exp), prefill and 8 decode steps against one
              process; (h) granite's FSDP train step at 2 layers in
              float32 against one process; held bytes against
              ``rank_bytes``, sent bytes against formulas; (i) the
              families under specs at full width: Mamba2 at 24 layers (in
              bf16 and float32), Jamba at 8 (its int4 bank drawn expert
              by expert; rows 1-2 at 8 rows, row 4 at 2), Whisper at 4 +
              4 (1500 frames, cross-attention on row 5), LLaVA at 2 of 60
              (its 576-token prefix), 8 and 2 rows, prefill and 8 decode
              steps, and the float32 FSDP train steps of Mamba2 and
              Whisper, each against one process, held bytes against
              ``rank_bytes``; (j) one ``InferenceEngine`` per rank of the
              2 x 2 grid (the 30B's experts replicated over data, each
              rank pinning only its own experts' host masters):
              ``dynaexq`` and ``fp16`` as (a), bit-equal to one process
              with every MoE call all-to-all over data x model, then
              (b)'s promotions, rebalance and faults with the same bank
              digests on both data rows; every rank's launches, expert
              device bytes, pinned host-master bytes and host RSS;
   dryrun   — the dry run (``repro_torch.launch.dryrun``), no card: (1)
              the 30B's four shapes on the 16 x 16 production grid at
              full width and depth, each rank's share priced over meta
              tensors in a process started after the build (one thread,
              nice 19, beside the phases): per-rank GB, sent MB by axis,
              roofline terms on H100 data-sheet figures, the bottleneck;
              and each family's decode_32k at full depth; (2) (g)'s,
              (h)'s and (i)'s own calls on meta copies of their trees
              under the recording mode, every rank of their 2 x 2 grid
              ((i) in that process too): the bytes each collective sent
              and each rank held, equal to what the ep phase measured on
              the card, and for (g), (h) the dry run's arguments plus peak
              beside each rank's device peak;
6. trace    — on each path, 10 decode steps of the static backend traced
              by ``torch.profiler``, graphed and eager: device time per
              step by kernel group, the port's kernels counted by the
              profiler against ``ops.LAUNCHES``, and the share of a replay
              the device idles, as issued and enqueued behind a spin; then
              one train step of the train phase's model and batch: its
              device busy ms and kernels against its ms by CUDA events.

The last two lines are a JSON object with one entry per kernel and the
contract line ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402,F401
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails at once outside a checkout)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor rate
ARCH = "qwen3-moe-30b-a3b"
#: The 30B's served depth (serving, requests, spec, the ladder's host tier,
#: obs, trace), of 48: bf16 host masters 4.8 GB, not 58 GB. Four layers
#: (eight before the families under specs joined the ep phase) keep the
#: default run under 600 s.
SERVE_LAYERS = 4
CHECK_LAYERS = 2
#: The paper's flagship (512 experts top-10, a shared expert, int2 lo and
#: int4-priced hi), checked on 1 layer and served on 4 of 48.
FLAGSHIP = "qwen3-moe-80b-a3b"
FLAGSHIP_SERVE_LAYERS = 4      # bf16 host masters 12.9 GB, not 155 GB
FLAGSHIP_CHECK_LAYERS = 1
#: The two served paths: (KV layout paged?, MoE dispatch) → the kernels
#: each must launch, and the kernels it must not.
PATHS = {
    "paged/ragged": (True, "ragged",
                     ("ragged_gateup", "ragged_down", "flash_decode_paged"),
                     ("grouped_lo_matmul", "flash_decode",
                      "ragged_dense_gateup", "ragged_dense_down")),
    "dense/padded": (False, "padded",
                     ("grouped_lo_matmul", "flash_decode"),
                     ("ragged_gateup", "ragged_down", "flash_decode_paged",
                      "ragged_dense_gateup", "ragged_dense_down")),
}
#: The ragged FFN's all-hi mode, which the paper's baselines (``fp16``,
#: ``offload``: dense bf16 experts) run on the ragged path.
DENSE_FFN_KERNELS = ("ragged_dense_gateup", "ragged_dense_down")
#: The same for the baselines: the padded path runs their experts as a
#: batched SwiGLU (cuBLAS), no kernel of the port.
BASELINE_PATHS = {
    "paged/ragged": (DENSE_FFN_KERNELS + ("flash_decode_paged",),
                     ("ragged_gateup", "ragged_down", "grouped_lo_matmul",
                      "flash_decode")),
    "dense/padded": (("flash_decode",),
                     DENSE_FFN_KERNELS + ("ragged_gateup", "ragged_down",
                                          "grouped_lo_matmul",
                                          "flash_decode_paged")),
}

RESULTS = {}                   # kernel name → JSON entry


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA
    events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` with the host out of the
    timed loop: ``iters`` calls captured in one CUDA graph, whose replays
    (``replays`` of them, after one untimed) are timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def profiler_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of one ``fn`` by ``torch.profiler``: the
    sum of the device time of every kernel it ran, over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / iters / 1e3


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` when nothing waits for the
    device: the time to enqueue ``calls`` calls, synchronised after."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_steps(name, q, k, v, *rest) -> dict:
    """Host microseconds per call of each step of a decode-attention
    wrapper on the card, each step timed alone (the median of 5
    ``host_us`` loops) with the wrapper's own calls: the argument checks,
    the launch-plan lookup, the pointer reads with the alignment check,
    the allocations, the stream handle, the ctypes call (its one or two
    kernel launches included); then the whole wrapper call, and what it
    costs beyond the sum of the steps (Python frames, shape compares)."""
    from repro_torch.kernels import ops
    dev = q.device
    bf, contig = torch.bfloat16, name == "flash_decode_paged"
    needs = [(q, "q", bf, 3, True), (k, "k", bf, 4, contig),
             (v, "v", bf, 4, contig)]
    if contig:
        table, valid = rest
        needs += [(table, "table", torch.int32, 2, True)]
        key = lambda: (name, q.shape, k.shape, table.shape[1], dev.index)
    else:
        valid, = rest
        key = lambda: (name, q.shape, k.shape, k.stride(), dev.index)
    needs += [(valid, "valid", torch.bool, 2, True)]
    call = getattr(ops, name)
    whole = lambda: call(q, k, v, *rest)
    whole()
    plan = ops._PLANS[key()]
    out = torch.empty(plan.shape, dtype=bf, device=dev)
    scratch = None if not plan.scratch else torch.empty(
        plan.scratch, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (q, k, v, *rest)]
    stream = ops._stream(dev.index)

    def checks():
        for t, n, dt, nd, c in needs:
            ops._need(t, n, dt, dev, nd, c)

    def pointers():
        pk, pv = k.data_ptr(), v.data_ptr()
        _ = [t.data_ptr() for t in rest]
        return pk % 16 or pv % 16 or q.data_ptr() % 4

    def alloc():
        torch.empty(plan.shape, dtype=bf, device=dev)
        if plan.scratch:
            torch.empty(plan.scratch, dtype=torch.float32, device=dev)

    def launch():
        plan.fn(*ptrs, out.data_ptr(), ops._ptr(scratch), plan.dims_ptr,
                plan.scale, stream)

    steps = {}
    for step, fn in (("checks", checks), ("plan", lambda: ops._PLANS.get(
            key())), ("pointers", pointers), ("alloc", alloc),
                     ("stream", lambda: ops._stream(dev.index)),
                     ("launch", launch), ("whole", whole)):
        steps[step] = float(np.median([host_us(fn) for _ in range(5)]))
    steps["rest"] = steps["whole"] - sum(
        t for s, t in steps.items() if s != "whole")
    return steps


def interleaved(kernel, library) -> dict:
    """Device times of a kernel and its library yardstick in turns
    (kernel, library, library, kernel), each by graph replay; where the
    library call cannot be captured, by ``torch.profiler`` device time."""
    k1 = graph_ms(kernel)
    try:
        l1, l2, how = graph_ms(library), graph_ms(library), "graph"
    except RuntimeError:
        torch.cuda.synchronize()
        l1, l2, how = profiler_ms(library), profiler_ms(library), "profiler"
    k2 = graph_ms(kernel)
    return {"graph_ms": (k1 + k2) / 2, "library_graph_ms": (l1 + l2) / 2,
            "library_graph_method": how, "graph_runs": [k1, l1, l2, k2]}


def bound(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / BF16_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", f"{smi} | torch {torch.__version__} cuda "
                f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} "
                f"x{torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    secs = build.build_all(verbose=bool(os.environ.get("PTXAS_VERBOSE")))
    for name in build.SOURCES:
        build.library(name)
    log("build", f"built {', '.join(build.SOURCES)} in {secs:.1f} s "
                 f"into {build.build_dir()}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _ffn_case(name, gen, dev, *, bits, T, lo_w, hi_w, slot_owner, tol_rel,
              host=False, top_k=8):
    """Route T tokens top-``top_k`` over the bank's experts, build the ragged
    tile map with
    the port's own dispatch helpers, and hold both FFN kernels against the
    plain versions; time each kernel by event loop and by graph replay
    (with ``host``, also the wrapper's host time per call). Returns a dict
    of the measurements."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import (RAGGED_BM, _sort_routing,
                                        _tile_slots, ragged_tile_map)
    from repro_torch.core.ver import ExpertBankQ
    E, K = lo_w["w_gate"].packed.shape[0], lo_w["w_gate"].packed.shape[1] \
        * (8 // bits)
    F = lo_w["w_gate"].packed.shape[2]
    D = lo_w["w_down"].packed.shape[2]
    group = lo_w["w_gate"].group_size
    bm = RAGGED_BM
    logits = torch.randn((T, E), generator=gen, device=dev)
    idx = torch.topk(logits, top_k, dim=-1).indices
    _, _, counts, _, _ = _sort_routing(idx, E)
    _, tile_eid, n_tiles = ragged_tile_map(counts, bm, T * top_k)
    Tt = tile_eid.shape[0]
    n_live = int(n_tiles.item())
    bank = ExpertBankQ(lo=lo_w, hi=hi_w or {}, slot_owner=slot_owner,
                       slot_map=torch.zeros((E,), dtype=torch.int32,
                                            device=dev))
    tile_slot = _tile_slots(bank, tile_eid, E)
    xs = (torch.randn((Tt * bm, K), generator=gen, device=dev)
          ).to(torch.bfloat16)
    hg = hu = hd = None
    if hi_w:
        hg, hu, hd = hi_w["w_gate"], hi_w["w_up"], hi_w["w_down"]
    kw = dict(bits=bits, group=group, bm=bm)
    lg, ug, ld_ = lo_w["w_gate"], lo_w["w_up"], lo_w["w_down"]

    def gateup_k():
        return ops.ragged_gateup(xs, tile_eid, tile_slot, n_tiles, lg.packed,
                                 lg.scales, ug.packed, ug.scales, hg, hu,
                                 **kw)

    def gateup_p():
        return ref.ragged_gateup_ref(xs, tile_eid, tile_slot, lg.packed,
                                     lg.scales, ug.packed, ug.scales, hg, hu,
                                     **kw)

    h_ref = gateup_p()
    h_k = gateup_k()
    torch.cuda.synchronize()

    def down_k():
        return ops.ragged_down(h_ref, tile_eid, tile_slot, n_tiles,
                               ld_.packed, ld_.scales, hd, **kw)

    def down_p():
        return ref.ragged_down_ref(h_ref, tile_eid, tile_slot, ld_.packed,
                                   ld_.scales, hd, **kw)

    y_ref = down_p()
    y_k = down_k()
    # The whole FFN through both kernels against the plain composition.
    y_full = ops.ragged_down(h_k, tile_eid, tile_slot, n_tiles, ld_.packed,
                             ld_.scales, hd, **kw)
    torch.cuda.synchronize()
    rows = n_live * bm

    def err(a, b):
        a, b = a[:rows].float(), b[:rows].float()
        assert torch.isfinite(a).all(), f"{name}: non-finite kernel output"
        return float((a - b).abs().max()), float(b.abs().max())

    e_h, m_h = err(h_k, h_ref)
    e_y, m_y = err(y_k, y_ref)
    e_f, m_f = err(y_full, y_ref)
    ok = e_h <= tol_rel * m_h and e_y <= tol_rel * m_y and \
        e_f <= tol_rel * m_f
    n_hi_tiles = int(((tile_slot[:n_live] >= 0)).sum().item()) if hi_w else 0
    top_slot = int(tile_slot[:n_live].max().item()) if hi_w else -1

    # Bytes each input is read once, each output written once; distinct
    # (expert, tier) weights of the live tiles.
    te = tile_eid[:n_live].long()
    ts = tile_slot[:n_live].long() if hi_w else torch.full_like(te, -1)
    lo_e = torch.unique(te[ts < 0]).numel()
    hi_s = torch.unique(ts[ts >= 0]).numel()
    lo_gu = 2 * (K // (8 // bits) * F + (K // group) * F * 2)
    lo_dn = F // (8 // bits) * D + (F // group) * D * 2
    maps = Tt * 4 * 2 + 4
    gu_bytes = rows * K * 2 + lo_e * lo_gu + hi_s * 2 * K * F * 2 + \
        rows * F * 2 + maps
    dn_bytes = rows * F * 2 + lo_e * lo_dn + hi_s * F * D * 2 + \
        rows * D * 2 + maps
    out = {"case": name, "ok": ok, "tiles": n_live, "hi_tiles": n_hi_tiles,
           "top_slot": top_slot, "err_ffn": e_f, "tol_ffn": tol_rel * m_f}
    for key, run_k, run_p, e, m, b in (
            ("gateup", gateup_k, gateup_p, e_h, m_h,
             bound(gu_bytes, 2 * rows * K * F * 2)),
            ("down", down_k, down_p, e_y, m_y,
             bound(dn_bytes, 2 * rows * F * D))):
        out[key] = {"err": e, "tol": tol_rel * m, "ms": time_ms(run_k),
                    "graph_ms": graph_ms(run_k),
                    "host_us": host_us(run_k) if host else None,
                    "plain_ms": time_ms(run_p, iters=3, warmup=1),
                    "bound_ms": b[0], "bound_by": b[1]}
    log("kernels", f"ragged FFN {name}: {n_live}/{Tt} live tiles "
                   f"({n_hi_tiles} hi, highest slot {top_slot}) | "
                   + " | ".join(
                       f"{key} err {c['err']:.3g} (tol {c['tol']:.3g}) "
                       f"{c['ms']:.4f} ms, graph {c['graph_ms']:.4f} ms"
                       + (f", host {c['host_us']:.1f} us/call" if host
                          else "")
                       + f", plain {c['plain_ms']:.3f} ms, bound "
                       f"{c['bound_ms']:.4f} ms ({c['bound_by']})"
                       for key, c in (("gateup", out["gateup"]),
                                      ("down", out["down"])))
                   + f" | ffn err {e_f:.3g} | {'ok' if ok else 'FAIL'}")
    return out


def _gqmm_case(name, gen, dev, qt, C, tol_rel, host=False):
    """The padded dispatch's grouped GEMM over all E experts of one lo
    weight at capacity C against the plain version. Returns a dict of the
    measurements."""
    from repro_torch.kernels import ops, ref
    E, KP, N = qt.packed.shape
    bits, group = qt.bits, qt.group_size
    K = KP * (8 // bits)
    xg = torch.randn((E, C, K), generator=gen, device=dev).to(torch.bfloat16)

    def run_k():
        return ops.grouped_lo_matmul(xg, qt.packed, qt.scales, bits, group)

    def run_p():
        return ref.grouped_lo_gemm(xg, qt.packed, qt.scales, bits, group)

    want, got = run_p(), run_k()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = tol_rel * float(want.float().abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol
    # Every expert's codes and scales (the padded layout reads them all),
    # the activations once, the output once.
    nbytes = xg.numel() * 2 + qt.packed.numel() + qt.scales.numel() * 2 + \
        E * C * N * 2
    out = {"case": name, "ok": ok, "err": err, "tol": tol,
           "ms": time_ms(run_k), "graph_ms": graph_ms(run_k),
           "host_us": host_us(run_k) if host else None,
           "plain_ms": time_ms(run_p, iters=3, warmup=1),
           "bound": bound(nbytes, 2 * E * C * K * N)}
    log("kernels", f"grouped_lo_matmul {name} E={E} C={C} K={K} N={N}: err "
                   f"{err:.3g} (tol {tol:.3g}) {out['ms']:.4f} ms, graph "
                   f"{out['graph_ms']:.4f} ms"
                   + (f", host {out['host_us']:.1f} us/call" if host else "")
                   + f", plain {out['plain_ms']:.3f} ms, bound "
                   f"{out['bound'][0]:.4f} ms ({out['bound'][1]}) | "
                   f"{'ok' if ok else 'FAIL'}")
    return out


# Tolerance of both attention kernels: float32 online softmax against
# float32 softmax, output rounded to bf16 — within 2 bf16 ulps of the
# output magnitude.
ATTN_TOL = 2.0 ** -7


def _attn_case(kind, case, run_k, run_p, run_lib, nbytes, ops_, zero_rows,
               n_split):
    """Hold one attention case against its plain version; time it (event
    loop and graph replay, interleaved with its SDPA yardstick); returns
    the case's entry."""
    o_k, o_p = run_k(), run_p()
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    tol = ATTN_TOL * float(o_p.float().abs().max())
    ok = bool(torch.isfinite(o_k.float()).all()) and err <= tol and \
        all(bool((o_k[r] == 0).all()) for r in zero_rows)
    b = bound(nbytes, ops_)
    out = {"case": case, "ok": ok, "err": err, "tol": tol, "n_split": n_split,
           "ms": time_ms(run_k), "plain_ms": time_ms(run_p),
           "library_ms": time_ms(run_lib), "bound_ms": b[0],
           "bound_by": b[1], "host_us": host_us(run_k)}
    out.update(interleaved(run_k, run_lib))
    log("kernels", f"{kind} {case}: {n_split} split(s) | err {err:.3g} (tol "
                   f"{tol:.3g}) | {out['ms']:.4f} ms, graph "
                   f"{out['graph_ms']:.4f} ms, host {out['host_us']:.1f} "
                   f"us/call | plain {out['plain_ms']:.4f} "
                   f"ms | sdpa {out['library_ms']:.4f} ms, "
                   f"{out['library_graph_method']} "
                   f"{out['library_graph_ms']:.4f} ms | bound "
                   f"{b[0]:.4f} ms ({b[1]}) | turns kernel/sdpa/sdpa/kernel "
                   f"{[round(x, 5) for x in out['graph_runs']]} | "
                   f"{'ok' if ok else 'FAIL'}")
    return out


def _log_host_steps(kind, case, steps):
    log("kernels", f"{kind} {case}: wrapper host us/call by step "
                   + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return steps


def _attn_result(name, source, replaces, cases):
    """The kernel's JSON entry: the first (main) case's numbers, every
    case beside them."""
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{bad}")
    m = cases[0]
    RESULTS[name] = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": max(c["err"] for c in cases), "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "graph_ms": m["graph_ms"], "library_graph_ms": m["library_graph_ms"],
        "library_graph_method": m["library_graph_method"],
        "host_steps_us": m["host_steps_us"],
        "cases": [{k: c[k] for k in ("case", "n_split", "err", "tol", "ms",
                                     "graph_ms", "host_us", "plain_ms",
                                     "library_ms", "library_graph_ms",
                                     "bound_ms", "bound_by")}
                  for c in cases]}


def _n_split(B, Hkv, n_tiles):
    from repro_torch.kernels import ops
    return ops.decode_splits(B, Hkv, n_tiles, ops._sm_count(0))[0]


def _dense_decode_inputs(cfg, gen, dev, B, S, holes=False, valid=None):
    """q, the (B, S, Hkv, hd) views of head-major caches and valid, plus the
    rows that must come out as zeros and SDPA's yardstick call. B=8:
    ragged rows, one full (the inputs of earlier runs); else full rows, or
    with ``holes`` row 0 valid only in [0, 100) ∪ [S-196, S), row 1 at
    valid[0] alone and row 2 all-masked. A ``valid`` given is used as it
    is (drawn after the caches and q)."""
    H, Hkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    ck = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    zero_rows = []
    if valid is None and B == 8:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lengths[0] = S                         # one full row
        valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    elif valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        if holes:
            valid[0, 100:S - 196] = False
            valid[1, 1:] = False
            valid[2] = False                   # an all-masked row gives 0
            zero_rows = [2]
    kl = ck.repeat_interleave(H // Hkv, dim=1)
    vl = cv.repeat_interleave(H // Hkv, dim=1)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=valid[:, None, None, :])

    return q, ck.transpose(1, 2), cv.transpose(1, 2), valid, zero_rows, lib


def _kernels_dense_decode(cfg, gen, dev) -> None:
    """The dense flash decode over the cache's head-major rows, seen as
    (B, S, Hkv, hd) without a copy, against the plain version and SDPA:
    the dense path's shape (B=8, S=288, ragged rows), one row alone, one
    long row, and a long row with holes (whole splits masked) beside a row
    with valid[0] alone and an all-masked row."""
    from repro_torch.kernels import ops, ref
    H, Hkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    cases = []
    # The main case draws from ``gen`` in the same order as earlier
    # versions of this script (the same inputs); the others from a
    # generator of their own.
    extra = torch.Generator(device=dev).manual_seed(31)
    lse_checks = []
    for case, B, S in (("B=8 S=288", 8, 288), ("B=1 S=288", 1, 288),
                       ("B=1 S=4096", 1, 4096),
                       ("B=3 S=4096 holes", 3, 4096)):
        q, k, v, valid, zero_rows, lib = _dense_decode_inputs(
            cfg, gen if B == 8 else extra, dev, B, S, holes="holes" in case)
        n_valid = int(valid.sum().item())
        nbytes = q.numel() * 2 * 2 + n_valid * 2 * Hkv * hd * 2 + \
            valid.numel()
        cases.append(_attn_case(
            "flash_decode", case,
            lambda q=q, k=k, v=v, m=valid: ops.flash_decode(q, k, v, m),
            lambda q=q, k=k, v=v, m=valid: ref.flash_decode_ref(q, k, v, m),
            lib, nbytes, 4 * n_valid * H * hd, zero_rows,
            _n_split(B, Hkv, -(-S // ops.DECODE_TILE))))
        if B == 8:
            cases[-1]["host_steps_us"] = _log_host_steps(
                "flash_decode", case, host_steps("flash_decode", q, k, v,
                                                 valid))
        if B == 8 or "holes" in case:
            lse_checks.append(_lse_case(case, q, k, v, valid))
    cases += _family_attn_cases("flash_decode", dev)
    _attn_result("flash_decode",
                 "src/repro_torch/kernels/csrc/flash_decode.cu",
                 "src/repro/kernels/flash_decode.py:31", cases)
    RESULTS["flash_decode"]["lse"] = lse_checks
    bad = [c["case"] for c in lse_checks if not c["ok"]]
    if bad:
        raise AssertionError(f"flash_decode's lse output disagrees with "
                             f"its plain version: {bad}")


#: Row 5's log-sum-exp output against its plain version's (float32, in
#: natural-log units of logits of magnitude ~10): the kernel's exp2/log2
#: of bf16 products summed in float32 in another order; -inf on exactly
#: the plain version's all-masked rows.
LSE_TOL = 1e-4


def _lse_case(case, q, k, v, valid) -> dict:
    """Row 5 with its log-sum-exp output (``ops.flash_decode(...,
    lse=True)``, the cache whose sequence is cut over model): o the same
    bits as without it, lse within LSE_TOL of the plain version's; the
    two launches' device times in turns (off, on, on, off)."""
    from repro_torch.kernels import ops, ref
    off = ops.flash_decode(q, k, v, valid)
    on, lse = ops.flash_decode(q, k, v, valid, lse=True)
    _, want = ref.flash_decode_ref(q, k, v, valid, lse=True)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err = float((lse - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    same_inf = torch.equal(torch.isinf(lse), ~fin) and \
        bool((lse[~fin] < 0).all())
    turns = interleaved(lambda: ops.flash_decode(q, k, v, valid),
                        lambda: ops.flash_decode(q, k, v, valid, lse=True))
    ok = torch.equal(off, on) and err <= LSE_TOL and same_inf
    out = {"case": case, "ok": ok, "o_bit_equal": torch.equal(off, on),
           "lse_err": err, "tol": LSE_TOL, "inf_rows_match": same_inf,
           "graph_ms_off": turns["graph_ms"],
           "graph_ms_on": turns["library_graph_ms"],
           "graph_runs": turns["graph_runs"]}
    log("kernels", f"flash_decode lse {case}: o bit-equal with lse off "
                   f"{out['o_bit_equal']}, max |lse - plain| {err:.3g} (tol "
                   f"{LSE_TOL}), -inf rows alike {same_inf} | graph ms in "
                   f"turns off/on/on/off "
                   f"{[round(x, 5) for x in turns['graph_runs']]} | "
                   f"{'ok' if ok else 'FAIL'}")
    return out


def _paged_decode_inputs(cfg, gen, dev, B, nb, holes=False, bt=16,
                         valid=None):
    """q, block pools, table and valid, plus the rows that must come out
    as zeros and SDPA's yardstick call over the gathered view: random
    lengths (row 0 full), -1 entries past each row's blocks; with
    ``holes`` row 0 valid only in its first 2 and last 56 blocks, row 1
    vacant (table -1, valid[0]: reads block 0), row 2 all-masked. A
    ``valid`` given (every block of every row allocated) replaces the
    drawn lengths' mask."""
    from repro_torch.models.layers import PagedKVCache, paged_view
    H, Hkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    N = 1 + B * nb
    k = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    perm = (1 + torch.randperm(N - 1, generator=gen, device=dev)).to(
        torch.int32)
    table = perm[:B * nb].reshape(B, nb).clone()
    lengths = torch.randint(1, nb * bt + 1, (B,), generator=gen, device=dev)
    lengths[0] = nb * bt                       # one full row
    zero_rows = []
    if holes:
        lengths[1] = 0                         # vacant: table -1, valid[0]
        lengths[2] = nb * bt                   # all-masked below
        zero_rows = [2]
    used = (lengths + bt - 1) // bt
    blk_idx = torch.arange(nb, device=dev)[None, :]
    table = torch.where(blk_idx < used[:, None], table,
                        torch.full_like(table, -1))
    if valid is not None:
        table = perm[:B * nb].reshape(B, nb).clone()
    else:
        valid = torch.arange(nb * bt, device=dev)[None, :] < \
            lengths[:, None]
    if holes:
        valid[0, 2 * bt:(nb - 56) * bt] = False
        valid[1, 0] = True
        valid[2] = False
    kl, vl = paged_view(PagedKVCache(k, v), table)
    kl = kl.repeat_interleave(H // Hkv, dim=1)
    vl = vl.repeat_interleave(H // Hkv, dim=1)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=valid[:, None, None, :])

    return q, k, v, table, valid, zero_rows, lib


def _kernels_paged_decode(cfg, gen, dev) -> None:
    """The paged flash decode through a block table, against the plain
    version and SDPA over the gathered view: the main shape (B=8, nb=32,
    -1 entries past each row's length; the inputs of earlier runs), the serving phase's 288-slot
    tables (nb=18), one row alone, and 256-block rows with holes (whole
    splits masked), a vacant row (table -1, valid[0]: reads block 0) and
    an all-masked row."""
    from repro_torch.kernels import ops, ref
    H, Hkv, hd, bt = cfg.attn.n_heads, cfg.attn.n_kv_heads, \
        cfg.attn.head_dim, 16
    cases = []
    extra = torch.Generator(device=dev).manual_seed(37)
    for case, B, nb in (("B=8 nb=32", 8, 32), ("B=8 nb=18", 8, 18),
                        ("B=1 nb=32", 1, 32), ("B=4 nb=256 holes", 4, 256)):
        q, k, v, table, valid, zero_rows, lib = _paged_decode_inputs(
            cfg, gen if case == "B=8 nb=32" else extra, dev, B, nb,
            holes="holes" in case)
        # Bytes: every block holding a valid slot (a -1 entry with a valid
        # slot reads block 0), q, the output, the table and valid.
        n_blocks = int(valid.reshape(B, nb, bt).any(-1).sum().item())
        n_valid = int(valid.sum().item())
        nbytes = q.numel() * 2 * 2 + n_blocks * 2 * Hkv * bt * hd * 2 + \
            table.numel() * 4 + valid.numel()
        cases.append(_attn_case(
            "flash_decode_paged", case,
            lambda q=q, k=k, v=v, t=table, m=valid:
                ops.flash_decode_paged(q, k, v, t, m),
            lambda q=q, k=k, v=v, t=table, m=valid:
                ref.flash_decode_paged_ref(q, k, v, t, m),
            lib, nbytes, 4 * n_valid * H * hd, zero_rows,
            _n_split(B, Hkv, nb)))
        if case == "B=8 nb=32":
            cases[-1]["host_steps_us"] = _log_host_steps(
                "flash_decode_paged", case, host_steps(
                    "flash_decode_paged", q, k, v, table, valid))
    # The flagship's heads (H = 16, Hkv = 2, hd = 256: rep 8), at the main
    # shape and at the flagship serving run's 288-slot tables.
    from repro_torch.configs import get_config
    cfg80 = get_config(FLAGSHIP)
    H, Hkv, hd = cfg80.attn.n_heads, cfg80.attn.n_kv_heads, \
        cfg80.attn.head_dim
    extra80 = torch.Generator(device=dev).manual_seed(53)
    for case, B, nb in (("80B B=8 nb=32", 8, 32), ("80B B=8 nb=18", 8, 18)):
        q, k, v, table, valid, zero_rows, lib = _paged_decode_inputs(
            cfg80, extra80, dev, B, nb)
        n_blocks = int(valid.reshape(B, nb, bt).any(-1).sum().item())
        n_valid = int(valid.sum().item())
        nbytes = q.numel() * 2 * 2 + n_blocks * 2 * Hkv * bt * hd * 2 + \
            table.numel() * 4 + valid.numel()
        cases.append(_attn_case(
            "flash_decode_paged", case,
            lambda q=q, k=k, v=v, t=table, m=valid:
                ops.flash_decode_paged(q, k, v, t, m),
            lambda q=q, k=k, v=v, t=table, m=valid:
                ref.flash_decode_paged_ref(q, k, v, t, m),
            lib, nbytes, 4 * n_valid * H * hd, zero_rows,
            _n_split(B, Hkv, nb)))
    cases += _family_attn_cases("flash_decode_paged", dev)
    _attn_result("flash_decode_paged",
                 "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
                 "src/repro/kernels/flash_decode.py:92", cases)


#: The families' decode-attention shapes (rows 3 and 5 beyond the
#: compiled widths' first shapes), each with the kernels it runs on:
#: Danube's hd 120 (run on the 128 width, zero-padded in shared memory),
#: rep 4, on rows past a wrap of its 4096 ring; DeepSeek's MHA (rep 1);
#: Llama's rep 3 (Phi-4-mini's heads too); Whisper's cross-attention over
#: its 1500 encoder frames (every frame valid; K/V one layer's contiguous
#: (B, Senc, Hkv, hd) slice of the cross cache; dense rows only); LLaVA's
#: rep 7 (56 heads over 8).
BOTH_ROWS = ("flash_decode", "flash_decode_paged")
FAMILY_ATTN = (("danube hd120 rep4 ring 4096", "h2o-danube-3-4b", 4096,
                BOTH_ROWS),
               ("deepseek hd128 rep1", "deepseek-7b", 288, BOTH_ROWS),
               ("llama hd128 rep3", "llama3_2-3b", 288, BOTH_ROWS),
               ("whisper cross S1500 rep1 hd64", "whisper-tiny", 1500,
                ("flash_decode",)),
               ("llava hd128 rep7", "llava-next-34b", 288, BOTH_ROWS))


def _family_attn_cases(name, dev) -> list:
    """``FAMILY_ATTN`` through one decode-attention kernel at B=8, each
    held against its plain version and timed beside SDPA over the gathered
    view. Danube's rows sit past the wrap of a 4096-slot ring (positions
    4096 + [0, 500), every slot valid under its 4096 window, as
    ``layers.decode_valid`` gives it); Whisper's cross-attention reads
    every one of its 1500 frames from contiguous rows; the others are the
    serving phase's 288-slot rows of random lengths (row 0 full)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import decode_valid
    gen = torch.Generator(device=dev).manual_seed(61)
    bt, B, out = 16, 8, []
    for case, arch, S, kernels in FAMILY_ATTN:
        if name not in kernels:
            continue
        cfg = get_config(arch)
        H, Hkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, \
            cfg.attn.head_dim
        valid = None
        if cfg.attn.sliding_window is not None:
            pos = S + torch.randint(0, 500, (B,), generator=gen, device=dev)
            valid = decode_valid(pos, S, cfg.attn)
        if cfg.is_encoder_decoder:
            valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        if name == "flash_decode":
            q, k, v, m, zero_rows, lib = _dense_decode_inputs(
                cfg, gen, dev, B, S, valid=valid)
            if cfg.is_encoder_decoder:
                k, v = k.contiguous(), v.contiguous()
            n_valid = int(m.sum().item())
            nbytes = q.numel() * 2 * 2 + n_valid * 2 * Hkv * hd * 2 + \
                m.numel()
            run_k = lambda q=q, k=k, v=v, m=m: ops.flash_decode(q, k, v, m)
            run_p = lambda q=q, k=k, v=v, m=m: ref.flash_decode_ref(q, k, v,
                                                                   m)
            n_split = _n_split(B, Hkv, -(-S // ops.DECODE_TILE))
        else:
            nb = S // bt
            q, k, v, t, m, zero_rows, lib = _paged_decode_inputs(
                cfg, gen, dev, B, nb, valid=valid)
            n_blocks = int(m.reshape(B, nb, bt).any(-1).sum().item())
            n_valid = int(m.sum().item())
            nbytes = q.numel() * 2 * 2 + n_blocks * 2 * Hkv * bt * hd * 2 + \
                t.numel() * 4 + m.numel()
            run_k = lambda q=q, k=k, v=v, t=t, m=m: ops.flash_decode_paged(
                q, k, v, t, m)
            run_p = lambda q=q, k=k, v=v, t=t, m=m: \
                ref.flash_decode_paged_ref(q, k, v, t, m)
            n_split = _n_split(B, Hkv, nb)
        out.append(_attn_case(name, case, run_k, run_p, lib, nbytes,
                              4 * n_valid * H * hd, zero_rows, n_split))
    return out


def _kernels_quant_matmul(gen, dev, tol_rel) -> None:
    """The plain quantized GEMM at the reference's benchmark shape (M = 128)
    and at M = 1 and 13, bits 8/4/2, against the plain version
    (dequantize-then-dot)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.qtensor import quantize
    K, N = 2048, 768
    w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(
        torch.bfloat16)
    xs = {128: torch.randn((128, K), generator=gen, device=dev).to(
        torch.bfloat16)}
    # The extra rows draw from a generator of their own, so the M = 128
    # inputs stay those of earlier runs.
    extra = torch.Generator(device=dev).manual_seed(41)
    for M in (1, 13):
        xs[M] = torch.randn((M, K), generator=extra, device=dev).to(
            torch.bfloat16)
    res = {}
    for bits in (8, 4, 2):
        qt = quantize(w, bits, 64)
        for M, x in xs.items():
            def run_k(x=x, qt=qt):
                return ops.quant_matmul_op(x, qt)

            def run_p(x=x, qt=qt, bits=bits):
                return ref.quant_matmul_ref(x, qt.packed, qt.scales, bits,
                                            64)

            want, got = run_p(), run_k()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = tol_rel * float(want.float().abs().max())
            nbytes = x.numel() * 2 + qt.packed.numel() + \
                qt.scales.numel() * 2 + M * N * 2
            main = bits == 4 and M == 128
            r = res[(bits, M)] = {
                "ok": bool(torch.isfinite(got.float()).all()) and err <= tol,
                "err": err, "ms": time_ms(run_k), "graph_ms": graph_ms(run_k),
                "host_us": host_us(run_k) if main else None,
                "plain_ms": time_ms(run_p),
                "bound": bound(nbytes, 2 * M * K * N)}
            log("kernels", f"quant_matmul int{bits} M={M} K={K} N={N}: err "
                           f"{err:.3g} (tol {tol:.3g}) {r['ms']:.4f} ms, "
                           f"graph {r['graph_ms']:.4f} ms"
                           + (f", host {r['host_us']:.1f} us/call" if main
                              else "")
                           + f", plain {r['plain_ms']:.4f} ms, bound "
                           f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) | "
                           f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [k for k, r in res.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"quant_matmul disagrees with its plain "
                             f"version: {bad}")
    r = res[(4, 128)]
    RESULTS["quant_matmul"] = {
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:79",
        "launches": 0, "max_abs_err": max(v["err"] for v in res.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1], "library_ms": None,
        "graph_ms": r["graph_ms"], "host_us": r["host_us"],
        "cases": [{"case": f"int{b} M={M}", "err": v["err"], "ms": v["ms"],
                   "graph_ms": v["graph_ms"], "plain_ms": v["plain_ms"],
                   "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                  for (b, M), v in res.items()]}
    log("kernels", "quant_matmul yardstick: none, no single library call "
                   "computes a dequantize-then-multiply")


def _flagship_ffn_cases(dev, tol) -> dict:
    """Both ragged FFN kernels at the flagship's width (512 experts, K =
    2048, F = 512, int2 lo, g = 64) with hi tiles from a pool of 2·n_hi =
    128 slots (96 owned, so tiles read slots past n_hi = 64): decode B = 8
    top-10 and a 512-token prefill. Inputs from a generator of their own,
    so the 30B cases keep theirs."""
    from repro_torch.configs import get_config
    from repro_torch.quant.qtensor import quantize
    cfg = get_config(FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(4321)
    E, K, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    pool, owned = 2 * (E // 8), 96
    lo = {}
    for n, s in (("w_gate", (K, F)), ("w_up", (K, F)), ("w_down", (F, K))):
        w = (torch.randn((E,) + s, generator=gen, device=dev)
             * s[0] ** -0.5).to(torch.bfloat16)
        lo[n] = quantize(w, 2, 64)
        del w
    hi_w = {n: (torch.randn((pool,) + tuple(q.shape[1:]), generator=gen,
                            device=dev) * q.shape[1] ** -0.5
                ).to(torch.bfloat16) for n, q in lo.items()}
    owner = torch.full((pool,), -1, dtype=torch.int32, device=dev)
    owner[:owned] = torch.randperm(E, generator=gen, device=dev)[:owned].to(
        torch.int32)
    out = {}
    for key, T, what in (("80b_decode", 8, "decode B=8"),
                         ("80b_prefill", 512, "prefill 512")):
        out[key] = _ffn_case(f"80B int2 {what} top-10 of 512, pool {pool}",
                             gen, dev, bits=2, T=T, lo_w=lo, hi_w=hi_w,
                             slot_owner=owner, tol_rel=tol, top_k=10)
    if not any(c["top_slot"] >= pool // 2 for c in out.values()):
        raise AssertionError("no 80B case read a hi slot past n_hi")
    return out


def _grouped_mm_yardstick(xs, w, offs):
    """One ``torch._grouped_mm`` over the ragged segments (``offs``: each
    expert's segment end in ``xs``'s rows): the library call nearest to a
    ragged dense expert GEMM. Returns (call, how) or (None, why not); the
    port never calls it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    try:
        fn(xs, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"torch._grouped_mm refused the (E, K, N) row-major " \
            f"bank: {str(e).splitlines()[0][:160]}"
    return (lambda: fn(xs, w, offs=offs)), "row-major weights"


#: The all-hi mode's cases: key → (model, tokens, every token routed to
#: expert 0 as one of its top-k). Decode B=8 and prefill 512 of both
#: models, and a skewed 30B prefill (expert 0 holds 512 rows, 64 tiles:
#: the heavy-tailed routing the paper is about).
DENSE_CASES = {"30b_decode": (ARCH, 8, False),
               "30b_prefill": (ARCH, 512, False),
               "30b_prefill_skew": (ARCH, 512, True),
               "80b_decode": (FLAGSHIP, 8, False),
               "80b_prefill": (FLAGSHIP, 512, False)}


def _dense_cases(dev, seed=2468):
    """Yield ``(key, name, bank, inputs)`` for each of ``DENSE_CASES``: a
    random dense (E, K, N) bf16 bank per model (freed after its cases),
    T tokens routed top-k over it, the tile map from the port's dispatch
    helpers and random activation rows; from a generator of their own."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import (RAGGED_BM, _sort_routing,
                                        ragged_tile_map)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bm = RAGGED_BM
    for arch in (ARCH, FLAGSHIP):
        cfg = get_config(arch)
        E, K, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
        top_k = cfg.moe.top_k
        bank = {n: (torch.randn((E,) + s, generator=gen, device=dev)
                    * s[0] ** -0.5).to(torch.bfloat16)
                for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                             ("w_down", (F, K)))}
        for key, (a, T, skew) in DENSE_CASES.items():
            if a != arch:
                continue
            logits = torch.randn((T, E), generator=gen, device=dev)
            if skew:
                logits[:, 0] = float("inf")
            idx = torch.topk(logits, top_k, dim=-1).indices
            _, _, counts, _, _ = _sort_routing(idx, E)
            _, tile_eid, n_tiles = ragged_tile_map(counts, bm, T * top_k)
            Tt = tile_eid.shape[0]
            xs = torch.randn((Tt * bm, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            name = (f"{arch} {'decode B=8' if T == 8 else f'prefill {T}'}"
                    f"{' skewed (expert 0 in every top-k)' if skew else ''}"
                    f" top-{top_k} of {E}, F={F}")
            yield key, name, bank, dict(xs=xs, tile_eid=tile_eid,
                                        n_tiles=n_tiles, counts=counts)
        del bank


def _dense_ffn_case(name, bank, inp, *, tol_rel):
    """The ragged FFN's all-hi mode (``ragged_dense_gateup`` /
    ``ragged_dense_down``) on one case of ``_dense_cases``: hold both
    kernels against the plain versions on the live tiles' rows, and time
    each (event loop, graph replay, plain version) beside its bound and
    the ``torch._grouped_mm`` yardstick (gate and up as one call over the
    two banks side by side; in turns with the kernel)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import RAGGED_BM
    xs, tile_eid, n_tiles = inp["xs"], inp["tile_eid"], inp["n_tiles"]
    E, K, F = bank["w_gate"].shape
    D = bank["w_down"].shape[2]
    bm = RAGGED_BM
    Tt, n_live = tile_eid.shape[0], int(n_tiles.item())
    rows = n_live * bm
    wg, wu, wd = bank["w_gate"], bank["w_up"], bank["w_down"]

    def gateup_k():
        return ops.ragged_dense_gateup(xs, tile_eid, n_tiles, wg, wu, bm=bm)

    def gateup_p():
        return ref.ragged_dense_gateup_ref(xs, tile_eid, wg, wu, bm=bm)

    h_ref = gateup_p()

    def down_k():
        return ops.ragged_dense_down(h_ref, tile_eid, n_tiles, wd, bm=bm)

    def down_p():
        return ref.ragged_dense_down_ref(h_ref, tile_eid, wd, bm=bm)

    h_k, y_ref, y_k = gateup_k(), down_p(), down_k()
    y_full = ops.ragged_dense_ffn(xs, tile_eid, n_tiles, bank, bm=bm)
    torch.cuda.synchronize()

    def err(a, b):
        a, b = a[:rows].float(), b[:rows].float()
        assert torch.isfinite(a).all(), f"{name}: non-finite kernel output"
        return float((a - b).abs().max()), float(b.abs().max())

    (e_h, m_h), (e_y, m_y), (e_f, m_f) = (err(h_k, h_ref), err(y_k, y_ref),
                                          err(y_full, y_ref))
    ok = e_h <= tol_rel * m_h and e_y <= tol_rel * m_y and \
        e_f <= tol_rel * m_f
    # Bytes: each input read once (the live tiles' rows, the weights of
    # the distinct experts they route to, the maps), each output written
    # once.
    n_e = torch.unique(tile_eid[:n_live]).numel()
    maps = Tt * 4 + 4
    gu_bytes = rows * K * 2 + n_e * 2 * K * F * 2 + rows * F * 2 + maps
    dn_bytes = rows * F * 2 + n_e * F * D * 2 + rows * D * 2 + maps
    # The yardstick: each expert's segment of the compacted rows.
    counts = inp["counts"]
    offs = torch.cumsum((counts + bm - 1) // bm * bm, 0).to(torch.int32)
    w_gu = torch.cat([wg, wu], dim=-1)
    libs = {"gateup": _grouped_mm_yardstick(xs, w_gu, offs),
            "down": _grouped_mm_yardstick(h_ref, wd, offs)}
    runs = ops.dense_runs(tile_eid.cpu(), n_live)
    out = {"case": name, "ok": ok, "tiles": n_live, "experts": n_e,
           "runs": len(runs),
           "longest_segment": int(((counts + bm - 1) // bm).max()),
           "err_ffn": e_f, "tol_ffn": tol_rel * m_f}
    for key, run_k, run_p, e, m, b in (
            ("gateup", gateup_k, gateup_p, e_h, m_h,
             bound(gu_bytes, 2 * rows * K * F * 2)),
            ("down", down_k, down_p, e_y, m_y,
             bound(dn_bytes, 2 * rows * F * D))):
        lib, how = libs[key]
        c = {"err": e, "tol": tol_rel * m, "ms": time_ms(run_k),
             "plain_ms": time_ms(run_p, iters=3, warmup=1),
             "bound_ms": b[0], "bound_by": b[1], "library": how,
             "library_ms": None, "library_graph_ms": None}
        if lib is None:
            c["graph_ms"] = graph_ms(run_k)
        else:
            c["library_ms"] = time_ms(lib)
            c.update(interleaved(run_k, lib))
        out[key] = c
    log("kernels", f"ragged dense FFN {name}: {n_live}/{Tt} live tiles of "
                   f"{n_e} experts in {len(runs)} runs (longest segment "
                   f"{out['longest_segment']} tiles) | " + " | ".join(
                       f"{key} err {c['err']:.3g} (tol {c['tol']:.3g}) "
                       f"{c['ms']:.4f} ms, graph {c['graph_ms']:.4f} ms, "
                       f"plain {c['plain_ms']:.3f} ms, bound "
                       f"{c['bound_ms']:.4f} ms ({c['bound_by']}), "
                       f"_grouped_mm " + (
                           f"{c['library_ms']:.4f} ms, "
                           f"{c['library_graph_method']} "
                           f"{c['library_graph_ms']:.4f} ms ({c['library']}"
                           f"; turns kernel/lib/lib/kernel "
                           f"{[round(x, 5) for x in c['graph_runs']]})"
                           if c["library_ms"] is not None
                           else f"none: {c['library']}")
                       for key, c in (("gateup", out["gateup"]),
                                      ("down", out["down"])))
                   + f" | ffn err {e_f:.3g} | {'ok' if ok else 'FAIL'}")
    return out


def _dense_orders(name, bank, inp, tol) -> dict:
    """The all-hi kernels on one case's tile map with its live tiles in
    other orders: ``shuffled`` (a random permutation) and ``split`` (the
    second half first: the expert at the cut has tiles in two separate
    places), beside the dispatch's ``sorted`` map. Each FFN is held to the
    plain version on the same map at ``tol`` × max|plain| over the live
    rows, with its segments (maximal runs of one id), runs and device
    time per call (graph replay). Returns {order: {"err", "tol",
    "segments", "runs", "graph_ms"}}."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import RAGGED_BM as bm
    xs, te, n = inp["xs"], inp["tile_eid"], inp["n_tiles"]
    live = int(n.item())
    gen = torch.Generator(device=te.device).manual_seed(17)
    perm = torch.randperm(live, generator=gen, device=te.device)
    eid = te[:live].tolist()
    cut = next(t for t in range(live // 2, live) if eid[t] == eid[t - 1])
    maps = {"sorted": te,
            "shuffled": torch.cat([te[:live][perm], te[live:]]),
            "split": torch.cat([te[cut:live], te[:cut], te[live:]])}
    out, rows = {}, live * bm
    for order, m in maps.items():
        run = lambda m=m: ops.ragged_dense_ffn(xs, m, n, bank, bm=bm)
        got = run()[:rows].float()
        want = ref.ragged_dense_ffn_ref(xs, m, bank["w_gate"], bank["w_up"],
                                        bank["w_down"], bm=bm)[:rows].float()
        torch.cuda.synchronize()
        ids = m[:live].tolist()
        out[order] = {"err": float((got - want).abs().max()),
                      "tol": tol * float(want.abs().max()),
                      "segments": 1 + sum(a != b for a, b in
                                          zip(ids, ids[1:])),
                      "runs": len(ops.dense_runs(m.cpu(), live)),
                      "graph_ms": graph_ms(run)}
    log("kernels", f"ragged dense FFN {name}, tile orders: " + ", ".join(
        f"{k} {v['segments']} segments in {v['runs']} runs, err "
        f"{v['err']:.3g} (tol {v['tol']:.3g}), "
        f"graph {v['graph_ms']:.4f} ms" for k, v in out.items()))
    bad = [k for k, v in out.items() if not v["err"] <= v["tol"]]
    if bad or not out["split"]["segments"] > out["sorted"]["segments"]:
        raise AssertionError(f"all-hi kernels on other tile orders: {bad}")
    return out


def _kernels_dense_ffn(dev, tol) -> None:
    """The all-hi mode at the baselines' shapes (``DENSE_CASES``):
    Qwen3-30B-A3B (top-8 of 128, K = 2048, F = 768) at decode B = 8,
    prefill 512 and a skewed prefill 512, and the flagship (top-10 of 512,
    F = 512) at decode B = 8 and prefill 512."""
    cases, orders = {}, None
    for key, name, bank, inp in _dense_cases(dev):
        cases[key] = _dense_ffn_case(name, bank, inp, tol_rel=tol)
        if key == "30b_prefill":
            orders = _dense_orders(name, bank, inp, tol)
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"ragged dense FFN kernels disagree: {bad}")
    _dense_routes(dev, tol)
    d = cases["30b_decode"]
    for kname, key in (("ragged_dense_gateup", "gateup"),
                       ("ragged_dense_down", "down")):
        RESULTS[kname] = {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ragged_dense_ffn.cu",
            "replaces": "src/repro/kernels/ops.py:131",
            "launches": 0,
            "max_abs_err": max(c[key]["err"] for c in cases.values()),
            "ms": d[key]["ms"], "plain_ms": d[key]["plain_ms"],
            "bound_ms": d[key]["bound_ms"], "bound_by": d[key]["bound_by"],
            "library_ms": d[key]["library_ms"],
            "graph_ms": d[key]["graph_ms"],
            "library_graph_ms": d[key]["library_graph_ms"],
            "library": d[key]["library"],
            "tile_orders": orders,
            "cases": [dict(case=c["case"], tiles=c["tiles"],
                           experts=c["experts"], runs=c["runs"],
                           **{k: v for k, v in c[key].items()
                              if k != "graph_runs"})
                      for c in cases.values()]}


def _dense_routes(dev, tol) -> None:
    """The all-hi wrappers' route (``ops.dense_route``, decided from shapes
    before any launch): every registered MoE config at full width takes the
    kernel on its operands as they are; a shape the kernels cannot tile as
    it is (N = 96, then K = 200) and a misaligned operand go to the kernel
    as zero-padded aligned copies, equal to the kernel on operands padded
    by hand and to the plain version within ``tol``. The counters are
    zeroed again before the main paths run."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import ops, ref
    routes = {}
    for name in ARCH_IDS:
        c = get_config(name)
        if c.moe is None:                   # no expert bank to route
            continue
        d, f, m = c.d_model, c.moe.d_ff_expert, c.moe
        # A prefill of 512 tokens: the dispatch's tile budget.
        Tt = 512 * m.top_k // 8 + min(m.num_experts, 512 * m.top_k) + 1
        x = torch.zeros((8, max(d, f)), dtype=torch.bfloat16, device=dev)
        routes[name] = (ops.dense_route(8, d, f, Tt, x),
                        ops.dense_route(8, f, d, Tt, x))
    if any(r != ("kernel", "kernel") for r in routes.values()):
        raise AssertionError(f"all-hi routes {routes}")
    gen = torch.Generator(device=dev).manual_seed(11)
    te = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)
    nt = torch.tensor([3], dtype=torch.int32, device=dev)
    pad = torch.nn.functional.pad
    errs = {}
    for K, N in ((256, 96), (200, 128)):
        x = torch.randn((24, K), generator=gen, device=dev).bfloat16()
        w = torch.randn((2, K, N), generator=gen, device=dev).bfloat16() * .1
        Kp, Np = -(-K // 16) * 16, -(-N // 64) * 64
        ops.reset_launches()
        got = ops.ragged_dense_gateup(x, te, nt, w, w, bm=8)
        route, launches = ops.dense_route(8, K, N, te.shape[0], x, w), \
            ops.LAUNCHES["ragged_dense_gateup"]
        byhand = ops.ragged_dense_launch(
            "ragged_dense_gateup", pad(x, (0, Kp - K)), te, nt,
            (pad(w, (0, Np - N, 0, Kp - K)),) * 2)[:, :N]
        want = ref.ragged_dense_gateup_ref(x, te, w, w, bm=8).float()
        err = float((got.float() - want).abs().max())
        errs[(K, N)] = err
        if route != "copy" or launches != 1 or \
                not torch.equal(got, byhand) or \
                err > tol * float(want.abs().max()):
            raise AssertionError(f"K, N = {K}, {N}: route {route}, "
                                 f"launches {launches}, equal to the "
                                 f"padded call {torch.equal(got, byhand)}, "
                                 f"max |err| {err}")
    wa = torch.randn((2, 256, 128), generator=gen, device=dev).bfloat16()
    x = torch.randn((24, 256), generator=gen, device=dev).bfloat16()
    xm = torch.zeros(24 * 256 + 1, dtype=torch.bfloat16, device=dev)[1:] \
        .view(24, 256)
    xm.copy_(x)
    route = ops.dense_route(8, 256, 128, te.shape[0], xm, wa)
    ops.reset_launches()
    got = ops.ragged_dense_gateup(xm, te, nt, wa, wa, bm=8)
    want = ops.ragged_dense_gateup(x, te, nt, wa, wa, bm=8)
    torch.cuda.synchronize()
    if route != "copy" or ops.LAUNCHES["ragged_dense_gateup"] != 2 or \
            not torch.equal(got[:24], want[:24]):
        raise AssertionError(f"misaligned x: route {route}, launches "
                             f"{ops.LAUNCHES}")
    ops.reset_launches()
    log("kernels", f"all-hi routes (decided before launch): every "
                   f"registered config takes the kernel on its operands "
                   f"{routes}; (K, N) = (256, 96) and (200, 128) and a "
                   f"misaligned x took the kernel on zero-padded aligned "
                   f"copies (equal to the kernel on operands padded by "
                   f"hand; max |err| against the plain version {errs}, tol "
                   f"{tol} of the largest output)")


#: The decode-attention shapes the kernels took before the padded widths
#: (the 30B's H 32 / Hkv 4 / hd 128, the flagship's 16 / 2 / 256, Jamba's
#: 32 / 8 / 128), held to the parent's kernels with ``--parent``.
ATTN_AB = (("30b", ARCH), ("80b", FLAGSHIP), ("jamba", "jamba-v0_1-52b"))
#: The parent's graph ms that these shapes' must stay within.
ATTN_AB_SPREAD = 0.03


def _attn_ab(parent) -> None:
    """With ``--parent``: both decode-attention kernels of the parent tree
    and this one on the same inputs at ``ATTN_AB``'s shapes (B=8, the
    serving phase's 288 positions of random lengths, row 0 full), through
    this tree's launch plan: outputs bit-equal, device ms by graph replay
    in turns (parent, change, change, parent); each kernel's entry gains a
    "parent_ab" list."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    libs, _ = _parent_library(pathlib.Path(parent),
                              ("flash_decode", "flash_decode_paged"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(71)
    for case, arch in ATTN_AB:
        cfg = get_config(arch)
        for name in ("flash_decode", "flash_decode_paged"):
            if name == "flash_decode":
                q, k, v, m, _, _ = _dense_decode_inputs(cfg, gen, dev, 8, 288)
                rest = (m,)
                ops.flash_decode(q, k, v, m)
                key = (name, q.shape, k.shape, k.stride(), q.device.index)
            else:
                q, k, v, t, m, _, _ = _paged_decode_inputs(cfg, gen, dev, 8,
                                                           18)
                rest = (t, m)
                ops.flash_decode_paged(q, k, v, t, m)
                key = (name, q.shape, k.shape, t.shape[1], q.device.index)
            plan = ops._PLANS[key]
            ptrs = [x.data_ptr() for x in (q, k, v) + rest]
            outs = [torch.empty(plan.shape, dtype=torch.bfloat16, device=dev)
                    for _ in range(2)]
            scratch = [None if not plan.scratch else torch.empty(
                plan.scratch, dtype=torch.float32, device=dev)
                for _ in range(2)]
            # The stream is read at each call: a graph capture runs on a
            # stream of its own.
            def run(lib, i, name=name, ptrs=ptrs, plan=plan):
                build.check(getattr(lib, name)(
                    *ptrs, outs[i].data_ptr(), ops._ptr(scratch[i]),
                    plan.dims_ptr, plan.scale, ops._stream(0)), name)

            mine = build.library(name)
            run(libs[name], 0)
            run(mine, 1)
            torch.cuda.synchronize()
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{name} {case}: parent and change "
                                     f"differ")
            tt = _turns(lambda: run(libs[name], 0), lambda: run(mine, 1))
            p_ms, c_ms = (tt[0] + tt[3]) / 2, (tt[1] + tt[2]) / 2
            within = abs(c_ms / p_ms - 1) <= ATTN_AB_SPREAD
            RESULTS[name].setdefault("parent_ab", []).append(
                {"case": case, "split": plan.n_split, "turns_ms": tt,
                 "parent_ms": p_ms, "change_ms": c_ms,
                 "within_spread": within})
            log("kernels", f"A/B {name} {case} B=8 (H {cfg.attn.n_heads}, "
                           f"Hkv {cfg.attn.n_kv_heads}, hd "
                           f"{cfg.attn.head_dim}), {plan.n_split} split(s): "
                           f"parent/change/change/parent graph ms "
                           f"{[round(x, 5) for x in tt]} -> parent "
                           f"{p_ms:.5f}, change {c_ms:.5f} "
                           f"({(c_ms / p_ms - 1) * 100:+.2f}%, within "
                           f"{ATTN_AB_SPREAD:.0%}: {within}), outputs "
                           f"bit-equal")


def phase_kernels(parent=None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.quant.qtensor import quantize
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    E, K, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    n_hi, group = 16, 64
    dense = {n: (torch.randn((E,) + s, generator=gen, device=dev)
                 * s[0] ** -0.5).to(torch.bfloat16)
             for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                          ("w_down", (F, K)))}
    hi_w = {n: (torch.randn((n_hi,) + tuple(w.shape[1:]), generator=gen,
                            device=dev) * w.shape[1] ** -0.5
                ).to(torch.bfloat16) for n, w in dense.items()}
    owner = torch.full((n_hi,), -1, dtype=torch.int32, device=dev)
    owner[:12] = torch.randperm(E, generator=gen, device=dev)[:12].to(
        torch.int32)
    # Tolerance: kernel and plain version both accumulate in float32 and
    # differ only in summation order and in where a bf16 rounding flips —
    # a few bf16 ulps (2^-8 relative) at the largest magnitude.
    tol = 2.0 ** -6
    cases, gq = {}, {}
    for bits in (4, 2, 8):
        lo = {n: quantize(w, bits, group) for n, w in dense.items()}
        # The padded dispatch's capacities: 8 at an 8-slot decode, 136 at a
        # 4-row × 256-token prefill.
        gq[f"int{bits} gate C=8"] = _gqmm_case(
            f"int{bits} gate/up decode", gen, dev, lo["w_gate"], 8, tol,
            host=bits == 4)
        if bits == 4:
            gq["int4 down C=8"] = _gqmm_case("int4 down decode", gen, dev,
                                             lo["w_down"], 8, tol)
            gq["int4 gate C=136"] = _gqmm_case("int4 gate/up prefill", gen,
                                               dev, lo["w_gate"], 136, tol)
            # Its own generator: the later cases keep their inputs.
            gq["int4 gate C=13"] = _gqmm_case(
                "int4 gate/up odd C", torch.Generator(device=dev)
                .manual_seed(43), dev, lo["w_gate"], 13, tol)
        if bits == 4:
            cases["decode"] = _ffn_case("int4 decode B=8 mixed", gen, dev,
                                        bits=4, T=8, lo_w=lo, hi_w=hi_w,
                                        slot_owner=owner, tol_rel=tol,
                                        host=True)
            cases["prefill"] = _ffn_case("int4 prefill 512 mixed", gen, dev,
                                         bits=4, T=512, lo_w=lo, hi_w=hi_w,
                                         slot_owner=owner, tol_rel=tol)
            cases["all_lo"] = _ffn_case(
                "int4 decode B=8 all-lo", gen, dev, bits=4, T=8, lo_w=lo,
                hi_w=None, slot_owner=torch.zeros((0,), dtype=torch.int32,
                                                  device=dev), tol_rel=tol)
        else:
            cases[f"int{bits}"] = _ffn_case(
                f"int{bits} decode B=8 mixed", gen, dev, bits=bits, T=8,
                lo_w=lo, hi_w=hi_w, slot_owner=owner, tol_rel=tol)
        del lo
    cases.update(_flagship_ffn_cases(dev, tol))
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"ragged FFN kernels disagree: {bad}")
    if not any(c["hi_tiles"] for c in cases.values()):
        raise AssertionError("no ragged kernel check exercised a hi tile")
    d = cases["decode"]
    for kname, key in (("ragged_gateup", "gateup"), ("ragged_down", "down")):
        RESULTS[kname] = {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ragged_ffn.cu",
            "replaces": ("src/repro/kernels/quant_matmul.py:185"
                         if key == "gateup" else
                         "src/repro/kernels/quant_matmul.py:236"),
            "launches": 0,
            "max_abs_err": max(c[key]["err"] for c in cases.values()),
            "ms": d[key]["ms"], "plain_ms": d[key]["plain_ms"],
            "bound_ms": d[key]["bound_ms"], "bound_by": d[key]["bound_by"],
            "library_ms": None, "graph_ms": d[key]["graph_ms"],
            "host_us": d[key]["host_us"],
            "cases": [dict(case=c["case"], tiles=c["tiles"],
                           hi_tiles=c["hi_tiles"], top_slot=c["top_slot"],
                           **c[key])
                      for c in cases.values()]}
    log("kernels", "ragged FFN yardstick: none, no single library call "
                   "computes the mixed-precision ragged FFN")
    bad = [k for k, c in gq.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped_lo_matmul disagrees: {bad}")
    d = gq["int4 gate C=8"]
    RESULTS["grouped_lo_matmul"] = {
        "name": "grouped_lo_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:131",
        "launches": 0, "max_abs_err": max(c["err"] for c in gq.values()),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound"][0],
        "bound_by": d["bound"][1], "library_ms": None,
        "graph_ms": d["graph_ms"], "host_us": d["host_us"],
        "cases": [{"case": c["case"], "err": c["err"], "ms": c["ms"],
                   "graph_ms": c["graph_ms"], "plain_ms": c["plain_ms"],
                   "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                  for c in gq.values()]}
    log("kernels", "grouped_lo_matmul yardstick: none, no single library "
                   "call computes a grouped quantized GEMM")
    del dense, hi_w
    _kernels_dense_ffn(dev, tol)
    _kernels_dense_decode(cfg, gen, dev)
    _kernels_quant_matmul(gen, dev, tol)
    _kernels_paged_decode(cfg, gen, dev)
    if parent is not None:
        _attn_ab(parent)


def phase_splits() -> None:
    """Each decode-attention kernel at its main shapes under forced split
    counts, held against its plain version at every count and timed by
    graph replay (device) and by the host time of one wrapper call: the
    data behind the split rule ``ops.decode_splits``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    Hkv = cfg.attn.n_kv_heads
    rule = ops.decode_splits
    for kind, B, n in (("flash_decode", 8, 288), ("flash_decode", 1, 4096),
                       ("flash_decode_paged", 8, 32),
                       ("flash_decode_paged", 8, 18),
                       ("flash_decode_paged", 1, 32),
                       ("flash_decode_paged", 1, 256)):
        if kind == "flash_decode":
            q, k, v, valid, _, _ = _dense_decode_inputs(cfg, gen, dev, B, n)
            n_tiles = -(-n // ops.DECODE_TILE)
            run = lambda q=q, k=k, v=v, m=valid: ops.flash_decode(q, k, v, m)
            want = ref.flash_decode_ref(q, k, v, valid)
            case = f"B={B} S={n}"
        else:
            q, k, v, table, valid, _, _ = _paged_decode_inputs(cfg, gen, dev,
                                                               B, n)
            n_tiles = n
            run = lambda q=q, k=k, v=v, t=table, m=valid: \
                ops.flash_decode_paged(q, k, v, t, m)
            want = ref.flash_decode_paged_ref(q, k, v, table, valid)
            case = f"B={B} nb={n}"
        tol = ATTN_TOL * float(want.float().abs().max())
        chosen = rule(B, Hkv, n_tiles, ops._sm_count(0))[0]
        seen = {}
        try:
            for forced in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128):
                tps = -(-n_tiles // min(forced, n_tiles))
                split = (-(-n_tiles // tps), tps)
                if split in seen:
                    continue
                ops.decode_splits = lambda *a, _s=split, **kw: _s
                ops._PLANS.clear()
                err = float((run().float() - want.float()).abs().max())
                if err > tol:
                    raise AssertionError(f"{kind} {case} at {split[0]} "
                                         f"splits: err {err} > tol {tol}")
                seen[split] = (graph_ms(run), host_us(run))
        finally:
            ops.decode_splits = rule
            ops._PLANS.clear()
        log("splits", f"{kind} {case} ({n_tiles} tiles; the rule picks "
                      f"{chosen}): n_split -> graph ms, host us/call "
                      + ", ".join(f"{ns}: {g:.4f}, {h:.1f}"
                                  for (ns, _), (g, h) in seen.items()))


def phase_gemms() -> None:
    """Both quantized GEMMs at their main shapes under forced plans, held
    against their plain versions at every setting and timed by graph
    replay: the grouped GEMM (128 experts, int4, g = 64) at the padded
    dispatch's decode (C = 8) and prefill (C = 136) capacities, gate/up
    (K = 2048, N = 768) and down (K = 768, N = 2048), under NT = 1, 2, 4 ×
    (K ranges, pieces per range) (1, 1), (1, 2), (1, 4), (1, 8), (2, rule),
    (4, rule); the plain GEMM (K = 2048, N = 768) at M = 1, 13, 128 under
    NT × K ranges 1 … 32 (pieces by the rule). The data behind
    ``ops.gemm_plan``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.qtensor import quantize
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    E, d, F, group, tol = cfg.moe.num_experts, cfg.d_model, \
        cfg.moe.d_ff_expert, 64, 2.0 ** -6
    rule, n_sm = ops.gemm_plan, ops._sm_count(0)

    def sweep(what, run, want, shape, settings):
        chosen = rule(*shape, n_sm)
        bound_tol = tol * float(want.float().abs().max())
        G = shape[2] // group
        seen = {}
        try:
            for nt, S, P in settings:
                gps = -(-G // S)
                gpc = ops.gemm_piece(nt, group, gps) if P is None else \
                    -(-gps // P)
                plan = ops.GemmPlan(nt, -(-G // gps), gps, gpc)
                key = (plan.nt, plan.n_split, -(-gps // gpc))
                if key in seen:
                    continue
                ops.gemm_plan = lambda *a, _p=plan: _p
                err = float((run().float() - want.float()).abs().max())
                if err > bound_tol:
                    raise AssertionError(f"{what} at {plan}: err {err} > "
                                         f"tol {bound_tol}")
                seen[key] = graph_ms(run)
        finally:
            ops.gemm_plan = rule
        log("gemms", f"{what} (the plan picks NT={chosen.nt}, "
                     f"S={chosen.n_split}, {-(-chosen.gps // chosen.gpc)} "
                     f"piece(s)): (NT, S, pieces) -> graph ms "
                     + ", ".join(f"{k}: {g:.4f}" for k, g in seen.items()))

    for name, (K, N) in (("gate/up", (d, F)), ("down", (F, d))):
        qt = quantize((torch.randn((E, K, N), generator=gen, device=dev)
                       * K ** -0.5).to(torch.bfloat16), 4, group)
        for C in (8, 136):
            xg = torch.randn((E, C, K), generator=gen, device=dev).to(
                torch.bfloat16)
            sweep(f"grouped_lo_matmul int4 {name} E={E} C={C}",
                  lambda xg=xg, qt=qt: ops.grouped_lo_matmul(
                      xg, qt.packed, qt.scales, 4, group),
                  ref.grouped_lo_gemm(xg, qt.packed, qt.scales, 4, group),
                  (E, C, K, N, group),
                  [(nt, S, P) for nt in ops.GEMM_NT
                   for S, P in ((1, 1), (1, 2), (1, 4), (1, 8), (2, None),
                                (4, None))])
        del qt
    K, N = d, F
    qt = quantize((torch.randn((K, N), generator=gen, device=dev)
                   * K ** -0.5).to(torch.bfloat16), 4, group)
    for M in (1, 13, 128):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        sweep(f"quant_matmul int4 M={M} K={K} N={N}",
              lambda x=x: ops.quant_matmul_op(x, qt),
              ref.quant_matmul_ref(x, qt.packed, qt.scales, 4, group),
              (1, M, K, N, group),
              [(nt, S, None) for nt in ops.GEMM_NT
               for S in (1, 2, 4, 8, 16, 32)])


@functools.lru_cache(maxsize=None)
def _parent_library(parent: pathlib.Path,
                    names=("ragged_ffn", "ragged_dense_ffn")):
    """The parent tree's libraries ``names`` (by default the ragged FFN's
    and the all-hi one's: ``csrc/ragged_ffn.cu`` and
    ``csrc/ragged_dense_ffn.cu`` of a ``git archive`` of the parent
    commit), built at once with this tree's flags into
    ``build/kernels/parent/`` and loaded with this tree's C signatures
    (the same entries; the parent's all-hi occupancy takes E where this
    tree's takes the tile count; an entry this tree added, as row 5's
    ``flash_decode_lse``, is not there). Returns ({name: library}, {name:
    path})."""
    import ctypes
    from repro_torch.kernels import build
    out_dir = build.build_dir() / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    procs = [subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                               str(paths[n]), str(
                                   parent / "src/repro_torch/kernels/csrc" /
                                   f"{n}.cu")]) for n in names]
    for p in procs:
        if p.wait(timeout=600) != 0:
            raise RuntimeError("nvcc failed on a parent source")
    libs = {}
    for n in names:
        lib = ctypes.CDLL(str(paths[n]))
        for fn, argtypes in build.SIGNATURES[n].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib
    return libs, paths


def _sass_summary(path) -> dict:
    """Registers and HMMA instructions of each ``ragged_ffn_kernel``
    instantiation in a library, keyed by (NMAT, BITS), from ``cuobjdump``
    (``-res-usage`` and ``-sass``)."""
    import re
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-res-usage", str(path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    pat = re.compile(r"ragged_ffn_kernelILi(\d)ELi(\d+)E(?:Lb0E)?E")
    out = {}
    for m in re.finditer(r"Function (\S+):\s*\n?\s*REG:(\d+)", res):
        k = pat.search(m.group(1))
        if k:
            out.setdefault(f"nmat{k.group(1)}_bits{k.group(2)}", {})[
                "regs"] = int(m.group(2))
    for block in sass.split("Function : ")[1:]:
        k = pat.search(block.split("\n", 1)[0])
        if k:
            out.setdefault(f"nmat{k.group(1)}_bits{k.group(2)}", {})[
                "hmma"] = block.count("HMMA")
    return out


def _turns(parent_run, change_run) -> list:
    """Device ms (graph replay) in turns: parent, change, change, parent."""
    return [graph_ms(parent_run), graph_ms(change_run),
            graph_ms(change_run), graph_ms(parent_run)]


def phase_dense(parent) -> None:
    """The all-hi kernels on every case of ``DENSE_CASES`` under forced
    settings, each held bit for bit to the default launch and timed by
    graph replay: the persistent grid against one CTA for every possible
    item (``Tt`` × column blocks), runs capped at 8, 4, 2 and 1 tiles (1:
    each tile reads its expert's weights, as the parent's kernel did), and
    4 and 8 consumer warps (an item of 64 or 128 columns) × rings of 2, 3,
    4, 6 and 8 slots (those that fit in shared memory).
    With ``--parent`` (a ``git archive`` of the parent commit): the parent's
    all-hi kernels against this tree's in turns (parent, change, change,
    parent) on every case, held to the plain version's tolerance; the
    quantized ragged kernels (int4 decode B=8 and prefill 512, hi tiles
    mixed in) of both trees in turns, bit-equal; and both trees'
    ``ragged_ffn_kernel`` registers and HMMA counts."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import RAGGED_BM as bm
    dev = torch.device("cuda")
    plibs = plib = None
    if parent is not None:
        plibs, ppaths = _parent_library(pathlib.Path(parent))
        plib = plibs["ragged_ffn"]
        from repro_torch.kernels import build
        mine = build._target("ragged_ffn")
        sp, sm = _sass_summary(ppaths["ragged_ffn"]), _sass_summary(mine)
        log("dense", f"ragged_ffn_kernel (nmat, bits) registers / HMMA, "
                     f"parent vs change: " + ", ".join(
                         f"{k} {sp[k].get('regs')}/{sp[k].get('hmma')} vs "
                         f"{sm.get(k, {}).get('regs')}/"
                         f"{sm.get(k, {}).get('hmma')}" for k in sorted(sp)
                         if not k.endswith("bits16")))
    stream = lambda: ops._stream(0)
    for key, name, bank, inp in _dense_cases(dev):
        xs, te, n = inp["xs"], inp["tile_eid"], inp["n_tiles"]
        Tt, rows = te.shape[0], int(n.item()) * bm
        h = ref.ragged_dense_gateup_ref(xs, te, bank["w_gate"],
                                        bank["w_up"], bm=bm)
        for kname, x, ws in (("ragged_dense_gateup", xs,
                              (bank["w_gate"], bank["w_up"])),
                             ("ragged_dense_down", h, (bank["w_down"],))):
            N = ws[0].shape[2]
            want = ops.ragged_dense_launch(kname, x, te, n, ws)
            plain = ref.ragged_dense_gateup_ref(xs, te, *ws, bm=bm) \
                if len(ws) == 2 else ref.ragged_dense_down_ref(x, te, *ws,
                                                               bm=bm)
            tol = 2.0 ** -6 * float(plain[:rows].float().abs().max())
            sweep, (w0, s0) = {}, ops.DENSE_PLAN[kname]
            every = Tt * -(-N // (16 * w0))
            settings = [(None, c, w0, s0) for c in (8, 4, 2, 1)] + \
                [(every, 8, w0, s0), (every, 1, w0, s0)] + \
                [(None, 8, w, st) for w in (4, 8)
                 for st in (2, 3, 4, 6, 8) if ops.dense_smem_bytes(
                     len(ws), w, st, Tt) <= ops.SMEM_MAX]
            for grid, cap, warps, stages in settings:
                run = lambda g=grid, c=cap, w=warps, st=stages: \
                    ops.ragged_dense_launch(kname, x, te, n, ws, grid=g,
                                            cap=c, warps=w, stages=st)
                if not torch.equal(run()[:rows], want[:rows]):
                    raise AssertionError(f"{kname} {name}: grid {grid}, cap "
                                         f"{cap}, warps {warps}, stages "
                                         f"{stages} differs")
                sweep[("persistent" if grid is None else "all items", cap,
                       warps, stages)] = graph_ms(run)
            log("dense", f"{kname} {name}: (grid, run cap, consumer warps, "
                         f"ring slots) -> graph ms " + ", ".join(
                             f"{k}: {v:.4f}" for k, v in sweep.items()))
            if plibs is None:
                continue
            out_p = torch.empty_like(want)
            pdense = plibs["ragged_dense_ffn"]
            E, K = ws[0].shape[0], x.shape[1]
            per_sm = pdense.ragged_dense_occupancy(len(ws), w0, s0, E)
            pgrid = ops.dense_grid(torch.cuda.get_device_properties(
                0).multi_processor_count, per_sm, Tt, -(-N // (16 * w0)))
            # The map buffers stay referenced by ``maps`` while ``prun``
            # runs (the cache may drop them).
            maps = [ops._tensor_map(x, ops.DENSE_X_BOX)] + \
                [ops._tensor_map(w, ops.DENSE_W_BOX) for w in ws]
            args = [*map(ctypes.addressof, maps), te.data_ptr(), n.data_ptr(),
                    out_p.data_ptr(), Tt, K, N, E, pgrid, ops.DENSE_NT, s0,
                    w0]
            prun = lambda: build.check(getattr(pdense, kname)(
                *args, stream()), f"parent {kname}")
            crun = lambda: ops.ragged_dense_launch(kname, x, te, n, ws)
            prun()
            torch.cuda.synchronize()
            e_p = float((out_p[:rows].float() - plain[:rows].float()).abs()
                        .max())
            e_c = float((want[:rows].float() - plain[:rows].float()).abs()
                        .max())
            if max(e_p, e_c) > tol:
                raise AssertionError(f"{kname} {name}: err parent {e_p}, "
                                     f"change {e_c} > tol {tol}")
            t = _turns(prun, crun)
            log("dense", f"A/B {kname} {name}: parent/change/change/parent "
                         f"graph ms {[round(v, 5) for v in t]} -> parent "
                         f"{(t[0] + t[3]) / 2:.4f}, change "
                         f"{(t[1] + t[2]) / 2:.4f} (err parent {e_p:.3g}, "
                         f"change {e_c:.3g}, tol {tol:.3g})")
    if plib is not None:
        _quant_ab(plib, ((ARCH, 4, 8), (ARCH, 4, 512)), "dense")


def _quant_ab(plib, cases, phase) -> None:
    """The quantized ragged kernels (rows 1–2) of the parent (``plib``)
    and this tree on the same inputs in turns (parent, change, change,
    parent), for each (arch, lo bits, tokens) of ``cases``: hi tiles from
    a 16-slot pool, g = 64; outputs bit-equal. Logged under ``phase``."""
    from repro_torch.configs import get_config
    from repro_torch.core.ver import ExpertBankQ
    from repro_torch.kernels import build, ops
    from repro_torch.models.moe import (RAGGED_BM, _sort_routing,
                                        _tile_slots, ragged_tile_map)
    from repro_torch.quant.qtensor import quantize
    dev = torch.device("cuda")
    stream = lambda: ops._stream(0)
    gen = torch.Generator(device=dev).manual_seed(77)
    mine = build.library("ragged_ffn")
    for arch, bits, T in cases:
        cfg = get_config(arch)
        E, K, F, k = cfg.moe.num_experts, cfg.d_model, \
            cfg.moe.d_ff_expert, cfg.moe.top_k
        n_hi, bm = 16, RAGGED_BM
        shapes = (("w_gate", (K, F)), ("w_up", (K, F)), ("w_down", (F, K)))
        lo = {n: quantize((torch.randn((E,) + s, generator=gen, device=dev)
                           * s[0] ** -0.5).to(torch.bfloat16), bits, 64)
              for n, s in shapes}
        hi = {n: (torch.randn((n_hi,) + s, generator=gen, device=dev)
                  * s[0] ** -0.5).to(torch.bfloat16) for n, s in shapes}
        owner = torch.full((n_hi,), -1, dtype=torch.int32, device=dev)
        owner[:12] = torch.randperm(E, generator=gen, device=dev)[:12].to(
            torch.int32)
        bank = ExpertBankQ(lo=lo, hi=hi, slot_owner=owner,
                           slot_map=torch.zeros((E,), dtype=torch.int32,
                                                device=dev))
        idx = torch.topk(torch.randn((T, E), generator=gen, device=dev), k,
                         dim=-1).indices
        _, _, counts, _, _ = _sort_routing(idx, E)
        _, te, n = ragged_tile_map(counts, bm, T * k)
        ts = _tile_slots(bank, te, E)
        Tt = te.shape[0]
        xs = torch.randn((Tt * bm, K), generator=gen, device=dev).to(
            torch.bfloat16)
        h = [torch.empty((Tt * bm, F), dtype=torch.bfloat16, device=dev)
             for _ in range(2)]
        y = [torch.empty((Tt * bm, K), dtype=torch.bfloat16, device=dev)
             for _ in range(2)]
        lg, lu, ld = lo["w_gate"], lo["w_up"], lo["w_down"]
        gu = lambda lib, o: lib.ragged_gateup(
            xs.data_ptr(), te.data_ptr(), ts.data_ptr(), n.data_ptr(),
            lg.packed.data_ptr(), lg.scales.data_ptr(), lu.packed.data_ptr(),
            lu.scales.data_ptr(), hi["w_gate"].data_ptr(),
            hi["w_up"].data_ptr(), o.data_ptr(), Tt, K, F, n_hi, bits, 64,
            stream())
        dn = lambda lib, o: lib.ragged_down(
            h[0].data_ptr(), te.data_ptr(), ts.data_ptr(), n.data_ptr(),
            ld.packed.data_ptr(), ld.scales.data_ptr(),
            hi["w_down"].data_ptr(), o.data_ptr(), Tt, F, K, n_hi, bits, 64,
            stream())
        rows = int(n.item()) * bm
        for what, fn, outs in (("ragged_gateup", gu, h),
                               ("ragged_down", dn, y)):
            for lib, o in zip((plib, mine), outs):
                build.check(fn(lib, o), what)
            torch.cuda.synchronize()
            if not torch.equal(outs[0][:rows], outs[1][:rows]):
                raise AssertionError(f"{what} {arch} T={T}: parent and "
                                     f"change differ")
            t = _turns(lambda: fn(plib, outs[0]), lambda: fn(mine, outs[1]))
            p_ms, c_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            log(phase, f"A/B {what} {arch} int{bits} T={T}: "
                       f"parent/change/change/parent graph ms "
                       f"{[round(v, 5) for v in t]} -> parent {p_ms:.5f}, "
                       f"change {c_ms:.5f} ({(c_ms / p_ms - 1) * 100:+.2f}%),"
                       f" outputs bit-equal")
        del lo, hi


# ---------------------------------------------------------------------------
# 4. model: CPU (plain versions) against the card (kernels)
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _fresh(params):
    """A new dict structure over the same tensors (a backend drops the
    dense experts from the dict it is given)."""
    if isinstance(params, dict):
        return {k: _fresh(v) for k, v in params.items()}
    return params


def _bank_with_hi(experts, n_hi, gen, lo_bits=4):
    """A bank with ``n_hi // 2`` published hi experts per layer."""
    from repro_torch.core.ver import build_bank
    bank = build_bank(experts, n_hi=n_hi, lo_bits=lo_bits)
    L, E = experts["w_gate"].shape[:2]
    for l in range(L):
        owners = torch.randperm(E, generator=gen)[:n_hi // 2]
        for s, e in enumerate(owners.tolist()):
            for n in bank.hi:
                bank.hi[n][l, s] = experts[n][l, e]
            bank.slot_owner[l, s] = e
            bank.slot_map[l, e] = s
    return bank


def run_model_check(cfg, dev_ref, dev, B=12, S=32, steps=4, bt=16,
                    seed=7, paged=True, dispatch="ragged", dispatch_ref=None,
                    lo_bits=4, n_hi=None, prefill_dispatch_ref=None,
                    lengths=None, card_dense=False, part=None):
    """Same seeded weights on ``dev_ref`` and ``dev``: one S-token prefill
    and ``steps`` teacher-forced decode steps, on the paged pool or dense
    rows, with MoE dispatch ``dispatch`` (``dispatch_ref`` on ``dev_ref``,
    default the same; ``prefill_dispatch_ref`` for its prefill alone). One
    bank per MoE position for both, int ``lo_bits`` with ``n_hi`` hi slots
    per layer, half of them published. The weights are drawn and the
    banks quantized on ``dev`` (on the CPU either takes minutes at full
    width), then copied. Returns per forward (max |Δlogit| on identically
    routed rows and on all rows, mean |Δlogit|, max |logit|, rows routed
    identically). ``lengths``: the rows' prompt lengths (else random in
    6..S, row 0 S). A sliding window shorter than S + steps makes the KV a
    ring of ``ceil(window / bt)`` blocks (dense rows: ``window`` slots),
    as the engine's. ``card_dense``: ``dev`` also runs the forwards
    on dense rows with padded dispatch (the same ring: ``window`` slots),
    held to the same reference; the report is then a pair (``paged``'s,
    dense rows'). ``part``: one half only (the halves run in two
    processes, ``_CpuRefs``): "card" returns the card's forwards, "ref"
    copies the weights to ``dev_ref``, frees them on ``dev`` and returns
    the function that runs the reference's forwards."""
    from repro_torch.models.model import (decode_step, decode_step_paged,
                                          init_caches, init_paged_caches,
                                          init_params, prefill,
                                          prefill_paged)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, seed=seed, device=dev)
    if n_hi is None:
        n_hi = 16 if cfg.moe.num_experts >= 64 else 2
    banks = {}
    for p in map(str, _moe_positions(cfg)):
        experts = params["blocks"][p]["moe"].pop("experts")
        banks[p] = _bank_with_hi(experts, n_hi, gen, lo_bits=lo_bits)
        del experts
    halves = [(dev_ref, dispatch_ref or dispatch,
               prefill_dispatch_ref or dispatch_ref or dispatch),
              (dev, dispatch, dispatch)]
    if part is not None:
        halves = halves[:1] if part == "ref" else halves[1:]
    runs = [(d, _to(params, d), {p: b.to(d) for p, b in banks.items()},
             disp, pdisp) for d, disp, pdisp in halves]
    nb = (S + steps + bt - 1) // bt + 1
    window = cfg.attn.sliding_window
    if window is not None and window < S + steps:
        nb = -(-window // bt)
    N = 1 + B * nb
    table = torch.arange(1, N, dtype=torch.int32).reshape(B, nb)
    if lengths is None:
        lengths = torch.randint(6, S + 1, (B,), generator=gen)
        lengths[0] = S
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.long)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen)
    def layers(counts):
        """Every MoE layer's (B, E) counts, position-major."""
        return torch.cat([counts[p] for p in sorted(counts)]).cpu()

    def forward(d, prm, bk, disp, pdisp, paged=paged):
        t = lambda x, d=d: x.to(d)
        kw = dict(bank=bk, per_row_counts=True, moe_dispatch=disp)
        pkw = dict(kw, moe_dispatch=pdisp)
        if paged:
            caches = init_paged_caches(cfg, N, bt, device=d, batch=B)
            logits, counts = prefill_paged(
                prm, cfg, t(toks), caches, t(table),
                t(torch.zeros(B, dtype=torch.long)), t(lengths), **pkw)
        else:
            caches = init_caches(cfg, B, nb * bt, device=d)
            logits, counts = prefill(prm, cfg, t(toks), caches, t(lengths),
                                     **pkw)
        seq = [(logits.float().cpu(), layers(counts))]
        pos = lengths.clone()
        for j in range(steps):
            if paged:
                slot = pos % (nb * bt)
                wb = table[torch.arange(B), slot // bt].long()
                logits, counts = decode_step_paged(
                    prm, cfg, t(feed[j]), t(pos), caches, t(table), t(wb),
                    t(slot % bt), **kw)
            else:
                logits, counts = decode_step(prm, cfg, t(feed[j]), t(pos),
                                             caches, **kw)
            seq.append((logits.float().cpu(), layers(counts)))
            pos = pos + 1
        return seq

    def on_card():
        """The card's forwards: [paged's] (+ [dense rows']); frees them."""
        t0 = time.perf_counter()
        run = runs.pop()
        seqs = [forward(*run)]
        if card_dense:
            seqs.append(forward(*run[:3], "padded", "padded", paged=False))
        log("model", f"{cfg.name}: the card's forwards "
                     f"{time.perf_counter() - t0:.1f} s")
        return seqs

    def on_ref(run):
        t0 = time.perf_counter()
        seq = forward(*run)
        log("model", f"{cfg.name}: the {run[0]} reference's forwards "
                     f"{time.perf_counter() - t0:.1f} s")
        return seq

    def reports(ref_seq, cards):
        return _reports(ref_seq, cards, B, card_dense)

    if part == "card":
        return on_card()
    if part == "ref":
        del params, banks
        ref = runs.pop()
        return lambda: on_ref(ref)
    card = on_card()
    return reports(on_ref(runs.pop()), card)


def _reports(ref_seq, cards, B, card_dense):
    """``run_model_check``'s report of the card's forwards against the
    reference's: one, or a pair with ``card_dense``."""
    out = [_model_report([ref_seq, c], B) for c in cards]
    return tuple(out) if card_dense else out[0]


def _model_report(out, B) -> list:
    """``run_model_check``'s report from the (reference, card) forwards."""
    report = []
    for (lr, cr), (lk, ck) in zip(out[0], out[1]):
        assert torch.isfinite(lk).all(), "non-finite logits"
        same = [r for r in range(B) if torch.equal(cr[:, r], ck[:, r])]
        err = (lk - lr).abs().amax(dim=1)
        report.append({
            "err_same": max([float(err[r]) for r in same], default=0.0),
            "err_all": float(err.max()),
            "mean_err": float((lk - lr)[same].abs().mean()) if same
            else 0.0,
            "mag": float(lr.abs().max()), "rows_same": len(same)})
    return report


#: The suffix-prefill cases: (prompt tokens, where it is cut, whether the
#: CPU runs it too). 96 = 64 + 32 (a trie hit of 4 blocks); 768 = 3 x 256
#: (the requests phase's chunked premium prompts), on the card alone.
PREFIX_CASES = ((96, (64,), True), (768, (256, 512), False))


def run_prefix_check(cfg, dev_ref, dev, cases=PREFIX_CASES, bt=16, seed=9,
                     lo_bits=4, n_hi=None, part=None):
    """Same seeded weights and bank on ``dev_ref`` and ``dev``: for each
    of ``cases`` an S-token prompt prefilled whole into blocks 1.., and
    separately in pieces cut at ``cuts`` into other blocks, each piece
    after the first a suffix with ``has_prefix`` over the blocks before it
    (the engine's route for a trie hit and for a chunk); the weights drawn
    and the bank quantized on ``dev``, every MoE layer drop-free (capacity
    over every
    token), so the routes differ only by rounding. Returns per device and
    S {"whole", "split"}: (logits (1, V), K and V of the S positions (nsb,
    S, Hkv, hd), each position's experts per layer, sorted (nsb, S,
    top_k)) on the CPU. ``part``: "card" runs ``dev``'s cases alone; "ref"
    returns the function that runs ``dev_ref``'s (``run_model_check``'s
    halves)."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.models.model import (init_paged_caches, init_params,
                                          prefill_paged)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, seed=seed, device=dev)
    experts = params["blocks"]["0"]["moe"].pop("experts")
    if n_hi is None:
        n_hi = 16 if cfg.moe.num_experts >= 64 else 2
    bank = _bank_with_hi(experts, n_hi, gen, lo_bits=lo_bits)
    del experts
    prompts = {S: torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
               for S, _, _ in cases}
    seen, route, me = [], moe_mod.route, threading.get_ident()

    def route_seen(*a, **k):
        out = route(*a, **k)
        if threading.get_ident() == me:     # not another check's thread
            seen.append(out[1].sort(dim=-1).values.cpu())
        return out

    def experts_of(n_calls):
        L = cfg.n_layers
        got = seen[-n_calls * L:]
        return torch.cat([torch.stack(got[c * L:(c + 1) * L])
                          for c in range(n_calls)], dim=1)

    def run(d, prm, bk):
        """The cases on ``d`` (the reference skips the card-only ones)."""
        key = d.type if isinstance(d, torch.device) else str(d)
        kw = dict(bank=bk, per_row_counts=True, moe_dispatch="ragged",
                  capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
        t = lambda x: torch.as_tensor(x).to(d)
        out = {}
        for S, cuts, both in cases:
            if d is dev_ref and not both:
                continue
            toks, nb = prompts[S], -(-S // bt)
            whole = torch.arange(1, 1 + nb, dtype=torch.int32)[None]
            split = whole + nb
            caches = init_paged_caches(cfg, 1 + 2 * nb, bt, device=d)

            def kv(table, S=S, caches=caches):
                blk = table[0].long().to(d)
                c = caches["0"]
                k = c.k[:, blk].permute(0, 1, 3, 2, 4).reshape(
                    c.k.shape[0], -1, c.k.shape[2], c.k.shape[4])[:, :S]
                v = c.v[:, blk].permute(0, 1, 3, 2, 4).reshape(
                    c.v.shape[0], -1, c.v.shape[2], c.v.shape[4])[:, :S]
                return k.float().cpu(), v.float().cpu()

            lw, _ = prefill_paged(prm, cfg, t(toks), caches, t(whole),
                                  t([0]), t([S]), **kw)
            ew = experts_of(1)
            edges = (0,) + tuple(cuts) + (S,)
            for c0, c1 in zip(edges, edges[1:]):
                ls, _ = prefill_paged(prm, cfg, t(toks[:, c0:c1]),
                                      caches, t(split), t([c0]),
                                      t([c1]), has_prefix=c0 > 0, **kw)
            es = experts_of(len(edges) - 1)
            out.setdefault(key, {})[S] = {
                "whole": (lw.float().cpu(),) + kv(whole) + (ew,),
                "split": (ls.float().cpu(),) + kv(split) + (es,)}
            del caches
        return out

    def routed(d, prm, bk):
        moe_mod.route = route_seen
        try:
            return run(d, prm, bk)
        finally:
            moe_mod.route = route

    if part == "ref":       # the reference's half alone, later
        prm, bk = _to(params, dev_ref), {"0": bank.to(dev_ref)}
        del params, bank
        return lambda: routed(dev_ref, prm, bk)
    out = {}
    for d in (dev,) if part == "card" else (dev_ref, dev):
        out.update(routed(d, _to(params, d), {"0": bank.to(d)}))
    return out


# Logits of the same weights on the CPU (plain versions, oneDNN GEMMs) and
# on the card (the kernels, cuBLAS GEMMs): float32 accumulation in other
# orders and bf16 roundings that flip in other places leave the hidden
# states a few bf16 ulps apart; on logits of magnitude ~5 that stays under
# MODEL_TOL for rows routed identically, while a wrong kernel moves logits
# by O(1). At 128 experts top-8 those ulps also tip near-ties between the
# 8th and 9th expert of some tokens (two probabilities within ~1e-3): the
# token then mixes one other expert at a normalized gate of ~1/8, which
# moves that row's logits by up to O(1) legitimately. Rows are therefore
# held to MODEL_TOL only while their routing is identical on both devices
# (most rows: prompts are short); rows with a swapped expert must stay
# finite and within MODEL_TOL_SWAP.
MODEL_TOL = 0.25
MODEL_TOL_SWAP = 4.0


def check_model(phase, cfg, what, dev_ref, card, later=False, key=None,
                **kw):
    """``run_model_check`` of ``cfg`` on ``dev_ref`` against ``card``, its
    line logged under ``phase``; raises when the logits disagree. ``key``:
    the check's name among the CPU process's jobs (``_CpuRefs``): while
    that process runs, only the card's forwards run here, and the
    reference's come from it. ``later``: returns the function that logs
    and checks (it waits for the CPU process's result). With
    ``card_dense``: also the card's forwards on dense rows with padded
    dispatch against the same reference, on a line of their own."""
    t0 = time.perf_counter()

    def report(out):
        if not kw.get("card_dense"):
            return _check_report(phase, cfg, what, out, t0, kw)
        _check_report(phase, cfg, what, out[0], t0, kw)
        _check_report(phase, cfg, f"{what}; the card on dense rows, padded "
                                  f"dispatch", out[1], t0, kw)

    if key is not None and _CPU_REFS is not None:
        cards = run_model_check(cfg, dev_ref, card, part="card", **kw)

        def finish():
            report(_reports(_CPU_REFS.get(key), cards, kw.get("B", 12),
                            kw.get("card_dense", False)))
    else:
        out = run_model_check(cfg, dev_ref, card, **kw)

        def finish():
            report(out)
    return finish if later else finish()


def _check_report(phase, cfg, what, report, t0, kw) -> None:
    from repro_torch.configs import get_config
    B, S = kw.get("B", 12), kw.get("S", 32)
    e_same = max(r["err_same"] for r in report)
    e_all = max(r["err_all"] for r in report)
    full = get_config(cfg.name)
    log(phase, f"{cfg.name} at full width, {cfg.n_layers} of "
               f"{full.n_layers} layers, {what}: prefill "
               f"+ {len(report) - 1} decode steps of {B} rows (prompts "
               + (f"{list(kw['lengths'])} tokens" if kw.get("lengths")
                  else f"6-{S} tokens, row 0 {S}")
               + f"); max |dlogit| {e_same:.4f} on "
               f"identically routed rows (tol {MODEL_TOL}), "
               f"{e_all:.4f} on all rows (tol {MODEL_TOL_SWAP}); mean "
               f"|dlogit| {max(r['mean_err'] for r in report):.5f} on "
               f"identically routed rows; max |logit| "
               f"{max(r['mag'] for r in report):.3f}; identically "
               f"routed rows per forward "
               f"{[r['rows_same'] for r in report]} | "
               f"{time.perf_counter() - t0:.1f} s")
    same = sum(r["rows_same"] for r in report)
    if e_same > MODEL_TOL or e_all > MODEL_TOL_SWAP or \
            same < B * len(report) // 2:
        raise AssertionError(f"logits disagree: {cfg.name} {what}")


#: The CPU halves of the hybrid and model phases' checks (the plain
#: versions' forwards at full width: PERF.md §6 has their seconds) run in one process of their own, started after the build at the lowest CPU
#: priority (``os.nice(19)``: the run's own host work comes first) with
#: CPU_REF_THREADS threads: it draws every check's weights on the card
#: before any phase starts (the same seeds as the card's halves, so the
#: same bits), copies them to the host and frees the card, then runs the
#: references one by one beside the phases that come before its checks,
#: and leaves each result in a file its check reads.
CPU_REF_THREADS = 6
#: Seconds the run waits for that process to draw its weights.
CPU_REF_READY_S = 300


def _cpu_jobs(only) -> list:
    """The CPU process's jobs for the phases in ``only``: (key, cfg, kwargs
    of ``run_model_check``; kwargs None for the suffix prefill's check;
    cfg None for a twin, ``HYBRID_TWINS`` and ``MM_TWINS``)."""
    from repro_torch.configs import get_config
    jobs = []
    if "hybrid" in only:
        key, cfg, _, _, kw = _hybrid_check()
        jobs.append((key, cfg, kw))
    if "model" in only:
        jobs += [(key, cfg, kw) for key, cfg, _, _, kw in _model_checks()]
        jobs.append(("model prefix", dataclasses.replace(
            get_config(ARCH), n_layers=CHECK_LAYERS), None))
    if "hybrid" in only:
        jobs += [(key, None, None) for key in HYBRID_TWINS]
    if "multimodal" in only:
        jobs += [(key, None, None) for key in MM_TWINS]
    return jobs


def _cpu_file(key: str) -> str:
    """A job's result file's name (a check's key may hold a slash)."""
    return key.replace("/", "_").replace(" ", "_")


def _cpu_input(out: pathlib.Path, key: str):
    """A job's input from the run (the card run's tokens a twin is fed),
    waited for."""
    import pickle
    path = out / f"{_cpu_file(key)}.in.pkl"
    while not path.exists():
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _cpu_child(jobs, out_dir: str, threads: int) -> None:
    """The CPU process: every job's weights drawn on the card and moved to
    the host (then "ready"), each reference's forwards run in turn into
    its ``.pkl`` file (``_cpu_file``); a failure into ``error``."""
    import pickle
    import traceback
    out = pathlib.Path(out_dir)
    try:
        os.nice(19)
        torch.set_num_threads(threads)
        cpu, card = torch.device("cpu"), torch.device("cuda")
        twins = {**HYBRID_TWINS, **MM_TWINS}
        todo = []
        for key, cfg, kw in jobs:
            if cfg is None:         # a twin: fed the card run's inputs
                todo.append((key, twins[key]()))
            elif kw is None:
                todo.append((key, run_prefix_check(cfg, cpu, card,
                                                   part="ref")))
            else:
                todo.append((key, run_model_check(cfg, cpu, card,
                                                  part="ref", **kw)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        (out / "ready").touch()
        while todo:                 # each job's weights freed once it ran
            key, run = todo.pop(0)
            kw = {"force": _cpu_input(out, key)} if key in twins else {}
            t0 = time.perf_counter()
            res = run(**kw)
            del run
            name = _cpu_file(key)
            with open(out / f"{name}.tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(out / f"{name}.tmp", out / f"{name}.pkl")
            log("cpu", f"{key}: the reference's forwards "
                       f"{time.perf_counter() - t0:.1f} s")
    except BaseException:
        (out / "error").write_text(traceback.format_exc())
        raise


class _CpuRefs:
    """The CPU process (see CPU_REF_THREADS) and its results."""

    def __init__(self, jobs):
        import multiprocessing
        import tempfile
        self.keys = {key for key, _, _ in jobs}
        self._tmp = tempfile.TemporaryDirectory(prefix="cpu_refs_")
        self.dir = pathlib.Path(self._tmp.name)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_cpu_child, args=(jobs, str(self.dir), CPU_REF_THREADS),
            daemon=True)
        self.t0 = time.perf_counter()
        self.proc.start()

    def ready(self) -> None:
        """Wait until the process has drawn every job's weights (the card
        is the run's from then on)."""
        t = time.perf_counter()
        self._wait("ready", CPU_REF_READY_S)
        log("cpu", f"the CPU references' weights drawn for {sorted(self.keys)}"
                   f" {time.perf_counter() - self.t0:.1f} s after the "
                   f"process started ({time.perf_counter() - t:.1f} s of it "
                   f"waited for after the build); their forwards go on in "
                   f"process {self.proc.pid} at nice 19, {CPU_REF_THREADS} "
                   f"threads")

    def _wait(self, name: str, timeout=None):
        t0 = time.perf_counter()
        while not (self.dir / name).exists():
            if (self.dir / "error").exists() or not self.proc.is_alive():
                time.sleep(0.5)         # the file may land just after
                err = (self.dir / "error").read_text() \
                    if (self.dir / "error").exists() else \
                    f"exit code {self.proc.exitcode}"
                if not (self.dir / name).exists():
                    raise RuntimeError(f"the CPU process failed: {err}")
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"the CPU process: no {name} in "
                                   f"{timeout} s")
            time.sleep(0.2)

    def put(self, key: str, value) -> None:
        """Job ``key``'s input (``_cpu_input``)."""
        import pickle
        name = _cpu_file(key)
        with open(self.dir / f"{name}.in.tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(self.dir / f"{name}.in.tmp", self.dir / f"{name}.in.pkl")

    def get(self, key: str):
        """The result of job ``key`` (waits for it)."""
        import pickle
        t0 = time.perf_counter()
        self._wait(f"{_cpu_file(key)}.pkl")
        with open(self.dir / f"{_cpu_file(key)}.pkl", "rb") as f:
            res = pickle.load(f)
        log("cpu", f"{key}: its result read after "
                   f"{time.perf_counter() - t0:.1f} s of waiting")
        return res

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=60)
        self._tmp.cleanup()


_CPU_REFS = None


def phase_model() -> None:
    import dataclasses
    from repro_torch.configs import get_config
    card = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHECK_LAYERS)
    checks = _model_checks()
    # The two dispatch layouts against each other on the card, same
    # weights, same fresh dense caches.
    checks.insert(2, (None, cfg, "dense, padded vs ragged dispatch on the "
                      "card", card, dict(paged=False, dispatch="padded",
                                         dispatch_ref="ragged")))
    for key, cfg, what, dev_ref, kw in checks:
        check_model("model", cfg, what, dev_ref, card, key=key, **kw)
    _model_prefix(dataclasses.replace(get_config(ARCH),
                                      n_layers=CHECK_LAYERS), card)


def _model_checks() -> list:
    """The model phase's checks of the card against the CPU: (key, cfg,
    what, "cpu", kwargs)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHECK_LAYERS)
    # The CPU's prefill of the ragged path runs on the padded layout (its
    # plain ragged version dequantizes an expert per row tile: ~4x the
    # work at 384 tokens); the same routing, drops and products, held
    # equal on the card below. Its decode steps stay ragged.
    checks = [(f"model {p}", cfg, f"{p}, CPU vs card"
               + (" (CPU prefill padded)" if disp == "ragged" else ""),
               "cpu", dict(paged=pg, dispatch=disp,
                           prefill_dispatch_ref="padded"))
              for p, (pg, disp, _, _) in PATHS.items()]
    # The flagship on its main path: the shared expert, 512 experts top-10,
    # int2 lo with 64 of a 128-slot pool published, 8 rows.
    cfg80 = dataclasses.replace(get_config(FLAGSHIP),
                                n_layers=FLAGSHIP_CHECK_LAYERS)
    checks.append(("model flagship", cfg80, "paged/ragged, CPU vs card (CPU "
                   "prefill padded)", "cpu",
                   dict(paged=True, dispatch="ragged", B=8, lo_bits=2,
                        n_hi=128, prefill_dispatch_ref="padded")))
    return checks


def routed_alike(ea, eb):
    """Which compared values two runs of one prompt computed from the same
    experts: ``ea``, ``eb`` each position's experts per layer (L, S, k).
    Returns (clean (L + 1, S) bool: row i of layer l's input, i.e. its K/V
    for l < L and its logits for l = L, depends only on experts that agree
    in both runs, the layer of the first expert difference (None)). The
    input of layer l at row i is fixed by row i's experts in layers < l and,
    through attention over rows j <= i, by theirs in layers < l - 1."""
    same = (ea == eb).all(dim=-1)                          # (L, S)
    L, S = same.shape
    clean = torch.ones((L + 1, S), dtype=torch.bool)
    for l in range(1, L + 1):
        clean[l] = same[:l].all(dim=0)
        if l > 1:
            clean[l] &= same[:l - 1].all(dim=0).cumprod(0).bool()
    bad = (~same).any(dim=1).nonzero()
    return clean, (int(bad[0]) if len(bad) else None)


def _model_prefix(cfg, card) -> None:
    """The suffix prefill over cached prefix blocks on the card against
    the plain CPU path, drop-free (``PREFIX_CASES``): a 96-token prompt
    whole, and as 64 + a 32-token suffix with ``has_prefix``, on the CPU
    and the card, split against whole on the card; and a 768-token prompt
    whole and as three 256-token chunks, split against whole on the card.
    Each pair compares K/V per layer and row, and the logits, to MODEL_TOL
    wherever the value depends only on experts that both runs chose alike
    (``routed_alike``); at least half the rows of the deepest layer, and
    half of those past the first cut, must be held so."""
    t0 = time.perf_counter()
    if _CPU_REFS is not None and "model prefix" in _CPU_REFS.keys:
        res = run_prefix_check(cfg, torch.device("cpu"), card, part="card")
        res.update(_CPU_REFS.get("model prefix"))
    else:
        res = run_prefix_check(cfg, torch.device("cpu"), card)
    log("model", f"the suffix prefill's forwards "
                 f"{time.perf_counter() - t0:.1f} s")
    cpu, dev = res["cpu"], res["cuda"]
    pairs = []
    for S, cuts, both in PREFIX_CASES:
        if both:
            pairs += [(f"{S} whole, CPU vs card", S, cuts,
                       cpu[S]["whole"], dev[S]["whole"]),
                      (f"{S} split, CPU vs card", S, cuts,
                       cpu[S]["split"], dev[S]["split"])]
        pairs.append((f"{S} on the card, whole vs split", S, cuts,
                      dev[S]["whole"], dev[S]["split"]))
    parts, bad = [], []
    for what, S, cuts, (lr, kr, vr, er), (lk, kk, vk, ek) in pairs:
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{what}: non-finite logits")
        clean, first = routed_alike(er, ek)
        L = kr.shape[0]
        dkv = torch.maximum((kk - kr).abs().amax(dim=(2, 3)),
                            (vk - vr).abs().amax(dim=(2, 3)))    # (L, S)
        held = [float(dkv[l][clean[l]].max()) if clean[l].any() else None
                for l in range(L)]
        free = [float(dkv[l][~clean[l]].max()) if (~clean[l]).any()
                else None for l in range(L)]
        dl = float((lk - lr).abs().max())
        logits_held = bool(clean[L, S - 1])
        rows = [int(clean[l].sum()) for l in range(L)]
        past = int(clean[L - 1, cuts[0]:].sum())
        parts.append(f"{what}: first expert difference at layer {first}; "
                     f"rows held per layer {rows} of {S} ({past} of "
                     f"{S - cuts[0]} past the first cut at layer {L - 1}), "
                     f"max |dK|,|dV| on them {held}, on the rest {free}; "
                     f"max |dlogit| {dl:.4f} "
                     f"({'held' if logits_held else 'not held'})")
        if any(h is not None and h > MODEL_TOL for h in held) or \
                (logits_held and dl > MODEL_TOL) or \
                rows[-1] < S // 2 or past < (S - cuts[0]) // 2:
            bad.append(what)
    log("model", f"{cfg.name} at full width, {cfg.n_layers} layers, "
                 f"suffix prefill over cached blocks, drop-free, cases "
                 f"(tokens, cuts, on the CPU too) {PREFIX_CASES}; values "
                 f"held to MODEL_TOL {MODEL_TOL} where every expert they "
                 f"depend on agrees; {'; '.join(parts)} | "
                 f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"prefix routes {bad}: K/V or logits disagree "
                             f"where routed alike, or too few rows routed "
                             f"alike")


# ---------------------------------------------------------------------------
# 5. serving
# ---------------------------------------------------------------------------

#: Each backend is served once per entry, in this order: "graph" decodes
#: through the engine's captured CUDA graph, "eager" op by op inside
#: ``engine.eager()``. In turns, since TPOT moves between calls. In these
#: runs ``dynaexq`` flushes after every step, so what it publishes, and so
#: the tokens, are a function of the tokens alone.
SERVE_MODES = ("graph", "eager", "eager", "graph")


def run_serving(cfg, device, *, n_requests, prompt_range, new_tokens,
                max_slots, n_hi, seed=0, paged=True, dispatch="ragged",
                params=None, baselines=None):
    """Serve ``n_requests`` greedy requests with ``static`` then
    ``dynaexq`` on one seeded model (``params``, else drawn from ``seed``),
    on the paged pool or dense rows with MoE dispatch ``dispatch``, each
    backend once per entry of ``SERVE_MODES`` on a fresh engine; then
    ``dynaexq`` once more graphed as users run it ("dynaexq free": no flush
    until the end, so its hi copies are in flight on the side stream while
    later replays run); then each of ``baselines`` ({name: backend
    arguments}: the paper's ``fp16`` and ``offload``) graphed, then eager.
    Returns {name: [summary per run]}."""
    from repro_torch.models.model import init_params

    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    prompts = serving_prompts(cfg.vocab_size, n_requests, prompt_range, seed)
    max_len = -(-(int(prompt_range[1]) + new_tokens) // 16) * 16
    kw = dict(new_tokens=new_tokens, max_slots=max_slots, max_len=max_len,
              paged=paged, dispatch=dispatch)
    backend_kw = {"static": dict(lo_bits=4, group_size=64),
                  "dynaexq": dict(lo_bits=4, group_size=64,
                                  n_hi_per_layer=n_hi)}
    runs = {name: [_serve_once(cfg, device, params, prompts, name, mode,
                               backend_kw=backend_kw[name], **kw)
                   for mode in SERVE_MODES]
            for name in ("static", "dynaexq")}
    runs["dynaexq free"] = [_serve_once(cfg, device, params, prompts,
                                        "dynaexq", "free",
                                        backend_kw=backend_kw["dynaexq"],
                                        **kw)]
    for name, bkw in (baselines or {}).items():
        runs[name] = [_serve_once(cfg, device, params, prompts, name, mode,
                                  backend_kw=bkw, **kw)
                      for mode in ("graph", "eager")]
    return runs


def serving_prompts(vocab, n_requests, prompt_range, seed=0) -> list:
    """The serving phase's greedy prompts: ``n_requests`` "text" prompts of
    lengths drawn from ``prompt_range`` (inclusive) by ``seed``."""
    from repro_torch.serving.requests import make_prompts
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    return [make_prompts("text", vocab, 1, int(n), seed=seed + i)[0]
            for i, n in enumerate(lens)]


def _serve_once(cfg, device, params, prompts, name, mode, *, new_tokens,
                max_slots, max_len, backend_kw, paged, dispatch,
                policy_every_step=True, obs=None, audit=False):
    """One served run on a fresh engine with ``make_backend(name,
    **backend_kw)`` (``dynaexq``: a policy window every step, unless
    ``policy_every_step`` is False: then the controller's default), observed
    by ``obs`` (an ``Observability``, or None), ``mode``
    "graph", "eager" or "free" (graphed; ``dynaexq`` flushes only at the
    end instead of after every step). Every step's logits must be finite:
    the prefill's through its entry point (watched for this run), the
    decode step's as the engine left them (``last_logits``: the graph's
    static output when graphed). ``pending_steps`` counts the steps that
    began with hi copies still in flight or unpublished; ``shared_calls``
    the shared-expert SwiGLUs the forwards ran op by op (prefill, eager
    decode, and the graph's capture); ``max_layer_hi`` the most hi
    residents one layer held after a flush. ``audit`` (with ``obs``): for
    every published promotion span, whether its copy's event had completed
    when it ended (``published_after_event``: (after, all))."""
    import contextlib
    import repro_torch.models.moe as moe_mod
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    t_build = time.perf_counter()
    kw = dict(backend_kw, device=device)
    if name == "dynaexq" and policy_every_step:
        kw.update(controller=ControllerConfig(update_interval_s=0.0))
    engine = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend(name, **kw),
        eng_mod.EngineConfig(max_slots=max_slots, max_len=max_len,
                             paged=paged, moe_dispatch=dispatch),
        device=device, obs=obs)
    t_build = time.perf_counter() - t_build
    audited_ends = []
    if audit:
        tms_a, end = [c.tm for c in engine.backend.controllers.values()], \
            engine.tracer.async_end

        def audited(span, span_id, cat="", **args):
            if span == "promotion" and args.get("published"):
                p = next(p for tm in tms_a for p in tm._pending
                         if p.seq == span_id)
                audited_ends.append(p.event is not None and p.event.query())
            end(span, span_id, cat, **args)

        engine.tracer.async_end = audited
    graphed = mode != "eager" and device.type == "cuda"
    if graphed:
        engine.decode_graph.events = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tms = [c.tm for c in getattr(engine.backend, "controllers", {}).values()]
    finite, pending_steps, max_layer_hi = [], 0, 0
    pre = "prefill_paged" if paged else "prefill"
    entry = getattr(eng_mod, pre)
    swiglu, shared_calls = moe_mod.swiglu, [0]

    def watched(*a, **k):
        out = entry(*a, **k)
        finite.append(torch.isfinite(out[0]).all())
        return out

    def counted(p, x):
        shared_calls[0] += x.dim() == 2     # not the padded hi overlay
        return swiglu(p, x)

    setattr(eng_mod, pre, watched)
    moe_mod.swiglu = counted
    try:
        ops.reset_launches()                 # the main path starts here
        t0 = time.perf_counter()
        handles = [engine.submit(Request(tokens=p, max_new_tokens=new_tokens))
                   for p in prompts]
        with eng_mod.eager() if mode == "eager" else contextlib.nullcontext():
            while engine.queue or any(h is not None for h in engine.slots):
                steps = engine.counters["steps"]
                pending_steps += any(tm.inflight_bytes for tm in tms)
                engine.step()
                if engine.counters["steps"] > steps:
                    finite.append(torch.isfinite(engine.last_logits).all())
                if name == "dynaexq" and mode != "free":
                    engine.flush()
                    max_layer_hi = max(max_layer_hi, max(
                        len(s) for sets in engine.backend.hi_sets().values()
                        for s in sets))
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)        # ... and ends here
    finally:
        setattr(eng_mod, pre, entry)
        moe_mod.swiglu = swiglu
    st = engine.stats()
    assert all(len(h.tokens) == new_tokens for h in handles), \
        [len(h.tokens) for h in handles]
    assert bool(torch.stack(finite).all()), f"{name} {mode}: NaN logits"
    replay = [a.elapsed_time(b) for a, b in engine.decode_graph.events] \
        if graphed else []
    summary = {
        "mode": mode, "tokens": [list(h.tokens) for h in handles],
        "launches": launches, "wall_s": wall,
        "tokens_per_s": len(prompts) * new_tokens / wall,
        "ttft_s": st["ttft_s"], "tpot_s": st["tpot_s"],
        "replay_ms": float(np.mean(replay)) if replay else None,
        "replays": len(replay), "capture_s": engine.capture_s,
        "build_s": t_build, "steps": int(st["steps"]),
        "pending_steps": pending_steps,
        "expert_bytes": engine.device_bytes(),
        "max_mem": torch.cuda.max_memory_allocated()
        if device.type == "cuda" else 0,
        "promotions": st["promotions"], "demotions": st["demotions"],
        "stall_s": st["stall_s"], "hits": st.get("hits"),
        "misses": st.get("misses"), "prefills": int(st["prefills"]),
        "shared_calls": shared_calls[0], "max_layer_hi": max_layer_hi,
        "kv_bytes": None if engine.pool is None
        else engine.pool.capacity_bytes,
        "experts": [h.expert_counts for h in handles]}
    if graphed and summary["replays"] != summary["steps"]:
        raise AssertionError(f"{name}: {summary['steps']} decode steps but "
                             f"{summary['replays']} graph replays")
    if name == "dynaexq":
        summary.update({k: st[k] for k in ("host_fetches", "fault_cancels",
                                           "retries", "lo_resident_frac")})
        summary["hi_routed"] = engine.backend.hi_routed
        summary["n_hi"] = next(iter(engine.backend.controllers.values())) \
            .policy.n_hi
        summary["slots"] = next(iter(engine.backend.banks.values())) \
            .slot_owner.shape[1]
        summary["global"] = engine.backend.allocator is not None
        engine.flush()
        for tm in tms:
            tm.check_invariants()
        summary["published_after_event"] = (sum(audited_ends),
                                            len(audited_ends))
        if audit:
            engine.tracer.async_end = end
    del engine
    # The engine and its backend refer to each other (the backend's
    # clock): collect now, not when the collector next runs, so the next
    # run gets its device memory and pinned host memory.
    gc.collect()
    return summary


def _ms(x):
    return "n/a" if x is None else f"{x:.3f}"


def pinned_h2d_gbps(nbytes: int = 256 << 20, reps: int = 5) -> float:
    """This card's pinned host→device copy rate in GB/s (10^9 bytes): one
    ``nbytes`` pinned host tensor copied ``reps`` times, each copy timed
    by CUDA events; the median."""
    src = torch.ones(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    rates = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        torch.cuda.synchronize()
        rates.append(nbytes / (e0.elapsed_time(e1) / 1e3) / 1e9)
    return float(np.median(rates))


def _check_baseline(path, name, s, layers):
    """A baseline's run on ``path``: it launched the path's kernels for
    dense experts and none of the quantized ones; on the ragged path the
    all-hi kernels ran once per layer of every forward (prefills and
    decode steps; a replay adds what its capture recorded)."""
    used, unused = BASELINE_PATHS[path]
    if not all(s["launches"][k] > 0 for k in used) or \
            any(s["launches"][k] for k in unused):
        raise AssertionError(f"{path} {name} {s['mode']}: launches "
                             f"{s['launches']}")
    if path == "paged/ragged":
        want = layers * (s["steps"] + s["prefills"])
        got = [s["launches"][k] for k in DENSE_FFN_KERNELS]
        if got != [want] * len(got):
            raise AssertionError(f"{path} {name} {s['mode']}: all-hi "
                                 f"launches {got}, want {want} = {layers} "
                                 f"layers x ({s['steps']} steps + "
                                 f"{s['prefills']} prefills)")


def phase_serving(card: str) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import OffloadConfig
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    host_gb = SERVE_LAYERS * cfg.moe.num_experts * 3 * cfg.d_model * \
        cfg.moe.d_ff_expert * 2 / 1e9
    pcie = pinned_h2d_gbps()
    log("serving", f"pinned host->device copy rate {pcie:.2f} GB/s (256 MiB "
                   f"copies, CUDA events, median of 5): offload's pcie_gbps "
                   f"on this card | {card}")
    log("serving", f"{cfg.name}: full width, depth cut to {SERVE_LAYERS} of "
                   f"{full.n_layers} layers (bf16 host masters {host_gb:.1f} "
                   f"GB instead of {host_gb * full.n_layers / SERVE_LAYERS:.0f}"
                   f" GB); random weights, seed 0; static and dynaexq served "
                   f"{len(SERVE_MODES)} times in turns {SERVE_MODES}, the "
                   f"baselines fp16 and offload graph then eager")
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    baselines = {"fp16": {},
                 "offload": {"ocfg": OffloadConfig(pcie_gbps=pcie)}}
    main_runs = []
    for path, (paged, dispatch, used, unused) in PATHS.items():
        t_path = time.perf_counter()
        res = run_serving(cfg, dev, n_requests=8, prompt_range=(64, 256),
                          new_tokens=32, max_slots=8, n_hi=16, paged=paged,
                          dispatch=dispatch, params=params,
                          baselines=baselines)
        for name, runs in res.items():
            for s in runs:
                log("serving", f"{path} {name} {s['mode']}: 8 requests x 32 "
                               f"tokens | TTFT {s['ttft_s'] * 1e3:.1f} ms "
                               f"TPOT {s['tpot_s'] * 1e3:.2f} ms "
                               f"{s['tokens_per_s']:.1f} tok/s (wall) | "
                               f"modeled stall {s['stall_s']:.4f} s"
                               + (f", hits {s['hits']:.0f} misses "
                                  f"{s['misses']:.0f}" if name == "offload"
                                  else "") + f" | replay "
                               f"ms by events {_ms(s['replay_ms'])} over "
                               f"{s['replays']} replays (capture "
                               f"{s['capture_s']:.2f} s) | expert bytes "
                               f"{s['expert_bytes'] / 1e9:.3f} GB | max "
                               f"allocated {s['max_mem'] / 1e9:.2f} GB | "
                               f"promotions {s['promotions']:.0f} demotions "
                               f"{s['demotions']:.0f} | steps begun with hi "
                               f"copies pending {s['pending_steps']} of "
                               f"{s['steps']} | launches "
                               f"{s['launches']} | engine built in "
                               f"{s['build_s']:.1f} s, served in "
                               f"{s['wall_s']:.1f} s | {card}")
                if name in baselines:
                    _check_baseline(path, name, s, SERVE_LAYERS)
                    continue
                if not all(s["launches"][k] > 0 for k in used):
                    raise AssertionError(f"{path} {name} {s['mode']}: a "
                                         f"kernel of the path never ran")
                if any(s["launches"][k] for k in unused):
                    raise AssertionError(f"{path} {name} {s['mode']}: a "
                                         f"kernel of the other path ran")
                if name != "static" and (s["promotions"] < 1 or
                                         s["hi_routed"] < 1):
                    raise AssertionError(f"{path} {name} {s['mode']}: "
                                         f"dynaexq published no promotion "
                                         f"that a forward then served from "
                                         f"hi")
                if s["mode"] == "free" and s["pending_steps"] < 1:
                    raise AssertionError(f"{path} {name}: no replay ran "
                                         f"while hi copies were pending")
            first = runs[0]
            for s in runs[1:]:
                if s["tokens"] != first["tokens"]:
                    bad = [i for i, (a, b) in enumerate(zip(
                        s["tokens"], first["tokens"])) if a != b]
                    raise AssertionError(f"{path} {name}: {s['mode']} and "
                                         f"{first['mode']} disagree on the "
                                         f"tokens of requests {bad}")
                if s["launches"] != first["launches"]:
                    raise AssertionError(f"{path} {name}: launches "
                                         f"{s['launches']} ({s['mode']}) != "
                                         f"{first['launches']} "
                                         f"({first['mode']})")
            if first["mode"] == "free":
                pairs = list(zip(first["tokens"], res["dynaexq"][0]["tokens"]))
                same = sum(a == b for a, b in pairs)
                split = min((next((i for i, (x, y) in enumerate(zip(a, b))
                                   if x != y), len(a)) for a, b in pairs))
                log("serving", f"{path} {name}: graphed with copies in "
                               f"flight across {first['pending_steps']} of "
                               f"{first['steps']} steps, finite logits every "
                               f"step, {first['hi_routed']} routed (layer, "
                               f"expert) cells served from hi slots, "
                               f"invariants hold after flush; {same} of 8 "
                               f"requests' tokens equal the flushed runs' "
                               f"(publication timing differs; the first "
                               f"difference at token {split}) | {card}")
                main_runs.append(first)
                continue
            tpot = {m: [f"{s['tpot_s'] * 1e3:.2f}" for s in runs
                        if s["mode"] == m] for m in ("graph", "eager")}
            log("serving", f"{path} {name}: graph and eager in turns give "
                           f"identical tokens for all 8 requests and "
                           f"identical launches; TPOT ms graph "
                           f"{tpot['graph']} eager {tpot['eager']}; replay "
                           f"ms by events "
                           f"{[_ms(s['replay_ms']) for s in runs]}"
                           + (f"; {first['hi_routed']} routed (layer, "
                              f"expert) cells served from hi slots, "
                              f"invariants hold after flush"
                              if name == "dynaexq" else "") + f" | {card}")
            if name == "static" or (name in baselines and
                                    path == "paged/ragged"):
                main_runs.append(first)
        if res["fp16"][0]["tokens"] != res["offload"][0]["tokens"]:
            raise AssertionError(f"{path}: fp16 and offload (the same dense "
                                 f"compute, residency modeled) disagree on "
                                 f"tokens")
        log("serving", f"{path}: fp16 and offload give identical tokens | "
                       f"{time.perf_counter() - t_path:.1f} s")
    _serve_comparison(card, cfg, params, pcie)
    del params
    main_runs += _serve_flagship(card)
    for k in RESULTS:
        RESULTS[k]["launches"] = sum(s["launches"][k] for s in main_runs)


#: The paper's throughput comparison (up to 2.73x over offloading/prefetch
#: at batch 32): the main path, this many slots and requests.
COMPARE_BATCH = 32


def _serve_comparison(card, cfg, params, pcie_gbps) -> None:
    """``static``, ``dynaexq``, ``fp16`` and ``offload`` in turns on fresh
    engines, graphed, on the main path with ``COMPARE_BATCH`` slots and
    requests (prompts 64-256 tokens, 32 new tokens each), every backend at
    its defaults as users run it (``dynaexq``: the controller's own policy
    interval, no flush until the end). ``offload`` gets ``dynaexq``'s
    device budget: ``cache_experts_per_layer = dynaexq.device_bytes() //
    (MoE layers x bf16 expert bytes)``, at this card's pinned copy rate.
    Tokens/s counts the modeled stall, which is never slept, as the
    reference's serving benchmark does: tokens / (wall + stall_s)."""
    from repro_torch.serving.backends import OffloadConfig
    from repro_torch.serving.requests import make_prompts
    dev = params["embed"].device
    B, new = COMPARE_BATCH, 32
    rng = np.random.default_rng(1)
    prompts = [make_prompts("text", cfg.vocab_size, 1, int(n), seed=100 + i)
               [0] for i, n in enumerate(rng.integers(64, 257, B))]
    kw = dict(new_tokens=new, max_slots=B, max_len=288, paged=True,
              dispatch="ragged", policy_every_step=False)
    L = cfg.n_superblocks()
    expert_bytes = 3 * cfg.d_model * cfg.moe.d_ff_expert * 2
    backend_kw = {"static": dict(lo_bits=4, group_size=64),
                  "dynaexq": dict(lo_bits=4, group_size=64,
                                  n_hi_per_layer=16),
                  "fp16": {}}
    out = {}
    t0 = time.perf_counter()
    for name in ("static", "dynaexq", "fp16", "offload"):
        if name == "offload":
            cache = out["dynaexq"]["expert_bytes"] // (L * expert_bytes)
            backend_kw[name] = dict(ocfg=OffloadConfig(
                cache_experts_per_layer=int(cache), pcie_gbps=pcie_gbps))
            log("serving", f"batch {B} offload: cache_experts_per_layer "
                           f"{cache} = dynaexq device_bytes "
                           f"{out['dynaexq']['expert_bytes']} // ({L} layers "
                           f"x {expert_bytes} B), pcie_gbps {pcie_gbps:.2f} "
                           f"(measured) | {card}")
        s = _serve_once(cfg, dev, params, prompts, name,
                        "free" if name == "dynaexq" else "graph",
                        backend_kw=backend_kw[name], **kw)
        s["tokens_per_s_e2e"] = B * new / (s["wall_s"] + s["stall_s"])
        out[name] = s
        log("serving", f"batch {B} {ARCH} {L} layers paged/ragged {name} "
                       f"graphed: {s['tokens_per_s_e2e']:.1f} tok/s (tokens "
                       f"/ (wall {s['wall_s']:.3f} s + modeled stall "
                       f"{s['stall_s']:.4f} s)) | TPOT "
                       f"{s['tpot_s'] * 1e3:.2f} ms TTFT "
                       f"{s['ttft_s'] * 1e3:.1f} ms | stall_s "
                       f"{s['stall_s']:.4f} over {s['steps']} steps + "
                       f"{s['prefills']} prefills"
                       + (f", hits {s['hits']:.0f} misses {s['misses']:.0f}"
                          if name == "offload" else "")
                       + f" | device_bytes {s['expert_bytes']} | replay ms "
                       f"{_ms(s['replay_ms'])} | promotions "
                       f"{s['promotions']:.0f} | launches {s['launches']} | "
                       f"{card}")
    if out["fp16"]["tokens"] != out["offload"]["tokens"]:
        raise AssertionError("batch 32: fp16 and offload disagree on tokens")
    if not out["offload"]["stall_s"] > 0 or \
            out["offload"]["expert_bytes"] > out["dynaexq"]["expert_bytes"]:
        raise AssertionError("batch 32: offload modeled no stall or got "
                             "more device bytes than dynaexq")
    off = out["offload"]["tokens_per_s_e2e"]
    log("serving", f"batch {B} comparison: tok/s "
                   + ", ".join(f"{n} {s['tokens_per_s_e2e']:.1f}"
                               for n, s in out.items())
                   + f"; dynaexq / offload "
                   f"{out['dynaexq']['tokens_per_s_e2e'] / off:.2f}x, "
                   f"static / offload "
                   f"{out['static']['tokens_per_s_e2e'] / off:.2f}x, fp16 / "
                   f"offload {out['fp16']['tokens_per_s_e2e'] / off:.2f}x | "
                   f"{time.perf_counter() - t0:.1f} s | {card}")


def _envelope_gb(params, kv_bytes, n_hi, lo_bits, hi_bits=16) -> float:
    """An ``hbm_gb`` envelope from which ``plan_budget`` leaves the hi tier
    ``n_hi`` slots per layer priced at ``hi_bits`` (and half a slot over):
    the fixed bytes as the backend counts them (``envelope_fixed_bytes``,
    on the KV pool of an engine of the same shape) plus one MoE
    position's int ``lo_bits`` lo tier (the backend's per-position
    rule)."""
    from repro_torch.core.ver import expert_hi_nbytes, expert_lo_nbytes
    from repro_torch.serving.backends import GiB, envelope_fixed_bytes
    moe = next(bp["moe"] for bp in params["blocks"].values() if "moe" in bp)
    shapes = {k: tuple(v.shape) for k, v in moe["experts"].items()}
    L, E = shapes["w_gate"][:2]
    hi_b = expert_hi_nbytes(shapes, hi_bits=hi_bits)
    lo = expert_lo_nbytes(shapes, lo_bits) * L * E
    return (envelope_fixed_bytes(params, kv_bytes) + lo
            + (n_hi + 0.5) * hi_b * L) / GiB


def _serve_flagship(card: str) -> list:
    """The flagship on its main path (paged KV, ragged dispatch) at full
    width, 4 of 48 layers: ``static`` int2, then ``dynaexq`` at its
    defaults (the global allocator) with int2 lo, int4-priced hi and an
    ``hbm_gb`` envelope that leaves n_hi = E/8 per layer; each graphed,
    then eager, with ``dynaexq`` flushed after every step, so tokens and
    launches must agree; then the ``fp16`` baseline graphed (its 12.9 GB of
    dense experts on the card). Returns the graphed runs (their launches
    count toward the kernels' line)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.requests import make_prompts
    full = get_config(FLAGSHIP)
    cfg = dataclasses.replace(full, n_layers=FLAGSHIP_SERVE_LAYERS)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    E, L = cfg.moe.num_experts, cfg.n_superblocks()
    host_gb = L * E * 3 * cfg.d_model * cfg.moe.d_ff_expert * 2 / 1e9
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 257, 8)
    prompts = [make_prompts("text", cfg.vocab_size, 1, int(n), seed=i)[0]
               for i, n in enumerate(lens)]
    max_len, n_hi = 288, E // 8
    log("serving", f"{cfg.name}: full width, depth cut to {L} of "
                   f"{full.n_layers} layers (bf16 host masters {host_gb:.1f} "
                   f"GB instead of {host_gb * full.n_layers / L:.0f} GB); "
                   f"random weights, seed 0; paged/ragged; static int2 and "
                   f"dynaexq(lo_bits=2, hi_bits=4, hbm_gb) at its defaults, "
                   f"each graphed then eager")
    kw = dict(new_tokens=32, max_slots=8, max_len=max_len, paged=True,
              dispatch="ragged")
    backend_kw = {"static": dict(lo_bits=2),
                  "dynaexq": dict(lo_bits=2, hi_bits=4)}
    used, unused = PATHS["paged/ragged"][2:]
    graphed = []
    for name in ("static", "dynaexq"):
        if name == "dynaexq":
            # The envelope on the KV pool the static engine built.
            hbm_gb = _envelope_gb(params, graphed[0]["kv_bytes"], n_hi,
                                  lo_bits=2, hi_bits=4)
            backend_kw[name]["hbm_gb"] = hbm_gb
            log("serving", f"{FLAGSHIP} dynaexq: hbm_gb {hbm_gb:.4f} for "
                           f"n_hi {n_hi} on a KV pool of "
                           f"{graphed[0]['kv_bytes']} B")
        runs = [_serve_once(cfg, dev, params, prompts, name, mode,
                            backend_kw=backend_kw[name], **kw)
                for mode in ("graph", "eager")]
        for s in runs:
            extra = ""
            if name == "dynaexq":
                extra = (f" | global allocator {s['global']}, derived n_hi "
                         f"{s['n_hi']} of {s['slots']} slots per layer, at "
                         f"most {s['max_layer_hi']} hi residents in one "
                         f"layer; {s['hi_routed']} routed (layer, expert) "
                         f"cells served from hi")
            log("serving", f"{FLAGSHIP} paged/ragged {name} {s['mode']}: 8 "
                           f"requests x 32 tokens | TTFT "
                           f"{s['ttft_s'] * 1e3:.1f} ms TPOT "
                           f"{s['tpot_s'] * 1e3:.2f} ms "
                           f"{s['tokens_per_s']:.1f} tok/s | replay ms by "
                           f"events {_ms(s['replay_ms'])} over "
                           f"{s['replays']} replays (capture "
                           f"{s['capture_s']:.2f} s) | expert bytes "
                           f"(device_bytes) {s['expert_bytes']} | max "
                           f"allocated {s['max_mem']} B | promotions "
                           f"{s['promotions']:.0f} demotions "
                           f"{s['demotions']:.0f} | shared-expert calls "
                           f"{s['shared_calls']} | launches {s['launches']} "
                           f"| engine built in {s['build_s']:.1f} s, served "
                           f"in {s['wall_s']:.1f} s{extra} | {card}")
            if not all(s["launches"][k] > 0 for k in used) or \
                    any(s["launches"][k] for k in unused):
                raise AssertionError(f"{FLAGSHIP} {name} {s['mode']}: "
                                     f"launches {s['launches']}")
            if s["shared_calls"] < L:
                raise AssertionError(f"{FLAGSHIP} {name} {s['mode']}: the "
                                     f"shared expert did not run")
            if name == "dynaexq" and not (
                    s["global"] and s["n_hi"] == n_hi
                    and s["promotions"] >= 1 and s["hi_routed"] >= 1
                    and s["max_layer_hi"] > n_hi):
                raise AssertionError(f"{FLAGSHIP} dynaexq {s['mode']}: "
                                     f"global {s['global']}, n_hi "
                                     f"{s['n_hi']} (want {n_hi}), "
                                     f"promotions {s['promotions']}, "
                                     f"hi_routed {s['hi_routed']}, at most "
                                     f"{s['max_layer_hi']} in one layer")
        g, e = runs
        if g["tokens"] != e["tokens"] or g["launches"] != e["launches"]:
            raise AssertionError(f"{FLAGSHIP} {name}: graph and eager "
                                 f"disagree on tokens or launches")
        log("serving", f"{FLAGSHIP} {name}: graph and eager give identical "
                       f"tokens for all 8 requests and identical launches | "
                       f"{card}")
        graphed.append(g)
    # The fp16 baseline: its dense experts (the params' own) through the
    # all-hi kernels.
    s = _serve_once(cfg, dev, params, prompts, "fp16", "graph",
                    backend_kw={}, **kw)
    log("serving", f"{FLAGSHIP} paged/ragged fp16 graph: 8 requests x 32 "
                   f"tokens | TTFT {s['ttft_s'] * 1e3:.1f} ms TPOT "
                   f"{s['tpot_s'] * 1e3:.2f} ms {s['tokens_per_s']:.1f} "
                   f"tok/s | replay ms by events {_ms(s['replay_ms'])} over "
                   f"{s['replays']} replays | expert bytes (device_bytes) "
                   f"{s['expert_bytes']} | max allocated {s['max_mem']} B | "
                   f"shared-expert calls {s['shared_calls']} | launches "
                   f"{s['launches']} | served in {s['wall_s']:.1f} s | "
                   f"{card}")
    _check_baseline("paged/ragged", "fp16", s, L)
    if s["shared_calls"] < L:
        raise AssertionError(f"{FLAGSHIP} fp16: the shared expert did not "
                             f"run")
    graphed.append(s)
    log("serving", f"{FLAGSHIP}: {time.perf_counter() - t0:.1f} s")
    del params
    return graphed


# ---------------------------------------------------------------------------
# 5b. requests: the request front on the main path
# ---------------------------------------------------------------------------

#: All on against all off: the second run is fed the first run's tokens
#: (teacher forcing), so both read the same tokens at every position and
#: differ only by rounding (a prefix hit, a chunk or a resume computes the
#: same K/V in other shapes). Rounding changes a token's experts only as a
#: router near tie does: at the first layer where they differ, one expert
#: swapped for another. The swap moves that token's later layers, and so
#: its K/V there, by up to O(1) (the model phase's MODEL_TOL_SWAP case):
#: a later token may then differ first at a deeper layer in any way. Every
#: difference in experts between the runs must be one of the two
#: (``routing_explained``). A position is held where no token it reads
#: (its context and itself) took other experts, as the model phase holds
#: a row; there, another token is allowed only where the flip is
#: rounding-sized: the two runs' logits of the tokens in play (greedy: the
#: two chosen; sampled: every token the first run could draw) differ by at
#: most FLIP_STEPS steps of bf16 (the logits' type) at the top logit's
#: magnitude (MODEL_TOL is 8 steps at logits of 4-8). At least MIN_HELD of
#: the positions must be held, and per request the median |logit|
#: difference of the first run's token must stay within MODEL_TOL. A wrong
#: prefix or chunk makes its request's tokens read other K/V: experts that
#: differ by more than one at their first layer, or flips of tens of steps
#: where they agree. A resume must read every lane back bit for bit
#: (``_watch``): a few lost lanes move the tokens that read them as little
#: as a near tie does.
FLIP_STEPS = 3
MIN_HELD = 1 / 2
#: The logit rule says little when near ties are common: it fails when more
#: than this share of the held greedy positions would pass a flip on it
#: (the two runs' top-2 gaps, the least change a flip needs, add up to
#: FLIP_STEPS at most).
MAX_TIE_SHARE = 1 / 2
#: Logits recorded per emitted position (top-k): room for a sampled
#: position's tokens in play to move in rank.
TOP_K_SEEN = 256
#: One virtual step of ``replay(realtime=False)`` (its default).
REQ_STEP_S = 2e-3
REQ_SLOTS = 8
REQ_MAX_LEN = 1024
REQ_NEW = 32


def request_stream(vocab, seed=0):
    """The requests phase's stream, timed in virtual steps of
    ``REQ_STEP_S``: 12 standard requests, one per step from step 0, each a
    shared 160-token system prompt (10 blocks) and 40-120 tokens of its
    own; then 8 batch requests of 64-256 tokens, one per step; then, at
    step 50 and every 6 steps after it (while batch rows hold the slots,
    each alone through its 3 chunks), 4 premium requests with 768-token
    prompts. Four sample (temperature 0.8, top-k 50, top-p 0.9, seeds
    1-4): standard 0 and 6, batch 3, premium 1; the rest are greedy."""
    from repro_torch.serving.requests import Request, make_prompts
    from repro_torch.serving.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    system = make_prompts("text", vocab, 1, 160, seed=seed + 1)[0]
    sampled = {("standard", 0): 1, ("standard", 6): 2, ("batch", 3): 3,
               ("premium", 1): 4}
    out = []

    def add(qos, j, toks, step):
        sp = sampled.get((qos, j))
        out.append(Request(
            tokens=toks, max_new_tokens=REQ_NEW, qos=qos,
            arrival_s=(step - 0.5) * REQ_STEP_S if step else 0.0,
            sampling=None if sp is None else SamplingParams(
                temperature=0.8, top_k=50, top_p=0.9, seed=sp)))

    for j in range(12):
        n = int(rng.integers(40, 121))
        add("standard", j, np.concatenate([system, make_prompts(
            "code", vocab, 1, n, seed=seed + 100 + j)[0]]), j)
    for j in range(8):
        n = int(rng.integers(64, 257))
        add("batch", j, make_prompts("math", vocab, 1, n,
                                     seed=seed + 200 + j)[0], 12 + j)
    for j in range(4):
        add("premium", j, make_prompts("text", vocab, 1, 768,
                                       seed=seed + 300 + j)[0], 50 + 6 * j)
    return out


def bf16_step(v: float) -> float:
    """The spacing of bf16 values at magnitude ``|v|``."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 2.0 ** -133


def _watch(engine, eng_mod, rec, force=None):
    """Instrument one engine for the requests phase: every prefill forward
    timed (CUDA-synchronised perf_counter; whole or with a prefix, its
    computed tokens); every emitted position's top ``TOP_K_SEEN`` logits
    and token ids, the token the engine chose, the position of the token
    it was emitted from and, sampled, the tokens it could draw (vocabulary
    order), under ``rec["pos"][request id][index]``; every token's experts
    in every layer as the forward that wrote its K/V took them, under
    ``rec["experts"][request id][position]`` (a trie hit's as the request
    that wrote the shared blocks); after every resume, whether the pool
    holds every lane of the request's snapshot bit for bit
    (``rec["resumed"]``); every forward's logits held finite.
    With ``force`` ({id(request): tokens}), each emitted token is then
    replaced by the forced one, which the next step reads. This costs
    device syncs and host copies on every step: wall-clock runs go
    unwatched. Returns the function that removes the wrappers."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.serving.sampler import sampling_probs
    entry, route = eng_mod.prefill_paged, moe_mod.route
    submit, resume = engine.submit, engine._resume_paged
    first, decode = engine._first_token, engine._decode_one
    bt, handles, last = engine.ecfg.block_tokens, [], {}
    at_block = {}           # (block, offset) -> experts of the K/V there
    sync = engine.device.type == "cuda"

    def wrote(h, p, blk, experts):
        rec["experts"].setdefault(h.id, {})[p] = experts
        at_block[(int(blk), p % bt)] = experts

    def note(h, t, row, slot, end):
        top = torch.topk(row, TOP_K_SEEN)
        r = rec["pos"].setdefault(h.id, {})[t] = {
            "v": top.values.float().tolist(), "ids": top.indices.tolist(),
            "own": h.tokens[t], "end": end}
        if not h.sampler.greedy:
            r["nucleus"] = np.flatnonzero(sampling_probs(
                row.float().cpu().numpy(), h.sampler.sp)).tolist()
        if force is not None:
            h.tokens[t] = force[id(h.request)][t]
            engine.tokens[slot] = h.tokens[t]

    def submit_watched(req):
        h = submit(req)
        handles.append(h)
        return h

    def prefill_watched(*a, **k):
        seen = []

        def route_seen(*ra, **rk):
            got = route(*ra, **rk)
            seen.append(got[1])
            return got

        if sync:
            torch.cuda.synchronize()
        moe_mod.route = route_seen
        t0 = time.perf_counter()
        try:
            out = entry(*a, **k)
        finally:
            moe_mod.route = route
        if sync:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        R, S = a[2].shape
        ex = torch.stack([i.sort(dim=-1).values for i in seen], 1) \
            .view(R, S, len(seen), -1).cpu().numpy()
        tables = a[4].cpu().numpy()
        starts, lengths = a[5].tolist(), a[6].tolist()
        for r in range(R):
            if lengths[r] <= starts[r]:
                continue
            h = next(h for h in handles if h.lease is not None and
                     np.array_equal(h.lease.table, tables[r]))
            mine = rec["experts"].setdefault(h.id, {})
            for p in range(starts[r]):
                if p not in mine:
                    mine[p] = at_block[(int(tables[r][p // bt]), p % bt)]
            for p in range(starts[r], lengths[r]):
                wrote(h, p, tables[r][p // bt],
                      tuple(map(tuple, ex[r, p - starts[r]])))
        last["ends"] = [n - 1 for n in lengths]
        rec["prefill"].append((bool(k.get("has_prefix")),
                               int((a[6] - a[5]).sum()), ms))
        rec["finite"].append(bool(torch.isfinite(out[0]).all()))
        last["logits"] = out[0]
        return out

    def resume_watched(h, slot):
        snap = h._snapshot
        ok = resume(h, slot)
        if ok:
            # The lanes read back bit for bit, restored or adopted; they
            # keep their experts.
            span = np.arange(snap.pos)
            got = engine._gather_lanes(h.lease.table[span // bt], span % bt)
            rec["resumed"].append(all(
                torch.equal(got[k][i], snap.attn_lanes[k][i])
                for k in got for i in (0, 1)))
            for p, e in rec["experts"][h.id].items():
                if p // bt < len(h.lease.table):
                    at_block[(int(h.lease.table[p // bt]), p % bt)] = e
        return ok

    def first_token(h, slot, plen, r, *a):
        first(h, slot, plen, r, *a)
        note(h, 0, last["logits"][r], slot, last["ends"][r])

    def decode_one(active, finished, lo=False):
        at = [(i, h, len(h.tokens), int(engine.pos[i])) for i, h in active]
        decode(active, finished, lo)
        rec["finite"].append(bool(torch.isfinite(engine.last_logits).all()))
        counts = engine.last_row_counts
        wblk = engine.decode_graph.inputs.host["wblk"]
        for i, h, t, p in at:
            wrote(h, p, wblk[i], tuple(
                tuple(np.flatnonzero(layer).tolist())
                for k in sorted(counts) for layer in counts[k][:, i]))
            note(h, t, engine.last_logits[i], i, p)

    eng_mod.prefill_paged = prefill_watched
    engine.submit, engine._resume_paged = submit_watched, resume_watched
    engine._first_token, engine._decode_one = first_token, decode_one

    def restore():
        eng_mod.prefill_paged = entry
        for name in ("submit", "_resume_paged", "_first_token",
                     "_decode_one"):
            delattr(engine, name)
    return restore


def run_requests(cfg, device, params, stream, *, backend, backend_kw,
                 chunk=256, sharing=True, preemption=True, realtime=False,
                 eager=False, watch=True, force=None):
    """``stream`` through ``replay`` on a fresh engine over ``params`` on
    the main path: paged KV, ragged dispatch, decode graphed on the card
    (op by op under ``engine.eager()`` with ``eager``), every MoE layer
    drop-free (capacity over every token: which tokens an expert drops
    depends on the batch, so runs of other batches would compute other
    functions), instrumented by
    ``_watch`` unless ``watch`` is false, fed ``force`` (a run's
    summary) if given. Returns a summary: per request (in arrival order)
    its QoS, prompt length, tokens, TTFT and per-position records; the
    counters; prefill, replay and TPOT times; launches; the all-lo view's
    owners."""
    import contextlib
    import repro_torch.serving.engine as eng_mod
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.scheduler import SchedulerConfig
    t_build = time.perf_counter()
    engine = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend(backend, device=device,
                                          **backend_kw),
        eng_mod.EngineConfig(
            max_slots=REQ_SLOTS, max_len=REQ_MAX_LEN, prefix_sharing=sharing,
            capacity_factor=cfg.moe.num_experts / cfg.moe.top_k,
            scheduler=SchedulerConfig(prefill_chunk=chunk,
                                      preemption=preemption)),
        device=device)
    t_build = time.perf_counter() - t_build
    cuda = device.type == "cuda" and not eager
    if cuda:
        engine.decode_graph.events, engine.lo_graph.events = [], []
    rec = {"pos": {}, "experts": {}, "resumed": [], "prefill": [],
           "finite": []}
    fed = None if force is None else {
        id(r): h["tokens"] for r, h in zip(stream, force["handles"])}
    restore = _watch(engine, eng_mod, rec, fed) if watch else \
        (lambda: None)
    try:
        ops.reset_launches()                 # the main path starts here
        t0 = time.perf_counter()
        with eng_mod.eager() if eager else contextlib.nullcontext():
            handles = engine.replay(stream, realtime=realtime)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)        # ... and ends here
    finally:
        restore()
    engine.flush()
    engine.pool.check_invariants()
    st = engine.stats()
    lo_owned = [int((b.slot_owner >= 0).sum())
                for b in (engine.lo_banks or {}).values()]
    hi_owned = [int((b.slot_owner >= 0).sum())
                for b in (engine.banks or {}).values()]
    graphs = {"mixed": engine.decode_graph, "lo": engine.lo_graph}
    out = {
        "handles": [dict(id=h.id, qos=h.qos, state=h.state.value,
                         tokens=list(h.tokens), ttft_s=h.ttft_s,
                         greedy=h.sampler.greedy,
                         pos=rec["pos"].get(h.id, {}),
                         experts=rec["experts"].get(h.id, {}),
                         prompt=len(h.prompt()))
                    for h in handles],
        "stats": st, "launches": launches, "wall_s": wall,
        "build_s": t_build, "capture_s": engine.capture_s, "watched": watch,
        "prefill": rec["prefill"], "finite": all(rec["finite"]),
        "resumed": rec["resumed"],
        "replay_ms": {k: [a.elapsed_time(b) for a, b in g.events]
                      if cuda else [] for k, g in graphs.items()},
        "captured": {k: g.graph is not None for k, g in graphs.items()},
        "lo_owned": lo_owned, "hi_owned": hi_owned}
    del engine
    return out


def _moved(ra, rb, toks) -> float:
    """The largest |logit| change between two records over ``toks``
    (infinite where one falls outside a record's top ``TOP_K_SEEN``)."""
    A, B = dict(zip(ra["ids"], ra["v"])), dict(zip(rb["ids"], rb["v"]))
    return max(abs(A[t] - B[t]) if t in A and t in B else math.inf
               for t in toks)


def routing_explained(ea, eb, n):
    """Two runs' experts per layer for positions 0..n-1 of one sequence
    ({position: experts per layer}). Returns (clean (n,) bool: no position
    up to it differs, the differences not explained [(position, layer,
    experts in one run only)]). A position's difference is explained when
    at its first differing layer one expert is swapped for another (a
    router near tie), or when an earlier position differs first at a
    shallower layer (whose K/V the swap has moved from the next layer
    on)."""
    clean, bad, lo = np.ones(n, bool), [], math.inf
    for p in range(n):
        a, b = ea.get(p), eb.get(p)
        if a is None or b is None:
            bad.append((p, None, "no record"))
            clean[p:] = False
            continue
        diff = [(l, sorted(set(x) ^ set(y)))
                for l, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            continue
        clean[p:] = False
        f, d = diff[0]
        if len(d) != 2 and not lo < f:
            bad.append((p, f, d))
        lo = min(lo, f)
    return clean, bad


def compare_forced(a, b):
    """Run ``a`` against run ``b`` fed ``a``'s tokens, position by
    position. Returns per request (id, positions, positions held, flips
    [(index, the largest logit change in play in bf16 steps, held,
    passes)], median |dlogit| of ``a``'s token, expert differences not
    explained), and over the held greedy positions (those where a flip
    would pass, positions)."""
    out, near, greedy = [], 0, 0
    for x, y in zip(a["handles"], b["handles"]):
        assert x["id"] == y["id"] and x["prompt"] == y["prompt"]
        clean, unexplained = routing_explained(
            x["experts"], y["experts"], max(x["experts"]) + 1)
        flips, dl, held = [], [], 0
        for t, tok in enumerate(x["tokens"]):
            ra, rb = x["pos"][t], y["pos"][t]
            assert ra["own"] == tok and ra["end"] == rb["end"]
            step = bf16_step(ra["v"][0])
            keep = bool(clean[ra["end"]])
            held += keep
            if x["greedy"] and keep:
                greedy += 1
                near += (ra["v"][0] - ra["v"][1]) / step + \
                    (rb["v"][0] - rb["v"][1]) / bf16_step(rb["v"][0]) <= \
                    FLIP_STEPS
            if rb["own"] != tok:
                play = {tok, rb["own"]} if x["greedy"] else \
                    set(ra["nucleus"]) | {rb["own"]}
                moved = _moved(ra, rb, play) / step
                flips.append((t, round(moved, 2), keep,
                              moved <= FLIP_STEPS or not keep))
            dl.append(_moved(ra, rb, [tok]))
        out.append((x["id"], len(x["tokens"]), held, flips,
                    float(np.median(dl)), unexplained))
    return out, (near, greedy)


def _tiers(run, clock):
    """TTFT p50/p99 per QoS tier, in ms."""
    out = []
    for q in ("premium", "standard", "batch"):
        v = [h["ttft_s"] * 1e3 for h in run["handles"] if h["qos"] == q]
        if v:
            out.append(f"{q} p50 {np.percentile(v, 50):.1f} p99 "
                       f"{np.percentile(v, 99):.1f}")
    return f"TTFT ms ({clock}) " + ", ".join(out)


def _report(what, run, card, clock="virtual clock"):
    st = run["stats"]
    whole = [(n, ms) for hp, n, ms in run["prefill"] if not hp]
    suffix = [(n, ms) for hp, n, ms in run["prefill"] if hp]

    def pf(rows):
        if not run["watched"]:
            return "not timed (unwatched run)"
        if not rows:
            return "none"
        n, ms = sum(r[0] for r in rows), sum(r[1] for r in rows)
        return (f"{len(rows)} forwards, {n} tokens, {ms / len(rows):.2f} "
                f"ms per forward, {ms / max(n, 1) * 1e3:.1f} us per token")

    submitted = sum(h["prompt"] for h in run["handles"])
    resumed = f"{sum(run['resumed'])} of {len(run['resumed'])}" \
        if run["watched"] else "not watched"
    counters = {k: int(st[k]) for k in (
        "prefills", "steps", "prefill_tokens", "prefix_hit_tokens",
        "chunk_prefills", "preemptions", "resumes", "kv_cow_copies",
        "prefix_trie_nodes", "shed_requests", "downgraded",
        "prefill_compiles")}
    rp = {k: (f"{np.mean(v):.3f}" if v else "n/a") + f" over {len(v)}"
          for k, v in run["replay_ms"].items()}
    log("requests", f"{what}: prefill tokens computed "
                    f"{int(st['prefill_tokens'])} of {submitted} submitted "
                    f"| prefill whole: "
                    f"{pf(whole)}; with a cached prefix: {pf(suffix)} | "
                    f"ms per graph replay (CUDA events) mixed {rp['mixed']}, "
                    f"all-lo {rp['lo']} | TPOT {st['tpot_s'] * 1e3:.2f} ms | "
                    f"{_tiers(run, clock)} | counters {counters} | "
                    f"resumes reading back every lane bit for bit "
                    f"{resumed} | "
                    f"promotions {st['promotions']:.0f} | launches "
                    f"{run['launches']} | built {run['build_s']:.1f} s, "
                    f"capture {run['capture_s']:.2f} s, served "
                    f"{run['wall_s']:.1f} s | {card}")


def phase_requests(card: str) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    stream = request_stream(cfg.vocab_size)
    log("requests", f"{cfg.name}: full width, {SERVE_LAYERS} of "
                    f"{full.n_layers} layers, random weights, seed 0; "
                    f"paged/ragged, decode graphed, {REQ_SLOTS} slots, "
                    f"max_len {REQ_MAX_LEN}; {len(stream)} requests x "
                    f"{REQ_NEW} "
                    f"tokens through replay(realtime=False): 12 standard "
                    f"sharing a 160-token prefix, 8 batch of 64-256 tokens, "
                    f"4 premium of 768 tokens arriving last; 4 sampled")
    static = dict(lo_bits=4, group_size=64)
    runs = {"static, all on": run_requests(cfg, dev, params, stream,
                                           backend="static",
                                           backend_kw=static)}
    runs["static, sharing/chunking/preemption off"] = run_requests(
        cfg, dev, params, stream, backend="static", backend_kw=static,
        chunk=0, sharing=False, preemption=False,
        force=runs["static, all on"])
    runs["dynaexq, all on"] = run_requests(
        cfg, dev, params, stream, backend="dynaexq",
        backend_kw=dict(lo_bits=4, group_size=64, n_hi_per_layer=16,
                        controller=ControllerConfig(update_interval_s=0.0)))
    eager = run_requests(cfg, dev, params, stream, backend="static",
                         backend_kw=static, eager=True)
    wall = run_requests(cfg, dev, params, stream, backend="static",
                        backend_kw=static, realtime=True, watch=False)
    used = PATHS["paged/ragged"][2]
    extra = [("static, all on, eager", eager),
             ("static, all on, wall clock", wall)]
    for what, run in list(runs.items()) + extra:
        _report(what, run, card, "wall clock" if run is wall
                else "virtual clock")
        st = run["stats"]
        if not run["finite"]:
            raise AssertionError(f"{what}: non-finite logits")
        if not all(run["launches"][k] > 0 for k in used):
            raise AssertionError(f"{what}: launches {run['launches']}")
        if any(h["state"] != "finished" or len(h["tokens"]) != REQ_NEW
               for h in run["handles"]):
            raise AssertionError(f"{what}: a request did not finish")
        if any(run["lo_owned"]) or (run is not eager and (
                not run["captured"]["lo"] or not run["replay_ms"]["lo"])):
            raise AssertionError(f"{what}: the batch tier's view owns hi "
                                 f"slots {run['lo_owned']} or its graph "
                                 f"never ran")
        if st["preemptions"] != st["resumes"] or (run["watched"] and (
                len(run["resumed"]) != st["resumes"] or
                not all(run["resumed"]))):
            raise AssertionError(f"{what}: {st['preemptions']} preemptions, "
                                 f"{st['resumes']} resumes, lanes read back "
                                 f"bit for bit {run['resumed']}")
    on = runs["static, all on"]["stats"]
    submitted = sum(h["prompt"] for h in runs["static, all on"]["handles"])
    if not (on["prefix_hit_tokens"] > 0 and on["prefill_tokens"] < submitted
            and on["chunk_prefills"] >= 12 and on["preemptions"] >= 1):
        raise AssertionError(f"static, all on: hits "
                             f"{on['prefix_hit_tokens']}, prefill tokens "
                             f"{on['prefill_tokens']} of {submitted}, chunk "
                             f"prefills {on['chunk_prefills']}, preemptions "
                             f"{on['preemptions']}")
    dx = runs["dynaexq, all on"]
    if dx["stats"]["promotions"] < 1 or not any(dx["hi_owned"]):
        raise AssertionError(f"dynaexq: promotions "
                             f"{dx['stats']['promotions']}, hi owners "
                             f"{dx['hi_owned']}")
    g = runs["static, all on"]
    if [h["tokens"] for h in g["handles"]] != \
            [h["tokens"] for h in eager["handles"]] or \
            g["launches"] != eager["launches"]:
        raise AssertionError("static, all on: the two graphs and eager "
                             "decode disagree on tokens or launches")
    log("requests", "static, all on: both graphs (served and all-lo "
                    "banks, one memory pool) and eager decode give "
                    "identical tokens for all 24 requests and identical "
                    "launches")
    per, (near, greedy) = compare_forced(
        runs["static, all on"], runs["static, sharing/chunking/preemption "
                                     "off"])
    n = sum(r[1] for r in per)
    held = sum(r[2] for r in per)
    flips = {r[0]: r[3] for r in per if r[3]}
    bad = [(i, [f for f in fl if not f[3]], round(m, 4), un[:3])
           for i, _, _, fl, m, un in per
           if m > MODEL_TOL or un or not all(f[3] for f in fl)]
    log("requests", f"static all on vs off fed all on's tokens: "
                    f"{sum(not r[3] for r in per)} of {len(per)} requests "
                    f"choose the same token at every position; positions "
                    f"held (every token read took the same experts in both "
                    f"runs) {held} of {n} (at least {MIN_HELD}), per "
                    f"request {[r[2] for r in per]}; flips "
                    f"{sum(len(f) for f in flips.values())} (request: "
                    f"[(index, largest logit change in play in bf16 "
                    f"steps, held, passes)]) {flips}; a held flip passes "
                    f"within {FLIP_STEPS} steps, as it would at {near} of "
                    f"{greedy} held greedy positions (limit "
                    f"{MAX_TIE_SHARE}); median |dlogit| of on's token per "
                    f"request, max {max(r[4] for r in per):.4f} (tol "
                    f"{MODEL_TOL}); expert differences not explained as "
                    f"router near ties {sum(len(r[5]) for r in per)}; over "
                    f"the limits (request, flips, median, first three "
                    f"unexplained) {bad} | dynaexq: hi "
                    f"owners per MoE position {dx['hi_owned']} while the "
                    f"batch tier's view owns {dx['lo_owned']} | "
                    f"{time.perf_counter() - t0:.1f} s | {card}")
    if bad or held < MIN_HELD * n or near > MAX_TIE_SHARE * greedy:
        raise AssertionError(f"all on vs off, fed the same tokens: {bad}; "
                             f"held {held} of {n}; {near} of {greedy} held "
                             f"greedy positions would pass a flip")
    for k in RESULTS:
        RESULTS[k]["launches"] = RESULTS[k].get("launches", 0) + sum(
            r["launches"][k] for r in list(runs.values()) + [eager, wall])
    del params


# ---------------------------------------------------------------------------
# 5. spec: self-speculative decoding, the watchdogs, dense preemption and
#    per-row MoE capacity
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_NEW = 32
SPEC_SLOTS = 8
SPEC_MAX_LEN = 288              # 256-token prompts + 32 tokens
SPEC_DENSE_LAYERS = 4
#: The draft and verify ladders' runs: (label, EngineConfig keywords).
SPEC_RUNS = (("off", {}), ("spec_k=4", dict(spec_k=SPEC_K)),
             ("spec_k=4 fixed", dict(spec_k=SPEC_K, spec_adaptive=False)))


def _spec_prompts(vocab, seed=0):
    """8 greedy prompts of 64-256 tokens (the serving phase's draw) and 8
    warm-up prompts of 96 tokens from other seeds."""
    from repro_torch.serving.requests import make_prompts
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 257, 8)
    return ([make_prompts("text", vocab, 1, int(n), seed=seed + i)[0]
             for i, n in enumerate(lens)],
            make_prompts("text", vocab, 8, 96, seed=seed + 50))


def _spec_engine(cfg, params, backend, warm, *, paged, dispatch, n_hi=16,
                 **ecfg):
    """A fresh engine (8 slots) with ``static`` int4 or ``dynaexq`` (int4
    lo, ``n_hi`` hi experts per MoE layer). ``dynaexq``'s policy runs no
    window by itself: after 4
    tokens of the 8 warm-up prompts (which leave no prefix in common with
    the served ones) one window publishes its hi sets, and they stay,
    so every run of a backend serves the same target."""
    import dataclasses
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.backends import make_backend
    dev = params["embed"].device
    kw = dict(lo_bits=4, group_size=64, device=dev)
    if backend == "dynaexq":
        kw.update(n_hi_per_layer=n_hi, controller=ControllerConfig(
            update_interval_s=1e9))
    eng = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend(backend, **kw),
        eng_mod.EngineConfig(max_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
                             paged=paged, moe_dispatch=dispatch, **ecfg),
        device=dev)
    if backend == "dynaexq":
        eng.generate({"tokens": warm}, 4)
        eng.backend.force_update()
        eng.backend.flush()
        for ctl in eng.backend.controllers.values():
            ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    return eng


def _experts(counts, i, j=None):
    """Row ``i``'s experts in every layer from per-row counts ((nsb, B, E),
    or step ``j`` of a verify's (W, nsb, B, E))."""
    return tuple(tuple(np.flatnonzero(layer).tolist())
                 for k in sorted(counts)
                 for layer in (counts[k][:, i] if j is None
                               else counts[k][j, :, i]))


def _spec_serve(eng, prompts, new=SPEC_NEW):
    """Serve ``prompts`` greedy on a built engine, every one admitted in
    its first step (so the prefill's shape is every run's). Records per
    request its tokens and, per decode position, its experts in every
    layer as the forward that consumed the position routed them (plain
    steps, and the accepted steps of each verify); holds what the backend
    observed in each round to the round's per-step counts under its accept
    mask; times every graph replay (CUDA events). Returns a summary."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import RequestState
    from repro_torch.serving.requests import Request
    spec, rec = eng._spec, {}
    decode, observe = eng._decode_one, eng.backend.observe
    observed, rounds = [], {"n": 0, "held": 0, "rows": 0}

    def decode_one(active, finished, lo=False):
        at = [(i, h, int(eng.pos[i])) for i, h in active]
        decode(active, finished, lo)
        for i, h, p in at:
            rec.setdefault(h.id, {})[p] = _experts(eng.last_row_counts, i)

    def watched(counts, *a, **k):
        observed.append({p: v.copy() for p, v in counts.items()})
        return observe(counts, *a, **k)

    graphs = [eng.decode_graph]
    if spec is not None:
        spec_round = spec.round

        def round_(rows, finished):
            at = [(i, h, int(eng.pos[i])) for i, h in rows]
            n = len(observed)
            ran = spec_round(rows, finished)
            if ran:
                mask, counts = spec.last["accept_mask"], spec.last["counts"]
                rounds["n"] += 1
                rounds["rows"] += len(rows)
                rounds["held"] += all(np.array_equal(
                    observed[n][k], (v * mask[:, None, :, None]).sum(0))
                    for k, v in counts.items())
                for i, h, p in at:
                    for j in np.flatnonzero(mask[:, i]):
                        rec.setdefault(h.id, {})[p + int(j)] = \
                            _experts(counts, i, int(j))
            return ran

        spec.round = round_
        graphs += [g for pair in spec.graphs.values() for g in pair]
    for g in graphs:
        g.events = []
    eng._decode_one, eng.backend.observe = decode_one, watched
    steps0, cap0 = eng.counters["steps"], eng.capture_s
    tpot0 = (eng._tpot_sum, eng._tpot_tokens)
    try:
        ops.reset_launches()                 # the path starts here
        t0 = time.perf_counter()
        handles = [eng.submit(Request(tokens=p, max_new_tokens=new))
                   for p in prompts]
        eng.step()
        if any(h.state is RequestState.QUEUED for h in handles):
            raise AssertionError("spec: not every request was admitted in "
                                 "the first step")
        eng.drain()
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)        # ... and ends here
    finally:
        del eng._decode_one, eng.backend.observe
        if spec is not None:
            del spec.round
    st = eng.stats()
    ms = lambda g: float(np.mean([a.elapsed_time(b) for a, b in g.events])) \
        if g.events else None
    summary = {
        "tokens": [list(h.tokens) for h in handles], "experts": rec,
        "plens": [len(p) for p in prompts], "ids": [h.id for h in handles],
        "launches": launches, "wall_s": wall,
        "steps": eng.counters["steps"] - steps0,
        # Per emitted token of a row: a step's (or round's) latency over
        # the tokens it emitted for each row (the engine's TPOT).
        "tpot_ms": (eng._tpot_sum - tpot0[0]) /
        (eng._tpot_tokens - tpot0[1]) * 1e3,
        "replay_ms": ms(eng.decode_graph), "capture_s": eng.capture_s - cap0,
        "hi_sets": eng.backend.hi_sets() if hasattr(eng.backend, "hi_sets")
        else None}
    if spec is not None:
        summary.update(
            rounds=rounds["n"], row_rounds=rounds["rows"],
            observed_held=rounds["held"], accepted=spec.accepted_total,
            drafted=spec.draft_total, verified=spec.verified_total,
            accept_rate=st["accept_rate"], spec_capture_s=spec.capture_s,
            widths={k: (ms(d), len(d.events), ms(v), len(v.events))
                    for k, (d, v) in spec.graphs.items()})
    return summary


def _spec_compare(off, on) -> list:
    """Each request's tokens of a spec run against spec off's. Returns
    [(request, first differing token, explained)]: a difference is
    explained (``routing_explained``) when the forwards' experts differ
    before the position it was emitted from by a router near tie."""
    out = []
    for r, (a, b) in enumerate(zip(off["tokens"], on["tokens"])):
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None and len(a) == len(b):
            continue
        t = min(len(a), len(b)) if t is None else t
        plen = off["plens"][r]
        ea = {p - plen: e for p, e in off["experts"][off["ids"][r]].items()}
        eb = {p - plen: e for p, e in on["experts"][on["ids"][r]].items()}
        n = min(len(ea), len(eb))
        clean, bad = routing_explained(ea, eb, n)
        at = max(0, t - 1)                  # token t came from plen + t - 1
        out.append((r, t, at < n and not clean[at] and not bad))
    return out


def _spec_paged(card, cfg, params, prompts, warm) -> list:
    """(a, b): static and dynaexq on the main path, spec off, spec_k = 4
    adaptive and fixed, graphed; greedy tokens identical to spec off (or
    each difference explained by routing)."""
    used, unused = PATHS["paged/ragged"][2:]
    runs = []
    for backend in ("static", "dynaexq"):
        res = {}
        for label, ecfg in SPEC_RUNS:
            eng = _spec_engine(cfg, params, backend, warm, paged=True,
                               dispatch="ragged", **ecfg)
            res[label] = _spec_serve(eng, prompts)
            del eng
        off = res["off"]
        for label, s in res.items():
            if not all(s["launches"][k] > 0 for k in used) or \
                    any(s["launches"][k] for k in unused):
                raise AssertionError(f"spec {backend} {label}: launches "
                                     f"{s['launches']}")
            if s["hi_sets"] != off["hi_sets"]:
                raise AssertionError(f"spec {backend} {label}: another "
                                     f"target's hi sets than spec off's")
            if label == "off":
                continue
            div = _spec_compare(off, s)
            wid = ", ".join(
                f"k={k}: draft {_ms(d)} ms x{nd}, verify {_ms(v)} ms x{nv}"
                for k, (d, nd, v, nv) in s["widths"].items())
            log("spec", f"paged/ragged {backend} {label}: {s['rounds']} "
                        f"rounds ({s['row_rounds']} row-rounds), drafted "
                        f"{s['drafted']}, accepted {s['accepted']}, "
                        f"verified (emitted) {s['verified']}, accept rate "
                        f"{s['accept_rate']:.3f}, tokens per row-round "
                        f"{s['verified'] / max(1, s['row_rounds']):.2f} | "
                        f"graph replay ms by width (CUDA events) {wid}; "
                        f"capture {s['spec_capture_s']:.2f} s | TPOT per "
                        f"emitted token {s['tpot_ms']:.2f} ms vs spec off "
                        f"{off['tpot_ms']:.2f} ms (plain replay "
                        f"{_ms(off['replay_ms'])} ms), {s['steps']} steps "
                        f"vs {off['steps']} | backend observed the accepted "
                        f"steps' counts in {s['observed_held']} of "
                        f"{s['rounds']} rounds | tokens vs spec off: "
                        f"{8 - len(div)} of 8 requests identical"
                        + (f", differences (request, token, explained by "
                           f"routing) {div}" if div else "")
                        + f" | launches {s['launches']} | {card}")
            if s["observed_held"] != s["rounds"] or s["rounds"] < 1:
                raise AssertionError(f"spec {backend} {label}: the backend "
                                     f"observed other counts than the "
                                     f"accepted steps'")
            if any(not ok for _, _, ok in div):
                raise AssertionError(f"spec {backend} {label}: tokens differ "
                                     f"from spec off, unexplained: {div}")
        runs += list(res.values())
    return runs


def _dense_row_lanes(eng, slot):
    return {p: (c.k[:, slot].clone(), c.v[:, slot].clone())
            for p, c in eng.caches.items()}


def _spec_dense(card, cfg, params, prompts, warm) -> list:
    """(c) on the dense/padded path: spec_k = 2 with per-row capacity
    against spec off (dynaexq); one preemption whose resume reads every
    lane of the row back bit for bit, and one no-progress requeue, each
    against an undisturbed run (static)."""
    used, unused = PATHS["dense/padded"][2:]
    kw = dict(paged=False, dispatch="padded")
    runs = {}
    for label, ecfg in (("off", {}), ("spec_k=2", dict(spec_k=2))):
        eng = _spec_engine(cfg, params, "dynaexq", warm,
                           row_capacity_norm=True, **kw, **ecfg)
        runs[label] = _spec_serve(eng, prompts)
        del eng
    s, off = runs["spec_k=2"], runs["off"]
    div = _spec_compare(off, s)
    for label, r in runs.items():
        if not all(r["launches"][k] > 0 for k in used) or \
                any(r["launches"][k] for k in unused):
            raise AssertionError(f"spec dense {label}: launches "
                                 f"{r['launches']}")
    if any(not ok for _, _, ok in div) or s["hi_sets"] != off["hi_sets"] \
            or s["observed_held"] != s["rounds"] or s["rounds"] < 1:
        raise AssertionError(f"spec dense: differences {div}, observed "
                             f"{s['observed_held']} of {s['rounds']}")
    log("spec", f"dense/padded dynaexq spec_k=2, row_capacity_norm: "
                f"{s['rounds']} rounds, accept rate {s['accept_rate']:.3f},"
                f" tokens per row-round "
                f"{s['verified'] / max(1, s['row_rounds']):.2f}, TPOT "
                f"{s['tpot_ms']:.2f} ms vs spec off {off['tpot_ms']:.2f} ms; "
                f"verify ms by width {[(k, _ms(v[2])) for k, v in s['widths'].items()]}"
                f"; tokens vs spec off: {8 - len(div)} of 8 identical"
                + (f", differences {div}" if div else "")
                + f" | launches {s['launches']} | {card}")

    # Preemption and the no-progress watchdog against an undisturbed run.
    base = _spec_serve(_spec_engine(cfg, params, "static", warm, **kw),
                       prompts)
    checks = {}
    for what, ecfg in (("preempt", {}), ("watchdog",
                                        dict(watchdog_no_progress_s=30.0))):
        eng = _spec_engine(cfg, params, "static", warm, **kw, **ecfg)
        eng._clock = 0.0
        from repro_torch.serving.requests import Request
        hs = [eng.submit(Request(tokens=p, max_new_tokens=SPEC_NEW))
              for p in prompts]
        for _ in range(3):
            eng.step()
            eng._clock += 1.0
        victim = hs[2]
        snap_rows, readback = _dense_row_lanes(eng, victim.slot), []
        resume = eng._resume_dense

        def resumed(h, slot, resume=resume, readback=readback):
            ok = resume(h, slot)
            if h is victim:
                got = _dense_row_lanes(eng, slot)
                readback.append(all(
                    torch.equal(got[p][i], snap_rows[p][i])
                    for p in got for i in (0, 1)))
            return ok

        eng._resume_dense = resumed
        if what == "preempt":
            eng.preempt(victim)
        else:
            victim.last_progress_s -= 1000.0
        eng.step()
        eng.drain()
        st = eng.stats()
        checks[what] = dict(
            tokens=[list(h.tokens) for h in hs] == base["tokens"],
            readback=readback, preemptions=st["preemptions"],
            resumes=st["resumes"], watchdog=st["watchdog_cancels"])
        del eng
    ok = all(c["tokens"] and c["readback"] == [True] and
             c["preemptions"] == c["resumes"] == 1 for c in checks.values())
    ok = ok and checks["watchdog"]["watchdog"] == 1
    log("spec", f"dense/padded static: one preemption and one no-progress "
                f"requeue (watchdog_no_progress_s=30, virtual clock) against "
                f"an undisturbed run: {checks} | {card}")
    if not ok:
        raise AssertionError(f"spec dense preemption/watchdog: {checks}")
    return list(runs.values()) + [base]


def _spec_promo_deadline(card, cfg, params, prompts) -> None:
    """(c) ``promo_deadline_s`` on the dense/padded path (dynaexq, a
    policy window every step): the first window's copies are queued
    behind a ~1 s spin on each side stream, and with the virtual clock
    moved past the deadline the next step's watchdog cancels each once:
    its reservation refunded exactly once (the tracker's bytes and the
    invariants right after the cancel), the expert left lo, and every
    request finishes."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.ver import Residency
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    eng = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend(
            "dynaexq", lo_bits=4, group_size=64, n_hi_per_layer=16,
            device=dev, controller=ControllerConfig(update_interval_s=0.0)),
        eng_mod.EngineConfig(max_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
                             paged=False, moe_dispatch="padded",
                             promo_deadline_s=1.0), device=dev)
    tms = [c.tm for c in eng.backend.controllers.values()]
    tick, ticks = eng.backend.tick, [0]

    def held_tick():
        if not ticks[0]:
            for tm in tms:                   # ~1 s of spin on the side
                with torch.cuda.stream(tm._side):
                    torch.cuda._sleep(2_000_000_000)
        ticks[0] += 1
        return tick()

    cancel, calls, stuck = eng.backend.cancel_stuck_promotions, [], []

    def cancel_watched(now, deadline_s):
        used = sum(tm.tracker.used for tm in tms)
        n = cancel(now, deadline_s)
        for tm in tms:
            tm.check_invariants()
        calls.append((now, n, used - sum(tm.tracker.used for tm in tms),
                      all(tm.state[l, e] == Residency.RESIDENT_LO.value
                          for tm, l, e in stuck)))
        return n

    eng.backend.tick = held_tick
    eng.backend.cancel_stuck_promotions = cancel_watched
    eng._clock = 0.0
    hs = [eng.submit(Request(tokens=p, max_new_tokens=8))
          for p in prompts]
    eng.step()                # its tick issues copies behind the spin
    stuck += [(tm, p.layer, p.expert) for tm in tms for p in tm._pending
              if not p.event.query()]
    eng._clock = 5.0
    eng.step()                # the watchdog's scan runs first
    del eng.backend.tick, eng.backend.cancel_stuck_promotions
    _, cancelled, refunded, lo = calls[1]
    eng.drain()
    eng.flush()
    for tm in tms:
        tm.check_invariants()
    st = eng.stats()
    hi_bytes = tms[0].hi_bytes
    log("spec", f"dense/padded dynaexq promo_deadline_s=1 (virtual clock): "
                f"{len(stuck)} copies held behind a ~1 s spin, "
                f"{cancelled} cancelled at t=5 s (fault_cancels "
                f"{st['fault_cancels']:.0f} at the end), bytes refunded by "
                f"the cancel {refunded} (= {refunded / max(1, hi_bytes):.0f}"
                f" x hi bytes), experts left lo {lo}, invariants hold after "
                f"the cancel and after the flush; "
                f"promotions {st['promotions']:.0f}, all "
                f"{len(hs)} requests finished "
                f"{all(len(h.tokens) == 8 for h in hs)} | "
                f"{time.perf_counter() - t0:.1f} s | {card}")
    if not (stuck and cancelled == len(stuck) == st["fault_cancels"] and
            refunded == cancelled * hi_bytes and lo and calls[0][1] == 0
            and all(len(h.tokens) == 8 for h in hs)):
        raise AssertionError("spec: promo_deadline_s did not cancel the "
                             "held copies once each")


def phase_spec(card: str) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    full = get_config(ARCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    prompts, warm = _spec_prompts(cfg.vocab_size)
    log("spec", f"{cfg.name}: full width, {SERVE_LAYERS} of {full.n_layers} "
                f"layers, random weights, seed 0; paged/ragged, graphed; "
                f"{SPEC_SLOTS} slots, 8 greedy requests (64-256-token "
                f"prompts, {SPEC_NEW} tokens) all admitted in the first "
                f"step; static int4 and dynaexq (n_hi 16, hi sets from one "
                f"window after a warm-up, then fixed); runs "
                f"{[label for label, _ in SPEC_RUNS]}")
    runs = _spec_paged(card, cfg, params, prompts, warm)
    del params
    cfg4 = dataclasses.replace(full, n_layers=SPEC_DENSE_LAYERS)
    params = init_params(cfg4, seed=0, device=dev)
    runs += _spec_dense(card, cfg4, params, prompts, warm)
    _spec_promo_deadline(card, cfg4, params, prompts)
    del params
    for k in RESULTS:
        RESULTS[k]["launches"] = RESULTS[k].get("launches", 0) + sum(
            r["launches"][k] for r in runs)
    log("spec", f"phase done in {time.perf_counter() - t0:.1f} s | {card}")


# ---------------------------------------------------------------------------
# 5d. ladder: the residency ladder on the main path
# ---------------------------------------------------------------------------

#: Layers of the streaming cold start. Its shards hold the reference's
#: float32 hi rows (128 x 18,874,368 B per layer of Qwen3-30B-A3B), the
#: packed lo rows and the float32 embedding and LM head: ~7.7 GB on disk
#: at 2 of 48 layers.
LADDER_STREAM_LAYERS = 2
LADDER_PER_TICK = 64           # experts staged per cold-start window
LADDER_NEW = 32
LADDER_SLOTS = 8
LADDER_MAX_LEN = 288           # 256-token prompts + 32 tokens
#: Free disk the shard directory needs over its own size.
LADDER_DISK_SLACK = 1.1


def _moe_positions(cfg) -> list:
    return [p for p, _ in enumerate(cfg.superblock_or_default())
            if cfg.ffn_kind(p) == "moe"]


def _ladder_engine(cfg, params, ecfg=None, **bkw):
    """A fresh engine on the main path (graphed, 8 slots) with ``dynaexq``
    (int4 lo, n_hi 16, policy frozen unless ``controller`` is given)."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.backends import make_backend
    dev = torch.device("cuda")
    kw = dict(lo_bits=4, group_size=64, n_hi_per_layer=16, device=dev,
              controller=ControllerConfig(update_interval_s=1e9))
    kw.update(bkw)
    return eng_mod.InferenceEngine(
        cfg, params, make_backend("dynaexq", **kw),
        eng_mod.EngineConfig(max_slots=LADDER_SLOTS, max_len=LADDER_MAX_LEN,
                             **(ecfg or {})), device=dev)


def _ladder_warm(eng, warm):
    """The spec phase's pattern: 4 tokens of the warm-up prompts, one
    policy window, flush, then the policy stays frozen."""
    import dataclasses
    eng.generate({"tokens": warm}, 4)
    eng.backend.force_update()
    eng.backend.flush()
    for ctl in eng.backend.controllers.values():
        ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)


def _ladder_serve(eng, prompts, on_step=None, virtual=False):
    """Serve ``prompts`` greedy on a built engine, the launch counts set to
    0 just before and read just after; ``on_step`` runs after every step
    (drain), ``virtual`` serves through ``replay(realtime=False)``.
    Returns the run's summary."""
    from repro_torch.kernels import ops
    from repro_torch.serving.requests import Request
    reqs = [Request(tokens=p, max_new_tokens=LADDER_NEW, arrival_s=0.0)
            for p in prompts]
    ops.reset_launches()
    t0 = time.perf_counter()
    if virtual:
        hs = eng.replay(reqs, realtime=False)
    else:
        hs = [eng.submit(r) for r in reqs]
        while eng.queue or any(h is not None for h in eng.slots):
            eng.step()
            if on_step is not None:
                on_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if not all(len(h.tokens) == LADDER_NEW for h in hs):
        raise AssertionError(f"ladder: tokens {[len(h.tokens) for h in hs]}")
    if not bool(torch.isfinite(eng.last_logits).all()):
        raise AssertionError("ladder: NaN logits")
    used, unused = PATHS["paged/ragged"][2:]
    if not all(launches[k] > 0 for k in used) or \
            any(launches[k] for k in unused):
        raise AssertionError(f"ladder: launches {launches}")
    return {"tokens": [list(h.tokens) for h in hs], "launches": launches,
            "ttft_s": float(np.mean([h.ttft_s for h in hs])),
            "first_s": float(min(h.ttft_s for h in hs)),
            "wall_s": wall, "degraded": [h.degraded for h in hs]}


def _check_ladder(be) -> None:
    for ctl in be.controllers.values():
        ctl.tm.check_invariants()
    for store in be.stores.values():
        store.check_invariants()


def _same_lo_rows(a, b) -> int:
    """Bank ``a``'s lo rows equal bank ``b``'s byte for byte (on the card);
    returns the bytes compared."""
    n = 0
    for pos, bank in a.banks.items():
        for name, q in bank.lo.items():
            want = b.banks[pos].lo[name]
            for x, y in ((q.packed, want.packed), (q.scales, want.scales)):
                if not torch.equal(x, y):
                    raise AssertionError(f"ladder: staged lo rows of "
                                         f"{pos}/{name} differ from "
                                         f"build_bank's")
                n += x.numel() * x.element_size()
    return n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _dir_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(root) for f in fs)


def _ladder_stream(card, full, prompts, runs) -> None:
    """(a) The streaming cold start at full width, 2 layers, and a cold
    start with one lo shard unreadable."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.models.model import init_params
    from repro_torch.serving.streaming import (ShardSource,
                                               load_streaming_params,
                                               save_expert_shards)
    cfg = dataclasses.replace(full, n_layers=LADDER_STREAM_LAYERS)
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    positions = _moe_positions(cfg)
    experts = {str(p): params["blocks"][str(p)]["moe"]["experts"]
               for p in positions}
    # float32 on disk: every leaf, and the experts' lo codes and scales.
    need = sum(v.numel() * 4 for v in _leaves(params)) + \
        sum(v.numel() // 2 + v.numel() // 64 * 4
            for ex in experts.values() for v in ex.values())
    root = tempfile.mkdtemp(prefix="ladder_shards_")
    try:
        free = shutil.disk_usage(root).free
        if free < need * LADDER_DISK_SLACK:
            raise AssertionError(
                f"ladder: {root} has {free / 1e9:.1f} GB free, the shard "
                f"directory needs {need * LADDER_DISK_SLACK / 1e9:.1f} GB")
        t = time.perf_counter()
        save_expert_shards(root, _fresh(params), positions, lo_bits=4)
        t_save = time.perf_counter() - t
        on_disk = _dir_bytes(root)
        base_bytes = _dir_bytes(os.path.join(root, "base"))
        log("ladder", f"{cfg.name}: full width, {LADDER_STREAM_LAYERS} of "
                      f"{full.n_layers} layers, random weights, seed 0; "
                      f"expert shards written in {t_save:.1f} s, "
                      f"{on_disk / 1e9:.2f} GB on disk (base/ "
                      f"{base_bytes / 1e9:.2f} GB) | {card}")
        # The engine built from the in-memory params: the tokens and rows
        # to hold the streamed one to (its run also warms the process).
        t = time.perf_counter()
        mat = _ladder_engine(cfg, _fresh(params))
        torch.cuda.synchronize()
        t_mat = time.perf_counter() - t
        a = _ladder_serve(mat, prompts)
        runs.append(a)
        # The streamed engine: base/ leaves, empty banks, staged lo rows.
        t0 = time.perf_counter()
        sp = load_streaming_params(root, device=dev)
        eng = _ladder_engine(cfg, sp, stream=root,
                             stream_experts_per_tick=LADDER_PER_TICK)
        be = eng.backend
        if be.serving_ready():
            raise AssertionError("ladder: serving ready before any tick")
        torch.cuda.synchronize()
        t_built = time.perf_counter() - t0
        state = {"calls": 0}

        def opened():
            state["calls"] += 1
            if "t" not in state and be.serving_ready():
                state["t"] = time.perf_counter()
                state["read"] = dict(be.stream.stats)
                state["steps"] = state["calls"]
        b = _ladder_serve(eng, prompts, on_step=opened)
        runs.append(b)
        staged = sum(s.stats["lo_bytes_staged"] for s in be.stores.values())
        t_ready = state["t"] - t0
        t_pump = state["t"] - t0 - t_built
        if b["tokens"] != a["tokens"]:
            bad = [i for i, (x, y) in enumerate(zip(a["tokens"],
                                                    b["tokens"])) if x != y]
            raise AssertionError(f"ladder: streamed tokens differ from the "
                                 f"materialized engine's for requests {bad}")
        lo_bytes = _same_lo_rows(be, mat.backend)
        _check_ladder(be)
        # Full materialization reads every hi shard of the same directory
        # up front (the cold start without streaming).
        t1 = time.perf_counter()
        src = ShardSource(root)
        for pos in positions:
            dense = src.load_dense_experts(pos, device=dev)
            for n, v in dense.items():
                if not torch.equal(v, experts[str(pos)][n]):
                    raise AssertionError(f"ladder: dense {n} from the "
                                         f"shards differs")
            del dense
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t1
        full_read = src.stats["bytes_read"]
        log("ladder", f"stream: serving_ready {t_ready:.2f} s after the "
                      f"load began (base/ leaves and engine {t_built:.2f} "
                      f"s, staging {t_pump:.2f} s over "
                      f"{state['steps']} windows of {LADDER_PER_TICK} "
                      f"experts); read before serving opened "
                      f"{state['read']['bytes_read'] / 1e9:.3f} GB of lo "
                      f"shards ({state['read']['lo_reads']} files, "
                      f"{state['read']['hi_reads']} hi) + base/ "
                      f"{base_bytes / 1e9:.2f} GB, against "
                      f"{full_read / 1e9:.3f} GB of hi shards for full "
                      f"materialization (load_dense_experts alone "
                      f"{t_full:.2f} s, equal to the params); staged "
                      f"{staged / 1e9:.3f} GB at {staged / 1e9 / t_pump:.2f}"
                      f" GB/s (shard reads, pinning and copies, wall clock)"
                      f" | {card}")
        log("ladder", f"stream: 8 requests x {LADDER_NEW} tokens identical "
                      f"to the engine built from the in-memory params; "
                      f"{lo_bytes / 1e9:.3f} GB of staged lo rows equal "
                      f"build_bank's byte for byte; invariants hold | TTFT "
                      f"(submit to first token, mean of 8; both submitted "
                      f"to a freshly built engine): streamed "
                      f"{b['ttft_s'] * 1e3:.1f} ms (it holds the staging), "
                      f"materialized {a['ttft_s'] * 1e3:.1f} ms (built "
                      f"from the in-memory params in {t_mat:.2f} s); first "
                      f"token {t_built + b['first_s']:.2f} s after the "
                      f"streamed load began | {card}")
        # Promotions read their hi shards lazily.
        for e in (mat, eng):
            e.backend.force_update()
            e.backend.flush()
        if be.hi_sets() != mat.backend.hi_sets():
            raise AssertionError("ladder: streamed hi sets differ")
        st = be.stats()
        n_hi = sum(len(s) for sets in be.hi_sets().values() for s in sets)
        if st["hi_loads"] != n_hi or n_hi < 1:
            raise AssertionError(f"ladder: hi_loads {st['hi_loads']}, "
                                 f"{n_hi} hi experts")
        for pos, ctl in be.controllers.items():
            for l in range(ctl.tm.slot_map_h.shape[0]):
                for e_ in ctl.tm.hi_set(l):
                    s = int(ctl.tm.slot_map_h[l, e_])
                    for n, h in be.banks[pos].hi.items():
                        if not torch.equal(h[l, s], experts[pos][n][l, e_]):
                            raise AssertionError("ladder: a hi slot read "
                                                 "from its shard differs")
        _check_ladder(be)
        log("ladder", f"stream: one window after serving promoted {n_hi} "
                      f"experts, each read from its hi shard once "
                      f"(hi_loads {st['hi_loads']:.0f}, "
                      f"{be.stores['0'].stats['hi_bytes_loaded'] / 1e9:.3f}"
                      f" GB), hi sets equal the materialized engine's, hi "
                      f"slots equal the bf16 params | {card}")
        del eng, mat, sp
        _ladder_quarantine(card, cfg, root, prompts, a, be, runs)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _ladder_quarantine(card, cfg, root, prompts, clean, clean_be,
                       runs) -> None:
    """A cold start with layer 1's lo shard unreadable (garbage on disk)
    and stage_lo failing at a fixed cadence (absorbed by retries): layer
    1's cells quarantine, serving opens, every request routed there is
    flagged degraded; with the shard restored the cells heal, 2 per
    window, to build_bank's rows and the fault-free tokens. Prefix sharing
    is off: the degraded run's prompt blocks would otherwise serve the
    healed run's prompts with K/V computed through the quarantined
    rows."""
    from repro_torch.fault import FaultPlan, FaultRule
    from repro_torch.serving.streaming import load_streaming_params
    dev = torch.device("cuda")
    bad = os.path.join(root, "lo", "p0_l1.npz")
    os.replace(bad, bad + ".kept")
    with open(bad, "wb") as f:
        f.write(b"not a shard")
    plan = FaultPlan(seed=7, rules=(FaultRule(site="stage_lo", every=3),))
    eng = _ladder_engine(cfg, load_streaming_params(root, device=dev),
                         ecfg=dict(prefix_sharing=False), stream=root,
                         stream_experts_per_tick=LADDER_PER_TICK,
                         fault=plan)
    be = eng.backend
    store = be.stores["0"]
    E = store.E
    steps = 0
    while not be.serving_ready():
        eng.step()
        steps += 1
        if steps > 100:
            raise AssertionError("ladder: a quarantined cold start never "
                                 "opened")
    if not (store.quarantined[1].all() and not store.quarantined[0].any()):
        raise AssertionError(f"ladder: quarantined "
                             f"{store.quarantined.sum(axis=1)}")
    _check_ladder(be)
    d = _ladder_serve(eng, prompts)
    runs.append(d)
    if not all(d["degraded"]):
        raise AssertionError(f"ladder: degraded {d['degraded']}")
    os.replace(bad + ".kept", bad)
    t = time.perf_counter()
    heal = 0
    while store.quarantined.any():
        eng.step()
        heal += 1
        if heal > 4 * E:
            raise AssertionError("ladder: quarantine never healed")
    be.flush()
    t_heal = time.perf_counter() - t
    _same_lo_rows(be, clean_be)
    _check_ladder(be)
    h = _ladder_serve(eng, prompts)
    runs.append(h)
    if any(h["degraded"]) or h["tokens"] != clean["tokens"]:
        raise AssertionError("ladder: healed tokens differ from the "
                             "fault-free run's")
    st = be.stats()
    inj = be.injector
    log("ladder", f"quarantine: layer 1's lo shard unreadable: serving "
                  f"opened after {steps} windows with {E} cells quarantined "
                  f"(quarantines {store.stats['quarantines']}), all 8 "
                  f"requests flagged degraded (host fetches "
                  f"{st['host_fetches']:.0f}); shard restored, healed in "
                  f"{heal} windows ({t_heal:.2f} s), rows equal build_bank's"
                  f", tokens then equal the fault-free run's; retries "
                  f"{st['retries']:.0f}, stage_lo arrivals "
                  f"{inj.arrivals('stage_lo')} of which injected "
                  f"{inj.stats['injected']} | {card}")


def _ladder_host_tier(card, full, prompts, warm, pcie, runs) -> None:
    """(b) the host tier and sensitivity on SERVE_LAYERS full-width
    layers, then (c)
    faults on the same configuration."""
    import dataclasses
    from repro_torch.models.model import init_params
    from repro_torch.quant.sensitivity import model_sensitivity
    from repro_torch.serving.hoststore import FetchModel
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    params = init_params(cfg, seed=0, device=torch.device("cuda"))
    positions = _moe_positions(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sens = model_sensitivity(params, positions, lo_bits=4)
    torch.cuda.synchronize()
    t_sens = time.perf_counter() - t
    L, E = SERVE_LAYERS, cfg.moe.num_experts
    quota = L * E // 2
    fetch = FetchModel(gbps=pcie)
    # The same window without sensitivity: the hi sets it moves.
    plain = _ladder_engine(cfg, _fresh(params))
    _ladder_warm(plain, warm)
    h_plain = plain.backend.hi_sets()
    del plain
    weighted = _ladder_engine(cfg, _fresh(params), sensitivity=sens)
    _ladder_warm(weighted, warm)
    w = _ladder_serve(weighted, prompts)
    runs.append(w)
    h_sens = weighted.backend.hi_sets()
    del weighted
    host = _ladder_engine(cfg, _fresh(params), sensitivity=sens,
                          lo_resident_total=quota, fetch=fetch,
                          ecfg=dict(prefix_sharing=False))
    _ladder_warm(host, warm)
    x = _ladder_serve(host, prompts)
    runs.append(x)
    be = host.backend
    if be.hi_sets() != h_sens or x["tokens"] != w["tokens"]:
        raise AssertionError("ladder: the host tier changed the hi sets or "
                             "the tokens")
    _check_ladder(be)
    st = be.stats()
    overlap = sum(len(set(a) & set(b)) for p in h_sens
                  for a, b in zip(h_sens[p], h_plain[p]))
    n_hi = sum(len(s) for sets in h_sens.values() for s in sets)
    log("ladder", f"host tier: {cfg.name} {L} of {full.n_layers} layers; "
                  f"model_sensitivity on the card {t_sens:.2f} s "
                  f"({len(positions)} position, {L} x {E} experts); "
                  f"dynaexq(n_hi 16, sensitivity, lo_resident_total "
                  f"{quota}, fetch {pcie:.2f} GB/s, this card's pinned "
                  f"rate): tokens and hi sets equal dynaexq(n_hi 16, "
                  f"sensitivity) without the host tier; host_fetches "
                  f"{st['host_fetches']:.0f}, host_fetch_bytes "
                  f"{be._host_acct['host_fetch_bytes'] / 1e9:.3f} GB, "
                  f"modeled stall {host._stall_clock:.4f} s over the run "
                  f"(the engine's stall clock; stats' stall_s is "
                  f"{st['stall_s']:.1f} for dynaexq, as the reference's), "
                  f"lo_resident_frac "
                  f"{st['lo_resident_frac']:.3f}, device bytes "
                  f"{be.device_bytes() / 1e9:.3f} GB; hi sets with "
                  f"sensitivity share {overlap} of {n_hi} experts with "
                  f"plain dynaexq's after the same warm-up window | TTFT "
                  f"{x['ttft_s'] * 1e3:.1f} ms | {card}")
    del params
    _ladder_faults(card, host, prompts, x, h_sens, runs)


#: (c)'s plan: promotion copies fail (every 4th: absorbed by the retry),
#: stall 20 ms on the virtual clock (every 5th) or arrive corrupt (every
#: 7th, twice); demand host fetches fail every 3rd (retried, a second
#: transfer's stall). Staging faults are the quarantined cold start's.
LADDER_FAULTS = (
    dict(site="promo_copy", every=4),
    dict(site="promo_copy", kind="stall", every=5, start=1, stall_s=0.02),
    dict(site="promo_copy", kind="corrupt", every=7, start=2, max_fires=2),
    dict(site="host_fetch", every=3))


def _ladder_faults(card, eng, prompts, clean, clean_sets, runs) -> None:
    """(c) The host-tier engine of (b) again, under ``LADDER_FAULTS``: its
    hi experts demoted, then promotion windows on the virtual clock until
    every stalled copy published (as its stall expired) and every corrupt
    one was cancelled, with the failure decay off and (b)'s served traffic
    dropped from the hotness, so that the windows reach (b)'s hi sets;
    then the requests through ``replay(realtime=False)``."""
    from repro_torch.fault import FaultPlan, FaultRule
    be = eng.backend
    be.injector = FaultPlan(seed=11, rules=tuple(
        FaultRule(**r) for r in LADDER_FAULTS)).injector()
    be._propagate_faults()
    tms = [c.tm for c in be.controllers.values()]
    for ctl in be.controllers.values():
        ctl.fail_decay = 1.0
        ctl.hotness.counts[:] = 0
        L = ctl.tm.state.shape[0]
        ctl.apply_plan([], [(l, e) for l in range(L)
                            for e in ctl.tm.hi_set(l)])
    be.flush()
    if any(s for sets in be.hi_sets().values() for s in sets):
        raise AssertionError("ladder: hi experts left after the demotions")
    issued, held, early = [], [0], []
    issue = type(tms[0])._issue_copy
    publish = type(tms[0]).publish_ready

    def watched(tm, layer, expert, slot):
        ok = issue(tm, layer, expert, slot)
        if ok:
            issued.append(tm._pending[-1])
        return ok

    def watched_publish(tm, wait=False):
        # Copies still stalled before the sweep must still be pending
        # after it (a blocking flush publishes regardless; none runs here).
        stalled = [p for p in tm._pending if p.stall_until > tm.clock()]
        n = publish(tm, wait)
        left = {id(p) for p in tm._pending}
        early.extend(p for p in stalled if id(p) not in left)
        return n
    for tm in tms:
        tm._issue_copy = watched.__get__(tm)
        tm.publish_ready = watched_publish.__get__(tm)
    eng._clock = 0.0
    target, windows = None, 0
    while True:
        be.force_update()
        windows += 1
        while any(tm._pending for tm in tms):
            torch.cuda.synchronize()
            for tm in tms:
                tm.publish_ready()
            if any(p.stall_until > eng._clock for tm in tms
                   for p in tm._pending):
                held[0] += 1
            eng._clock += 0.005
            for tm in tms:
                tm.check_invariants()
        sets = be.hi_sets()
        if sets == target:
            break
        target = sets
        if windows > 8:
            raise AssertionError("ladder: the fault windows never settled")
    eng._clock = None
    for tm in tms:
        del tm._issue_copy, tm.publish_ready
    if be.hi_sets() != clean_sets:
        raise AssertionError("ladder: the fault windows settled on other "
                             "hi sets than the fault-free window")
    corrupt = [p for p in issued if p.corrupt]
    stalled = [p for p in issued if p.stall_until > 0]
    if not corrupt or not stalled:
        raise AssertionError(f"ladder: {len(corrupt)} corrupt and "
                             f"{len(stalled)} stalled copies")
    if early:
        raise AssertionError(f"ladder: {len(early)} stalled copies left "
                             f"the wire before their stall expired")
    if any(any(p is q for tm in tms for q in tm._pending) for p in stalled):
        raise AssertionError("ladder: a stalled copy never published")
    if not all(p.cancelled for p in corrupt):
        raise AssertionError("ladder: a corrupt copy was published")
    # A second cancel of a cancelled copy refunds nothing.
    tm = tms[0]
    used = tm.tracker.used
    tm._cancel_pending(corrupt[0])
    if tm.tracker.used != used:
        raise AssertionError("ladder: a second cancel refunded again")
    c = _ladder_serve(eng, prompts, virtual=True)
    runs.append(c)
    be.flush()
    _check_ladder(be)
    st = be.stats()
    keep = [i for i, dg in enumerate(c["degraded"]) if not dg]
    if any(c["tokens"][i] != clean["tokens"][i] for i in keep):
        raise AssertionError("ladder: a non-degraded request's tokens differ "
                             "from the fault-free run's")
    inj = be.injector
    arrivals = {s: inj.arrivals(s) for s in ("promo_copy", "host_fetch")}
    log("ladder", f"faults: (b)'s engine, its hi experts demoted: "
                  f"{len(issued)} promotion copies issued over {windows} "
                  f"windows on the virtual clock, {len(stalled)} stalled "
                  f"(none left the wire before the clock passed its stall, "
                  f"asserted at every publication sweep; {held[0]} sweeps "
                  f"found one still held), {len(corrupt)} "
                  f"corrupt and cancelled, never published; retries "
                  f"{st['retries']:.0f}, fault_cancels "
                  f"{st['fault_cancels']:.0f}, quarantined "
                  f"{st['quarantined']:.0f}, degraded requests "
                  f"{sum(c['degraded'])}; arrivals by site {arrivals}, "
                  f"{inj.stats['injected']} faults injected; invariants and "
                  f"exactly-once refunds hold; the {len(keep)} non-degraded "
                  f"requests' tokens equal the fault-free run's (replay, "
                  f"virtual clock) | {card}")


def phase_ladder(card: str) -> None:
    from repro_torch.configs import get_config
    full = get_config(ARCH)
    t0 = time.perf_counter()
    pcie = pinned_h2d_gbps()
    prompts, warm = _spec_prompts(full.vocab_size)
    runs: list = []
    t1 = time.perf_counter()
    _ladder_stream(card, full, prompts, runs)
    t2 = time.perf_counter()
    _ladder_host_tier(card, full, prompts, warm, pcie, runs)
    for k in RESULTS:
        RESULTS[k]["launches"] = RESULTS[k].get("launches", 0) + sum(
            r["launches"][k] for r in runs)
    log("ladder", f"phase done in {time.perf_counter() - t0:.1f} s (cold "
                  f"starts {t2 - t1:.1f} s, host tier and faults "
                  f"{time.perf_counter() - t2:.1f} s) | {card}")


# ---------------------------------------------------------------------------
# 5e. obs: the flight recorder, the metrics and the cost model on the card,
#     and the serving launcher
# ---------------------------------------------------------------------------

#: The reference launcher's default model, served through the launcher at
#: full width and depth (24 layers, d 1024, 32 experts top-8, hd 64).
OBS_ARCH = "granite-moe-1b-a400m"
OBS_LAUNCH = ("--full", "--batch", "8", "--prompt-len", "64",
              "--new-tokens", "32")
#: The launcher's two runs: its defaults (dynaexq, speculation on), and
#: static without speculation.
OBS_LAUNCH_RUNS = (("dynaexq", ("--backend", "dynaexq")),
                   ("static", ("--backend", "static", "--no-spec")))
#: The 30B main path with the recorder and registry off and on, in turns
#: on fresh engines.
OBS_TURNS = (False, True, True, False)
OBS_NEW = 32
OBS_MAX_LEN = 288              # 256-token prompts + 32 tokens


def _obs_launcher(card, tmp) -> list:
    """(a) ``repro_torch.launch.serve.main`` in this process on granite at
    full width and depth: the ragged FFN and paged attention kernels ran,
    the saved trace loads and folds, its published promotion spans are the
    backend's promotions, and the metrics file has one row per step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import costmodel, load_chrome_trace
    used, unused = PATHS["paged/ragged"][2:]
    runs = []
    for name, extra in OBS_LAUNCH_RUNS:
        trace = os.path.join(tmp, f"{name}.trace.json")
        rows = os.path.join(tmp, f"{name}.metrics.jsonl")
        ops.reset_launches()                 # the main path starts here
        t0 = time.perf_counter()
        out = serve.main(list(OBS_LAUNCH + extra) + [
            "--trace-out", trace, "--metrics-jsonl", rows])
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)        # ... and ends here
        secs = time.perf_counter() - t0
        if not all(launches[k] for k in used) or \
                any(launches[k] for k in unused):
            raise AssertionError(f"launcher {name}: launches {launches}")
        if any(len(t) != OBS_NEW for t in out["tokens"]):
            raise AssertionError(f"launcher {name}: token counts "
                                 f"{[len(t) for t in out['tokens']]}")
        obj = load_chrome_trace(trace)
        rep = costmodel.report(obj)
        steps = [e["args"]["step"] for e in obj["traceEvents"]
                 if e["name"] == "step"]
        sampled = [json.loads(line)["step"] for line in open(rows)]
        published = rep["promotions"]["n_published"]
        if rep["roofline"]["n_steps"] < 1 or sampled != steps or \
                obj["otherData"]["dropped_events"]:
            raise AssertionError(f"launcher {name}: "
                                 f"{rep['roofline']['n_steps']} folded "
                                 f"steps, {len(sampled)} metrics rows for "
                                 f"{len(steps)} steps")
        if published != out["stats"]["promotions"] or \
                (name == "dynaexq" and published < 1):
            raise AssertionError(f"launcher {name}: {published} published "
                                 f"spans, promotions "
                                 f"{out['stats']['promotions']}")
        log("obs", f"(a) launcher {OBS_ARCH} --full ({name}): "
                   f"{' '.join(OBS_LAUNCH + extra)} | {secs:.1f} s in "
                   f"process (weights drawn, banks built, graphs captured, "
                   f"served) | launches {launches} | trace {len(steps)} "
                   f"steps, {len(obj['traceEvents'])} events, "
                   f"{rep['roofline']['n_steps']} decode forwards folded; "
                   f"{published} promotion spans published = the backend's "
                   f"promotions; {len(sampled)} metrics rows | {card}")
        runs.append({"launches": launches})
    return runs


def _obs_overhead(card, cfg, params, prompts) -> list:
    """(b) The 30B main path, ``static`` graphed, with obs off and on in
    turns on fresh engines: identical tokens and launches; TPOT, the
    replay's device ms and the host's ms per step (TPOT - replay ms)
    reported, not gated."""
    from repro_torch.obs import ObsConfig, Observability
    dev = torch.device("cuda")
    kw = dict(new_tokens=OBS_NEW, max_slots=8, max_len=OBS_MAX_LEN,
              backend_kw=dict(lo_bits=4, group_size=64), paged=True,
              dispatch="ragged")
    runs = []
    for on in OBS_TURNS:
        obs = Observability(ObsConfig()) if on else None
        s = _serve_once(cfg, dev, params, prompts, "static", "graph",
                        obs=obs, **kw)
        s["obs"] = on
        s["host_ms"] = s["tpot_s"] * 1e3 - s["replay_ms"]
        log("obs", f"(b) {cfg.name} {cfg.n_layers} layers static graphed, "
                   f"obs {'on' if on else 'off'}: TPOT "
                   f"{s['tpot_s'] * 1e3:.3f} ms, replay "
                   f"{s['replay_ms']:.3f} ms, host {s['host_ms']:.3f} ms per "
                   f"step over {s['steps']} steps"
                   + (f"; {len(obs.tracer)} events" if on else "")
                   + f" | {card}")
        runs.append(s)
    first = runs[0]
    for s in runs[1:]:
        if s["tokens"] != first["tokens"] or \
                s["launches"] != first["launches"]:
            raise AssertionError("obs on and off served different tokens "
                                 "or launches")
    mean = lambda key, on: float(np.mean([s[key] for s in runs
                                          if s["obs"] == on]))
    log("obs", f"(b) obs off / on, mean of 2 each: TPOT "
               f"{mean('tpot_s', False) * 1e3:.3f} / "
               f"{mean('tpot_s', True) * 1e3:.3f} ms, replay "
               f"{mean('replay_ms', False):.3f} / "
               f"{mean('replay_ms', True):.3f} ms, host "
               f"{mean('host_ms', False):.3f} / {mean('host_ms', True):.3f} "
               f"ms per step; tokens and launches identical | {card}")
    return runs


def _obs_promotions(card, cfg, params, prompts) -> dict:
    """(c) ``dynaexq`` observed on the wall clock, a policy window every
    step and no flush until the end, so copies are in flight while replays
    run: every ``published=1`` span ends after its own copy's event
    completed; publish latency and the bytes/token residual reported."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import ObsConfig, Observability, costmodel
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    dev = torch.device("cuda")
    obs = Observability(ObsConfig())
    engine = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend(
            "dynaexq", lo_bits=4, group_size=64, n_hi_per_layer=16,
            device=dev, controller=ControllerConfig(update_interval_s=0.0)),
        eng_mod.EngineConfig(max_slots=8, max_len=OBS_MAX_LEN), device=dev,
        obs=obs)
    tms = [c.tm for c in engine.backend.controllers.values()]
    ended, end = [], obs.tracer.async_end

    def audited(name, span_id, cat="", **args):
        if name == "promotion" and args.get("published"):
            p = next(p for tm in tms for p in tm._pending
                     if p.seq == span_id)
            ended.append(p.event is not None and p.event.query())
        end(name, span_id, cat, **args)

    obs.tracer.async_end = audited
    ops.reset_launches()                     # the main path starts here
    handles = [engine.submit(Request(tokens=p, max_new_tokens=OBS_NEW))
               for p in prompts]
    pending_steps = steps = 0
    while engine.queue or any(h is not None for h in engine.slots):
        pending_steps += any(tm._pending for tm in tms)
        steps += 1
        engine.step()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)            # ... and ends here
    in_flight = sum(len(tm._pending) for tm in tms)
    engine.flush()
    st = engine.stats()
    prom = costmodel.promotion_report(obs.tracer)
    roof = costmodel.residual_report(obs.tracer)
    snap = obs.metrics.snapshot()
    if not ended or not all(ended) or len(ended) != st["promotions"] or \
            prom["n_published"] != st["promotions"] or \
            snap["promotion_publish_latency_seconds_count"] != len(ended):
        raise AssertionError(f"dynaexq: {len(ended)} published span ends, "
                             f"{sum(ended)} after their copy completed; "
                             f"promotions {st['promotions']}")
    if pending_steps < 1 or any(len(t.tokens) != OBS_NEW for t in handles):
        raise AssertionError("dynaexq: no step ran with copies in flight")
    for tm in tms:
        tm.check_invariants()
    buckets = "; ".join(
        f"{b['tokens']:g} tok, {b['hi_per_layer']:g} hi/layer: "
        f"{b['measured_bpt']:.0f} vs {b['predicted_bpt']:.0f} B/token "
        f"({b['rel_residual']:+.4f}, {b['n_steps']} steps)"
        for b in roof["buckets"])
    log("obs", f"(c) {cfg.name} {cfg.n_layers} layers dynaexq (n_hi 16, a "
               f"window every step, wall clock), graphed, no flush until the "
               f"end: {prom['n_published']} promotions published, "
               f"{prom['n_cancelled']} cancelled, every published span "
               f"ended after its copy's event completed; {pending_steps} of "
               f"{steps} steps began with copies in flight, {in_flight} "
               f"still in flight at the end; publish latency p50 "
               f"{prom['publish_latency_p50_s'] * 1e3:.3f} ms, p95 "
               f"{prom['publish_latency_p95_s'] * 1e3:.3f} ms, max "
               f"{prom['publish_latency_max_s'] * 1e3:.3f} ms (histogram "
               f"p50 {snap['promotion_publish_latency_seconds_p50'] * 1e3:.3f}"
               f" ms); bytes/token residual over {roof['n_steps']} decode "
               f"forwards: mean |r| {roof['mean_abs_rel_residual']:.4f}, "
               f"max {roof['max_abs_rel_residual']:.4f}; by bucket: "
               f"{buckets} | launches {launches} | {card}")
    return {"launches": launches}


def phase_obs(card: str) -> None:
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    card_dev = torch.device("cuda")
    granite = get_config(OBS_ARCH)
    check_model("obs", dataclasses.replace(granite, n_layers=CHECK_LAYERS),
                "paged/ragged, CPU vs card", "cpu", card_dev, paged=True,
                dispatch="ragged")
    t1 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        runs += _obs_launcher(card, tmp)
    t2 = time.perf_counter()
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    params = init_params(cfg, seed=0, device=card_dev)
    prompts = serving_prompts(cfg.vocab_size, 8, (64, 256))
    runs += _obs_overhead(card, cfg, params, prompts)
    runs.append(_obs_promotions(card, cfg, params, prompts))
    del params
    for k in RESULTS:
        RESULTS[k]["launches"] = RESULTS[k].get("launches", 0) + sum(
            r["launches"][k] for r in runs)
    log("obs", f"phase done in {time.perf_counter() - t0:.1f} s (model "
               f"check {t1 - t0:.1f} s, launcher {t2 - t1:.1f} s, 30B "
               f"{time.perf_counter() - t2:.1f} s) | {card}")


# ---------------------------------------------------------------------------
# 5b. hybrid: Jamba-v0.1 (Mamba/attention super-blocks) on the main path
# ---------------------------------------------------------------------------

#: The hybrid family: Jamba-v0.1-52B at full width (d 4096, 16 experts x
#: 14336 top-2, SSD d_state 16, attention 32/8 x 128, window 8192), depth
#: cut to one super-block of 8 of its 32 layers (bf16 experts 22.5 GB, not
#: 90 GB; the model's 104 GB of bf16 do not fit one 80 GB card).
JAMBA = "jamba-v0_1-52b"
JAMBA_LAYERS = 8
#: The ring run's window, cut from 8192 so that prompts and decode wrap it.
JAMBA_RING = 256
#: The model check's window and prompts: a 192-token prompt (three SSD
#: chunks) wraps a 128-slot ring, and a 48-token one stays inside it. Half
#: the ring run's, for the CPU's forwards, the longest part of a whole run.
HYBRID_CHECK_RING = 128
HYBRID_CHECK_PROMPTS = (192, 48)
HYBRID_NEW = 32
HYBRID_SLOTS = 8
HYBRID_MAX_LEN = 288           # 256-token prompts + 32 tokens
HYBRID_RING_PROMPTS = (300, 380)
HYBRID_RING_MAX_LEN = 448      # 380-token prompts + 32, whole SSD chunks
#: Hi slots per MoE layer that dynaexq's hbm_gb envelope leaves.
HYBRID_N_HI = 4
#: Decode steps served before the forced preemption.
HYBRID_PREEMPT_AT = 8
#: The quantized ragged kernels' A/B against the parent (with --parent):
#: Qwen3-30B-A3B and the flagship at decode B=8, int4 / int2.
HYBRID_AB = ((ARCH, 4, 8), (FLAGSHIP, 2, 8))


def _jamba(window=None):
    """(the full config, the served one: JAMBA_LAYERS layers, ``window``
    in place of the model's when given)."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    if window is not None:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, sliding_window=window))
    return full, cfg


def _hybrid_attention(full, gen, dev) -> list:
    """The paged decode attention at Jamba's heads (H 32, Hkv 8, hd 128:
    rep 4), B=8, rows past a ring's wrap: the model's 8192 window over a
    512-block ring (every slot valid once wrapped), and a 250 window over
    a 16-block ring (the slots of positions past the window masked at the
    wrap point); against the plain version and SDPA over the gathered
    view."""
    import dataclasses
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import (PagedKVCache, decode_valid,
                                           paged_view)
    H, Hkv, hd, bt, B = full.attn.n_heads, full.attn.n_kv_heads, \
        full.attn.head_dim, 16, 8
    cases = []
    for case, nb, window, lo, hi in (
            ("jamba B=8 window 8192 wrapped, nb=512", 512, 8192, 8192,
             12000),
            ("jamba B=8 window 250 ring, nb=16", 16, 250, 256, 700)):
        acfg = dataclasses.replace(full.attn, sliding_window=window)
        N = 1 + B * nb
        k = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randn((B, H, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        table = (1 + torch.randperm(N - 1, generator=gen, device=dev)
                 ).to(torch.int32).reshape(B, nb)
        pos = torch.randint(lo, hi, (B,), generator=gen, device=dev)
        valid = decode_valid(pos, nb * bt, acfg)
        kl, vl = paged_view(PagedKVCache(k, v), table)
        kl = kl.repeat_interleave(H // Hkv, dim=1)
        vl = vl.repeat_interleave(H // Hkv, dim=1)

        def lib(q=q, kl=kl, vl=vl, m=valid):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], kl, vl, attn_mask=m[:, None, None, :])

        n_blocks = int(valid.reshape(B, nb, bt).any(-1).sum().item())
        n_valid = int(valid.sum().item())
        nbytes = q.numel() * 2 * 2 + n_blocks * 2 * Hkv * bt * hd * 2 + \
            table.numel() * 4 + valid.numel()
        cases.append(_attn_case(
            "flash_decode_paged", case,
            lambda q=q, k=k, v=v, t=table, m=valid:
                ops.flash_decode_paged(q, k, v, t, m),
            lambda q=q, k=k, v=v, t=table, m=valid:
                ref.flash_decode_paged_ref(q, k, v, t, m),
            lib, nbytes, 4 * n_valid * H * hd, [], _n_split(B, Hkv, nb)))
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash_decode_paged disagrees: {bad}")
    return cases


def _hybrid_kernels() -> dict:
    """(a) The kernels of the hybrid main path at Jamba's shapes, each held
    against its plain version on the card to 2^-6 x max|plain| (attention:
    2^-7): the quantized ragged FFN (rows 1-2; int4 g=64, a 4-slot hi pool
    all owned; K = 4096 -> F = 14336 -> D = 4096, so down walks K = 14336
    in two pieces) at decode B=8 top-2 and prefill 512; its all-hi mode
    (row 7) on the dense bf16 bank at both shapes beside one
    ``torch._grouped_mm``; the paged decode attention (row 3). Returns
    {"ffn", "dense", "attn"}."""
    from repro_torch.kernels import ops
    from repro_torch.models.moe import (RAGGED_BM, _sort_routing,
                                        ragged_tile_map)
    from repro_torch.quant.qtensor import quantize
    full, _ = _jamba()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8080)
    E, K, F = full.moe.num_experts, full.d_model, full.moe.d_ff_expert
    tol = 2.0 ** -6
    dense = {n: (torch.randn((E,) + s, generator=gen, device=dev)
                 * s[0] ** -0.5).to(torch.bfloat16)
             for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                          ("w_down", (F, K)))}
    hi_w = {n: (torch.randn((HYBRID_N_HI,) + tuple(w.shape[1:]),
                            generator=gen, device=dev) * w.shape[1] ** -0.5
                ).to(torch.bfloat16) for n, w in dense.items()}
    owner = torch.randperm(E, generator=gen, device=dev)[:HYBRID_N_HI].to(
        torch.int32)
    lo = {n: quantize(w, 4, 64) for n, w in dense.items()}
    log("hybrid", f"ragged FFN pieces of K at Jamba's shapes: gate/up K={K}"
                  f" in {-(-(K // 64) // ops.ragged_piece(2, K, 64))} "
                  f"piece(s), down K={F} in "
                  f"{-(-(F // 64) // ops.ragged_piece(1, F, 64))} of "
                  f"{ops.ragged_piece(1, F, 64)} groups "
                  f"({ops.ragged_smem_bytes(1, 64, ops.ragged_piece(1, F, 64))}"
                  f" B of shared memory)")
    ffn = {key: _ffn_case(f"jamba int4 {what} top-2 of 16, F={F}", gen, dev,
                          bits=4, T=T, lo_w=lo, hi_w=hi_w, slot_owner=owner,
                          tol_rel=tol, top_k=full.moe.top_k)
           for key, T, what in (("decode", 8, "decode B=8"),
                                ("prefill", 512, "prefill 512"))}
    del lo, hi_w
    bad = [k for k, c in ffn.items() if not c["ok"]]
    if bad or not any(c["hi_tiles"] for c in ffn.values()):
        raise AssertionError(f"ragged FFN at Jamba's shapes: {bad} (or no "
                             f"hi tile)")
    dcases = {}
    for key, T in (("decode", 8), ("prefill", 512)):
        idx = torch.topk(torch.randn((T, E), generator=gen, device=dev),
                         full.moe.top_k, dim=-1).indices
        _, _, counts, _, _ = _sort_routing(idx, E)
        _, tile_eid, n_tiles = ragged_tile_map(counts, RAGGED_BM,
                                               T * full.moe.top_k)
        xs = torch.randn((tile_eid.shape[0] * RAGGED_BM, K), generator=gen,
                         device=dev).to(torch.bfloat16)
        dcases[key] = _dense_ffn_case(
            f"{JAMBA} {'decode B=8' if T == 8 else f'prefill {T}'} top-2 of "
            f"16, F={F}", dense,
            dict(xs=xs, tile_eid=tile_eid, n_tiles=n_tiles, counts=counts),
            tol_rel=tol)
    del dense
    bad = [k for k, c in dcases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"all-hi kernels at Jamba's shapes: {bad}")
    attn = _hybrid_attention(full, gen, dev)
    return {"ffn": ffn, "dense": dcases, "attn": attn}


def _hybrid_results(k) -> None:
    """The hybrid phase's kernel numbers into ``RESULTS``: each kernel's
    entry gains a "hybrid" list of its Jamba cases; a kernel whose entry
    the kernels phase did not make (``--only card,build,hybrid``) gets one
    from its Jamba decode case."""
    src = "src/repro_torch/kernels/csrc/"
    rows = {"ragged_gateup": ("ffn", "gateup", src + "ragged_ffn.cu",
                              "src/repro/kernels/quant_matmul.py:185"),
            "ragged_down": ("ffn", "down", src + "ragged_ffn.cu",
                            "src/repro/kernels/quant_matmul.py:236"),
            "ragged_dense_gateup": ("dense", "gateup",
                                    src + "ragged_dense_ffn.cu",
                                    "src/repro/kernels/ops.py:131"),
            "ragged_dense_down": ("dense", "down",
                                  src + "ragged_dense_ffn.cu",
                                  "src/repro/kernels/ops.py:131")}
    keys = ("err", "tol", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms")
    for name, (group, part, source, replaces) in rows.items():
        cases = [dict(case=c["case"], tiles=c["tiles"],
                      **{x: c[part].get(x) for x in keys})
                 for c in k[group].values()]
        d = cases[0]
        RESULTS.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(c["err"] for c in cases), "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "graph_ms": d["graph_ms"]})["hybrid"] = cases
    cases = [{x: c[x] for x in ("case", "n_split", "err", "tol", "ms",
                                "graph_ms", "plain_ms", "library_ms",
                                "library_graph_ms", "bound_ms", "bound_by")}
             for c in k["attn"]]
    d = cases[0]
    RESULTS.setdefault("flash_decode_paged", {
        "name": "flash_decode_paged", "route": "cuda",
        "source": src + "flash_decode_paged.cu",
        "replaces": "src/repro/kernels/flash_decode.py:92", "launches": 0,
        "max_abs_err": max(c["err"] for c in cases), "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "graph_ms": d["graph_ms"]})["hybrid"] = cases


def _hybrid_ab(parent) -> None:
    """With ``--parent``: the quantized ragged kernels of the parent tree
    and this one at today's decode shapes (``HYBRID_AB``), in turns,
    bit-equal (a K that fits one piece sums in the parent's order), with
    both trees' registers and HMMA instructions per instantiation."""
    from repro_torch.kernels import build
    libs, paths = _parent_library(pathlib.Path(parent))
    sp = _sass_summary(paths["ragged_ffn"])
    sm = _sass_summary(build._target("ragged_ffn"))
    log("hybrid", "ragged_ffn_kernel (nmat, bits) registers / HMMA, parent "
                  "vs change: " + ", ".join(
                      f"{k} {sp[k].get('regs')}/{sp[k].get('hmma')} vs "
                      f"{sm.get(k, {}).get('regs')}/"
                      f"{sm.get(k, {}).get('hmma')}" for k in sorted(sp)))
    _quant_ab(libs["ragged_ffn"], HYBRID_AB, "hybrid")


def _hybrid_kv_bytes(cfg) -> int:
    """The KV pool of an engine of ``HYBRID_SLOTS`` x ``HYBRID_MAX_LEN``
    on ``cfg`` (its attention position only), as the engine sizes it."""
    from repro_torch.models.model import attn_logical_capacity, \
        attn_positions
    bt = 16
    nb = attn_logical_capacity(cfg, HYBRID_MAX_LEN, bt) // bt
    return (1 + HYBRID_SLOTS * nb) * bt * 2 * cfg.attn.n_kv_heads * \
        cfg.attn.head_dim * 2 * len(attn_positions(cfg)) * \
        cfg.n_superblocks()


def _hybrid_preempt(cfg, params, prompts, want) -> dict:
    """(c) One paged/ragged ``static`` run, graphed, with the first
    running request preempted after ``HYBRID_PREEMPT_AT`` decode steps
    (its K/V lanes and its Mamba rows to the host) and resumed by the next
    step's admission; every request's tokens must equal ``want``, the
    uninterrupted run's."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    dev = torch.device("cuda")
    engine = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend("static", lo_bits=4, device=dev),
        eng_mod.EngineConfig(max_slots=HYBRID_SLOTS,
                             max_len=HYBRID_MAX_LEN), device=dev)
    ops.reset_launches()                     # the main path starts here
    handles = [engine.submit(Request(tokens=p, max_new_tokens=HYBRID_NEW))
               for p in prompts]
    victim = None
    while engine.queue or any(h is not None for h in engine.slots):
        engine.step()
        if victim is None and engine.counters["steps"] == HYBRID_PREEMPT_AT:
            victim = next(h for h in engine.slots if h is not None)
            engine.preempt(victim)
            if victim._snapshot.mamba_rows is None:
                raise AssertionError("preemption kept no Mamba rows")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)            # ... and ends here
    got = [list(h.tokens) for h in handles]
    if engine.counters["preemptions"] != 1 or \
            engine.counters["resumes"] != 1 or got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"preempted run: counters "
                             f"{engine.counters['preemptions']}/"
                             f"{engine.counters['resumes']}, requests {bad} "
                             f"differ from the uninterrupted run")
    out = {"launches": launches, "victim": victim.id,
           "tpot_s": engine.stats()["tpot_s"]}
    del engine
    gc.collect()
    return out


def _serve_line(what, s, card) -> None:
    log("hybrid", f"{what} {s['mode']}: {len(s['tokens'])} requests x "
                  f"{HYBRID_NEW} tokens | TTFT {s['ttft_s'] * 1e3:.1f} ms "
                  f"TPOT {s['tpot_s'] * 1e3:.2f} ms "
                  f"{s['tokens_per_s']:.1f} tok/s (wall) | replay ms "
                  f"{_ms(s['replay_ms'])} over {s['replays']} replays | "
                  f"device_bytes {s['expert_bytes']} | promotions "
                  f"{s['promotions']:.0f} | modeled stall "
                  f"{s['stall_s']:.4f} s"
                  + (f", hits {s['hits']:.0f} misses {s['misses']:.0f}"
                     if s.get("hits") is not None else "")
                  + f" | max allocated {s['max_mem'] / 1e9:.2f} GB | "
                  f"launches {s['launches']} | built in "
                  f"{s['build_s']:.1f} s, served in {s['wall_s']:.1f} s | "
                  f"{card}")


def _same_by_routing(a, b, what) -> int:
    """Two runs' tokens held by routing first: the requests whose
    per-request expert counts agree must be at least half of them, and
    each must have equal tokens. Returns how many routed alike."""
    same = [i for i, (x, y) in enumerate(zip(a["experts"], b["experts"]))
            if all(np.array_equal(x[k], y[k]) for k in x)]
    bad = [i for i in same if a["tokens"][i] != b["tokens"][i]]
    if bad or 2 * len(same) < len(a["tokens"]):
        raise AssertionError(f"{what}: {len(same)} of {len(a['tokens'])} "
                             f"requests routed alike (at least half must), "
                             f"of those {bad} have other tokens")
    return len(same)


def _hybrid_serving(card, cfg, params, pcie) -> list:
    """(c) The 8-layer Jamba served on its main path (paged KV, ragged
    dispatch, graphed; 8 requests of 64-256 tokens, 32 new, greedy, 8
    slots) by ``static`` int4 (graph, then eager: identical tokens and
    launches), ``dynaexq`` (int4 lo, bf16 hi, an ``hbm_gb`` envelope for
    ``HYBRID_N_HI`` hi slots per MoE layer, a policy window every step, no
    flush until the end, observed: every published promotion ended after
    its copy's event completed), ``fp16`` and ``offload`` (its cache sized
    to dynaexq's ``device_bytes()``, at this card's pinned rate; the same
    tokens as fp16); then ``static`` on dense rows with padded dispatch
    (graph, eager); then the forced preemption. Returns the main path's
    runs."""
    from repro_torch.obs import ObsConfig, Observability
    from repro_torch.serving.backends import OffloadConfig
    from repro_torch.models.model import mamba_positions
    dev = torch.device("cuda")
    prompts = serving_prompts(cfg.vocab_size, HYBRID_SLOTS, (64, 256))
    kw = dict(new_tokens=HYBRID_NEW, max_slots=HYBRID_SLOTS,
              max_len=HYBRID_MAX_LEN)
    paged = dict(kw, paged=True, dispatch="ragged")
    static = dict(lo_bits=4, group_size=64)
    runs = {}
    for mode in ("graph", "eager"):
        runs[f"static {mode}"] = _serve_once(cfg, dev, params, prompts,
                                             "static", mode,
                                             backend_kw=static, **paged)
    hbm = _envelope_gb(params, _hybrid_kv_bytes(cfg), HYBRID_N_HI, lo_bits=4)
    torch.cuda.empty_cache()     # the lo tier's quantization takes 7 GB

    obs = Observability(ObsConfig())
    runs["dynaexq"] = _serve_once(
        cfg, dev, params, prompts, "dynaexq", "free",
        backend_kw=dict(lo_bits=4, group_size=64, hbm_gb=hbm), obs=obs,
        audit=True, **paged)
    obs.close()
    del obs              # its recorder's clock refers to the engine
    gc.collect()
    runs["fp16"] = _serve_once(cfg, dev, params, prompts, "fp16", "graph",
                               backend_kw={}, **paged)
    moe_layers = len(_moe_positions(cfg)) * cfg.n_superblocks()
    expert_bytes = 3 * cfg.d_model * cfg.moe.d_ff_expert * 2
    cache = runs["dynaexq"]["expert_bytes"] // (moe_layers * expert_bytes)
    runs["offload"] = _serve_once(
        cfg, dev, params, prompts, "offload", "graph",
        backend_kw=dict(ocfg=OffloadConfig(
            cache_experts_per_layer=int(cache), pcie_gbps=pcie)), **paged)
    dense = dict(kw, paged=False, dispatch="padded")
    for mode in ("graph", "eager"):
        runs[f"static dense {mode}"] = _serve_once(
            cfg, dev, params, prompts, "static", mode, backend_kw=static,
            **dense)
    for what, s in runs.items():
        _serve_line(f"{cfg.name} {cfg.n_layers} layers "
                    + ("dense/padded" if "dense" in what else "paged/ragged")
                    + f" {what.split()[0]}", s, card)
    used = {"paged": PATHS["paged/ragged"][2],
            "dense": PATHS["dense/padded"][2]}
    for what, s in runs.items():
        want = BASELINE_PATHS["paged/ragged"][0] if what in ("fp16",
                                                             "offload") \
            else used["dense" if "dense" in what else "paged"]
        if not all(s["launches"][k] > 0 for k in want):
            raise AssertionError(f"{what}: a kernel of its path never ran: "
                                 f"{s['launches']}")
    for a, b in (("static graph", "static eager"),
                 ("static dense graph", "static dense eager")):
        if runs[a]["tokens"] != runs[b]["tokens"] or \
                runs[a]["launches"] != runs[b]["launches"]:
            raise AssertionError(f"{a} and {b} disagree on tokens or "
                                 f"launches")
    if runs["fp16"]["tokens"] != runs["offload"]["tokens"]:
        raise AssertionError("fp16 and offload disagree on tokens")
    d = runs["dynaexq"]
    ok, total = d["published_after_event"]
    if not (d["promotions"] >= 1 and d["hi_routed"] >= 1 and ok == total
            >= 1 and d["pending_steps"] >= 1):
        raise AssertionError(f"dynaexq: promotions {d['promotions']}, "
                             f"served from hi {d['hi_routed']}, published "
                             f"after their event {ok}/{total}, steps with "
                             f"copies pending {d['pending_steps']}")
    if not runs["offload"]["stall_s"] > 0:
        raise AssertionError("offload modeled no stall")
    same = _same_by_routing(runs["static graph"], runs["static dense graph"],
                            "paged/ragged and dense/padded")
    log("hybrid", f"graphed = eager (tokens and launches) on both paths; "
                  f"fp16 = offload; dynaexq (hbm_gb {hbm:.3f}: n_hi "
                  f"{d['n_hi']}, {d['slots']} slots per layer) published "
                  f"{ok} promotions, each after its copy's event completed, "
                  f"{d['hi_routed']} routed cells served from hi, "
                  f"{d['pending_steps']} of {d['steps']} steps began with "
                  f"copies pending; offload at {pcie:.2f} GB/s (this "
                  f"card's pinned copy rate), its cache {int(cache)} "
                  f"experts per layer = dynaexq device_bytes "
                  f"{d['expert_bytes']} // ({moe_layers} x {expert_bytes}); "
                  f"paged/ragged vs dense/padded: {same} of "
                  f"{len(prompts)} requests routed alike, their tokens "
                  f"equal; Mamba positions {mamba_positions(cfg)} | {card}")
    pre = _hybrid_preempt(cfg, params, prompts, runs["static graph"]["tokens"])
    log("hybrid", f"paged static graphed, request {pre['victim']} preempted "
                  f"after {HYBRID_PREEMPT_AT} decode steps (K/V lanes and "
                  f"Mamba rows to the host) and resumed: every request's "
                  f"tokens equal the uninterrupted run's | TPOT "
                  f"{pre['tpot_s'] * 1e3:.2f} ms | {card}")
    return [runs["static graph"], runs["dynaexq"], runs["fp16"],
            runs["offload"], pre]


#: (d') The residency ladder's options on a ring run of Jamba, on the card
#: and in the CPU process from the same expert shards: the full width, its
#: depth cut to one super-block of 2 layers (Mamba; attention with the
#: MoE: the shards of 1 MoE layer, ~15.5 GB on disk in the reference's
#: float32, where 8 layers' would be ~53 GB), the window to
#: ``HYBRID_LADDER_RING``.
HYBRID_LADDER_RING = 64
#: 2 requests of 72-96 tokens (each wraps the ring), 8 new, 2 slots.
HYBRID_LADDER_PROMPTS = (72, 96)
HYBRID_LADDER_ROWS = 2
HYBRID_LADDER_NEW = 8
HYBRID_LADDER_MAX_LEN = 128     # 96 + 8 tokens, whole SSD chunks
#: Hi slots, lo-resident cells of the 16 (the rest on the host tier) and
#: experts staged per cold-start window.
HYBRID_LADDER_N_HI = 4
HYBRID_LADDER_LO_RESIDENT = 10
HYBRID_LADDER_PER_TICK = 4
#: The forced window's counts: (1 layer, 16 experts).
HYBRID_LADDER_WARM = np.array([[40.0, 5.0, 30.0, 10.0, 25.0, 1.0, 2.0, 3.0,
                                20.0, 4.0, 6.0, 7.0, 8.0, 9.0, 11.0, 12.0]])
#: The ladder's stats that routing does not move.
HYBRID_LADDER_STATS = ("retries", "fault_cancels", "quarantined",
                       "promotions", "hi_loads", "lo_resident_frac")


def _hybrid_ladder_plan():
    """Every third lo staging of the cold start fails once (retried); the
    first 4 promotion copies fail: the first promotion's 3 attempts (it
    is cancelled and serves lo) and the second's first (retried), so that
    the other promotions land and serve hi."""
    from repro_torch.fault.inject import FaultPlan, FaultRule
    return FaultPlan(seed=5, rules=(
        FaultRule(site="stage_lo", kind="fail", every=3),
        FaultRule(site="promo_copy", kind="fail", every=1, max_fires=4)))


def _hybrid_ladder_cfg():
    import dataclasses
    full, _ = _jamba()
    return full, dataclasses.replace(
        full, n_layers=2, superblock=("mamba", "attn"), moe_positions=(1,),
        attn=dataclasses.replace(full.attn,
                                 sliding_window=HYBRID_LADDER_RING))


def _hybrid_ladder_run(cfg, root, dev, prompts, gbps, force=None) -> dict:
    """``dynaexq`` from the expert shards at ``root`` on ``dev``, paged/
    ragged: the streaming cold start (``HYBRID_LADDER_PER_TICK`` experts
    per window) to ``serving_ready``, the host tier
    (``HYBRID_LADDER_LO_RESIDENT`` lo-resident cells, fetches priced at
    ``gbps``) and ``_hybrid_ladder_plan``; one forced window on
    ``HYBRID_LADDER_WARM``, flushed; then the policy frozen and
    ``prompts`` served greedy, each position's top ``FAMILY_TOP_K`` logits
    recorded (the prefill's too), fed ``force`` (tokens per prompt) where
    given (``_family_margin``'s teacher forcing). On the card the counts
    are zeroed just before the requests and read after them."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.hoststore import FetchModel
    from repro_torch.serving.requests import Request
    from repro_torch.serving.streaming import load_streaming_params
    be = make_backend(
        "dynaexq", device=dev, lo_bits=4, group_size=64,
        n_hi_per_layer=HYBRID_LADDER_N_HI,
        lo_resident_total=HYBRID_LADDER_LO_RESIDENT,
        fetch=FetchModel(gbps=gbps), fault=_hybrid_ladder_plan(),
        stream=root, stream_experts_per_tick=HYBRID_LADDER_PER_TICK,
        controller=ControllerConfig(update_interval_s=1e9))
    eng = eng_mod.InferenceEngine(
        cfg, load_streaming_params(root, device=dev), be,
        eng_mod.EngineConfig(max_slots=HYBRID_LADDER_ROWS,
                             max_len=HYBRID_LADDER_MAX_LEN, paged=True,
                             moe_dispatch="ragged"), device=dev)
    if be.serving_ready():
        raise AssertionError("hybrid ladder: serving ready before any "
                             "window")
    be.flush()
    if not be.serving_ready():
        raise AssertionError("hybrid ladder: not ready after the flush")
    out = {"read": dict(be.stream.stats),
           "ready_retries": be.stats()["retries"]}
    for ctl in be.controllers.values():
        ctl.observe(HYBRID_LADDER_WARM)
    be.force_update()
    be.flush()
    st = be.stats()
    out.update(
        hi_sets=be.hi_sets(),
        lo_resident={p: s.lo_resident.copy() for p, s in be.stores.items()},
        quarantined={p: s.quarantined.copy() for p, s in be.stores.items()},
        window={k: st[k] for k in HYBRID_LADDER_STATS},
        host_master_bytes=be.host_master_bytes())
    entry, first, decode = eng_mod.prefill_paged, eng._first_token, \
        eng._decode_one
    forced, recs, own, pre = {}, [], {}, {}

    def prefill_seen(*a, **k):
        res = entry(*a, **k)
        pre["logits"] = res[0]
        return res

    def emit(h, slot):
        own[(h.id, len(h.tokens) - 1)] = h.tokens[-1]
        if h.id in forced:
            h.tokens[-1] = forced[h.id][len(h.tokens) - 1]
            if eng.slots[slot] is h:
                eng.tokens[slot] = h.tokens[-1]

    def first_seen(h, slot, plen, r, *a):
        top = pre["logits"][r].float().topk(FAMILY_TOP_K)
        recs.append((top.values[None], top.indices[None], [(h.id, 0, 0)]))
        first(h, slot, plen, r, *a)
        emit(h, slot)

    def decode_seen(active, finished, lo=False):
        decode(active, finished, lo)
        top = eng.last_logits.float().topk(FAMILY_TOP_K, dim=-1)
        recs.append((top.values, top.indices,
                     [(h.id, len(h.tokens) - 1, i) for i, h in active]))
        for i, h in active:
            emit(h, i)

    eng_mod.prefill_paged = prefill_seen
    eng._first_token, eng._decode_one = first_seen, decode_seen
    card = dev.type == "cuda"
    try:
        if card:
            torch.cuda.synchronize()
            ops.reset_launches()                 # the path starts here
        hs = [eng.submit(Request(tokens=p, max_new_tokens=HYBRID_LADDER_NEW))
              for p in prompts]
        if force is not None:
            forced = {h.id: f for h, f in zip(hs, force)}
        eng.drain()
        if card:
            torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES) if card else {}    # ... and ends here
    finally:
        eng_mod.prefill_paged = entry
    if not all(len(h.tokens) == HYBRID_LADDER_NEW for h in hs):
        raise AssertionError(f"hybrid ladder: {[len(h.tokens) for h in hs]}"
                             f" tokens")
    top = {}
    for v, ids, rows in recs:
        v, ids = v.cpu(), ids.cpu()
        for rid, t, i in rows:
            top[(rid, t)] = {"v": v[i].tolist(), "ids": ids[i].tolist()}
    if not all(np.isfinite(r["v"]).all() for r in top.values()):
        raise AssertionError("hybrid ladder: non-finite logits")
    st = be.stats()
    out.update(tokens=[list(h.tokens) for h in hs], ids=[h.id for h in hs],
               own=own, top=top, launches=launches,
               served={k: st[k] for k in HYBRID_LADDER_STATS},
               host_fetches=st["host_fetches"], hi_routed=be.hi_routed)
    return out


def _hybrid_ladder_cpu(force) -> dict:
    """The CPU half of (d'): ``_hybrid_ladder_run`` on the host from the
    card's shards, fed the card's tokens (``force``: the shard directory,
    the prompts, the fetch rate and the card's tokens)."""
    _, cfg = _hybrid_ladder_cfg()
    return _hybrid_ladder_run(cfg, force["root"], torch.device("cpu"),
                              [torch.tensor(p) for p in force["prompts"]],
                              force["gbps"], force=force["tokens"])


def _twin_hybrid_ladder():
    """The CPU process's twin of (d'): nothing to draw (its weights are
    the shards the card writes), fed the card run's inputs."""
    return _hybrid_ladder_cpu


#: The hybrid phase's CPU twin the CPU process runs (``MM_TWINS``' form).
HYBRID_TWINS = {"hybrid ladder": _twin_hybrid_ladder}


def _hybrid_ring(card, params) -> list:
    """(d) The same 8 layers and weights with the window cut to
    ``JAMBA_RING``: 8 requests of 300-380 tokens, 32 new, served graphed by
    ``static`` on paged/ragged (a 256-slot ring of blocks) and on dense
    rows/padded (a 256-slot ring row), held to each other by routing first
    (at least half the requests route alike, and those have equal tokens);
    the ring against the CPU, on both layouts, is the phase's model
    check.
    Returns the paged run."""
    _, cfg = _jamba(window=JAMBA_RING)
    dev = torch.device("cuda")
    prompts = serving_prompts(cfg.vocab_size, HYBRID_SLOTS,
                              HYBRID_RING_PROMPTS, seed=5)
    kw = dict(new_tokens=HYBRID_NEW, max_slots=HYBRID_SLOTS,
              max_len=HYBRID_RING_MAX_LEN, backend_kw=dict(lo_bits=4))
    pg = _serve_once(cfg, dev, params, prompts, "static", "graph",
                     paged=True, dispatch="ragged", **kw)
    dn = _serve_once(cfg, dev, params, prompts, "static", "graph",
                     paged=False, dispatch="padded", **kw)
    for what, s in (("paged/ragged", pg), ("dense/padded", dn)):
        _serve_line(f"ring {JAMBA_RING} {what} static", s, card)
    if pg["kv_bytes"] is None or not all(
            pg["launches"][k] > 0 for k in PATHS["paged/ragged"][2]):
        raise AssertionError(f"ring paged: launches {pg['launches']}")
    same = _same_by_routing(pg, dn, f"ring {JAMBA_RING} on both layouts")
    log("hybrid", f"ring {JAMBA_RING}: prompts "
                  f"{HYBRID_RING_PROMPTS[0]}-{HYBRID_RING_PROMPTS[1]} + "
                  f"{HYBRID_NEW} tokens wrap it on both layouts; "
                  f"{same} of {len(prompts)} requests routed alike, "
                  f"their tokens equal | {card}")
    return [pg]


def _hybrid_ladder(card, pcie):
    """(d') The residency ladder's options on a ring run of Jamba
    (``_hybrid_ladder_cfg``): seeded weights drawn on the card, their
    expert shards written to a temporary directory, then
    ``_hybrid_ladder_run`` on the card, and the same from the same shards
    on the host (the CPU process's twin), fed the card's tokens. Returns
    (the card's run, the function that holds the CPU's against it)."""
    import shutil
    import tempfile
    from repro_torch.models.model import init_params
    from repro_torch.serving.streaming import save_expert_shards
    full, cfg = _hybrid_ladder_cfg()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device=dev)
    positions = _moe_positions(cfg)
    need = sum(v.numel() * 4 for v in _leaves(params)) + sum(
        v.numel() // 2 + v.numel() // 64 * 4 for p in positions
        for v in params["blocks"][str(p)]["moe"]["experts"].values())
    twin = _CPU_REFS is not None and "hybrid ladder" in _CPU_REFS.keys
    root = str(_CPU_REFS.dir / "jamba_shards") if twin else \
        tempfile.mkdtemp(prefix="jamba_shards_")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < need * LADDER_DISK_SLACK:
        raise AssertionError(f"hybrid ladder: {root} has {free / 1e9:.1f} "
                             f"GB free, the shards need "
                             f"{need * LADDER_DISK_SLACK / 1e9:.1f} GB")
    t = time.perf_counter()
    save_expert_shards(root, _fresh(params), positions, lo_bits=4)
    t_save = time.perf_counter() - t
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompts = serving_prompts(cfg.vocab_size, HYBRID_LADDER_ROWS,
                              HYBRID_LADDER_PROMPTS, seed=7)
    t = time.perf_counter()
    run = _hybrid_ladder_run(cfg, root, dev, prompts, pcie)
    t_card = time.perf_counter() - t
    w = run["window"]
    log("hybrid", f"ladder: {cfg.name} at full width, {cfg.n_layers} of "
                  f"{full.n_layers} layers (Mamba; attention with the MoE), "
                  f"window {HYBRID_LADDER_RING}; shards written in "
                  f"{t_save:.1f} s, {_dir_bytes(root) / 1e9:.2f} GB; the "
                  f"streaming cold start read {run['read']['bytes_read'] / 1e9:.3f} "
                  f"GB ({run['read']['lo_reads']} lo, "
                  f"{run['read']['hi_reads']} hi shards) before serving "
                  f"opened; the forced window: hi sets {run['hi_sets']}, "
                  f"{w['promotions']:.0f} promotions landed, "
                  f"{w['fault_cancels']:.0f} cancelled after "
                  f"{w['retries']:.0f} retries, {w['hi_loads']:.0f} hi shards "
                  f"read, lo_resident_frac {w['lo_resident_frac']:.3f}, "
                  f"pinned host masters {run['host_master_bytes'] / 1e9:.3f} "
                  f"GB; {len(prompts)} requests "
                  f"({HYBRID_LADDER_PROMPTS[0]}-{HYBRID_LADDER_PROMPTS[1]} "
                  f"tokens, {HYBRID_LADDER_NEW} new): {run['hi_routed']} "
                  f"routed cells served from hi, "
                  f"{run['host_fetches']:.0f} host fetches; engine and "
                  f"requests {t_card:.1f} s | {card}")
    used = PATHS["paged/ragged"][2]
    if not (w["promotions"] >= 1 and w["fault_cancels"] >= 1 and
            w["retries"] >= 1 and w["hi_loads"] >= 1 and
            run["read"]["hi_reads"] == 0 and run["read"]["bytes_read"] > 0
            and run["ready_retries"] >= 1 and run["hi_routed"] >= 1 and
            run["host_fetches"] > 0 and w["lo_resident_frac"] < 1.0 and
            all(run["launches"][k] > 0 for k in used)):
        raise AssertionError(f"hybrid ladder: window {w}, read "
                             f"{run['read']}, hi_routed {run['hi_routed']}, "
                             f"host fetches {run['host_fetches']}, launches "
                             f"{run['launches']}")
    inputs = {"root": root, "prompts": [p.tolist() for p in prompts],
              "gbps": pcie, "tokens": run["tokens"]}
    if twin:
        _CPU_REFS.put("hybrid ladder", inputs)
        get = functools.partial(_CPU_REFS.get, "hybrid ladder")
    else:
        def get():
            return _hybrid_ladder_cpu(inputs)

    def hold():
        cpu = get()
        shutil.rmtree(root, ignore_errors=True)
        for k in ("read", "ready_retries", "hi_sets", "window", "served"):
            if cpu[k] != run[k]:
                raise AssertionError(f"hybrid ladder: {k} on the card "
                                     f"{run[k]}, on the host {cpu[k]}")
        for k in ("lo_resident", "quarantined"):
            for p, v in run[k].items():
                if not np.array_equal(v, cpu[k][p]):
                    raise AssertionError(f"hybrid ladder: {k} of {p} "
                                         f"differs")
        held = _family_margin(run, cpu, "hybrid ladder, the host engine "
                                        "fed the card's tokens")
        log("hybrid", f"ladder: the host engine from the same shards read "
                      f"the same bytes, published the same hi sets, "
                      f"lo-resident and quarantined cells, with the same "
                      f"stats; fed the card's tokens: {held['held']} of "
                      f"{held['positions']} positions held, flips "
                      f"{held['flips']}, median |dlogit| per request "
                      f"{[round(m, 4) for m in held['median_dlogit']]}, "
                      f"{held['near']} near ties | {card}")

    return run, hold


#: Draft depth of the hybrid phase's speculative decoding.
HYBRID_SPEC_K = 3


def _hybrid_spec(card, cfg, params) -> list:
    """(e) Speculative decoding on the 8-layer Jamba, paged/ragged,
    graphed (the spec phase's 8 greedy requests of 64-256 tokens, 32 new):
    ``dynaexq`` (int4 lo, ``HYBRID_N_HI`` hi experts per MoE layer from one
    window after a warm-up, then fixed, so drafts on the all-lo view are
    sometimes rejected) with spec off and ``spec_k`` 3: each row's Mamba
    state rolls back to its last accepted step; tokens identical to spec
    off, or each difference explained by routing."""
    prompts, warm = _spec_prompts(cfg.vocab_size)
    used, unused = PATHS["paged/ragged"][2:]
    res = {}
    for label, ecfg in (("off", {}),
                        (f"spec_k={HYBRID_SPEC_K}",
                         dict(spec_k=HYBRID_SPEC_K))):
        eng = _spec_engine(cfg, params, "dynaexq", warm, paged=True,
                           dispatch="ragged", n_hi=HYBRID_N_HI, **ecfg)
        res[label] = _spec_serve(eng, prompts)
        del eng
        gc.collect()
    off, on = res["off"], res[f"spec_k={HYBRID_SPEC_K}"]
    for label, r in res.items():
        if not all(r["launches"][k] > 0 for k in used) or \
                any(r["launches"][k] for k in unused):
            raise AssertionError(f"hybrid spec {label}: launches "
                                 f"{r['launches']}")
    div = _spec_compare(off, on)
    wid = ", ".join(f"k={k}: draft {_ms(d)} ms x{nd}, verify {_ms(v)} ms "
                    f"x{nv}" for k, (d, nd, v, nv) in on["widths"].items())
    log("hybrid", f"spec_k={HYBRID_SPEC_K} on {cfg.n_layers} layers, "
                  f"dynaexq n_hi {HYBRID_N_HI} fixed: {on['rounds']} rounds "
                  f"({on['row_rounds']} row-rounds), drafted "
                  f"{on['drafted']}, accepted {on['accepted']}, accept rate "
                  f"{on['accept_rate']:.3f} | graph replay ms by width "
                  f"{wid} | TPOT per emitted token {on['tpot_ms']:.2f} ms vs "
                  f"spec off {off['tpot_ms']:.2f} ms | tokens vs spec off: "
                  f"{len(prompts) - len(div)} of {len(prompts)} requests "
                  f"identical" + (f", differences (request, token, "
                                  f"explained by routing) {div}" if div
                                  else "") + f" | {card}")
    if on["rounds"] < 1 or on["hi_sets"] != off["hi_sets"]:
        raise AssertionError(f"hybrid spec: {on['rounds']} rounds, or "
                             f"another target's hi sets than spec off's")
    if any(not ok for _, _, ok in div):
        raise AssertionError(f"hybrid spec: tokens differ from spec off, "
                             f"unexplained: {div}")
    return [off, on]


def _hybrid_check():
    """The hybrid phase's check of the card against the CPU (key, cfg,
    what, "cpu", kwargs): Jamba at full width, a 128-slot window."""
    _, ring_cfg = _jamba(window=HYBRID_CHECK_RING)
    return ("hybrid", ring_cfg, f"window {HYBRID_CHECK_RING}, paged/ragged, "
            "CPU vs card (CPU prefill padded)", "cpu",
            dict(paged=True, dispatch="ragged", B=2,
                 S=HYBRID_CHECK_PROMPTS[0], steps=4,
                 lengths=HYBRID_CHECK_PROMPTS, prefill_dispatch_ref="padded",
                 card_dense=True))


def phase_hybrid(card: str, parent=None):
    """Jamba at full width through (a)-(e) of the module's docstring.
    Returns the function that waits for the model check's CPU part, logs
    and checks it; ``main`` calls it before the next phase that times
    anything on the host."""
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    # Jamba's 22.5 GB of experts need the card and the host clear of what
    # earlier phases left to the collector or the allocator's cache.
    gc.collect()
    torch.cuda.empty_cache()
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=30).stdout.split("\n")[1].split()
    full, cfg = _jamba()
    host_gb = cfg.n_superblocks() * len(_moe_positions(cfg)) * \
        cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert * 2 / 1e9
    log("hybrid", f"{cfg.name}: full width, depth cut to {JAMBA_LAYERS} of "
                  f"{full.n_layers} layers (one super-block: Mamba at "
                  f"0-6, attention at 7, MoE at 1/3/5/7); bf16 experts "
                  f"{host_gb:.1f} GB (dynaexq pins them on the host), host "
                  f"memory total {free[1]} GB, available {free[-1]} GB; "
                  f"device memory allocated "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
                  f"{torch.cuda.memory_reserved() / 1e9:.2f} GB | {card}")
    # (b) The model check, CPU against the card, on the main path at a
    # 128 window: row 0 a 192-token prompt that wraps its 8-block ring, row
    # 1 a 48-token one (below the window it computes what the model's 8192
    # window would), 4 decode steps; the card also runs them on dense rows
    # (a 128-slot ring row), held to the same CPU forwards. The CPU's
    # plain forwards take minutes at full width: in a whole run they come
    # from the CPU process (``_CpuRefs``), which ran them from the run's
    # start; the check is held at the run's end.
    key, ring_cfg, what, dev_ref, kw = _hybrid_check()
    model_check = check_model("hybrid", ring_cfg, what, dev_ref,
                              torch.device("cuda"), later=True, key=key,
                              **kw)
    t1 = time.perf_counter()
    k = _hybrid_kernels()
    _hybrid_results(k)
    if parent is not None:
        _hybrid_ab(parent)
    t2 = time.perf_counter()
    pcie = pinned_h2d_gbps()
    params = init_params(cfg, seed=0, device=torch.device("cuda"))
    main_runs = _hybrid_serving(card, cfg, params, pcie)
    ring = _hybrid_ring(card, params)
    main_runs += ring
    main_runs += _hybrid_spec(card, cfg, params)
    del params
    ladder, ladder_hold = _hybrid_ladder(card, pcie)
    main_runs.append(ladder)
    t3 = time.perf_counter()
    for name in RESULTS:
        RESULTS[name]["launches"] = RESULTS[name].get("launches", 0) + sum(
            r["launches"].get(name, 0) for r in main_runs)
    log("hybrid", f"phase done in {time.perf_counter() - t0:.1f} s (the "
                  f"model check's card part {t1 - t0:.1f} s, kernels and "
                  f"A/B {t2 - t1:.1f} s, serving and ring {t3 - t2:.1f} s); "
                  f"the check's CPU part is the CPU process's | {card}")

    def join():
        t = time.perf_counter()
        model_check()
        ladder_hold()
        log("hybrid", f"the model check's and the ladder's CPU parts joined "
                      f"{time.perf_counter() - t3:.1f} s after the card part "
                      f"ended, {time.perf_counter() - t:.1f} s of it waited "
                      f"for | {card}")

    return join


# ---------------------------------------------------------------------------
# families: the dense and pure-SSM stacks
# ---------------------------------------------------------------------------

#: The dense attention families and the pure SSM stack, at full width and
#: full depth (bf16 weights 7.2, 13.8, 8.9, 7.9 and 0.26 GB).
FAMILIES = ("llama3_2-3b", "deepseek-7b", "phi4-mini-3.8b",
            "h2o-danube-3-4b", "mamba2-130m")
FAMILY_SLOTS = 8
FAMILY_NEW = 32
FAMILY_MAX_LEN = 288            # 256-token prompts + 32 tokens
#: The family also served op by op (``eager()``), held to its graph run.
FAMILY_EAGER = "llama3_2-3b"
FAMILY_SPEC_K = 4
#: Danube's long prompt: past 2048 at a multiple of 256 (the chunked
#: attention) and past its 4096 window.
FAMILY_LONG = 4608
#: The chunked prefill against the whole masked attention of the same layer
#: on the card: the same arithmetic per query chunk, the Q·Kᵀ and P·V
#: products at other GEMM shapes (another cuBLAS order, bf16 outputs a
#: rounding apart): 2^-6 of the largest output magnitude.
FAMILY_LONG_TOL = 2.0 ** -6


#: Logits recorded per decoded position in the families' runs (top-k):
#: room for the tokens of a flip to sit below each other's runner-up.
FAMILY_TOP_K = 8


def _family_serve(cfg, params, prompts, *, paged, mode, spec_k=0,
                  force=None):
    """8 greedy requests (32 new tokens, 8 slots) through the engine with
    ``fp16`` on paged KV (``paged``) or dense rows, graphed (``mode``
    "graph") or op by op ("eager"), ``spec_k`` draft tokens. The counts
    are zeroed just before the first request and read after the last
    token. With ``spec_k`` 0, records each decoded position's top
    ``FAMILY_TOP_K`` logits and their tokens (one top-k kernel on the
    device per step, read back after the run: no host sync inside it).
    Every emitted token is kept under ``own`` as the run chose it. With
    ``force`` (tokens per prompt), each emitted token is then replaced by
    the forced one, which the next step reads (teacher forcing, for
    ``_family_margin``)."""
    import contextlib
    import repro_torch.serving.engine as eng_mod
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    dev = params["embed"].device
    eng = eng_mod.InferenceEngine(
        cfg, _fresh(params), make_backend("fp16", device=dev),
        eng_mod.EngineConfig(max_slots=FAMILY_SLOTS, max_len=FAMILY_MAX_LEN,
                             paged=paged, spec_k=spec_k), device=dev)
    graphed = mode == "graph"
    if graphed:
        eng.decode_graph.events = []
    forced, recs, own = {}, [], {}
    first, decode = eng._first_token, eng._decode_one

    def emit(h, slot):
        own[(h.id, len(h.tokens) - 1)] = h.tokens[-1]
        if h.id in forced:
            h.tokens[-1] = forced[h.id][len(h.tokens) - 1]
            if eng.slots[slot] is h:
                eng.tokens[slot] = h.tokens[-1]

    def first_forced(h, slot, *a):
        first(h, slot, *a)
        emit(h, slot)

    def decode_seen(active, finished, lo=False):
        decode(active, finished, lo)
        top = eng.last_logits.topk(FAMILY_TOP_K, dim=-1)
        recs.append((top.values, top.indices,
                     [(h.id, len(h.tokens) - 1, i) for i, h in active]))
        for i, h in active:
            emit(h, i)

    eng._first_token = first_forced
    if not spec_k:
        eng._decode_one = decode_seen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # the path starts here
    t0 = time.perf_counter()
    handles = [eng.submit(Request(tokens=p, max_new_tokens=FAMILY_NEW))
               for p in prompts]
    if force is not None:
        forced = {h.id: f for h, f in zip(handles, force)}
    with eng_mod.eager() if not graphed else contextlib.nullcontext():
        while eng.queue or any(h is not None for h in eng.slots):
            eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)            # ... and ends here
    st = eng.stats()
    if not all(len(h.tokens) == FAMILY_NEW for h in handles):
        raise AssertionError(f"{cfg.name}: {[len(h.tokens) for h in handles]}"
                             f" tokens")
    top = {}
    for v, ids, rows in recs:
        v, ids = v.float().cpu(), ids.cpu()
        for hid, t, i in rows:
            top[(hid, t)] = {"v": v[i].tolist(), "ids": ids[i].tolist()}
    replay = [a.elapsed_time(b) for a, b in eng.decode_graph.events] \
        if graphed else []
    out = {"tokens": [list(h.tokens) for h in handles],
           "ids": [h.id for h in handles], "top": top, "own": own,
           "launches": launches, "wall_s": wall, "ttft_s": st["ttft_s"],
           "tpot_s": st["tpot_s"], "steps": int(st["steps"]),
           "replay_ms": float(np.mean(replay)) if replay else None,
           "capture_s": eng.capture_s, "pool": eng.pool is not None,
           "max_mem": torch.cuda.max_memory_allocated(),
           "spec_rounds": st["spec_rounds"],
           "accept_rate": st["accept_rate"]}
    del eng, recs
    gc.collect()
    return out


def _family_margin(a, b, what) -> dict:
    """Run ``b`` fed run ``a``'s tokens (``_family_serve(force=...)``),
    held position by position as ``compare_forced`` holds the requests
    phase: both read the same tokens at every position and differ only by
    rounding. A position is held where both runs recorded its logits (a
    request's first token comes from the prefill, unrecorded: there the
    runs must choose alike); at least ``MIN_HELD`` of the positions must
    be held. Where ``b`` would have chosen another token, the flip passes
    if the largest change of the two tokens' logits between the runs is
    within ``FLIP_STEPS`` bf16 steps of ``a``'s top logit (infinite where
    a token falls outside a record's top ``FAMILY_TOP_K``). The rule says
    little when near ties are common: it fails when more than
    ``MAX_TIE_SHARE`` of the held positions would pass a flip (the two
    runs' top-2 gaps add up to ``FLIP_STEPS`` steps at most). Returns the
    counts it held."""
    n = held = near = 0
    flips, bad, med = [], [], []
    for r, x in enumerate(a["tokens"]):
        ia, ib = a["ids"][r], b["ids"][r]
        dl = []
        for t, tok in enumerate(x):
            n += 1
            ra, rb = a["top"].get((ia, t)), b["top"].get((ib, t))
            own = b["own"][(ib, t)]
            if ra is None or rb is None:
                if t == 0 and ra is None and rb is None and own == tok:
                    continue                 # the prefill's token: alike
                bad.append((r, t, "no record"))
                continue
            held += 1
            step = bf16_step(ra["v"][0])
            near += (ra["v"][0] - ra["v"][1]) / step + \
                (rb["v"][0] - rb["v"][1]) / bf16_step(rb["v"][0]) <= \
                FLIP_STEPS
            A = dict(zip(ra["ids"], ra["v"]))
            B = dict(zip(rb["ids"], rb["v"]))
            if tok not in B:
                bad.append((r, t, "forced token outside b's top"))
                continue
            dl.append(abs(A[tok] - B[tok]))
            if own != tok:
                moved = max(abs(A[u] - B[u]) if u in A and u in B
                            else math.inf for u in (tok, own)) / step
                flips.append((r, t, round(moved, 2)))
                if moved > FLIP_STEPS:
                    bad.append((r, t, f"flip moved {moved:.2f} steps"))
        med.append(float(np.median(dl)) if dl else math.nan)
    out = {"positions": n, "held": held, "near": near, "flips": flips,
           "median_dlogit": med}
    if bad or held < MIN_HELD * n or near > MAX_TIE_SHARE * held:
        raise AssertionError(f"{what}: held {held} of {n} (at least "
                             f"{MIN_HELD}); {near} of {held} held positions "
                             f"would pass a flip (at most {MAX_TIE_SHARE}); "
                             f"failed (request, index, why) {bad[:8]}")
    return out


def _family_step_bytes(cfg, params, prompts) -> tuple:
    """The bytes a decode step reads at least: every weight but the
    embedding table's unused rows (the tied table is the LM head: read
    whole), the K/V of every valid position at the step's mean context
    (8 rows, prompts + half the new tokens), and the Mamba rows (read and
    written). Returns (bytes, bound ms at 3.35 TB/s)."""
    from repro_torch.models.model import attn_positions, mamba_positions
    from repro_torch.models.ssm import conv_dim
    w = sum(t.numel() * t.element_size() for t in _leaves(params))
    if not cfg.tie_embeddings:
        w -= params["embed"].numel() * params["embed"].element_size()
    nsb, kv = cfg.n_superblocks(), 0
    if attn_positions(cfg):
        a = cfg.attn
        ctx = sum(min(len(p) + FAMILY_NEW // 2, a.sliding_window or 1 << 30)
                  for p in prompts)
        kv = ctx * 2 * a.n_kv_heads * a.head_dim * 2 * \
            len(attn_positions(cfg)) * nsb
    ssm = 0
    if mamba_positions(cfg):
        c = cfg.ssm
        row = c.n_heads(cfg.d_model) * c.head_dim * c.d_state * 4 + \
            c.d_conv * conv_dim(c, cfg.d_model) * 2
        ssm = 2 * row * len(prompts) * len(mamba_positions(cfg)) * nsb
    nbytes = w + kv + ssm
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _family_long_prefill(cfg, params, card) -> None:
    """Danube's 4608-token prompt: the whole stack's prefill on dense rows
    (each attention layer past 2048 tokens, at a multiple of 256: the
    q-chunked attention; a 4096-slot ring, so the prompt wraps it) gives
    finite logits; and layer 0's chunked attention against the whole
    masked attention of the same layer on the card, to
    ``FAMILY_LONG_TOL``."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import _layer, init_caches, prefill
    dev = params["embed"].device
    S = FAMILY_LONG
    gen = torch.Generator(device=dev).manual_seed(46)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device=dev)
    lengths = torch.full((1,), S, dtype=torch.int64, device=dev)
    caches = init_caches(cfg, 1, S, device=dev)
    chunked, entry = [], L._sdpa_chunked
    L._sdpa_chunked = lambda *a: chunked.append(a[-1]) or entry(*a)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(params, cfg, tokens, caches, lengths)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        p = _layer(params["blocks"]["0"], 0)
        x = L.rmsnorm(p["norm1"], params["embed"][tokens], cfg.norm_eps)
        n_calls = len(chunked)
        ring = L.init_kv_cache((1,), cfg.attn.sliding_window, cfg.attn, dev)
        got = L.attention_prefill(p["attn"], cfg.attn, x, ring, lengths)
    finally:
        L._sdpa_chunked = entry
    pos = torch.arange(S, device=dev)[None, :]
    q, k, v = L._project_qkv(p["attn"], cfg.attn, x, pos)
    qp, kp = pos[:, :, None], pos[:, None, :]
    mask = (kp <= qp) & (kp > qp - cfg.attn.sliding_window)
    want = L._sdpa(q, k, v, mask, cfg.attn.n_heads) @ p["attn"]["wo"]
    err = float((got.float() - want.float()).abs().max())
    tol = FAMILY_LONG_TOL * float(want.float().abs().max())
    ok = bool(torch.isfinite(logits).all()) and n_calls == cfg.n_layers \
        and len(chunked) == n_calls + 1 and err <= tol
    log("families", f"{cfg.name} prompt of {S} tokens (window "
                    f"{cfg.attn.sliding_window}, ring "
                    f"{caches['0'].k.shape[-2]}): prefill of {cfg.n_layers} "
                    f"layers on dense rows in {whole_s * 1e3:.1f} ms (host "
                    f"clock, synchronised), q-chunked attention in "
                    f"{n_calls} of {cfg.n_layers} layers (chunks of "
                    f"{chunked[0] if chunked else None}), logits finite "
                    f"{bool(torch.isfinite(logits).all())}; layer 0 chunked "
                    f"vs whole masked attention on the card: max |diff| "
                    f"{err:.4g} (tol {tol:.4g}) | {'ok' if ok else 'FAIL'} "
                    f"| {card}")
    if not ok:
        raise AssertionError(f"{cfg.name}: the chunked prefill failed its "
                             f"check")


def _family_launches(arch, what, run, attn) -> None:
    """A family's run launched its layout's decode-attention kernel (a
    paged run: row 3, on a pool; dense rows: row 5) and no other kernel of
    the port; a stack without attention none."""
    want = {"flash_decode_paged"} if attn and run["pool"] else \
        {"flash_decode"} if attn else set()
    if run["pool"] != (attn and what in ("paged", "eager")) or \
            any(bool(n) != (k in want) for k, n in run["launches"].items()):
        raise AssertionError(f"{arch} {what}: pool {run['pool']}, launches "
                             f"{run['launches']}")


def _family_launcher(arch, card) -> dict:
    """``python -m repro_torch.launch.serve --arch ARCH --full --backend
    fp16`` in this process (the launcher's defaults otherwise: speculation
    on, the observability layer on): 8 requests of 64 tokens, 32 new."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--full", "--backend", "fp16",
                      "--batch", "8", "--prompt-len", "64", "--new-tokens",
                      "32"])
    st = out["stats"]
    if [len(t) for t in out["tokens"]] != [32] * 8 or out["device_bytes"]:
        raise AssertionError(f"{arch} launcher: tokens "
                             f"{[len(t) for t in out['tokens']]}, expert "
                             f"bytes {out['device_bytes']}")
    log("families", f"launcher --arch {arch} --full --backend fp16: 8 x 32 "
                    f"tokens in {out['wall_s']:.2f} s, TPOT "
                    f"{st['tpot_s'] * 1e3:.2f} ms, spec accept "
                    f"{st['accept_rate']:.3f} over {st['spec_rounds']:.0f} "
                    f"rounds, 0 expert bytes | {card}")
    return out


def phase_families(card: str) -> None:
    """Every dense and pure-SSM family the reference serves, at full width
    and full depth, seeded random weights drawn on the card: 8 greedy
    requests (64-256-token prompts, 32 new tokens, 8 slots) with ``fp16``
    on paged KV and on dense rows, graphed; Llama-3.2-3B also op by op
    (tokens and launches equal to the graph run); the dense-row run fed
    the paged run's tokens and held to it position by position
    (``_family_margin``); the attention families' paged runs launch the
    paged decode attention (row 3) and their dense runs the dense one (row
    5), and nothing else of the port; Mamba2 runs none (plain SSD; no pool
    under ``paged=True``) and, with ``spec_k`` 4, emits the tokens of spec
    off;
    Danube's 4608-token chunked prefill; then the launcher at ``--full``.
    Per family: TTFT, TPOT, ms per graph replay, the bytes a step reads and
    their bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import attn_positions, init_params
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    main_runs = []
    for arch in FAMILIES:
        t = time.perf_counter()
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        prompts = serving_prompts(cfg.vocab_size, FAMILY_SLOTS, (64, 256))
        runs = {"paged": _family_serve(cfg, params, prompts, paged=True,
                                       mode="graph")}
        runs["dense"] = _family_serve(cfg, params, prompts, paged=False,
                                      mode="graph",
                                      force=runs["paged"]["tokens"])
        if arch == FAMILY_EAGER:
            runs["eager"] = _family_serve(cfg, params, prompts, paged=True,
                                          mode="eager")
            if runs["eager"]["tokens"] != runs["paged"]["tokens"] or \
                    runs["eager"]["launches"] != runs["paged"]["launches"]:
                raise AssertionError(f"{arch}: graph and eager disagree on "
                                     f"tokens or launches")
        attn = bool(attn_positions(cfg))
        if not attn:
            runs["spec"] = _family_serve(cfg, params, prompts, paged=False,
                                         mode="graph", spec_k=FAMILY_SPEC_K)
            sp = runs["spec"]
            if sp["tokens"] != runs["paged"]["tokens"] or \
                    not sp["spec_rounds"] > 0:
                raise AssertionError(f"{arch}: spec_k={FAMILY_SPEC_K} emits "
                                     f"other tokens than spec off (rounds "
                                     f"{sp['spec_rounds']})")
        for what, run in runs.items():
            _family_launches(arch, what, run, attn)
        held = _family_margin(runs["paged"], runs["dense"],
                              f"{arch} dense rows fed the paged run's "
                              f"tokens")
        nbytes, bnd = _family_step_bytes(cfg, params, prompts)
        for what, run in runs.items():
            ran = {k: n for k, n in run["launches"].items() if n}
            log("families", f"{cfg.name} {cfg.n_layers} layers d "
                            f"{cfg.d_model} {what} ("
                            f"{'pool' if run['pool'] else 'dense rows'}): "
                            f"TTFT "
                            f"{run['ttft_s'] * 1e3:.1f} ms, TPOT "
                            f"{run['tpot_s'] * 1e3:.2f} ms, replay "
                            f"{_ms(run['replay_ms'])} ms, "
                            f"{run['steps']} steps, served in "
                            f"{run['wall_s']:.2f} s, max allocated "
                            f"{run['max_mem'] / 1e9:.2f} GB"
                            + (f", {run['spec_rounds']:.0f} spec rounds, "
                               f"accept {run['accept_rate']:.3f}"
                               if what == "spec" else "")
                            + f" | launches {ran} | {card}")
        log("families", f"{cfg.name}: a decode step reads {nbytes / 1e9:.3f} "
                        f"GB (weights, K/V at the mean context, Mamba "
                        f"rows): bound {bnd:.3f} ms at 3.35 TB/s; paged "
                        f"replay {_ms(runs['paged']['replay_ms'])} ms = "
                        f"{(runs['paged']['replay_ms'] or 0) / bnd:.2f}x the "
                        f"bound; dense rows fed the paged run's tokens: "
                        f"positions held {held['held']} of "
                        f"{held['positions']} (at least {MIN_HELD}), "
                        f"{held['near']} of them near ties (at most "
                        f"{MAX_TIE_SHARE}), flips (request, index, bf16 "
                        f"steps moved; at most {FLIP_STEPS}) "
                        f"{held['flips']}, median |dlogit| of the paged "
                        f"token per request "
                        f"{[round(m, 4) for m in held['median_dlogit']]}"
                        + (", graph = eager (tokens and launches)"
                           if "eager" in runs else "")
                        + (", spec on = spec off" if "spec" in runs else "")
                        + f" | family done in {time.perf_counter() - t:.1f} "
                        f"s | {card}")
        if cfg.attn is not None and cfg.attn.sliding_window:
            _family_long_prefill(cfg, params, card)
        main_runs += list(runs.values())
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
        _family_launcher(arch, card)
        gc.collect()
        torch.cuda.empty_cache()
    for name in RESULTS:
        RESULTS[name]["launches"] = RESULTS[name].get("launches", 0) + sum(
            r["launches"].get(name, 0) for r in main_runs)
    log("families", f"phase done in {time.perf_counter() - t0:.1f} s | "
                    f"{card}")


# ---------------------------------------------------------------------------
# multimodal: the encoder-decoder and VLM families
# ---------------------------------------------------------------------------

WHISPER = "whisper-tiny"
LLAVA = "llava-next-34b"
#: Rows of the batch runs (Whisper's, LLaVA's multimodal run), their
#: text prompts' lengths (inclusive) and tokens: Whisper's 32 greedy
#: tokens are the prefill's and 31 decode steps', LLaVA's multimodal run
#: decodes 32 steps after its prefill.
MM_ROWS = 8
WHISPER_PROMPTS = (4, 64)
WHISPER_NEW = 32
LLAVA_TEXT = (16, 64)
LLAVA_STEPS = 32
#: LLaVA's CPU check: full width, 2 of 60 layers, 2 rows (576 patches and
#: 48 or 16 text tokens), 4 decode steps.
LLAVA_CHECK_LAYERS = 2
LLAVA_CHECK_TEXT = (48, 16)
LLAVA_CHECK_STEPS = 4


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _batch_run(cfg, params, tokens, lengths, steps, *, extra=None,
               force=None):
    """The batch entry points on dense rows: ``prefill`` of the
    right-padded ``tokens`` (``lengths`` count a VLM's image prefix;
    ``extra``: ``image_embeds`` or ``audio_embeds``), then ``steps``
    ``decode_step`` calls, op by op, greedy or fed ``force`` ((B, steps +
    1) tokens: teacher forcing). On the card the counts are zeroed just
    before the prefill and read after the last step (a CPU run leaves
    them alone). Records each position's full logits (kept on the device
    and read back after the run: no host sync inside the decode loop) and
    their top ``FAMILY_TOP_K`` in ``_family_margin``'s form. TTFT: the
    prefill and its argmax, synchronised; TPOT: the decode loop's wall
    time per step."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_caches, prefill
    dev = params["embed"].device
    B, S = tokens.shape
    n_img = extra["image_embeds"].shape[1] if extra and \
        "image_embeds" in extra else 0
    caches = init_caches(cfg, B, n_img + S + steps + 1, device=dev)
    outs, chosen, fed = [], [], []
    card = dev.type == "cuda"
    _sync(dev)
    if card:
        ops.reset_launches()                 # the path starts here
    t0 = time.perf_counter()
    logits, _ = prefill(params, cfg, tokens, caches, lengths, **(extra or {}))
    pos = lengths.clone()
    for j in range(steps + 1):
        if j:
            logits, _ = decode_step(params, cfg, tok, pos, caches)
            pos = pos + 1
        outs.append(logits)
        chosen.append(torch.argmax(logits, -1))
        tok = chosen[-1] if force is None else force[:, j].to(dev)
        fed.append(tok)
        if j == 0:
            _sync(dev)
            ttft = time.perf_counter() - t0
            t1 = time.perf_counter()
    _sync(dev)
    tpot = (time.perf_counter() - t1) / max(steps, 1)
    launches = dict(ops.LAUNCHES) if card else {}    # ... and ends here
    logits = torch.stack(outs, 1).float().cpu()          # (B, steps+1, V)
    top = logits.topk(FAMILY_TOP_K, dim=-1)
    own = torch.stack(chosen, 1).cpu()
    fed = torch.stack(fed, 1).cpu()
    del caches, outs
    return {"tokens": fed.tolist(), "ids": list(range(B)),
            "own": {(r, t): int(own[r, t]) for r in range(B)
                    for t in range(steps + 1)},
            "top": {(r, t): {"v": top.values[r, t].tolist(),
                             "ids": top.indices[r, t].tolist()}
                    for r in range(B) for t in range(steps + 1)},
            "logits": logits, "forced": fed, "ttft_s": ttft,
            "tpot_s": tpot, "launches": launches, "steps": steps}


def _batch_held(card_run, cpu_run, what) -> dict:
    """The CPU run (fed the card's tokens) against the card's: every
    position's logits within ``MODEL_TOL`` and the greedy tokens under
    ``_family_margin``'s rule."""
    err = float((card_run["logits"] - cpu_run["logits"]).abs().max())
    if not bool(torch.isfinite(card_run["logits"]).all()) or \
            err > MODEL_TOL:
        raise AssertionError(f"{what}: max |dlogit| {err:.4f} (tol "
                             f"{MODEL_TOL})")
    held = _family_margin(card_run, cpu_run, what)
    held["err"] = err
    held["mag"] = float(card_run["logits"].abs().max())
    return held


def _mm_inputs(cfg, gen, dev, text, n_rows):
    """Right-padded text tokens (row lengths drawn from ``text``, row 0 at
    its top; or ``text`` as the lengths), the stub frontend's embeddings
    and ``lengths`` counting a VLM's image prefix."""
    from repro_torch.models.frontend import (audio_frame_embeddings,
                                             image_patch_embeddings)
    if len(text) == n_rows:
        lens = torch.tensor(text, dtype=torch.long)
    else:
        lens = torch.randint(text[0], text[1] + 1, (n_rows,), generator=gen)
        lens[0] = text[1]
    tokens = torch.randint(0, cfg.vocab_size, (n_rows, int(lens.max())),
                           generator=gen)
    if cfg.is_encoder_decoder:
        extra = {"audio_embeds": audio_frame_embeddings(gen, cfg, n_rows)}
        n_img = 0
    else:
        extra = {"image_embeds": image_patch_embeddings(gen, cfg, n_rows)}
        n_img = cfg.num_image_tokens
    return (tokens.to(dev), {k: v.to(dev) for k, v in extra.items()},
            (lens + n_img).to(dev))


def _mm_twin(key, what, cfg, params, tokens, lengths, steps, extra,
             card_run):
    """The twin of ``card_run``: from the CPU process where it runs (it
    drew the same weights and inputs at the run's start, ``MM_TWINS``; it
    is sent the card's tokens now), else ``_twin_job``."""
    if _CPU_REFS is not None and key in _CPU_REFS.keys:
        _CPU_REFS.put(key, card_run["forced"])
        return (what, card_run, lambda: _CPU_REFS.get(key))
    return _twin_job(what, cfg, params, tokens, lengths, steps, extra,
                     card_run)


def _twin_whisper():
    """Whisper's twin on the host (``_mm_whisper``'s weights and inputs),
    still to be fed the card's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg, cpu = get_config(WHISPER), torch.device("cpu")
    params = _to(init_params(cfg, seed=0, device=torch.device("cuda")), cpu)
    tokens, extra, lengths = _mm_inputs(
        cfg, torch.Generator().manual_seed(81), cpu, WHISPER_PROMPTS, MM_ROWS)
    return functools.partial(_batch_run, cfg, params, tokens, lengths,
                             WHISPER_NEW - 1, extra=extra)


def _twin_llava():
    """The 2-layer LLaVA's twin on the host (``_mm_llava_check``'s)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config(LLAVA), n_layers=LLAVA_CHECK_LAYERS)
    cpu = torch.device("cpu")
    params = _to(init_params(cfg, seed=1, device=torch.device("cuda")), cpu)
    tokens, extra, lengths = _mm_inputs(
        cfg, torch.Generator().manual_seed(83), cpu, LLAVA_CHECK_TEXT,
        len(LLAVA_CHECK_TEXT))
    return functools.partial(_batch_run, cfg, params, tokens, lengths,
                             LLAVA_CHECK_STEPS, extra=extra)


#: The multimodal phase's CPU twins the CPU process runs: key → the
#: function that draws the twin's weights and inputs.
MM_TWINS = {"multimodal whisper": _twin_whisper,
            "multimodal llava": _twin_llava}


def _twin_job(what, cfg, params, tokens, lengths, steps, extra, card_run):
    """(what, the card's run, its CPU twin): ``_batch_run`` on host copies
    of the card's weights and inputs (made now: the job holds nothing on
    the card), fed the card's tokens."""
    cpu = torch.device("cpu")
    return (what, card_run, functools.partial(
        _batch_run, cfg, _to(params, cpu), tokens.to(cpu), lengths.to(cpu),
        steps, extra={k: v.to(cpu) for k, v in extra.items()},
        force=card_run["forced"]))


def _mm_whisper(card, dev, cfg, jobs) -> list:
    """Whisper at full width and depth on the card: 8 rows of 1500 stub
    frames and 4-64-token prompts, 32 greedy tokens through ``prefill``
    and 31 ``decode_step`` calls on dense rows, op by op (the engine
    refuses the family, as the reference's). Row 5 (``flash_decode``) runs
    self- and cross-attention: exactly 2 x layers launches per decode
    step, nothing else of the port. The CPU twin (fed the card's tokens)
    goes on ``jobs``."""
    from repro_torch.models.model import encode, init_params
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(81)
    tokens, extra, lengths = _mm_inputs(cfg, gen, dev, WHISPER_PROMPTS,
                                        MM_ROWS)
    _batch_run(cfg, params, tokens, lengths, 2, extra=extra)   # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    encode(params, cfg, extra["audio_embeds"])
    _sync(dev)
    enc_ms = (time.perf_counter() - t0) * 1e3
    run = _batch_run(cfg, params, tokens, lengths, WHISPER_NEW - 1,
                     extra=extra)
    want = {"flash_decode": 2 * cfg.n_layers * (WHISPER_NEW - 1)}
    got = {k: n for k, n in run["launches"].items() if n}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{cfg.name}: launches {got}, want {want}")
    log("multimodal", f"{cfg.name} (d {cfg.d_model}, {cfg.n_encoder_layers} "
                      f"encoder + {cfg.n_layers} decoder layers, "
                      f"{cfg.encoder_seq} frames) on the card, "
                      f"{MM_ROWS} rows, prompts "
                      f"{(lengths.cpu()).tolist()} tokens, "
                      f"{WHISPER_NEW} greedy tokens on dense rows, op by op: "
                      f"encoder {enc_ms:.2f} ms, TTFT "
                      f"{run['ttft_s'] * 1e3:.2f} ms (encoder, cross K/V "
                      f"and prefill), TPOT {run['tpot_s'] * 1e3:.2f} ms | "
                      f"launches {got} ({2 * cfg.n_layers} per decode step: "
                      f"self- and cross-attention) | {card}")
    jobs.append(_mm_twin("multimodal whisper", f"{cfg.name} CPU vs card",
                         cfg, params, tokens, lengths, WHISPER_NEW - 1,
                         extra, run))
    return [run]


def _mm_llava_check(dev, full, jobs) -> None:
    """LLaVA at full width and ``LLAVA_CHECK_LAYERS`` of 60 layers on the
    card: 2 rows of 576 patches and 48 / 16 text tokens through
    ``prefill(image_embeds=...)`` and 4 decode steps, after the 60-layer
    model is freed; the CPU twin goes on ``jobs``."""
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(full, n_layers=LLAVA_CHECK_LAYERS)
    params = init_params(cfg, seed=1, device=dev)
    gen = torch.Generator().manual_seed(83)
    tokens, extra, lengths = _mm_inputs(cfg, gen, dev, LLAVA_CHECK_TEXT,
                                        len(LLAVA_CHECK_TEXT))
    run = _batch_run(cfg, params, tokens, lengths, LLAVA_CHECK_STEPS,
                     extra=extra)
    jobs.append(_mm_twin("multimodal llava", f"{full.name} {cfg.n_layers} "
                         f"of {full.n_layers} layers, image prefix, CPU vs "
                         f"card", cfg, params, tokens, lengths,
                         LLAVA_CHECK_STEPS, extra, run))


def _products_ms(cfg, params, B=FAMILY_SLOTS) -> tuple:
    """Device ms of a decode step's large products at ``B`` rows, each
    timed alone by graph replay on layer 0's weights (wq, wk, wv, wo,
    w_gate, w_up, w_down) times the depth, plus the LM head; and their
    bytes' bound. A weight that fits the 50 MB L2 (wk, wv) is read warm
    there, cold in a step."""
    from repro_torch.models.model import _layer
    dev = params["embed"].device
    bp = _layer(params["blocks"]["0"], 0)
    mats = [bp["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [bp["mlp"][n] for n in ("w_gate", "w_up", "w_down")]
    gen = torch.Generator(device=dev).manual_seed(87)
    layer_ms = nbytes = 0
    for w in mats:
        a = torch.randn((B, w.shape[0]), generator=gen, device=dev).to(
            torch.bfloat16)
        layer_ms += graph_ms(lambda a=a, w=w: a @ w)
        nbytes += w.numel() * w.element_size()
    head = params["lm_head"]
    a = torch.randn((B, head.shape[0]), generator=gen, device=dev).to(
        torch.bfloat16)
    ms = layer_ms * cfg.n_layers + graph_ms(lambda: a @ head)
    nbytes = nbytes * cfg.n_layers + head.numel() * head.element_size()
    return ms, nbytes / HBM_BYTES_PER_S * 1e3


def _mm_llava(card, dev, cfg) -> list:
    """LLaVA at full width and depth: ``fp16`` graphed on paged KV and on
    dense rows (8 greedy requests, 64-256-token prompts, 32 new, 8 slots;
    the dense run fed the paged run's tokens and held to it position by
    position), rows 3 and 5 the only kernels of the port each launches;
    then 8 rows of 576 stub patches and 16-64 text tokens through
    ``prefill(image_embeds=...)`` on dense rows and 32 decode steps, op by
    op."""
    from repro_torch.models.model import init_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = serving_prompts(cfg.vocab_size, FAMILY_SLOTS, (64, 256))
    runs = {"paged": _family_serve(cfg, params, prompts, paged=True,
                                   mode="graph")}
    runs["dense"] = _family_serve(cfg, params, prompts, paged=False,
                                  mode="graph",
                                  force=runs["paged"]["tokens"])
    if dev.type == "cuda":
        for what, run in runs.items():
            _family_launches(cfg.name, what, run, True)
    held = _family_margin(runs["paged"], runs["dense"],
                          f"{cfg.name} dense rows fed the paged run's tokens")
    nbytes, bnd = _family_step_bytes(cfg, params, prompts)
    prod_ms, prod_bnd = _products_ms(cfg, params) if dev.type == "cuda" \
        else (math.nan, math.nan)
    gen = torch.Generator().manual_seed(85)
    tokens, extra, lengths = _mm_inputs(cfg, gen, dev, LLAVA_TEXT, MM_ROWS)
    mm = _batch_run(cfg, params, tokens, lengths, LLAVA_STEPS, extra=extra)
    got = {k: n for k, n in mm["launches"].items() if n}
    if dev.type == "cuda" and got != {"flash_decode": cfg.n_layers *
                                      LLAVA_STEPS}:
        raise AssertionError(f"{cfg.name} multimodal: launches {got}")
    peak = max([r["max_mem"] for r in runs.values()] +
               [torch.cuda.max_memory_allocated()])
    del params
    for what, run in runs.items():
        ran = {k: n for k, n in run["launches"].items() if n}
        log("multimodal", f"{cfg.name} {cfg.n_layers} layers d "
                          f"{cfg.d_model} {what} "
                          f"({'pool' if run['pool'] else 'dense rows'}), "
                          f"fp16 graphed: TTFT {run['ttft_s'] * 1e3:.1f} ms, "
                          f"TPOT {run['tpot_s'] * 1e3:.2f} ms, replay "
                          f"{_ms(run['replay_ms'])} ms, {run['steps']} "
                          f"steps, served in {run['wall_s']:.2f} s | "
                          f"launches {ran} | {card}")
    mm_lens = (lengths.cpu() - cfg.num_image_tokens).tolist()
    log("multimodal", f"{cfg.name}: weights {weights / 1e9:.2f} GB drawn on "
                      f"the card in {init_s:.1f} s; a decode step reads "
                      f"{nbytes / 1e9:.3f} GB (weights but the embedding's "
                      f"unused rows, K/V at the mean context): bound "
                      f"{bnd:.3f} ms at 3.35 TB/s; paged replay "
                      f"{_ms(runs['paged']['replay_ms'])} ms = "
                      f"{(runs['paged']['replay_ms'] or 0) / bnd:.2f}x the "
                      f"bound, dense {_ms(runs['dense']['replay_ms'])} ms; "
                      f"its products alone (7 per layer x {cfg.n_layers} + "
                      f"the LM head, each by graph replay at "
                      f"{FAMILY_SLOTS} rows) {prod_ms:.3f} ms = "
                      f"{prod_ms / prod_bnd:.2f}x their bound "
                      f"{prod_bnd:.3f} ms, the rest of the paged replay "
                      f"{(runs['paged']['replay_ms'] or 0) - prod_ms:.3f} "
                      f"ms; dense rows fed the paged run's tokens: positions "
                      f"held {held['held']} of {held['positions']}, "
                      f"{held['near']} near ties, flips (request, index, "
                      f"bf16 steps) {held['flips']} | {card}")
    log("multimodal", f"{cfg.name} multimodal on dense rows, op by op: "
                      f"{MM_ROWS} rows of {cfg.num_image_tokens} stub "
                      f"patches + {mm_lens} text tokens, prefill then "
                      f"{LLAVA_STEPS} decode steps: TTFT "
                      f"{mm['ttft_s'] * 1e3:.1f} ms, TPOT "
                      f"{mm['tpot_s'] * 1e3:.2f} ms, logits finite "
                      f"{bool(torch.isfinite(mm['logits']).all())} | "
                      f"launches {got} | peak device memory over the "
                      f"{cfg.n_layers}-layer runs {peak / 1e9:.2f} GB | "
                      f"{card}")
    if not bool(torch.isfinite(mm["logits"]).all()):
        raise AssertionError(f"{cfg.name} multimodal: non-finite logits")
    return list(runs.values()) + [mm]


def _mm_twins(card, jobs) -> None:
    """Run the CPU twins (all of the host's threads) and hold each card
    run to its twin (``_batch_held``)."""
    t = time.perf_counter()
    for what, card_run, twin in jobs:
        held = _batch_held(card_run, twin(), what)
        log("multimodal", f"{what}: max |dlogit| {held['err']:.4f} over "
                          f"every position (tol {MODEL_TOL}), max |logit| "
                          f"{held['mag']:.3f}; greedy tokens held "
                          f"{held['held']} of {held['positions']} positions, "
                          f"{held['near']} near ties, flips (row, index, "
                          f"bf16 steps) {held['flips']} | {card}")
    log("multimodal", f"the CPU twins took {time.perf_counter() - t:.1f} s "
                      f"| {card}")


def phase_multimodal(card: str):
    """The encoder-decoder and VLM families at full width, seeded random
    weights drawn on the card: Whisper-tiny (full depth) through its batch
    entry points; LLaVA-NeXT-34B at all 60 layers (68.8 GB of bf16)
    through the engine on both layouts and its multimodal batch on dense
    rows; then LLaVA at 2 of 60 layers (image prefix). Whisper and the
    2-layer LLaVA are held to CPU twins, which the CPU process runs
    (``MM_TWINS``; a thread of this process beside the eager multimodal
    run slowed its TPOT 1.8x): returns the function that holds them."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    jobs = []
    main_runs = _mm_whisper(card, dev, get_config(WHISPER), jobs)
    main_runs += _mm_llava(card, dev, get_config(LLAVA))
    t1 = time.perf_counter()
    _mm_llava_check(dev, get_config(LLAVA), jobs)
    for name in RESULTS:
        RESULTS[name]["launches"] = RESULTS[name].get("launches", 0) + sum(
            r["launches"].get(name, 0) for r in main_runs)
    log("multimodal", f"card part done in {time.perf_counter() - t0:.1f} s "
                      f"(Whisper and LLaVA at 60 layers {t1 - t0:.1f} s, the "
                      f"LLaVA check's card part "
                      f"{time.perf_counter() - t1:.1f} s) | {card}")
    return lambda: _mm_twins(card, jobs)


# ---------------------------------------------------------------------------
# 5j. train: training on the card through the launcher; the twin of one
#     step on the CPU; perplexity under quantized banks on the ragged
#     kernels; a checkpoint round trip
# ---------------------------------------------------------------------------

#: The reference launcher's default model at full width and depth (24
#: layers, d 1024, 32 experts top-8, F 512, vocab 49155: 1.33 B
#: parameters), trained by ``repro_torch.launch.train.main`` in process.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 20
TRAIN_BATCH = 16
TRAIN_SEQ = 65
TRAIN_ARGV = ("--full", "--steps", str(TRAIN_STEPS), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ))
#: The step time reported: the median of the last this many steps.
TRAIN_TIMED = 10
#: The held-out cross-entropy (the launcher's three held-out batches) must
#: fall at least this far (nats) from the seeded weights to the trained
#: ones. The same batches before and after, not the first and last steps'
#: losses: each step's batch differs (its CE moves ~0.03 between steps),
#: and the steps' total loss carries the load-balance term, which rose
#: over the 20 steps while the cross-entropy fell (on the H100).
TRAIN_DROP = 0.01
#: The twin: the same weights (drawn on the CPU) at full width and 2 of 24
#: layers, one step on a batch of TWIN_BATCH rows on the card and on the
#: CPU's plain path, in bf16 (the training dtype) and in float32. The card's
#: bf16 step runs TWIN_CARD_RUNS times (its backward scatters with atomics,
#: so runs differ); the worst run is held. Loss to *_LOSS_RTOL relative;
#: each gradient leaf to *_GRAD_RTOL relative L2; each leaf's update (new -
#: old) to *_UPDATE_RTOL relative L2 (Adam's first step is ~lr · sign(g):
#: an element near 0 whose sign differs moves by 2 lr).
#: bf16: gradients computed in two libraries' orders sit apart by the
#: rounding of bf16 sums, amplified by cancellation: 4.8% median and 5.7%
#: at most at full width (on the H100), while each side sits 10-11% (median
#: leaf; 12-13% the largest) from a float32 step: a bf16 step held to a
#: float32 one would fail 0.08. Updates: 0.224 in every run on the H100
#: (the card's runs bit-equal to each other; PERF.md).
#: float32: the same products with float32 sums: gradients 3.7e-6 and
#: updates 2.7e-4 apart on the H100 (the CPU against the reference at 24
#: layers: 1.4e-5, ``tests/test_torch_train_depth.py``); a wrong tile,
#: expert or layer shows at once.
TWIN_LAYERS = 2
TWIN_BATCH = 4
TWIN_CARD_RUNS = 3
TWIN_LOSS_RTOL = 1e-3
TWIN_GRAD_RTOL = 0.08
TWIN_UPDATE_RTOL = 0.25
TWIN_F32_LOSS_RTOL = 1e-5
TWIN_F32_GRAD_RTOL = 1e-4
TWIN_F32_UPDATE_RTOL = 5e-3
#: Held-out perplexity on the ragged kernels against the padded layout on
#: the card, relative (the same products summed in other orders; the CPU
#: tests hold both layouts to the reference within 2e-3).
TRAIN_PPL_RTOL = 2e-3
#: ... and the logits of every held-out position, max |ragged - padded|
#: (bit-equal on the H100). The trained model sits near the uniform
#: perplexity, where a wrong tile moves the perplexity little but its
#: rows' logits by the FFN's share of them: the int4 bank moves them 3.6
#: from no bank's (the line logs it, for scale).
TRAIN_LOGIT_ATOL = 1e-3
#: The rows the train phase's evaluations launch, by perplexity run.
TRAIN_EVAL_KERNELS = {
    "no bank": (DENSE_FFN_KERNELS, ("grouped_lo_matmul", "ragged_gateup",
                                    "ragged_down")),
    "static int4": (("ragged_gateup", "ragged_down"),
                    ("grouped_lo_matmul",) + DENSE_FFN_KERNELS),
    "int2 + hot bf16": (("ragged_gateup", "ragged_down"),
                        ("grouped_lo_matmul",) + DENSE_FFN_KERNELS),
}
#: The checkpoint needs this much more free space than its bytes.
TRAIN_CKPT_SLACK = 1.2
#: (d) saves and loads the first TRAIN_CKPT_LAYERS of (a)'s 24 layers
#: (every leaf outside the blocks whole): ~5 GB on disk, not 16.
TRAIN_CKPT_LAYERS = 6


def _train_launcher(card) -> dict:
    """(a) ``launch.train.main`` at ``--full``: 20 steps, every loss
    finite, the held-out perplexity (the all-hi kernels, row 7: one launch
    per layer and batch each, and nothing else of the port: no training
    step reached a kernel), its cross-entropy TRAIN_DROP below the seeded
    weights' on the same batches; the median step time of the last
    TRAIN_TIMED steps (CUDA events), tokens/s, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.training import SyntheticLMTask
    from repro_torch.training.train import eval_perplexity
    full = get_config(TRAIN_ARCH)
    seeded = init_params(full, seed=0, device=torch.device("cuda"))
    ppl0 = eval_perplexity(full, seeded, SyntheticLMTask(
        full.vocab_size, seed=0).batches(TRAIN_BATCH, TRAIN_SEQ, 3,
                                         seed=9999))
    del seeded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # the main path starts here
    t0 = time.perf_counter()
    out = train.main(list(TRAIN_ARGV))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)            # ... and ends here
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, steps = out["cfg"], out["steps"]
    losses = [s["loss"] for s in steps]
    ces = [s["ce"] for s in steps]
    if len(steps) != TRAIN_STEPS or \
            not all(map(math.isfinite, losses + ces)) or \
            not math.isfinite(out["ppl"]):
        raise AssertionError(f"train: losses {losses}, ppl {out['ppl']}")
    drop = math.log(ppl0) - math.log(out["ppl"])
    if not drop >= TRAIN_DROP:
        raise AssertionError(f"train: held-out cross-entropy "
                             f"{math.log(ppl0):.4f} -> "
                             f"{math.log(out['ppl']):.4f}, not {TRAIN_DROP} "
                             f"lower")
    evals = 3 * cfg.n_layers
    want = {k: evals if k in DENSE_FFN_KERNELS else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, want {want} (the "
                             f"held-out evaluation's row 7 alone)")
    ms = sorted(s["ms"] for s in steps[-TRAIN_TIMED:])
    med = float(np.median(ms))
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    log("train", f"(a) launcher {TRAIN_ARCH} {' '.join(TRAIN_ARGV)}: "
                 f"{out['n_params'] / 1e9:.3f} B parameters, {secs:.1f} s in "
                 f"process (weights drawn, {TRAIN_STEPS} steps, held-out "
                 f"perplexity {out['ppl']:.2f}) | held-out cross-entropy "
                 f"{math.log(ppl0):.4f} (seeded) -> "
                 f"{math.log(out['ppl']):.4f} (trained), drop {drop:.4f} "
                 f"(min {TRAIN_DROP}) | loss by step "
                 f"{[round(x, 4) for x in losses]}, ce "
                 f"{[round(x, 4) for x in ces]} | step ms (events) "
                 f"median of the last {TRAIN_TIMED} {med:.2f} (min "
                 f"{ms[0]:.2f}, max {ms[-1]:.2f}; first step "
                 f"{steps[0]['ms']:.2f}) = {tokens / med * 1e3:.0f} tokens/s "
                 f"| max allocated {peak / 1e9:.2f} GB | launches "
                 f"{launches} | {card}")
    out.update(launches=launches, step_ms=med, peak=peak)
    return out


def _twin_grads(cfg, params, batch):
    """(loss, gradients, the parameters after one AdamW step) of
    ``params``' step on ``batch``, in float32 on the step's device."""
    from repro_torch.training import AdamWConfig, TrainConfig, adamw_init
    from repro_torch.training import adamw_update
    from repro_torch.core import tree as T
    from repro_torch.training.train import _grads
    loss, _, grads = _grads(params, cfg, batch, TrainConfig())
    new, _, m = adamw_update(AdamWConfig(), params,
                             T.unflatten(params, grads), adamw_init(params))
    return float(loss), [g.float() for g in grads], \
        [p.float() for p in T.leaves(new)], float(m["gnorm"])


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _to_card(step, dev):
    """A ``_twin_grads`` result with its tensors on ``dev``."""
    loss, grads, new, gnorm = step
    return loss, [g.to(dev) for g in grads], [p.to(dev) for p in new], gnorm


def _twin_errors(got, want, old, paths):
    """The loss's relative error, and each leaf's relative L2 error of the
    gradient and of the update, of step ``got`` against step ``want``."""
    g_err = {p: _rel(a, b) for p, a, b in zip(paths, got[1], want[1])}
    u_err = {p: _rel(a - o, b - o)
             for p, a, b, o in zip(paths, got[2], want[2], old)}
    return abs(got[0] - want[0]) / abs(want[0]), g_err, u_err


def _train_twin(card):
    """(b) One step at full width, 2 of 24 layers, on the card and on the
    CPU's plain path, same weights and batch, in bf16 (the card's step
    TWIN_CARD_RUNS times) and in float32: loss, each gradient leaf and each
    leaf's update against the CPU's. Runs the card's steps and starts the
    CPU's in a thread; returns the function that joins them and holds the
    two."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training import SyntheticLMTask
    from repro_torch.core import tree as T
    from repro_torch.training.train import to_batch
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TWIN_LAYERS)
    cpu_params = init_params(cfg, seed=1, device="cpu")
    cpu32 = T.tree_map(lambda t: t.float(), cpu_params)
    batch = next(SyntheticLMTask(cfg.vocab_size, seed=0).batches(
        TWIN_BATCH, TRAIN_SEQ, 1, seed=4321))
    dev = torch.device("cuda")
    runs = [_twin_grads(cfg, _to(cpu_params, dev), to_batch(batch, dev))
            for _ in range(TWIN_CARD_RUNS)]
    got32 = _twin_grads(cfg, _to(cpu32, dev), to_batch(batch, dev))
    t1 = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    job = pool.submit(lambda: (
        _twin_grads(cfg, cpu_params, to_batch(batch, "cpu")),
        _twin_grads(cfg, cpu32, to_batch(batch, "cpu")),
        time.perf_counter()))
    pool.shutdown(wait=False)

    def join() -> None:
        tj = time.perf_counter()
        want, want32, t_done = job.result()
        # Compared on the card: the host's passes over 2 x 0.2 B elements
        # per step took seconds.
        want, want32 = (_to_card(w, dev) for w in (want, want32))
        paths = T.flatten(cpu_params)[0]
        old = [p.to(dev).float() for p in T.leaves(cpu_params)]
        errs = [_twin_errors(r, want, old, paths) for r in runs]
        l_err = max(e[0] for e in errs)
        g_err = {p: max(e[1][p] for e in errs) for p in paths}
        u_err = {p: max(e[2][p] for e in errs) for p in paths}
        spread = max(_rel(a, b) for r in runs[1:]
                     for a, b in zip(r[1], runs[0][1]))
        l32, g32, u32 = _twin_errors(got32, want32, old, paths)
        noise = [sorted(_rel(a, f) for a, f in zip(side[1], got32[1]))
                 for side in (runs[0], want)]
        worst_g, worst_u = max(g_err, key=g_err.get), max(u_err,
                                                          key=u_err.get)
        w32_g, w32_u = max(g32, key=g32.get), max(u32, key=u32.get)
        log("train", f"(b) twin: {cfg.name} full width, {TWIN_LAYERS} of "
                     f"24 layers, one step on {TWIN_BATCH} x 64 tokens, card "
                     f"vs CPU. bf16, worst of {TWIN_CARD_RUNS} card runs: "
                     f"loss {runs[0][0]:.5f} vs {want[0]:.5f} (rel "
                     f"{l_err:.2e}, tol {TWIN_LOSS_RTOL}); gnorm "
                     f"{runs[0][3]:.4f} vs {want[3]:.4f}; gradients' rel L2 "
                     f"max {g_err[worst_g]:.4f} ({worst_g}; tol "
                     f"{TWIN_GRAD_RTOL}), median "
                     f"{float(np.median(list(g_err.values()))):.4f}; card "
                     f"runs apart by at most {spread:.4f}; each side's "
                     f"distance to the card's float32 step, median / max "
                     f"leaf: card {np.median(noise[0]):.4f} / "
                     f"{noise[0][-1]:.4f}, CPU {np.median(noise[1]):.4f} / "
                     f"{noise[1][-1]:.4f}; updates' rel L2 max "
                     f"{u_err[worst_u]:.4f} ({worst_u}; tol "
                     f"{TWIN_UPDATE_RTOL}), by run "
                     f"{[round(max(e[2].values()), 4) for e in errs]}. "
                     f"float32: loss rel {l32:.2e} (tol "
                     f"{TWIN_F32_LOSS_RTOL}); gradients' rel L2 max "
                     f"{g32[w32_g]:.2e} ({w32_g}; tol {TWIN_F32_GRAD_RTOL}), "
                     f"median {float(np.median(list(g32.values()))):.2e}; "
                     f"updates' rel L2 max {u32[w32_u]:.2e} ({w32_u}; tol "
                     f"{TWIN_F32_UPDATE_RTOL}) | card {t1 - t0:.1f} s "
                     f"(weights drawn on the CPU included), CPU "
                     f"{t_done - t1:.1f} s beside (c) and (d), waited "
                     f"{time.perf_counter() - tj:.1f} s | {card}")
        if l_err > TWIN_LOSS_RTOL or g_err[worst_g] > TWIN_GRAD_RTOL or \
                u_err[worst_u] > TWIN_UPDATE_RTOL or \
                l32 > TWIN_F32_LOSS_RTOL or g32[w32_g] > TWIN_F32_GRAD_RTOL \
                or u32[w32_u] > TWIN_F32_UPDATE_RTOL:
            raise AssertionError("train: the card's step disagrees with the "
                                 "CPU's")
    return join


def _train_perplexity(card, out) -> list:
    """(c) Held-out perplexity of (a)'s trained weights on the launcher's
    held-out batches, on the ragged kernels (no bank: row 7; a static int4
    bank: rows 1-2, every tile lo; int2 lo with a hot bf16 quarter of each
    layer's experts from router counts: rows 1-2, both tiers), each held
    against the same evaluation on the padded layout on the card (row 4
    with a bank), and then its logits on every held-out position. Returns
    the launches of each evaluation."""
    from repro_torch.kernels import ops
    from repro_torch.training.quality import (bank_with_hotset, hot_sets,
                                              hotness_from_counts)
    from repro_torch.training.train import (_forward_with_bank,
                                            eval_perplexity, to_batch)
    cfg, params, task = out["cfg"], out["params"], out["task"]
    L, E = cfg.n_layers, cfg.moe.num_experts
    t0 = time.perf_counter()
    hot = hotness_from_counts(cfg, params,
                              task.batches(TRAIN_BATCH, TRAIN_SEQ, 3,
                                           seed=777))
    banks = {"no bank": None,
             "static int4": {"0": bank_with_hotset(params, 4,
                                                   [[]] * L)},
             "int2 + hot bf16": {"0": bank_with_hotset(
                 params, 2, hot_sets(hot, E // 4))}}
    held_out = [to_batch(b, torch.device("cuda")) for b in task.batches(
        TRAIN_BATCH, TRAIN_SEQ, 3, seed=9999)]
    t1 = time.perf_counter()
    runs, parts, first = [], [], None
    for name, bank in banks.items():
        ppl, logits = {}, {}
        for dispatch in ("ragged", "padded"):
            ops.reset_launches()             # the evaluation starts here
            ppl[dispatch] = eval_perplexity(
                cfg, params, task.batches(TRAIN_BATCH, TRAIN_SEQ, 3,
                                          seed=9999),
                bank=bank, dispatch=dispatch)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)    # ... and ends here
            runs.append({"launches": launches})
            used, unused = TRAIN_EVAL_KERNELS[name]
            if dispatch == "padded":
                used = ("grouped_lo_matmul",) if bank is not None else ()
                unused = ("ragged_gateup", "ragged_down") + DENSE_FFN_KERNELS
            if not all(launches[k] == 3 * L * (1 + (k == "grouped_lo_matmul")
                                               * 2) for k in used) or \
                    any(launches[k] for k in unused):
                raise AssertionError(f"train (c) {name} {dispatch}: "
                                     f"launches {launches}")
            with torch.no_grad():
                logits[dispatch] = [_forward_with_bank(
                    params, cfg, {"tokens": b["tokens"]}, bank, 4.0,
                    dispatch) for b in held_out]
        rel = abs(ppl["ragged"] - ppl["padded"]) / ppl["padded"]
        dl = _max_abs(logits["ragged"], logits["padded"])
        moved = "" if first is None else \
            f", {_max_abs(logits['ragged'], first):.4f} from no bank's"
        first = logits["ragged"] if first is None else first
        parts.append(f"{name}: ragged {ppl['ragged']:.4f}, padded "
                     f"{ppl['padded']:.4f} (rel {rel:.2e}), logits max "
                     f"|ragged - padded| {dl:.2e}{moved}")
        if not all(map(math.isfinite, ppl.values())) or \
                rel > TRAIN_PPL_RTOL or not dl <= TRAIN_LOGIT_ATOL:
            log("train", f"(c) {parts[-1]}")
            raise AssertionError(f"train (c) {name}: perplexity {ppl}, "
                                 f"logits apart by {dl}")
        del logits
    log("train", f"(c) held-out perplexity of the trained {cfg.name} (3 x "
                 f"16 x 64 tokens), ragged kernels vs the padded layout "
                 f"(tol {TRAIN_PPL_RTOL} rel; logits tol {TRAIN_LOGIT_ATOL} "
                 f"abs; largest |logit| "
                 f"{max(float(x.abs().max()) for x in first):.3f}): "
                 f"{'; '.join(parts)} | hot "
                 f"sets of {E // 4} per layer from {int(hot.sum())} router "
                 f"selections; banks built in {t1 - t0:.1f} s, evaluations "
                 f"{time.perf_counter() - t1:.1f} s | {card}")
    return runs


def _max_abs(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def _first_layers(tree, n: int):
    """``tree`` with every leaf under a "blocks" key (stacked over layers)
    cut to its first ``n`` layers: a shallower model's tree."""
    if isinstance(tree, dict):
        return {k: (_first_layers(v, n) if k != "blocks" else
                    _stacked_head(v, n)) for k, v in tree.items()}
    return tree


def _stacked_head(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked_head(v, n) for k, v in tree.items()}
    return tree if tree is None else tree[:n]


def _train_checkpoint(card, out) -> None:
    """(d) (a)'s parameters and optimizer state, cut to its first
    TRAIN_CKPT_LAYERS layers, to a temporary directory in the reference's
    layout and back: every leaf bit-equal."""
    import shutil
    import tempfile
    from repro_torch.training import load_checkpoint, save_checkpoint
    from repro_torch.core import tree as T
    tree = _first_layers({"params": out["params"], "opt": out["opt_state"]},
                         TRAIN_CKPT_LAYERS)
    nbytes = sum(t.numel() * max(4, t.element_size())
                 for t in T.leaves(tree))
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < TRAIN_CKPT_SLACK * nbytes:
        raise AssertionError(f"train (d): {free / 1e9:.1f} GB free under "
                             f"{tmp}, the checkpoint needs "
                             f"{nbytes / 1e9:.1f} GB")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(d, tree, step=TRAIN_STEPS)
        t1 = time.perf_counter()
        back, step = load_checkpoint(d, tree)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bad = [p for p, a, b in zip(T.flatten(tree)[0], T.leaves(tree),
                                    T.leaves(back))
               if a.dtype != b.dtype or a.device != b.device
               or not torch.equal(a, b)]
        n = len(T.leaves(tree))
    log("train", f"(d) checkpoint of the trained parameters and optimizer "
                 f"state, the first {TRAIN_CKPT_LAYERS} layers: {n} leaves, {nbytes / 1e9:.2f} GB on disk (bf16 as "
                 f"float32), saved in {t1 - t0:.1f} s, loaded back to the "
                 f"card in {t2 - t1:.1f} s; step {step}; "
                 f"{n - len(bad)} of {n} leaves bit-equal | {card}")
    if bad or step != TRAIN_STEPS:
        raise AssertionError(f"train (d): leaves {bad[:5]} differ")


def phase_train(card: str) -> None:
    """Training on the card: (a) the launcher at full width and depth, (b)
    the twin of one step on the CPU, (c) perplexity of (a)'s weights under
    three banks on the ragged kernels against the padded layout, (d) a
    checkpoint round trip. The launches of (a) and (c) go to the kernels'
    line."""
    t0 = time.perf_counter()
    out = _train_launcher(card)
    t1 = time.perf_counter()
    twin = _train_twin(card)
    t2 = time.perf_counter()
    runs = [{"launches": out["launches"]}] + _train_perplexity(card, out)
    t3 = time.perf_counter()
    _train_checkpoint(card, out)
    t4 = time.perf_counter()
    del out
    twin()
    for name in RESULTS:
        RESULTS[name]["launches"] = RESULTS[name].get("launches", 0) + sum(
            r["launches"].get(name, 0) for r in runs)
    log("train", f"phase done in {time.perf_counter() - t0:.1f} s "
                 f"(launcher {t1 - t0:.1f} s, twin's card half "
                 f"{t2 - t1:.1f} s, perplexity {t3 - t2:.1f} s, checkpoint "
                 f"{t4 - t3:.1f} s, the twin's CPU half joined "
                 f"{time.perf_counter() - t4:.1f} s after) | {card}")


# ---------------------------------------------------------------------------
# 5l. ep: expert parallelism over torch.distributed, ranks on the one card
# ---------------------------------------------------------------------------

#: Layers of the ep phase's Qwen3-30B-A3B (of 48, full width): each rank
#: draws every dense weight and its bf16 host masters (1.2 GB per layer
#: per rank), and the phase has ~20 s of the default run (on an H100 80GB
#: HBM3 at 700 W, 2 layers took 20.7 s and the whole run 601.0 s, over
#: its 600 s target).
EP_LAYERS = 1
EP_WORLD = 4                   # ranks on the card; N = 2 is ranks 0 and 1
EP_SLOTS = 8
EP_REQUESTS = 8
EP_NEW = 16
EP_PROMPTS = (32, 96)
EP_N_HI = 16                   # hi slots per layer: 4 per shard at N = 4
EP_SEED = 29
#: (c): T divisible by no N, so the padded regime runs; each rank adds its
#: experts' share of a token's top-8 contributions in bf16 and the ranks'
#: partial outputs sum in float32, rounded once, where the single process
#: adds all 8 in bf16: up to 7 roundings apart, 2^-6 of the largest
#: magnitude (the CPU test, at top-2, holds 2^-7).
EP_PADDED_T = 63
EP_PADDED_TOL = 2.0 ** -6
#: (b): a relabel leaves the layer's function unchanged in exact
#: arithmetic, and the routing exactly (the counts permute). In bf16 the
#: combine adds a token's top-8 contributions in the order of their expert
#: positions, so a row routed to a moved expert is summed in another order:
#: up to 7 roundings of the partial sums, 2^-6 of the largest magnitude.
#: (At the reference test's top-2 the two orders give the same bits: the
#: CPU test holds its relabel bit-equal.)
EP_RELABEL_TOL = 2.0 ** -6
#: The kernels of the EP runs: the quantized ragged FFN (rows 1-2) and the
#: paged decode attention (row 3), the all-hi pair (row 7) for fp16; the
#: padded case (c) runs the grouped GEMM (row 4).
EP_KERNELS = {"dynaexq": ("ragged_gateup", "ragged_down",
                          "flash_decode_paged"),
              "static": ("ragged_gateup", "ragged_down",
                         "flash_decode_paged"),
              "fp16": DENSE_FFN_KERNELS + ("flash_decode_paged",)}
EP_RUNS = {4: ("dynaexq",), 2: ("dynaexq", "static", "fp16")}


def _ep_model(dev):
    """The phase's model on ``dev``: (cfg, seeded params, prompts), the
    same bits in every process."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config(ARCH), n_layers=EP_LAYERS)
    return cfg, init_params(cfg, seed=EP_SEED, device=dev), \
        serving_prompts(cfg.vocab_size, EP_REQUESTS, EP_PROMPTS, EP_SEED)


def _ep_serve(cfg, params, prompts, name, dev, ctx=None):
    """One drop-free run of ``name`` over fresh routers (the coordinator
    swaps a router in place), op by op (``eager()``; under ``ctx`` the
    engine runs so anyway): the main path's launches, sharded regimes and
    bytes sent counted from zero over the run. Returns (engine,
    summary)."""
    import repro_torch.models.moe as moe_mod
    import repro_torch.serving.engine as eng_mod
    from repro_torch.core.controller import ControllerConfig, RebalanceConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dist as D
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    n = 1 if ctx is None else ctx.model_size
    kw = {"dynaexq": dict(lo_bits=4, group_size=64, n_hi_per_layer=EP_N_HI,
                          ep_shards=n,
                          controller=ControllerConfig(update_interval_s=1e9),
                          rebalance=RebalanceConfig(interval_s=1e9)
                          if n > 1 else None),
          "static": dict(lo_bits=4, group_size=64), "fp16": {}}[name]
    p = _fresh(params)
    for blk in p["blocks"].values():
        if "moe" in blk:
            blk["moe"]["router"] = blk["moe"]["router"].clone()
    # Capacity factor E/k: a forward's capacity covers all of its tokens,
    # so no assignment drops. Under drops the all-to-all regime keeps per
    # (expert, sender) slices of the capacity (the reference's rule), and
    # its drops need not be the single process's.
    engine = eng_mod.InferenceEngine(
        cfg, p, make_backend(name, device=dev, **kw),
        eng_mod.EngineConfig(
            max_slots=EP_SLOTS, max_len=-(-(EP_PROMPTS[1] + EP_NEW) // 16) *
            16, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k),
        device=dev, dist=ctx)
    ops.reset_launches()                 # the main path starts here
    moe_mod.reset_regimes()
    D.reset_sent()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(Request(tokens=q, max_new_tokens=EP_NEW))
               for q in prompts]
    with eng_mod.eager():
        engine.drain()
    engine.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)        # ... and ends here
    st = engine.stats()
    assert all(len(h.tokens) == EP_NEW for h in handles)
    assert bool(torch.isfinite(engine.last_logits).all())
    return engine, {
        "tokens": [list(h.tokens) for h in handles],
        "logits": engine.last_logits.float().cpu(), "launches": launches,
        "regimes": dict(moe_mod.REGIMES), "sent": {k: dict(v) for k, v in D.SENT_BYTES.items()},
        "tpot_s": st["tpot_s"], "ttft_s": st["ttft_s"], "wall_s": wall,
        "steps": int(st["steps"]), "expert_bytes": engine.device_bytes(),
        "host_master_bytes": engine.backend.host_master_bytes(),
        "graphed": engine.graphed}


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS"))
    return kb / 1e6


def _ep_layer(engine, ctx, x, l=0):
    """MoE position 0's layer ``l`` on ``x`` (the served bank) under
    ``ctx``: (y, counts)."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.launch.dist import dist_ctx
    cfg = engine.cfg
    pos = str(engine.backend.moe_positions[0])
    moe = engine.params["blocks"][pos]["moe"]
    bank = engine.banks[pos].layer(l) if engine.banks else \
        {k: v[l] for k, v in moe["experts"].items()}
    with dist_ctx(ctx):
        y, aux = moe_mod.moe_apply(
            {"router": moe["router"][l]}, bank, x, cfg.moe,
            moe_mod.moe_capacity(x.shape[0], cfg.moe))
    return y, aux.counts


def _ep_bytes(engine, ctx, gen) -> dict:
    """(d) one decode-shaped layer call (EP_SLOTS tokens): the bytes this
    rank sent by collective, and the reference's model of the payload,
    2·(N−1)·S·d elements out and back, plus the (N, E/N) counts."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.launch import dist as D
    cfg = engine.cfg
    x = torch.randn((EP_SLOTS, cfg.d_model), generator=gen,
                    device=ctx.device).to(torch.bfloat16)
    D.reset_sent()
    _ep_layer(engine, ctx, x)
    n, E = ctx.model_size, cfg.moe.num_experts
    S = moe_mod.ep_payload_rows(EP_SLOTS, cfg.moe.top_k, E // n,
                                moe_mod.moe_capacity(EP_SLOTS, cfg.moe), n)
    return {"sent": {k: dict(v) for k, v in D.SENT_BYTES.items()}, "S": S,
            "model_rows": 2 * (n - 1) * S * cfg.d_model * 2,
            "counts": (n - 1) * (E // n) * 8}


def _ep_state(engine) -> list:
    """Copies of what a migration touches, per MoE position: this rank's
    lo leaves, the router, the placement."""
    return [({k: (q.packed.clone(), q.scales.clone())
              for k, q in ctl.bank.lo.items()}, moe["router"].clone(),
             placement.copy())
            for ctl, moe, placement in engine.backend.coordinator._entries]


def _ep_same(a, b) -> bool:
    return all(torch.equal(ra, rb) and np.array_equal(pa, pb) and
               all(torch.equal(x, y) for k in la for x, y in zip(la[k],
                                                                  lb[k]))
               for (la, ra, pa), (lb, rb, pb) in zip(a, b))


def _ep_promote_rebalance(engine, ctx, gen) -> dict:
    """(b) at N = 4: a forced promotion window (every published expert on
    a slot of its own shard, its rows landed on the owner's device,
    ``check_invariants`` on every rank), a forced rebalance after a skew
    on two lo experts of shard 0 per layer (the layer's output bit-equal
    before and after, its counts permuted with the placement, no
    demotion), then ``ep_mig`` faults mid-swap and before it (rolled back
    bit for bit, the window's bytes refunded)."""
    from repro_torch.fault.inject import FaultPlan, FaultRule
    from repro_torch.obs.trace import FlightRecorder
    be = engine.backend
    be.force_update()
    be.flush()
    out = {"promoted": 0, "shard_correct": True, "landed": True}
    for ctl in be.controllers.values():
        tm = ctl.tm
        tm.check_invariants()
        out["promoted"] += tm.stats["promoted"]
        per = tm.pools[0].per_shard
        for l, s in zip(*np.nonzero(tm.slot_owner_h >= 0)):
            e = int(tm.slot_owner_h[l, s])
            out["shard_correct"] &= tm.pools[l].shard_of(int(s)) == \
                tm.shard_of_expert(e)
            if tm.pools[l].shard_of(int(s)) == ctx.rank:
                out["landed"] &= all(
                    torch.equal(leaf[l, int(s) - ctx.rank * per],
                                tm.host_hi[n][l, e].to(leaf.device))
                    for n, leaf in ctl.bank.hi.items())
    ctl = be.controllers[str(be.moe_positions[0])]
    tm, coord = ctl.tm, be.coordinator
    L, E = tm.state.shape
    e_per = E // ctx.model_size
    hot = ctl.hotness.scores + ctl.hotness.counts
    bump = 10.0 * float(coord.shard_loads(hot[0]).mean()) + 100.0
    for l in range(L):
        cold = [e for e in range(e_per) if e not in tm.hi_set(l)][:2]
        ctl.hotness.counts[l, cold] += int(bump)
    import repro_torch.models.moe as moe_mod
    x = torch.randn((EP_SLOTS, engine.cfg.d_model), generator=gen,
                    device=ctx.device).to(torch.bfloat16)
    y0, c0 = _ep_layer(engine, ctx, x)
    moe = coord._entries[0][1]
    _, idx, _ = moe_mod.route(moe["router"][0], x, engine.cfg.moe)
    placement = coord._entries[0][2]
    before, demoted = placement.copy(), tm.stats["demoted"]
    out["migrated"] = coord.maybe_rebalance(force=True)
    y1, c1 = _ep_layer(engine, ctx, x)
    tm.check_invariants()
    perm = np.argsort(before[0])[placement[0]]
    moved = torch.as_tensor(np.nonzero(placement[0] != before[0])[0],
                            device=idx.device)
    touched = torch.isin(idx, moved).any(dim=1)
    same = (y0 == y1).all(dim=1)
    out["forward_same"] = bool(torch.equal(y0, y1))
    out["forward_diff"] = float((y0.float() - y1.float()).abs().max())
    out["forward_tol"] = EP_RELABEL_TOL * float(y0.float().abs().max())
    out["rows_same"] = int(same.sum())
    out["rows_touched"] = int(touched.sum())
    out["untouched_same"] = int((same & ~touched).sum())
    out["counts_permuted"] = bool(np.array_equal(
        c1.cpu().numpy(), c0.cpu().numpy()[perm]))
    out["demoted_in_rebalance"] = tm.stats["demoted"] - demoted
    out["y"] = y1.float().cpu()
    # ep_mig: a pair of lo experts across the first and last shard.
    tracer = FlightRecorder()
    coord.tracer = tracer
    moe = coord._entries[0][1]
    e = next(i for i in range(e_per) if i not in tm.hi_set(0))
    f = next(i for i in range(E - 1, E - e_per - 1, -1)
             if i not in tm.hi_set(0))
    tm.rate_limit = 1 << 40            # metered, never binding
    for kind in ("corrupt", "fail"):
        coord.injector = FaultPlan(seed=EP_SEED, rules=(
            FaultRule(site="ep_mig", kind=kind, every=1),)).injector()
        state, aborted = _ep_state(engine), coord.stats["aborted_migrations"]
        tm._window_used = 0
        ok = coord._migrate(ctl, moe, placement, 0, e, f)
        out[f"fault {kind}"] = (
            not ok and _ep_same(state, _ep_state(engine)) and
            coord.stats["aborted_migrations"] - aborted == 1 and
            tm._window_used == 0)
    out["fault_cancel_events"] = len(tracer.instants("fault_cancel"))
    coord.injector = coord.tracer = None
    tm.rate_limit = 0
    return out


def _ep_padded(cfg, params, ctx=None) -> dict:
    """(c) layer 0 of a static int4 bank on EP_PADDED_T tokens: under
    ``ctx`` the padded regime (row 4 on this rank's experts), else the
    single process's padded dispatch."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.core.ver import build_bank
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import dist_ctx
    moe = params["blocks"]["0"]["moe"]
    bank = build_bank({k: v[:1] for k, v in moe["experts"].items()}, n_hi=0,
                      lo_bits=4, shard=None if ctx is None
                      else (ctx.rank, ctx.model_size)).layer(0)
    dev = bank.slot_map.device
    gen = torch.Generator(device=dev).manual_seed(EP_SEED + 2)
    x = torch.randn((EP_PADDED_T, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    ops.reset_launches()
    moe_mod.reset_regimes()
    with dist_ctx(ctx):
        y, aux = moe_mod.moe_apply(
            {"router": moe["router"][0]}, bank, x, cfg.moe,
            moe_mod.moe_capacity(EP_PADDED_T, cfg.moe),
            dispatch="padded" if ctx is None else "ragged")
    torch.cuda.synchronize()
    return {"y": y.float().cpu(), "counts": aux.counts.cpu(),
            "launches": dict(ops.LAUNCHES),
            "regimes": dict(moe_mod.REGIMES)}


#: (e) the mesh's data axis: the 30B at the phase's depth on a 2 x 2
#: (data x model) grid of the phase's ranks; EP_GRID_ROWS dense rows of
#: EP_GRID_PROMPT tokens prefilled, then EP_GRID_STEPS decode steps fed
#: seeded tokens (teacher-forced, so that every regime sees the same
#: inputs), drop-free (capacity factor E/k). The bank holds EP_GRID_N_HI
#: published hi experts per layer (slot s: expert s·E/EP_GRID_N_HI, on
#: the model shard of its slot).
EP_GRID_ROWS, EP_GRID_PROMPT, EP_GRID_STEPS = 8, 32, 8
EP_GRID_N_HI = 4
#: (e)'s regimes: name → (the MoE call's regime, the tokens split over
#: data, the experts' FF dims sliced over data, tokens over data x model,
#: the dense bf16 experts in place of the int4 bank (fp16 serving), the
#: single process's run it is held to).
EP_GRID_REGIMES = {
    "a": ("padded_dp", True, False, False, False, "padded"),
    "b": ("padded_ff", False, True, False, False, "padded"),
    "c": ("all_to_all_dp", True, False, True, False, "ragged"),
    "c fp16": ("all_to_all_dp", True, False, True, True, "ragged fp16")}
#: The kernels each regime of (e) must launch on every rank: the grouped
#: GEMM (row 4) in the padded regimes, the ragged FFN (rows 1-2) in the
#: all-to-all, its all-hi mode (row 7) on the dense experts; the dense
#: decode attention (row 5) in each.
EP_GRID_KERNELS = {"a": ("grouped_lo_matmul", "flash_decode"),
                   "b": ("grouped_lo_matmul", "flash_decode"),
                   "c": ("ragged_gateup", "ragged_down", "flash_decode"),
                   "c fp16": DENSE_FFN_KERNELS + ("flash_decode",)}
#: (f): forward_train's loss of the 30B at the phase's depth on a 1 x 3
#: grid of ranks 0-2 (32 heads % 3: sequence-parallel attention; 128
#: experts % 3: every rank's whole bank), float32, EP_SP_B rows of
#: EP_SP_S tokens (a multiple of 3), against one process; the reference's
#: bar for its sharded forward, 1e-4 of the largest |logit|.
EP_SP_B, EP_SP_S = 2, 48
EP_SP_TOL = 1e-4


def _grid_bank(cfg, params):
    """(e)'s stacked int4 bank of MoE position 0 ({position: bank}), with
    EP_GRID_N_HI hi experts published."""
    from repro_torch.core.ver import build_bank
    experts = params["blocks"]["0"]["moe"]["experts"]
    E = cfg.moe.num_experts
    bank = build_bank(experts, n_hi=EP_GRID_N_HI, lo_bits=4, group_size=64)
    for s in range(EP_GRID_N_HI):
        e = s * E // EP_GRID_N_HI
        for n in bank.hi:
            bank.hi[n][:, s] = experts[n][:, e]
        bank.slot_owner[:, s] = e
        bank.slot_map[:, e] = s
    return {"0": bank}


def _bank_bytes(banks) -> int:
    """Device bytes of the int4 banks' leaves (codes, scales, hi pool), or
    of a dense experts dict's {position: {name: (L, E, K, N)}}."""
    return sum(t.numel() * t.element_size() for b in banks.values()
               for t in (list(b.values()) if isinstance(b, dict) else
                         [x for q in b.lo.values() for x in (q.packed,
                                                             q.scales)]
                         + list(b.hi.values())))


def _with_experts(params, experts_of):
    """``params`` with MoE position 0's dense experts replaced by
    ``experts_of(experts)``."""
    blk = params["blocks"]["0"]
    moe = dict(blk["moe"], experts=experts_of(blk["moe"]["experts"]))
    return dict(params, blocks=dict(params["blocks"], **{"0": dict(
        blk, moe=moe)}))


def _grid_run(cfg, params, banks, ctx, dispatch) -> dict:
    """(e) one run on the batch entry points under ``ctx`` (None: one
    process) with ``banks`` (None: the dense experts in ``params``):
    prefill, then the decode steps, launches and regimes counted from
    zero over it (the main path of this run). Returns the logits of every
    step (prefill first), their argmax tokens, the prefill's counts,
    launches, regimes and seconds."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.models.model import decode_step, init_caches, prefill
    dev = params["embed"].device
    B, P = EP_GRID_ROWS, EP_GRID_PROMPT
    gen = torch.Generator().manual_seed(EP_SEED + 3)
    tok = torch.randint(1, cfg.vocab_size, (B, P + EP_GRID_STEPS),
                        generator=gen).to(dev)
    cf = cfg.moe.num_experts / cfg.moe.top_k
    caches = init_caches(cfg, B, P + EP_GRID_STEPS, device=dev)
    ops.reset_launches()                 # the main path starts here
    moe_mod.reset_regimes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), dist_ctx(ctx):
        lg, counts = prefill(params, cfg, tok[:, :P], caches,
                             torch.full((B,), P, device=dev), bank=banks,
                             capacity_factor=cf, moe_dispatch=dispatch)
        steps = [lg]
        for i in range(EP_GRID_STEPS):
            lg, _ = decode_step(params, cfg, tok[:, P + i],
                                torch.full((B,), P + i, device=dev), caches,
                                bank=banks, capacity_factor=cf,
                                moe_dispatch=dispatch)
            steps.append(lg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)        # ... and ends here
    logits = torch.stack(steps).float().cpu()
    assert bool(torch.isfinite(logits).all())
    return {"logits": logits, "tokens": logits.argmax(-1),
            "counts": counts["0"].cpu(), "launches": launches,
            "regimes": dict(moe_mod.REGIMES), "s": wall}


def _grid_sent_expected(cfg, regime: str, T: int, n_slot: int) -> dict:
    """The bytes one rank of the 2 x 2 grid sends in one MoE layer call of
    ``regime`` on T tokens (derived in PERF.md): by collective and
    axis, as ``launch.dist.SENT_BYTES`` prices them (an all-reduce a
    ring's 2(n-1)/n of its buffer, an all-gather (n-1) copies of this
    rank's part, an all-to-all the (n-1)/n of its buffer bound elsewhere;
    n = 2 on either axis, 4 on the token axes)."""
    import repro_torch.models.moe as moe_mod
    d, E, k, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k, \
        cfg.moe.d_ff_expert
    mn = dp = 2
    e_l = E // mn
    zero = {"model": 0, "data": 0, "tokens": 0}
    out = {c: dict(zero) for c in ("all_to_all", "exchange", "all_gather",
                                   "all_reduce", "broadcast",
                                   "reduce_scatter")}
    if regime == "c":
        n_tok = dp * mn
        S = moe_mod.ep_payload_rows(T, k, e_l, moe_mod.moe_capacity(T, cfg.moe),
                                    n_tok)
        out["all_to_all"]["model"] = 2 * (mn - 1) * S * d * 2 + \
            (mn - 1) * e_l * 8
        out["all_gather"]["tokens"] = T // n_tok * d * 2 * (n_tok - 1)
        out["all_reduce"]["tokens"] = (E + 3) * 8 * 2 * (n_tok - 1) // n_tok
        return out
    ring = 2 * (mn - 1) // mn            # = 1 at n = 2, on either axis
    out["all_gather"]["model"] = e_l * 4 * (mn - 1)          # counts
    out["all_reduce"]["model"] = 2 * 8 * ring                # dropped, pad
    if regime == "a":
        t = T // dp
        out["all_reduce"]["model"] += t * d * 4 * ring       # y, float32
        out["all_gather"]["data"] = t * d * 2 * (dp - 1)     # y rows
        out["all_reduce"]["data"] = (E * 8 + 3 * 8) * ring   # counts, means
        return out
    C = moe_mod.moe_capacity(T, cfg.moe)
    out["all_reduce"]["model"] += T * (d // dp) * 4 * ring   # y's columns
    out["all_gather"]["data"] = ((e_l + n_slot) * C * (F // dp) * 2 +
                                 T * (d // dp) * 2) * (dp - 1)   # h, y
    return out


def _grid_rank(cfg, params, ctx) -> dict:
    """(e) on this rank of the 2 x 2 grid ``ctx``: each regime's run on
    this rank's slice of the bank, the bytes it holds, one decode-shaped
    layer call's bytes sent by collective and axis; then a slice the
    grouped GEMM's kernel cannot take (an 8-way FF slice of gate/up: 96
    columns) raises on the card rather than running a plain version."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import dist as D
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.launch.sharding import bank_shard
    full = _grid_bank(cfg, params)
    out = {"coords": (ctx.data_rank, ctx.rank),
           "full_bytes": _bank_bytes(full)}
    gen = torch.Generator(device=ctx.device).manual_seed(EP_SEED + 5)
    x = torch.randn((EP_SLOTS, cfg.d_model), generator=gen,
                    device=ctx.device).to(torch.bfloat16)
    router = params["blocks"]["0"]["moe"]["router"][0]
    for name, (_, dp_split, ff, ep, dense, _) in EP_GRID_REGIMES.items():
        c = dataclasses.replace(ctx, tokens_dp_sharded=dp_split,
                                tokens_ep_sharded=ep)
        if dense:
            p = _with_experts(params, lambda e: bank_shard(e, c))
            banks, layer = None, {k: v[0] for k, v in
                                  p["blocks"]["0"]["moe"]["experts"].items()}
            held = {"0": p["blocks"]["0"]["moe"]["experts"]}
        else:
            p = params
            banks = {k: bank_shard(b, c, ff=ff) for k, b in full.items()}
            layer, held = banks["0"].layer(0), banks
        r = _grid_run(cfg, p, banks, c, "ragged" if ep else "padded")
        r["bytes"] = _bank_bytes(held)
        D.reset_sent()
        with torch.no_grad(), dist_ctx(c):
            moe_mod.moe_apply({"router": router}, layer, x, cfg.moe,
                              moe_mod.moe_capacity(EP_SLOTS, cfg.moe))
        r["sent"] = {k: dict(v) for k, v in D.SENT_BYTES.items()}
        r["n_slot"] = 0 if dense else banks["0"].hi["w_gate"].shape[1]
        out[name] = r
        del banks, held, p
    q = full["0"].lo["w_gate"]
    try:
        ops.grouped_lo_matmul(
            torch.zeros((2, 8, cfg.d_model), dtype=torch.bfloat16,
                        device=ctx.device),
            q.packed[0, :2, :, :96].contiguous(),
            q.scales[0, :2, :, :96].contiguous(), q.bits, q.group_size)
        out["narrow_slice"] = None
    except ValueError as e:
        out["narrow_slice"] = str(e)
    return out


def _grid_sp(cfg, params, ctx) -> dict:
    """(f) forward_train and its loss in float32 under ``ctx`` (None: one
    process): logits, loss, regimes and the sequence-parallel attention
    calls."""
    import repro_torch.models.layers as layers_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.models.model import forward_train
    from repro_torch.training.train import TrainConfig, loss_fn

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return t.float() if t.is_floating_point() else t
    p32 = f32(params)
    dev = params["embed"].device
    gen = torch.Generator().manual_seed(EP_SEED + 4)
    tok = torch.randint(1, cfg.vocab_size, (EP_SP_B, EP_SP_S + 1),
                        generator=gen).to(dev)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    cf = cfg.moe.num_experts / cfg.moe.top_k
    moe_mod.reset_regimes()
    layers_mod.SEQ_PARALLEL["attention_full"] = 0
    with torch.no_grad(), dist_ctx(ctx):
        logits, _ = forward_train(p32, cfg, batch, capacity_factor=cf,
                                  remat=False)
        loss, _ = loss_fn(p32, cfg, batch, TrainConfig(capacity_factor=cf,
                                                      remat=False))
    torch.cuda.synchronize()
    return {"logits": logits.cpu(), "loss": float(loss),
            "regimes": dict(moe_mod.REGIMES),
            "seq_parallel": layers_mod.SEQ_PARALLEL["attention_full"]}


def _grid_single(cfg, params) -> dict:
    """The one-process runs (e) and (f) are held to: the full bank on the
    padded and the ragged dispatch, and (f)'s float32 forward."""
    full = _grid_bank(cfg, params)
    out = {"bytes": _bank_bytes(full),
           "padded": _grid_run(cfg, params, full, None, "padded"),
           "ragged": _grid_run(cfg, params, full, None, "ragged"),
           "ragged fp16": _grid_run(cfg, params, None, None, "ragged"),
           "bytes fp16": _bank_bytes(
               {"0": params["blocks"]["0"]["moe"]["experts"]})}
    del full
    out["f"] = _grid_sp(cfg, params, None)
    return out


#: (g) the planner's specs executed, serving: the 30B at full width,
#: PLAN_LAYERS of 48 layers, a static int4 bank (no hi slot), on the phase's
#: 2 x 2 grid, each rank holding only its shards (``launch.sharding.
#: shard_tree``); dense rows of PLAN_PROMPT tokens prefilled, then
#: PLAN_STEPS teacher-forced decode steps, drop-free (capacity factor E/k),
#: the MoE layers in the all-to-all regime over the model axis on each
#: model group's rows. PLAN_ROWS: 8 rows (over data x model: case h) and 2
#: (over data, the caches' sequence over model: case g, row 5 with its
#: log-sum-exp); held to one process on the ragged dispatch by the model
#: phase's rule: at 128 experts top-8 the ulps a tensor-parallel sum
#: moves tip near ties between the 8th and 9th expert, and a swapped
#: expert moves its row by O(1). Logits of rows whose every token so far
#: took the same experts in both runs within PLAN_TOL of the largest
#: |logit| ((e)'s bar), and at least PLAN_HELD_SHARE of the (rank, row,
#: forward) logits so held (never none); rows routed alike in their own
#: forward within MODEL_TOL, at least half of them; every row within
#: MODEL_TOL_SWAP. Counts exact where they cannot turn on a tie: every
#: row's counts sum to top-k times its tokens in each layer and forward
#: (drop-free), and the ranks of a model group count alike.
PLAN_LAYERS, PLAN_ROWS, PLAN_PROMPT, PLAN_STEPS = 2, (8, 2), 32, 8
PLAN_TOL = 2.0 ** -6
PLAN_HELD_SHARE = 1 / 8
#: (h) training under the FSDP specs: granite at full width, PLAN_LAYERS
#: layers, float32, one train step of PLAN_TRAIN_B rows of PLAN_TRAIN_S
#: tokens on the 2 x 2 grid against one process: the loss within
#: PLAN_LOSS_RTOL, every gathered gradient (AdamW's first moment) and
#: updated parameter within PLAN_GRAD_TOL of its leaf's largest magnitude.
PLAN_TRAIN_B, PLAN_TRAIN_S = 4, 64
PLAN_LOSS_RTOL, PLAN_GRAD_TOL = 1e-5, 1e-4
#: AdamW's first update of an element is g / (|g| + eps) · lr (eps 1e-8):
#: where |g| is within a hundred eps of 0 it swings with the gradient's
#: last bits (one process's float32 sums against the grid's), so the
#: updated parameters are held where the clipped gradient is at least
#: this; the gradients themselves (the first moment m) everywhere.
PLAN_G_FLOOR = 1e-6
#: The kernels (g) may launch, printed per run: rows 1-2 (the all-to-all
#: regime), 4 (the padded regime where a decode step's rows do not split
#: over the model axis), 5 (dense decode attention) and 7 (dense experts).
PLAN_KERNELS = ("ragged_gateup", "ragged_down", "grouped_lo_matmul",
                "flash_decode", "ragged_dense_gateup", "ragged_dense_down")


def _plan_model(dev):
    """(g)'s model on ``dev``: (cfg, params without the dense experts, the
    static int4 bank {position: bank}), the same bits in every process."""
    from repro_torch.configs import get_config
    from repro_torch.core.ver import build_bank
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config(ARCH), n_layers=PLAN_LAYERS)
    params = init_params(cfg, seed=EP_SEED + 7, device=dev)
    banks = {}
    for p, bp in params["blocks"].items():
        if "moe" in bp:
            banks[p] = build_bank(bp["moe"].pop("experts"), n_hi=0,
                                  lo_bits=4, group_size=64)
            bp["moe"]["experts"] = None
    return cfg, params, banks


def _plan_tokens(cfg, B, dev):
    gen = torch.Generator().manual_seed(EP_SEED + 11 + B)
    return torch.randint(1, cfg.vocab_size, (B, PLAN_PROMPT + PLAN_STEPS),
                         generator=gen).to(dev)


def _plan_args(cfg, params, banks, B, ctx=None):
    """(g)'s arguments for a run of B rows on the device of ``params``:
    under ``ctx`` (None: one process) the context with the planner and
    each tree cut to this rank's shards, the bytes it holds against
    ``rank_bytes`` by kind, and its group's rows. Returns (ctx, params,
    banks, caches, inputs, steps, held, rows)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_caches
    from repro_torch.models.specs import layout
    dev = params["embed"].device
    tok = _plan_tokens(cfg, B, dev)
    P = PLAN_PROMPT
    caches = init_caches(cfg, B, P + PLAN_STEPS, device=dev)
    inputs = {"tokens": tok[:, :P], "lengths": torch.full((B,), P,
                                                          device=dev)}
    steps = [{"token": tok[:, P + i], "pos": torch.full((B,), P + i,
                                                        device=dev)}
             for i in range(PLAN_STEPS)]
    held, rows = {}, slice(0, B)
    if ctx is not None:
        pl = SH.ShardingPlanner(cfg, SH.grid_of(ctx))
        ctx = dataclasses.replace(ctx, planner=pl, batch=B,
                                  tokens_ep_sharded=True)
        grid = SH.grid_of(ctx)
        local = {}
        for kind, name, tree in (("param", "params", params),
                                 ("param", "bank", banks),
                                 ("cache", "caches", caches),
                                 ("input", "inputs", inputs)):
            local[name] = SH.shard_tree(tree, kind, pl, ctx)
            held[name] = (SH.held_bytes(local[name], kind == "cache"),
                          SH.rank_bytes(tree, kind, pl, grid))
        params, banks, caches, inputs = (local[k] for k in (
            "params", "bank", "caches", "inputs"))
        steps = [SH.shard_tree(st, "input", pl, ctx) for st in steps]
        rows = layout(ctx).group
    return ctx, params, banks, caches, inputs, steps, held, rows


def _plan_steps(cfg, params, banks, caches, inputs, steps, ctx):
    """(g)'s and (i)'s calls: the prefill (a VLM's ``image_embeds``, an
    encoder-decoder's ``audio_embeds`` from ``inputs``), then the decode
    steps, under ``ctx`` (ragged dispatch, per-row counts, capacity factor
    E/k: drop-free). Returns (logits, counts, the bytes each collective
    sent in the first decode step, and in the prefill)."""
    from repro_torch.launch import dist as D
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.models.model import decode_step, prefill
    cf = cfg.moe.num_experts / cfg.moe.top_k if cfg.is_moe else 2.0
    sent = None
    with torch.no_grad(), dist_ctx(ctx):
        torch.cuda.synchronize()
        D.reset_sent()
        lg, counts = prefill(params, cfg, inputs["tokens"], caches,
                             inputs["lengths"], bank=banks,
                             capacity_factor=cf, moe_dispatch="ragged",
                             per_row_counts=True,
                             image_embeds=inputs.get("image_embeds"),
                             audio_embeds=inputs.get("audio_embeds"))
        sent_prefill = {k: dict(v) for k, v in D.SENT_BYTES.items()}
        logits, all_counts = [lg], [counts]
        for i, st in enumerate(steps):
            if i == 0:
                torch.cuda.synchronize()
                D.reset_sent()
            lg, counts = decode_step(params, cfg, st["token"], st["pos"],
                                     caches, bank=banks, capacity_factor=cf,
                                     moe_dispatch="ragged",
                                     per_row_counts=True)
            if i == 0:
                sent = {k: dict(v) for k, v in D.SENT_BYTES.items()}
            logits.append(lg)
            all_counts.append(counts)
    return logits, all_counts, sent, sent_prefill


def _plan_serve(cfg, params, banks, B, ctx=None, args=None) -> dict:
    """(g) one run of B rows: prefill, then the decode steps, under ``ctx``
    with the planner (None: one process, ragged dispatch); launches and
    regimes counted from zero over it (the run's main path), the bytes
    each collective sent in the first decode step, the device's memory at
    the run's start and its peak over it (``mem_start``, ``max_mem``: the
    process's whole tree too, which the rank cut its shards from), and on
    the grid the bytes this rank holds against
    ``rank_bytes`` by kind. ``args``: ``_plan_args``' result (another
    run's: (i)'s), else (g)'s."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels import ops
    ctx, params, banks, caches, inputs, steps, held, rows = \
        args if args is not None else _plan_args(cfg, params, banks, B, ctx)
    out = {"held": held, "rows": rows}
    dev = params["embed"].device
    ops.reset_launches()                 # the main path starts here
    moe_mod.reset_regimes()
    torch.cuda.synchronize()
    out["mem_start"] = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, all_counts, out["sent"], out["sent_prefill"] = _plan_steps(
        cfg, params, banks, caches, inputs, steps, ctx)
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    out["max_mem"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = dict(ops.LAUNCHES)          # ... and ends here
    out["regimes"] = dict(moe_mod.REGIMES)
    out["logits"] = torch.stack(logits).float().cpu()
    out["counts"] = [{k: v.cpu() for k, v in c.items()} for c in all_counts]
    assert bool(torch.isfinite(out["logits"]).all())
    return out


def _plan_sent_expected(cfg, B: int) -> dict:
    """The bytes one rank of the 2 x 2 grid sends in one (g) decode step of
    B rows, by collective and axis, from the shapes (``launch.dist.
    SENT_BYTES``' pricing; n = 2 on either axis, so a ring's 2(n-1)/n is
    1): rows over data x model (B = 8): the token and position ids
    gathered over model, q/k/v from the group's rows' local heads to the
    rank's own rows' every head and the attention output back by
    all-to-alls; rows over data (B = 2): q/k/v gathered over model, each
    rank's (o, lse) over its half of the cache gathered and combined. Then
    per layer wo's all-reduce, the MoE layer on the group's tokens (the
    all-to-all regime where they split over model, else the padded one)
    with its group rows' per-row counts, its load-balance statistics
    summed over data; the embedding's all-reduce and the logits' gather
    over model."""
    import repro_torch.models.moe as moe_mod
    a, m = cfg.attn, cfg.moe
    d, hd, V, E = cfg.d_model, a.head_dim, cfg.vocab_size, m.num_experts
    dp = mn = 2
    over = B % (dp * mn) == 0
    Bg = B // dp
    Bo = Bg // mn if over else Bg
    hq, hk = a.n_heads // mn, a.n_kv_heads // mn
    out = {c: {x: 0 for x in ("model", "data", "tokens")}
           for c in ("all_to_all", "exchange", "all_gather", "all_reduce",
                     "broadcast", "reduce_scatter")}
    mdl, tok, dat = {}, {}, {}

    def add(where, c, n):
        where[c] = where.get(c, 0) + n
    if over:
        add(mdl, "all_gather", 2 * Bo * 8)                  # ids, positions
    add(mdl, "all_reduce", Bg * d * 4)                      # embedding
    per_m, per_t, per_d = {}, {}, {}
    qkv = (Bg * hq * hd + 2 * Bg * hk * hd) * 2
    if over:
        add(per_m, "all_to_all", qkv // 2 + Bg * hq * hd * 2 // 2)
    else:
        add(per_m, "all_gather", qkv + Bg * a.n_heads * (hd * 2 + 4))
    add(per_m, "all_reduce", Bg * d * 4)                    # wo
    cap = moe_mod.moe_capacity(B, m, E / m.top_k)
    cap_l = max(8, (cap // dp + 7) // 8 * 8)
    if Bg % mn == 0:
        rows = moe_mod.ep_payload_rows(Bg, m.top_k, E // mn, cap_l, mn,
                                       n_rows=Bg)
        add(per_m, "all_to_all", 2 * rows * d * 2 + (E // mn) * 8)
        add(per_t, "all_gather", Bg // mn * d * 2            # y
            + Bg // mn * E * 4)                              # row counts
        add(per_t, "all_reduce", (E + 3) * 8)
    else:
        add(per_m, "all_reduce", Bg * d * 4 + 2 * 8          # y, means
            + Bg * E * 8)                                    # row counts
        add(per_m, "all_gather", (E // mn) * 4)             # counts
    add(per_d, "all_reduce", (E + 1) * 8 + E * 4)           # aux
    for where, axis in ((mdl, "model"), (tok, "tokens"), (dat, "data")):
        for c, n in where.items():
            out[c][axis] += n
    for where, axis in ((per_m, "model"), (per_t, "tokens"),
                        (per_d, "data")):
        for c, n in where.items():
            out[c][axis] += cfg.n_superblocks() * n
    out["all_gather"]["model"] += Bg * V // mn * 4          # logits
    return out


def _plan_train_model(dev):
    """(h)'s model on ``dev``: (cfg, float32 params, the batch)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PLAN_LAYERS)
    params = T.tree_map(lambda t: t.float(),
                        init_params(cfg, seed=EP_SEED + 13, device=dev))
    gen = torch.Generator().manual_seed(EP_SEED + 17)
    tok = torch.randint(0, cfg.vocab_size, (PLAN_TRAIN_B, PLAN_TRAIN_S + 1),
                        generator=gen).to(dev)
    return cfg, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _plan_train_args(ctx=None, dev=None, model=None):
    """(h)'s arguments (``model(dev)``: another model's (cfg, float32
    params, batch), (i)'s): under ``ctx`` the context with the FSDP
    planner and the params, AdamW state and batch cut to this rank's
    shards, with the bytes held against ``rank_bytes``. Returns (cfg,
    tcfg, ctx, params, opt, batch, held)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.train import TrainConfig
    dev = dev if ctx is None else ctx.device
    cfg, params, batch = (model or _plan_train_model)(dev)
    tcfg = TrainConfig(capacity_factor=cfg.moe.num_experts / cfg.moe.top_k
                       if cfg.is_moe else 2.0)
    opt = adamw_init(params)
    held = {}
    if ctx is not None:
        pl = SH.ShardingPlanner(cfg, SH.grid_of(ctx), fsdp=True)
        ctx = dataclasses.replace(ctx, planner=pl,
                                  batch=batch["tokens"].shape[0],
                                  tokens_ep_sharded=False)
        grid = SH.grid_of(ctx)
        local = {}
        for kind, name, tree in (("param", "params", params),
                                 ("param", "adamw", opt),
                                 ("input", "inputs", batch)):
            local[name] = SH.shard_tree(tree, kind, pl, ctx)
            held[name] = (SH.held_bytes(local[name]),
                          SH.rank_bytes(tree, kind, pl, grid))
        params, opt, batch = local["params"], local["adamw"], \
            local["inputs"]
    return cfg, tcfg, ctx, params, opt, batch, held


def _plan_train_forward(cfg, tcfg, ctx, params, batch) -> dict:
    """(h)'s forward on the rank's shards (no remat, no autograd): the
    bytes each collective sent."""
    from repro_torch.launch import dist as D
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.models.model import forward_train
    D.reset_sent()
    with torch.no_grad(), dist_ctx(ctx):
        forward_train(params, cfg, {k: v for k, v in batch.items()
                                    if k != "labels"},
                      capacity_factor=tcfg.capacity_factor, remat=False)
    return {k: dict(v) for k, v in D.SENT_BYTES.items()}


def _plan_train(ctx=None, dev=None, model=None) -> dict:
    """(h) one train step under ``ctx`` with the FSDP planner (None: one
    process): the loss, gradient norm, learning rate, and the AdamW
    moments and updated parameters as (path, spec, float32 tensor on the
    host); on the grid the bytes held against ``rank_bytes`` (params,
    AdamW state, inputs), the bytes each collective sent in one forward
    (no remat, no autograd) and the device's memory at the step's start
    and its peak over it (``mem_start``, ``max_mem``)."""
    from repro_torch.core import tree as T
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.models import specs as SP
    from repro_torch.training.train import make_train_step
    cfg, tcfg, ctx, params, opt, batch, held = _plan_train_args(ctx, dev,
                                                                model)
    paths = T.flatten(params)[0]
    out = {"held": held}
    specs = [None] * len(paths)
    if ctx is not None:
        specs = SP._leaf_specs(params, cfg, ctx)
        out["sent"] = _plan_train_forward(cfg, tcfg, ctx, params, batch)
    dev = params["embed"].device
    torch.cuda.synchronize()
    out["mem_start"] = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with dist_ctx(ctx):
        new, state, metrics = make_train_step(cfg, tcfg)(params, opt, batch)
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    out["max_mem"] = torch.cuda.max_memory_allocated(dev)
    out["loss"], out["gnorm"] = float(metrics["loss"]), \
        float(metrics["gnorm"])
    out["lr"] = float(metrics["lr"])
    host = lambda ts: [(p, sp, t.detach().float().cpu())
                       for p, sp, t in zip(paths, specs, ts)]
    # The first step's moments are the clipped gradient's: m = (1 - b1)·g,
    # v = (1 - b2)·g², exact in the gradient where the update divides by
    # sqrt(v) + eps.
    out["m"], out["v"] = host(T.leaves(state["m"])), \
        host(T.leaves(state["v"]))
    out["new"], out["old"] = host(T.leaves(new)), \
        host(T.leaves(params)) if ctx is None else None
    return out


def _plan_train_sent_expected(cfg, planner) -> dict:
    """The bytes one rank sends in (h)'s forward (no remat, no autograd)
    on the 2 x 2 grid, from the specs and shapes: every leaf cut over
    data (FSDP) gathered at use (the embedding twice: lookup and tied
    head; each block leaf once per layer), wo's all-reduce over model,
    the MoE layer's padded regime over model and its counts and
    load-balance statistics over data; where the vocabulary divides the
    model axis (not granite's 49155), the embedding's all-reduce."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_params
    dp = mn = 2
    B, S = PLAN_TRAIN_B // dp, PLAN_TRAIN_S
    d, E = cfg.d_model, cfg.moe.num_experts
    out = {c: {x: 0 for x in ("model", "data", "tokens")}
           for c in ("all_to_all", "exchange", "all_gather", "all_reduce",
                     "broadcast", "reduce_scatter")}
    abstract = init_params(cfg, device="meta")
    specs = planner.tree_specs(abstract, "param")
    grid = SH.GridShape({"data": dp, "model": mn}, ("data", "model"))
    for path, leaf in SH.leaf_paths(abstract):
        spec = specs[path]
        if not any(e is not None and "model" not in
                   ((e,) if isinstance(e, str) else e) for e in spec):
            continue
        local = leaf.numel() * 4
        for n in SH._split_counts(spec, grid):
            local //= n
        uses = 2 if path == "['embed']" else 1
        out["all_gather"]["data"] += uses * local * (dp - 1)
    L = cfg.n_superblocks()
    out["all_reduce"]["model"] += L * (B * S * d * 4          # wo
                                       + B * S * d * 4 + 2 * 8)  # y, means
    out["all_gather"]["model"] += L * (E // mn) * 4          # counts
    out["all_reduce"]["data"] += L * (E * 8 + (E + 1) * 8 + E * 4)
    if cfg.vocab_size % mn == 0:
        out["all_reduce"]["model"] += B * S * d * 4          # embedding
    return out


def _plan_rank(ctx) -> dict:
    """(g) and (h) on this rank of the 2 x 2 grid ``ctx``."""
    cfg, params, banks = _plan_model(ctx.device)
    out = {"coords": (ctx.data_rank, ctx.rank)}
    for B in PLAN_ROWS:
        out[("g", B)] = _plan_serve(cfg, params, banks, B, ctx)
    del params, banks
    gc.collect()
    torch.cuda.empty_cache()
    out["h"] = _plan_train(ctx)
    return out


def _plan_single(dev) -> dict:
    """The one-process runs (g) and (h) are held to, on ``dev``."""
    cfg, params, banks = _plan_model(dev)
    out = {("g", B): _plan_serve(cfg, params, banks, B) for B in PLAN_ROWS}
    del params, banks
    gc.collect()
    torch.cuda.empty_cache()
    out["h"] = _plan_train(dev=dev)
    return out


def _plan_assemble(ranks, key) -> list:
    """(h)'s whole tensors from every rank's shards of ``key`` ("grads" or
    "new"): each cut dim placed at its axis index (model: the model
    index, data: the data index)."""
    out = []
    for li, (path, spec, _) in enumerate(ranks[0]["h"][key]):
        parts = [(r["coords"], r["h"][key][li][2]) for r in ranks]
        t0 = parts[0][1]
        shape = list(t0.shape)
        for d, e in enumerate(spec):
            if e is not None:
                shape[d] *= 2
        full = torch.zeros(shape)
        for (i, j), t in parts:
            idx = tuple(slice(0, None) if e is None else slice(
                (j if e == "model" else i) * t.shape[d],
                ((j if e == "model" else i) + 1) * t.shape[d])
                for d, e in enumerate(spec))
            full[idx] = t
        out.append((path, full))
    return out


def _plan_check(ranks, single, fails, card) -> list:
    """Hold (g) and (h) to the one process and log them; returns (g)'s
    runs' launches (the main path's of each run)."""
    from repro_torch.configs import get_config
    runs = []
    cfg = dataclasses.replace(get_config(ARCH), n_layers=PLAN_LAYERS)
    for B in PLAN_ROWS:
        want = single[("g", B)]
        got = [r[("g", B)] for r in ranks]
        runs += [{"launches": g["launches"]} for g in got]
        a = _hold_serve(got, want, cfg.moe.top_k, PLAN_PROMPT)
        strict, now, loose, held, alike_now, pairs, counts, conserved, \
            group_same, held_ok, scale = (a[k] for k in _HOLD_KEYS)
        sent_ok = all(g["sent"] == _plan_sent_expected(cfg, B) for g in got)
        # A group's rows split over the model axis (8 rows: 4 per group)
        # take the all-to-all regime (rows 1-2); one row does not (the
        # padded regime, row 4). Row 5 in every decode layer.
        k_need = ("ragged_gateup", "ragged_down") if B % 4 == 0 else \
            ("grouped_lo_matmul",)
        k_ok = all(g["launches"].get(k, 0) > 0 for g in got
                   for k in k_need + ("flash_decode",))
        ok = held_ok and sent_ok and k_ok and group_same and conserved \
            and held >= max(1, PLAN_HELD_SHARE * pairs) and \
            strict <= PLAN_TOL * scale and now <= MODEL_TOL and \
            loose <= MODEL_TOL_SWAP and 2 * alike_now >= pairs and \
            bool(torch.isfinite(torch.stack([g["logits"]
                                             for g in got])).all())
        case = "h: rows over data x model" if B % 4 == 0 else \
            "g: rows over data, the caches' sequence over model (row 5 " \
            "with lse)"
        log("ep", f"(g) 2x2 under specs, {B} rows ({case}): prefill "
                  f"{B}x{PLAN_PROMPT} + {PLAN_STEPS} decode steps against "
                  f"one process's ragged run, of {pairs} (rank, row, "
                  f"forward) logits: {held} (at least "
                  f"{max(1, PLAN_HELD_SHARE * pairs):g}) from rows whose "
                  f"every token "
                  f"took the same experts in both runs so far, max |logit "
                  f"diff| on them {strict:.4g} (largest |logit| "
                  f"{scale:.4g}; bar {PLAN_TOL * scale:.4g}); {alike_now} "
                  f"routed alike in their forward (at least half), "
                  f"{now:.4g} (bar MODEL_TOL {MODEL_TOL}); every row "
                  f"{loose:.4g} (bar MODEL_TOL_SWAP {MODEL_TOL_SWAP}); "
                  f"per-row counts "
                  f"{'=' if counts else '!='}, each row's summing to top-k "
                  f"times its tokens {conserved}; a model group's ranks' "
                  f"logits and counts bit-equal {group_same}; regimes rank 0 "
                  f"{got[0]['regimes']}; launches per rank "
                  + "; ".join(", ".join(f"{k} {g['launches'].get(k, 0)}"
                                        for k in PLAN_KERNELS) for g in got)
                  + f"; held bytes rank 0 {got[0]['held']} (= rank_bytes on "
                    f"every rank: {held_ok}); run {got[0]['s']:.2f} s, one "
                    f"process {want['s']:.2f} s | {card}")
        log("ep", f"(g) {B} rows: one decode step sent, rank 0: " + ", ".join(
            f"{c} {v}" for c, v in got[0]["sent"].items() if any(v.values()))
            + f" bytes; every rank's = the formulas {sent_ok} | {card}")
        if not ok:
            fails.append(f"(g) {B} rows")
    want = single["h"]
    from repro_torch.launch.sharding import ShardingPlanner, GridShape
    tcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PLAN_LAYERS)
    sent_want = _plan_train_sent_expected(tcfg, ShardingPlanner(
        tcfg, GridShape({"data": 2, "model": 2}, ("data", "model")),
        fsdp=True))
    t = _hold_train(ranks, want)
    worst, path, flat, g_at, floored = (t[k] for k in (
        "worst", "path", "flat", "g_at", "floored"))
    sent_ok = all(r["h"]["sent"] == sent_want for r in ranks)
    ok = t["ok"] and sent_ok
    log("ep", f"(h) 2x2 under FSDP specs: {TRAIN_ARCH} at full width, "
              f"{PLAN_LAYERS} layers, float32, one train step of "
              f"{PLAN_TRAIN_B}x{PLAN_TRAIN_S}: loss "
              f"{[round(r['h']['loss'], 7) for r in ranks]} vs one process "
              f"{want['loss']:.7f}; gnorm {ranks[0]['h']['gnorm']:.6g} vs "
              f"{want['gnorm']:.6g}; worst leaf |diff| / its largest "
              f"|value|: the gradients (AdamW's m) {worst['m']:.3g}, their "
              f"squares (v) {worst['v']:.3g}, updated params "
              f"{worst['new']:.3g} (bar {PLAN_GRAD_TOL}; at {path}, element "
              f"{flat}, clipped gradient {g_at:.3g}; {floored} elements "
              f"whose clipped gradient is under {PLAN_G_FLOOR} held by m "
              f"alone; lr {want['lr']:.3g}); held bytes rank 0 "
              f"{ranks[0]['h']['held']} (= rank_bytes on every rank: "
              f"{t['held_ok']}); one forward sent, rank 0: "
              + ", ".join(f"{c} {v}" for c, v in ranks[0]["h"]["sent"].items()
                          if any(v.values()))
              + f" (= the formulas on every rank: {sent_ok}); step "
                f"{ranks[0]['h']['s']:.2f} s, one process {want['s']:.2f} s"
                f" | {card}")
    if not ok:
        fails.append("(h)")
    return runs


_HOLD_KEYS = ("strict", "now", "loose", "held", "alike_now", "pairs",
              "counts", "conserved", "group_same", "held_ok", "scale")


def _hold_serve(got, want, top_k, prompt) -> dict:
    """A served run's ranks ``got`` (each with its group ``rows``) held to
    one process's run ``want``. Per (rank, row, forward): routed alike in
    that forward (its tokens took the same experts in every layer; every
    row on a stack without MoE), and alike so far (in every forward up to
    it: the K/V and state it reads too); the largest |logit diff| on the
    rows alike so far (``strict``), alike in their forward (``now``) and
    on every row (``loose``), their numbers (``held``, ``alike_now`` of
    ``pairs``); per-row counts equal, each row's summing to top-k times
    its tokens (``prompt`` in the prefill); a model group's ranks'
    logits and counts bit-equal; held bytes = ``rank_bytes``; the
    largest |logit| of one process (``scale``)."""
    out = dict(strict=0.0, now=0.0, loose=0.0, held=0, alike_now=0,
               pairs=0, counts=True, conserved=True,
               scale=float(want["logits"].abs().max()))
    for g in got:
        rows = g["rows"]
        n = rows.stop - rows.start
        so_far = torch.ones(n, dtype=torch.bool)
        for f, (gc_, wc) in enumerate(zip(g["counts"], want["counts"])):
            same = torch.ones(n, dtype=torch.bool)
            for k in wc:
                same &= (gc_[k] == wc[k][:, rows]).all(2).all(0)
            out["counts"] &= bool(same.all())
            per_row = top_k * (prompt if f == 0 else 1)
            out["conserved"] &= all(bool((c.sum(-1) == per_row).all())
                                    for c in gc_.values())
            so_far &= same
            d = (g["logits"][f] - want["logits"][f][rows]).abs().amax(-1)
            out["loose"] = max(out["loose"], float(d.max()))
            if bool(so_far.any()):
                out["strict"] = max(out["strict"], float(d[so_far].max()))
            if bool(same.any()):
                out["now"] = max(out["now"], float(d[same].max()))
            out["held"] += int(so_far.sum())
            out["alike_now"] += int(same.sum())
            out["pairs"] += n
    out["group_same"] = all(
        torch.equal(a["logits"], b["logits"]) and
        all(torch.equal(ca[k], cb[k]) for ca, cb in
            zip(a["counts"], b["counts"]) for k in ca)
        for a in got for b in got if a["rows"] == b["rows"])
    out["held_ok"] = all(h == w for g in got for h, w in g["held"].values())
    return out


def _hold_train(ranks, want, tol=PLAN_GRAD_TOL) -> dict:
    """A train step's ranks (each ``{"coords", "h": its run}``) held to one
    process's run ``want``: the loss within PLAN_LOSS_RTOL; the gathered
    gradients (AdamW's m), their squares (v) and the updated parameters
    within ``tol`` of each leaf's largest magnitude, the parameters
    where the clipped gradient is at least PLAN_G_FLOOR; held bytes =
    ``rank_bytes``. Returns {"ok", "worst" by key, the worst updated
    parameter's "path", "flat" index and clipped gradient "g_at",
    "floored" elements, "held_ok"}."""
    loss_ok = all(abs(r["h"]["loss"] - want["loss"]) <=
                  PLAN_LOSS_RTOL * abs(want["loss"]) for r in ranks)
    worst, where, floored = {}, {}, 0
    for key in ("m", "v", "new"):
        err = 0.0
        for li, (path, g) in enumerate(_plan_assemble(ranks, key)):
            w = want[key][li][2]
            d = (g - w).abs()
            if key == "new":
                # Where the clipped gradient (m = 0.1·g) is under
                # PLAN_G_FLOOR, AdamW's first update g / (|g| + eps) turns
                # on rounding: those elements are held by m alone.
                small = want["m"][li][2].abs() < 0.1 * PLAN_G_FLOOR
                floored += int(small.sum())
                d = torch.where(small, torch.zeros_like(d), d)
            e = float(d.max()) / max(float(w.abs().max()), 1e-30)
            if e >= err:
                err, at = e, (path, li, int(d.argmax()))
        worst[key], where[key] = err, at
    path, li, flat = where["new"]
    g_at = float(want["m"][li][2].reshape(-1)[flat]) / 0.1
    moments_ok = max(worst["m"], worst["v"]) <= tol
    held_ok = all(h == w for r in ranks for h, w in r["h"]["held"].values())
    return {"ok": loss_ok and held_ok and moments_ok and
            worst["new"] <= tol, "worst": worst, "path": path,
            "flat": flat, "g_at": g_at, "floored": floored,
            "held_ok": held_ok}


# (i) the families under the planner's specs on the 2 x 2 grid, at full
# width: family → (arch, layers (None: full depth), prompt tokens). Mamba2
# at its 24 layers, Jamba at one super-block (JAMBA_LAYERS), Whisper at
# its 4 + 4, LLaVA at LLAVA_CHECK_LAYERS of 60 with its 576-token prefix.
FAM_SERVE = {"mamba": ("mamba2-130m", None, 64),
             "jamba": (JAMBA, JAMBA_LAYERS, 64),
             "whisper": (WHISPER, None, 16),
             "llava": (LLAVA, LLAVA_CHECK_LAYERS, 64)}
#: (i)'s rows: 8 (case h: over data x model) and 2 (case g: over data,
#: the attention caches' sequence over model); decode steps after each
#: prefill.
FAM_ROWS, FAM_STEPS = (8, 2), 8
#: (i)'s serving runs: (name, family, float32). Mamba2 (no attention:
#: row 5 takes bf16 only) also in float32.
FAM_RUNS = (("mamba", "mamba", False), ("mamba32", "mamba", True),
            ("jamba", "jamba", False), ("whisper", "whisper", False),
            ("llava", "llava", False))
#: (i)'s float32 FSDP train steps: family → (rows, tokens, the bar on
#: the gradients and updated parameters, of each leaf's largest
#: magnitude). Mamba2's 24 SSD layers: exp(cumsum(dt·A)) turns a
#: last-bit difference of dt (the contraction-split in_proj's sum order)
#: into a relative one of |sum dt·A| · 2^-24, and depth compounds it: the
#: same step on the CPU at full width holds 2.9e-5 at 2 layers, 4.7e-5
#: at 8, 2.6e-4 at 24; at reduced width the tests hold 1e-4.
FAM_TRAIN = {"mamba": (4, 64, 1e-2), "whisper": (4, 64, PLAN_GRAD_TOL)}
#: (i)'s float32 serving against one process: the prefill's logits within
#: PLAN_GRAD_TOL of the largest |logit|; the decode steps' within one
#: bf16 step of it (the conv window a prefill writes is bf16 in the
#: model, and a float32 difference can move one of its inputs by an
#: ulp, which 24 SSD layers amplify: 8e-4 of it at full size on the CPU).
FAM_F32_DECODE = 2.0 ** -8
FAM_SEED = EP_SEED + 23
#: (i)'s kernels: rows 1-2 (Jamba's MoE in the all-to-all regime), 4 (in
#: the padded regime, where a decode step's group rows do not split over
#: model) and 5 (decode attention and Whisper's cross-attention).
FAM_KERNELS = ("ragged_gateup", "ragged_down", "grouped_lo_matmul",
               "flash_decode")


def _fam_cfg(fam):
    from repro_torch.configs import get_config
    arch, layers, _ = FAM_SERVE[fam]
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _fam_model(fam, dev):
    """(i)'s model of ``fam`` on ``dev`` ("meta": shapes only): (cfg,
    params, banks or None), the same bits in every process. Jamba's
    experts are a static int4 bank (group 64, no hi slot), each expert
    drawn in bf16 and quantized into it in turn (its 22.5 GB of bf16
    experts are never whole), and params hold none."""
    from repro_torch.core.ver import build_bank_empty
    from repro_torch.models.model import init_params
    from repro_torch.quant.qtensor import quantize
    cfg = _fam_cfg(fam)
    seed = FAM_SEED + list(FAM_SERVE).index(fam)
    meta = torch.device(dev).type == "meta"
    params = init_params(cfg, seed=seed, device=dev,
                         experts=not cfg.is_moe)
    if not cfg.is_moe:
        return cfg, params, None
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    nsb = cfg.n_superblocks()
    shapes = {"w_gate": (nsb, E, d, f), "w_up": (nsb, E, d, f),
              "w_down": (nsb, E, f, d)}
    gen = None if meta else \
        torch.Generator(device=dev).manual_seed(seed + 1000)
    banks = {}
    for p in range(len(cfg.superblock_or_default())):
        if cfg.ffn_kind(p) != "moe":
            continue
        bank = build_bank_empty(shapes, n_hi=0, lo_bits=4, group_size=64,
                                device=dev)
        for name, shape in ([] if meta else shapes.items()):
            lo = bank.lo[name]
            for l in range(nsb):
                for e in range(E):
                    q = quantize((torch.randn(shape[2:], generator=gen,
                                              device=dev) * E ** -0.5
                                  ).to(torch.bfloat16), 4, 64)
                    lo.packed[l, e].copy_(q.packed)
                    lo.scales[l, e].copy_(q.scales)
        banks[str(p)] = bank
    return cfg, params, banks


def _fam_data(cfg, B, S, dev, seed):
    """Tokens (B, S), and a VLM's patches or an encoder-decoder's frames
    from the stub frontends, drawn on the host from ``seed`` (empty on
    ``meta``)."""
    from repro_torch.models.frontend import (audio_frame_embeddings,
                                             image_patch_embeddings)
    meta = torch.device(dev).type == "meta"
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.empty((B, S), dtype=torch.long, device=dev)
           if meta else torch.randint(1, cfg.vocab_size, (B, S),
                                      generator=gen).to(dev)}
    for key, on, n, fn in (("image_embeds", cfg.family == "vlm",
                            cfg.num_image_tokens, image_patch_embeddings),
                           ("audio_embeds", cfg.is_encoder_decoder,
                            cfg.encoder_seq, audio_frame_embeddings)):
        if on:
            out[key] = torch.empty((B, n, cfg.d_model), dtype=torch.bfloat16,
                                   device=dev) if meta else \
                fn(gen, cfg, B, dev)
    return out


def _fam_shard(cfg, params, banks, ctx):
    """This rank's shards of (i)'s params and banks under the planner of
    ``ctx``'s grid, and the bytes each holds against ``rank_bytes``:
    (planner, params, banks, held)."""
    from repro_torch.launch import sharding as SH
    pl = SH.ShardingPlanner(cfg, SH.grid_of(ctx))
    held = {}
    out = []
    for name, tree in (("params", params), ("bank", banks)):
        if tree is None:
            out.append(None)
            continue
        out.append(SH.shard_tree(tree, "param", pl, ctx))
        held[name] = (SH.held_bytes(out[-1]),
                      SH.rank_bytes(tree, "param", pl, SH.grid_of(ctx)))
    return pl, out[0], out[1], held


def _fam_args(fam, cfg, params, banks, B, ctx=None, pl=None, held=None):
    """(i)'s arguments of a run of B rows, as ``_plan_args`` returns them
    (params and banks already this rank's, ``held`` their bytes): the
    prompt (a VLM's patches ahead of it, counted in ``lengths``; an
    encoder-decoder's frames) and FAM_STEPS teacher-forced decode steps,
    into dense rows of the whole length."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_caches
    from repro_torch.models.specs import layout
    dev = params["embed"].device
    P = FAM_SERVE[fam][2]
    data = _fam_data(cfg, B, P + FAM_STEPS, dev,
                     FAM_SEED + 100 * list(FAM_SERVE).index(fam) + B)
    tok = data.pop("tokens")
    n = P + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    caches = init_caches(cfg, B, n + FAM_STEPS, device=dev)
    if params["embed"].dtype == torch.float32:
        caches = {k: type(c)(*(t.float() for t in c))
                  for k, c in caches.items()}
    inputs = dict(data, tokens=tok[:, :P],
                  lengths=torch.full((B,), n, device=dev))
    steps = [{"token": tok[:, P + i], "pos": torch.full((B,), n + i,
                                                        device=dev)}
             for i in range(FAM_STEPS)]
    held, rows = dict(held or {}), slice(0, B)
    if ctx is not None:
        ctx = dataclasses.replace(ctx, planner=pl, batch=B,
                                  tokens_ep_sharded=True)
        local = {}
        for kind, name, tree in (("cache", "caches", caches),
                                 ("input", "inputs", inputs)):
            local[name] = SH.shard_tree(tree, kind, pl, ctx)
            held[name] = (SH.held_bytes(local[name], kind == "cache"),
                          SH.rank_bytes(tree, kind, pl, SH.grid_of(ctx)))
        caches, inputs = local["caches"], local["inputs"]
        steps = [SH.shard_tree(st, "input", pl, ctx) for st in steps]
        rows = layout(ctx).group
    return ctx, params, banks, caches, inputs, steps, held, rows


def _fam_train_model(fam):
    """(i)'s train step's model: ``model(dev)`` → (cfg, float32 params,
    the batch: FAM_TRAIN's rows and tokens, a VLM's or an
    encoder-decoder's embeddings)."""
    from repro_torch.core import tree as T

    def model(dev):
        cfg, params, _ = _fam_model(fam, dev)
        B, S, _ = FAM_TRAIN[fam]
        data = _fam_data(cfg, B, S + 1, dev, FAM_SEED + 7 + B)
        tok = data.pop("tokens")
        return cfg, T.tree_map(lambda t: t.float(), params), \
            dict(data, tokens=tok[:, :-1], labels=tok[:, 1:])
    return model


def _fam_variant(name, fam, f32, dev, ctx=None):
    """(i)'s model of run ``name`` (float32 where ``f32``) and, under
    ``ctx``, this rank's shards of it: (cfg, params, banks, planner,
    held)."""
    from repro_torch.core import tree as T
    cfg, params, banks = _fam_model(fam, dev)
    if f32:
        params = T.tree_map(lambda t: t.float(), params)
    pl = held = None
    if ctx is not None:
        pl, params, banks, held = _fam_shard(cfg, params, banks, ctx)
    return cfg, params, banks, pl, held


def _fam_runs(ctx, dev):
    """(i) on this rank of the 2 x 2 grid ``ctx`` (None: one process on
    ``dev``): each family's serving runs, then the train steps."""
    out = {}
    for name, fam, f32 in FAM_RUNS:
        cfg, params, banks, pl, held = _fam_variant(name, fam, f32, dev, ctx)
        gc.collect()
        torch.cuda.empty_cache()
        for B in FAM_ROWS:
            args = _fam_args(fam, cfg, params, banks, B, ctx, pl, held)
            out[(name, B)] = _plan_serve(cfg, params, banks, B, args=args)
        del params, banks
        gc.collect()
        torch.cuda.empty_cache()
    for fam in FAM_TRAIN:
        out[("train", fam)] = _plan_train(ctx, dev,
                                          model=_fam_train_model(fam))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _fam_check(ranks, single, fails, card) -> list:
    """Hold (i) to the one process and log it; returns its runs' launches
    (the main path's of each run). bf16: Whisper and LLaVA every row
    within MODEL_TOL; Jamba, whose tensor-parallel sums tip router near
    ties, the rows routed alike in their forward within MODEL_TOL (at
    least half of them) and every row within MODEL_TOL_SWAP; Mamba2, 24
    SSD layers that amplify an ulp, the grid's logits within twice one
    process's bf16 distance from its float32 run; float32 as
    FAM_F32_DECODE says; the train steps as FAM_TRAIN. Every run: held
    bytes = ``rank_bytes``, a model group's ranks bit-equal, each row's
    counts summing to top-k times its tokens, its kernels launched."""
    runs = []
    for name, fam, f32 in FAM_RUNS:
        cfg = _fam_cfg(fam)
        attn = cfg.attn is not None
        for B in FAM_ROWS:
            want = single[(name, B)]
            got = [r["i"][(name, B)] for r in ranks]
            runs += [{"launches": g["launches"]} for g in got]
            n = FAM_SERVE[fam][2] + (cfg.num_image_tokens
                                     if cfg.family == "vlm" else 0)
            a = _hold_serve(got, want, cfg.moe.top_k if cfg.is_moe else 0, n)
            # Jamba's 8 rows split over the model axis in every forward
            # (rows 1-2); a decode step's one group row does not (row 4).
            k_need = (("flash_decode",) if attn else ()) + (
                () if not cfg.is_moe else ("ragged_gateup", "ragged_down")
                if B % 4 == 0 else ("grouped_lo_matmul",))
            k_ok = all(g["launches"].get(k, 0) > 0 for g in got
                       for k in k_need)
            if f32:
                first = max(float((g["logits"][0] - want["logits"][0][
                    g["rows"]]).abs().max()) for g in got)
                bar = f"prefill {first:.4g} (bar " \
                    f"{PLAN_GRAD_TOL * a['scale']:.4g}), decode bar " \
                    f"{FAM_F32_DECODE * a['scale']:.4g}"
                close = first <= PLAN_GRAD_TOL * a["scale"] and \
                    a["loose"] <= FAM_F32_DECODE * a["scale"]
            elif fam == "mamba":
                # Two bf16 runs of 24 SSD layers part by the rounding each
                # amplifies: held by their distance from one process's
                # float32 run, the grid's within twice one process's.
                ref = single[(name + "32", B)]["logits"]
                band = float((want["logits"] - ref).abs().max())
                dist = max(float((g["logits"] - ref[:, g["rows"]]).abs()
                                 .max()) for g in got)
                bar = f"from one process's float32 run: the grid " \
                      f"{dist:.4g}, one process {band:.4g}; bar twice " \
                      f"one process's"
                close = dist <= 2 * band
            elif cfg.is_moe:
                bar = f"bar MODEL_TOL {MODEL_TOL} on the rows routed " \
                      f"alike, MODEL_TOL_SWAP {MODEL_TOL_SWAP} on every row"
                close = a["strict"] <= MODEL_TOL and \
                    a["now"] <= MODEL_TOL and \
                    2 * a["alike_now"] >= a["pairs"] and \
                    a["loose"] <= MODEL_TOL_SWAP
            else:
                bar = f"bar MODEL_TOL {MODEL_TOL}"
                close = a["loose"] <= MODEL_TOL
            ok = close and a["held_ok"] and k_ok and a["group_same"] and \
                a["conserved"] and \
                bool(torch.isfinite(torch.stack([g["logits"]
                                                 for g in got])).all())
            case = "h: rows over data x model" if B % 4 == 0 else \
                "g: rows over data" + (", the caches' sequence over model"
                                       if attn else "")
            log("ep", f"(i) {cfg.name} at {cfg.n_layers} layers"
                      + (" in float32" if f32 else "")
                      + f", 2x2 under specs, {B} rows ({case}): prefill "
                        f"{B}x{n} + {FAM_STEPS} decode steps against one "
                        f"process, of {a['pairs']} (rank, row, forward) "
                        f"logits: every row max |logit diff| "
                        f"{a['loose']:.4g} (largest |logit| "
                        f"{a['scale']:.4g}; {bar}); {a['held']} from rows "
                        f"routed alike so far, {a['strict']:.4g}; "
                        f"{a['alike_now']} routed alike in their forward, "
                        f"{a['now']:.4g}; per-row counts "
                        f"{'=' if a['counts'] else '!='}, each summing to "
                        f"top-k times its tokens {a['conserved']}; a model "
                        f"group's ranks bit-equal {a['group_same']}; "
                        f"regimes rank 0 {got[0]['regimes']}; launches per "
                        f"rank " + "; ".join(
                            ", ".join(f"{k} {g['launches'].get(k, 0)}"
                                      for k in FAM_KERNELS) for g in got)
                      + "; held bytes per rank "
                      + str([{k: h for k, (h, _) in g["held"].items()}
                             for g in got])
                      + f" (= rank_bytes on every rank: {a['held_ok']}); "
                        f"sent rank 0: prefill "
                      + _sent_str(got[0]["sent_prefill"]) + ", first decode "
                        f"step " + _sent_str(got[0]["sent"])
                      + f"; run {got[0]['s']:.2f} s, one process "
                        f"{want['s']:.2f} s | {card}")
            if not ok:
                fails.append(f"(i) {name} {B} rows")
    for fam in FAM_TRAIN:
        key = ("train", fam)
        want = single[key]
        got = [{"coords": r["gh"]["coords"], "h": r["i"][key]}
               for r in ranks]
        B, S, tol = FAM_TRAIN[fam]
        t = _hold_train(got, want, tol)
        log("ep", f"(i) {_fam_cfg(fam).name} 2x2 under FSDP specs, float32, "
                  f"one train step of {B}x{S}: loss "
                  f"{[round(g['h']['loss'], 7) for g in got]} vs one process "
                  f"{want['loss']:.7f}; worst leaf |diff| / its largest "
                  f"|value|: gradients (m) {t['worst']['m']:.3g}, squares "
                  f"(v) {t['worst']['v']:.3g}, updated params "
                  f"{t['worst']['new']:.3g} (bar {tol}; "
                  f"{t['floored']} elements under {PLAN_G_FLOOR} held by m "
                  f"alone); held bytes rank 0 {got[0]['h']['held']} (= "
                  f"rank_bytes on every rank: {t['held_ok']}); one forward "
                  f"sent, rank 0: " + _sent_str(got[0]["h"]["sent"])
                  + f"; step {got[0]['h']['s']:.2f} s, one process "
                    f"{want['s']:.2f} s | {card}")
        if not t["ok"]:
            fails.append(f"(i) {fam} train")
    return runs


def _sent_str(sent) -> str:
    """The bytes each collective sent, by axis, without the zeros."""
    return "{" + ", ".join(f"{c} {dict((a, b) for a, b in v.items() if b)}"
                           for c, v in sent.items() if any(v.values())) + \
        "} B"


def _ep_rank(ctx) -> dict:
    """One rank of the phase's world: (a) and (b) at N = 4 over every rank,
    then (a) and (c) at N = 2 over ranks 0 and 1 (a group of the world);
    then the 2 x 2 grid's (e), (f) and (j), (g), (h) and (i); every run
    on this rank's experts only. Loads the kernels the build phase built
    and builds none."""
    import torch.distributed as tdist
    from repro_torch.kernels import build
    from repro_torch.launch.dist import ep_context
    missing = [n for n in build.SOURCES if not build._target(n).exists()]
    if missing:
        raise RuntimeError(f"rank {ctx.rank}: kernels {missing} not built")
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(EP_SEED + 1)
    t0 = time.perf_counter()
    out = {"rank": ctx.rank, "entered": time.time()}
    cfg, params, prompts = _ep_model(dev)
    out["build_s"] = time.perf_counter() - t0
    n2 = tdist.new_group([0, 1])
    for n in (4, 2):
        sub = ctx if n == ctx.model_size else \
            ep_context(n2, tdist.get_rank(n2), n, dev) if ctx.rank < n \
            else None
        if sub is None:
            continue
        for name in EP_RUNS[n]:
            torch.cuda.reset_peak_memory_stats()
            engine, s = _ep_serve(cfg, params, prompts, name, dev, sub)
            s["max_mem"] = torch.cuda.max_memory_allocated()
            s["rss_gb"] = _rss_gb()
            if name == "dynaexq":
                s["bytes"] = _ep_bytes(engine, sub, gen)
            if n == 4:
                out["b"] = _ep_promote_rebalance(engine, sub, gen)
            out[(n, name)] = s
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        if n == 2:
            out["c"] = _ep_padded(cfg, params, sub)
    # (e) and (f): every rank makes the grids' groups, in this order.
    from repro_torch.launch.mesh import grid_context
    grid = grid_context(2, 2, device=dev)
    row3 = grid_context(1, 3, ranks=[0, 1, 2], device=dev)
    t1 = time.perf_counter()
    out["e"] = _grid_rank(cfg, params, grid)
    out["e_s"] = time.perf_counter() - t1
    if row3 is not None:
        t1 = time.perf_counter()
        out["f"] = _grid_sp(cfg, params, row3)
        out["f_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["j"] = _grid_engine_rank(cfg, params, prompts, dataclasses.replace(
        grid, tokens_ep_sharded=True), gen)
    out["j_s"] = time.perf_counter() - t1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["gh"] = _plan_rank(grid)
    out["gh_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["i"] = _fam_runs(grid, dev)
    out["i_s"] = time.perf_counter() - t1
    tdist.barrier()
    out["left"] = time.time()
    return out


def _grid_check(ranks, single, cfg, fails, card) -> list:
    """Hold (e) and (f) to the one process and log them; returns (e)'s
    runs' launches (the main path's of each regime)."""
    runs = []
    for name, (regime, *_, dense, against) in EP_GRID_REGIMES.items():
        want = single[against]
        got = [r["e"][name] for r in ranks]
        runs += [{"launches": g["launches"]} for g in got]
        diff = max(float((g["logits"] - want["logits"]).abs().max())
                   for g in got)
        scale = float(want["logits"].abs().max())
        same = all(torch.equal(g["tokens"], want["tokens"]) for g in got)
        counts = all(torch.equal(g["counts"], want["counts"]) for g in got)
        calls = (1 + EP_GRID_STEPS) * EP_LAYERS
        reg_ok = all(g["regimes"] == {"all_to_all": 0, "padded": 0,
                                      regime: calls} for g in got)
        k_ok = all(g["launches"].get(k, 0) > 0 for g in got
                   for k in EP_GRID_KERNELS[name])
        quarter = 4 if name == "b" else 2
        whole = single["bytes fp16" if dense else "bytes"]
        bytes_ok = all(quarter * g["bytes"] == whole for g in got)
        sent_ok = all(g["sent"] == _grid_sent_expected(
            cfg, name[0], EP_SLOTS, g["n_slot"]) for g in got)
        exact = regime == "all_to_all_dp"
        ok = reg_ok and k_ok and bytes_ok and sent_ok and counts and (
            diff == 0.0 and same if exact
            else diff <= EP_PADDED_TOL * scale)
        log("ep", f"(e) 2x2 {name}, {regime}: prefill {EP_GRID_ROWS}x"
                  f"{EP_GRID_PROMPT} + {EP_GRID_STEPS} decode steps against "
                  f"one process's {against} run: max |logit diff| "
                  f"{diff:.4g} (largest |logit| {scale:.4g}; bar "
                  + ("0" if exact else f"{EP_PADDED_TOL * scale:.4g}")
                  + f"), tokens {'=' if same else '!='}, counts "
                  f"{'=' if counts else '!='}; regimes rank 0 "
                  f"{got[0]['regimes']}; launches per rank "
                  + "; ".join(", ".join(f"{k} {g['launches'].get(k, 0)}"
                                        for k in EP_GRID_KERNELS[name])
                              for g in got)
                  + f"; expert bytes per rank {[g['bytes'] for g in got]} "
                    f"of one process's {whole} (1/{quarter}: "
                    f"{bytes_ok}); run {got[0]['s']:.2f} s, one process "
                    f"{want['s']:.2f} s | {card}")
        log("ep", f"(e) {name}: one {EP_SLOTS}-token layer call sent, "
                  f"rank 0: " + ", ".join(
                      f"{c} {v}" for c, v in got[0]["sent"].items()
                      if any(v.values()))
                  + f" bytes; every rank's = the formulas {sent_ok} | {card}")
        if not ok:
            fails.append(f"(e) {name}")
    narrow = [r["e"]["narrow_slice"] for r in ranks]
    log("ep", f"(e) an 8-way FF slice (96 columns) on the grouped GEMM: "
              f"{narrow[0]!r} on every rank "
              f"{all(n and 'multiple of 64' in n for n in narrow)}")
    if not all(n and "multiple of 64" in n for n in narrow):
        fails.append("(e) narrow slice")
    want = single["f"]
    scale = float(want["logits"].abs().max())
    for r in ranks[:3]:
        f = r["f"]
        diff = float((f["logits"] - want["logits"]).abs().max())
        ok = (f["seq_parallel"] == 2 * EP_LAYERS and
              f["regimes"].get("replicated", 0) == 2 * EP_LAYERS and
              diff <= EP_SP_TOL * scale and
              abs(f["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]))
        log("ep", f"(f) 1x3 rank {r['rank']}: forward_train float32 "
                  f"{EP_SP_B}x{EP_SP_S} with sequence-parallel attention "
                  f"({f['seq_parallel']} calls), regimes {f['regimes']}; "
                  f"loss {f['loss']:.6f} vs one process {want['loss']:.6f},"
                  f" max |logit diff| {diff:.3g} (bar "
                  f"{EP_SP_TOL * scale:.3g}); {r['f_s']:.2f} s | {card}")
        if not ok:
            fails.append(f"(f) rank {r['rank']}")
    log("ep", f"(e) took {max(r['e_s'] for r in ranks):.1f} s, (f) "
              f"{max(r['f_s'] for r in ranks[:3]):.1f} s on the ranks | "
              f"{card}")
    return runs


#: (j) the engine over the 2 x 2 grid of the phase's ranks (two data rows
#: of a 2-rank model group, the 30B's experts replicated over data): the
#: backends it serves, each held to the one process's run.
EP_ENGINE_RUNS = ("dynaexq", "fp16")


def _digest(t: torch.Tensor) -> str:
    """A digest of ``t``'s bytes (equal digests: equal bits)."""
    import hashlib
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.blake2b(b.numpy().tobytes(), digest_size=16).hexdigest()


def _engine_state(engine) -> list:
    """Digests of what every data row must hold alike: per MoE position
    this rank's lo and hi leaves, slot map and owners, and the router;
    the coordinator's placements."""
    be = engine.backend
    out = []
    for pos, bank in sorted(be.banks.items()):
        leaves = [x for q in bank.lo.values() for x in (q.packed, q.scales)]
        leaves += list(bank.hi.values()) + [
            bank.slot_map, bank.slot_owner,
            engine.params["blocks"][pos]["moe"]["router"]]
        out.append([_digest(t) for t in leaves])
    out.append([_digest(torch.from_numpy(p.copy()))
                for _, _, p in be.coordinator._entries])
    return out


def _grid_engine_rank(cfg, params, prompts, ctx, gen) -> dict:
    """(j) on this rank of the 2 x 2 grid ``ctx`` (the all-to-all regime
    over data x model): one ``InferenceEngine`` per backend of
    EP_ENGINE_RUNS over the phase's requests (``_ep_serve``), this rank's
    device and host memory after each; then on dynaexq's engine (b)'s
    forced promotions, rebalance and ``ep_mig`` faults, and the digests
    of the state both data rows must hold alike."""
    out = {"coords": (ctx.data_rank, ctx.rank)}
    for name in EP_ENGINE_RUNS:
        torch.cuda.reset_peak_memory_stats()
        engine, s = _ep_serve(cfg, params, prompts, name, ctx.device, ctx)
        s["max_mem"] = torch.cuda.max_memory_allocated()
        s["rss_gb"] = _rss_gb()
        if name == "dynaexq":
            b = _ep_promote_rebalance(engine, ctx, gen)
            b["state"] = _engine_state(engine)
            out["b"] = b
        out[name] = s
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _grid_engine_check(ranks, single, fails, card) -> list:
    """Hold (j) to the one process and log it: per backend every rank's
    tokens and last logits bit-equal to it where every MoE call took the
    all-to-all regime, the kernels of its path launched on every rank,
    the expert device bytes alike on both data rows, each rank's pinned
    host masters half of one process's; after dynaexq's forced
    promotions, rebalance and ``ep_mig`` faults (b)'s checks on every
    rank, and the same banks, routers and placements on both data rows.
    Returns the runs' launches."""
    runs = []
    by = {r["j"]["coords"]: r["j"] for r in ranks}
    for name in EP_ENGINE_RUNS:
        want = single[name]
        got = [by[c][name] for c in sorted(by)]
        runs += [{"launches": g["launches"]} for g in got]
        exact = all({k for k, v in g["regimes"].items() if v} ==
                    {"all_to_all_dp"} for g in got)
        same = all(g["tokens"] == want["tokens"] for g in got)
        dl = max(float((g["logits"] - want["logits"]).abs().max())
                 for g in got)
        k_ok = all(g["launches"][k] > 0 for g in got
                   for k in EP_KERNELS[name])
        rows_ok = all(by[(1, j)][name]["expert_bytes"] ==
                      by[(0, j)][name]["expert_bytes"] for j in (0, 1))
        host_ok = all(2 * g["host_master_bytes"] ==
                      want["host_master_bytes"] for g in got)
        log("ep", f"(j) 2x2 engine {name}: {EP_REQUESTS} requests x "
                  f"{EP_NEW} tokens on every rank (data, model) "
                  f"{sorted(by)}; tokens {'=' if same else '!='} one "
                  f"process, max |logit diff| last step {dl:.3g}; MoE "
                  f"calls by regime rank 0 {got[0]['regimes']} (all "
                  f"all_to_all_dp: {exact}); launches per rank "
                  + "; ".join(", ".join(f"{k} {g['launches'][k]}"
                                        for k in EP_KERNELS[name])
                              for g in got)
                  + f" | TPOT rank 0 {got[0]['tpot_s'] * 1e3:.2f} ms, one "
                    f"process eager {want['tpot_s'] * 1e3:.2f} ms; expert "
                    f"device bytes per rank "
                    f"{[g['expert_bytes'] for g in got]}, one process "
                    f"{want['expert_bytes']}; pinned host masters per rank "
                    f"{[g['host_master_bytes'] for g in got]}, one process "
                    f"{want['host_master_bytes']}; device max "
                    f"{[round(g['max_mem'] / 1e9, 2) for g in got]} GB; "
                    f"host RSS {[round(g['rss_gb'], 2) for g in got]} GB; "
                    f"graphed {got[0]['graphed']} | {card}")
        if not (exact and same and dl == 0.0 and k_ok and rows_ok and
                host_ok):
            fails.append(f"(j) {name}")
    y0 = by[(0, 0)]["b"]["y"]
    for c in sorted(by):
        b = by[c]["b"]
        ok = (b["promoted"] > 0 and b["shard_correct"] and b["landed"] and
              b["migrated"] >= 1 and b["forward_diff"] <= b["forward_tol"]
              and b["counts_permuted"] and b["fault corrupt"] and
              b["fault fail"] and b["fault_cancel_events"] == 1 and
              torch.equal(b["y"], y0))
        log("ep", f"(j) rank {c}: {b['promoted']} promotions on "
                  f"shard-correct slots {b['shard_correct']}, hi rows "
                  f"landed {b['landed']}; {b['migrated']} migrations, the "
                  f"layer's output max |diff| {b['forward_diff']:.3g} "
                  f"(bound {b['forward_tol']:.3g}), bit-equal "
                  f"{b['forward_same']}, counts permuted "
                  f"{b['counts_permuted']}; ep_mig rolled back "
                  f"{b['fault corrupt']} / refunded {b['fault fail']} | "
                  f"{card}")
        if not ok:
            fails.append(f"(j) rank {c}")
    alike = all(by[(1, j)]["b"]["state"] == by[(0, j)]["b"]["state"]
                for j in (0, 1))
    log("ep", f"(j) after promotions, rebalance and faults both data rows "
              f"hold the same banks, slot maps, routers and placements: "
              f"{alike}; (j) took "
              f"{max(r['j_s'] for r in ranks):.1f} s on the ranks | {card}")
    if not alike:
        fails.append("(j) data rows")
    return runs


def phase_ep(card: str) -> None:
    """Expert parallelism on the one card: EP_WORLD ranks over gloo
    (``repro_torch.launch.mesh.spawn``), each holding E/N of the 30B's
    experts at full width; their tokens and last logits held bit-equal to
    one eager process on the same weights, which runs here while the
    ranks start."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    log("ep", f"{ARCH} at full width, {EP_LAYERS} of 48 layers, seed "
              f"{EP_SEED}; {EP_WORLD} ranks on {card}, gloo (host-staged "
              f"collectives, the ranks sharing one device: not an EP "
              f"deployment); {EP_REQUESTS} requests x {EP_NEW} tokens, "
              f"{EP_SLOTS} slots, op by op, frozen policy timers")
    box: dict = {"spawned": time.time()}

    def world():
        try:
            box["ranks"] = spawn(_ep_rank, EP_WORLD, "cuda", threads=2)
        except BaseException as e:          # re-raised below, in order
            box["error"] = e

    th = threading.Thread(target=world)
    th.start()
    cfg, params, prompts = _ep_model(dev)
    single = {}
    for name in EP_RUNS[2]:
        engine, single[name] = _ep_serve(cfg, params, prompts, name, dev)
        del engine
    padded = _ep_padded(cfg, params)
    grid_single = _grid_single(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    spec_single = _plan_single(dev)
    gc.collect()
    torch.cuda.empty_cache()
    fam_single = _fam_runs(None, dev)
    t1 = time.perf_counter()
    th.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    fails, runs = [], []
    for n, names in EP_RUNS.items():
        for name in names:
            want = single[name]
            got = [r[(n, name)] for r in ranks[:n]]
            runs += [{"launches": g["launches"]} for g in got]
            same = all(g["tokens"] == want["tokens"] for g in got)
            dl = max(float((g["logits"] - want["logits"]).abs().max())
                     for g in got)
            k_ok = all(g["launches"][k] > 0 for g in got
                       for k in EP_KERNELS[name])
            steps = got[0]["steps"]
            rg = got[0]["regimes"]
            regimes_ok = all(g["regimes"]["padded"] == 0 for g in got) and \
                rg["all_to_all"] > steps * EP_LAYERS
            log("ep", f"(a) N={n} {name}: tokens {'=' if same else '!='} "
                      f"one process, max |logit diff| last step {dl:.3g}; "
                      f"MoE calls by regime {rg} ({steps} decode steps x "
                      f"{EP_LAYERS} layers + prefills); launches per rank "
                      + "; ".join(
                          ", ".join(f"{k} {g['launches'][k]}"
                                    for k in EP_KERNELS[name])
                          for g in got)
                      + f" | TPOT rank 0 {got[0]['tpot_s'] * 1e3:.2f} ms, "
                        f"one process eager {want['tpot_s'] * 1e3:.2f} ms; "
                        f"expert bytes per rank "
                        f"{[g['expert_bytes'] for g in got]}, one process "
                        f"{want['expert_bytes']}; pinned host masters "
                        f"per rank {[g['host_master_bytes'] for g in got]},"
                        f" one process {want['host_master_bytes']}; "
                        f"device max "
                        f"{[round(g['max_mem'] / 1e9, 2) for g in got]} GB; "
                        f"host RSS {[round(g['rss_gb'], 2) for g in got]} GB;"
                        f" graphed {got[0]['graphed']} | {card}")
            # Each rank pins its own experts' bf16 masters: 1/N of one
            # process's (none without dynaexq).
            host_ok = all(n * g["host_master_bytes"] ==
                          want["host_master_bytes"] for g in got)
            if not (same and dl == 0.0 and k_ok and regimes_ok and host_ok):
                fails.append(f"(a) N={n} {name}")
            if name == "dynaexq":
                for i, g in enumerate(got):
                    b = g["bytes"]
                    # A model-only group: every collective on the model
                    # axis, or on the token axes, which are the same ranks.
                    a2a = sum(b["sent"]["all_to_all"].values())
                    log("ep", f"(d) N={n} rank {i}: one decode "
                              f"layer ({EP_SLOTS} tokens, S={b['S']}) sent "
                              f"{b['sent']} bytes; all_to_all {a2a} = the "
                              f"reference's 2(N-1)·S·d bf16 "
                              f"{b['model_rows']} + the counts "
                              f"{b['counts']} | {card}")
                    if a2a != b["model_rows"] + b["counts"]:
                        fails.append(f"(d) N={n} bytes")
    for r in ranks:
        b = r["b"]
        ok = (b["promoted"] > 0 and b["shard_correct"] and b["landed"] and
              b["migrated"] >= 1 and b["forward_diff"] <= b["forward_tol"]
              and
              b["counts_permuted"] and b["demoted_in_rebalance"] == 0 and
              b["fault corrupt"] and b["fault fail"] and
              b["fault_cancel_events"] == 1 and
              torch.equal(b["y"], ranks[0]["b"]["y"]))
        log("ep", f"(b) N=4 rank {r['rank']}: {b['promoted']} promotions on "
                  f"shard-correct slots {b['shard_correct']}, rows landed "
                  f"{b['landed']}; {b['migrated']} migrations, layer output "
                  f"bit-equal {b['forward_same']} ({b['rows_same']} of "
                  f"{EP_SLOTS} rows; {b['untouched_same']} of the "
                  f"{EP_SLOTS - b['rows_touched']} rows routed to no moved "
                  f"expert), max |diff| {b['forward_diff']:.3g} (bound "
                  f"{b['forward_tol']:.3g}), counts permuted "
                  f"{b['counts_permuted']}; ep_mig mid-swap rolled back "
                  f"{b['fault corrupt']}, before the swap refunded "
                  f"{b['fault fail']} | {card}")
        if not ok:
            fails.append(f"(b) rank {r['rank']}")
    err = [float((r["c"]["y"] - padded["y"]).abs().max()) for r in ranks[:2]]
    tol = EP_PADDED_TOL * float(padded["y"].abs().max())
    c_ok = all(r["c"]["regimes"] == {"all_to_all": 0, "padded": 1} and
               r["c"]["launches"]["grouped_lo_matmul"] > 0 and
               torch.equal(r["c"]["counts"], padded["counts"]) and
               torch.equal(r["c"]["y"], ranks[0]["c"]["y"])
               for r in ranks[:2]) and max(err) <= tol
    runs += [{"launches": r["c"]["launches"]} for r in ranks[:2]]
    log("ep", f"(c) N=2, T={EP_PADDED_T}: the padded regime on each rank "
              f"(grouped_lo_matmul "
              f"{[r['c']['launches']['grouped_lo_matmul'] for r in ranks[:2]]}"
              f"), max |y - one process's padded layer| {max(err):.4g} "
              f"(tolerance {tol:.4g}) | {card}")
    if not c_ok:
        fails.append("(c)")
    runs += _grid_check(ranks, grid_single, cfg, fails, card)
    runs += _grid_engine_check(ranks, single, fails, card)
    runs += _plan_check([r["gh"] for r in ranks], spec_single, fails, card)
    runs += _fam_check(ranks, fam_single, fails, card)
    EP_PLAN[:] = [{k: (v if k == "coords" else
                       {f: v[f] for f in ("sent", "held", "mem_start",
                                          "max_mem")})
                   for k, v in r["gh"].items()} for r in ranks]
    EP_FAM[:] = [dict({k: {f: v.get(f) for f in ("sent", "sent_prefill",
                                                 "held")}
                       for k, v in r["i"].items()},
                      coords=r["gh"]["coords"]) for r in ranks]
    log("ep", f"(g) and (h) took {max(r['gh_s'] for r in ranks):.1f} s, (i) "
              f"{max(r['i_s'] for r in ranks):.1f} s on the ranks | {card}")
    for k in RESULTS:
        RESULTS[k]["launches"] = RESULTS[k].get("launches", 0) + sum(
            r["launches"][k] for r in runs)
    started = max(r["entered"] for r in ranks) - box["spawned"]
    ran = max(r["left"] for r in ranks) - max(r["entered"] for r in ranks)
    log("ep", f"phase done in {time.perf_counter() - t0:.1f} s (one "
              f"process's runs beside the ranks' start {t1 - t0:.1f} s; "
              f"the ranks in their function {started:.1f} s after the "
              f"spawn, there {ran:.1f} s, rank 0's model built in "
              f"{ranks[0]['build_s']:.1f} s) | {card}")
    if fails:
        raise AssertionError(f"ep: {fails}")


# ---------------------------------------------------------------------------
# 5b. dryrun: every (arch × shape) priced per rank over meta tensors
# ---------------------------------------------------------------------------

#: The 30B's shapes the phase prices on the 16 x 16 grid, at full width
#: and depth (``repro_torch.launch.dryrun.run_one``), and the families'
#: decode_32k, each at full depth.
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_FAMILIES = ("mamba2-130m", "jamba-v0_1-52b", "whisper-tiny",
                "llava-next-34b")
DRY_CELLS = tuple((ARCH, s) for s in DRY_SHAPES) + \
    tuple((a, "decode_32k") for a in DRY_FAMILIES)
#: Most seconds the dry-run process may take past the phase's start.
DRY_WAIT_S = 600
#: (g) and (h) as the ep phase measured them on each rank: the bytes each
#: collective sent, the bytes each rank held and its device peak
#: (``phase_ep`` fills it; the dryrun phase holds its recorded runs to it).
EP_PLAN: list = []
#: (i) as the ep phase measured it on each rank: the bytes each collective
#: sent and each rank held, by run.
EP_FAM: list = []
_DRY_BESIDE = None

#: The dry-run process's program: the cells ("arch:shape" in argv[3:]) on
#: 16 x 16, then (i) recorded on each rank of its 2 x 2 grid (this
#: script's ``_dry_fam``, the script's directory argv[2]); one thread, no
#: card (CUDA_VISIBLE_DEVICES is empty), the records to argv[1].
_DRY_CODE = """
import json, os, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
out = []
for cell in sys.argv[3:]:
    arch, shape = cell.split(":")
    t = time.perf_counter()
    recs = dryrun.run_one(arch, shape, False, verbose=False)
    out.append({"arch": arch, "shape": shape, "s": time.perf_counter() - t,
                "records": recs})
sys.path.insert(0, sys.argv[2])
import chip_smoke
torch.cuda.synchronize = lambda *a, **k: None
t = time.perf_counter()
fam = [chip_smoke._dry_fam(r) for r in range(4)]
fam = {"s": time.perf_counter() - t, "ranks": [
    {"coords": d.pop("coords"), "runs": [[list(k), v] for k, v in d.items()]}
    for d in fam]}
with open(sys.argv[1] + ".tmp", "w") as f:
    json.dump({"cells": out, "fam": fam}, f)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
"""


class _DryBeside:
    """The dry run of DRY_CELLS and (i)'s recording in a process of its own,
    started after the build at nice 19 on one thread: it needs no card,
    and its minute or two of host work runs beside the card's phases."""

    def __init__(self):
        import tempfile
        self._tmp = tempfile.TemporaryDirectory(prefix="dryrun_")
        self.path = pathlib.Path(self._tmp.name) / "records.json"
        self.err = open(pathlib.Path(self._tmp.name) / "stderr", "w+")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DRY_CODE, str(self.path), str(ROOT),
             *(f"{a}:{s}" for a, s in DRY_CELLS)], env=env,
            stdout=subprocess.DEVNULL,
            stderr=self.err, preexec_fn=lambda: os.nice(19))

    def result(self):
        """(the records: {"cells": by cell, "fam": (i)'s}, the process's
        seconds, the seconds waited for it here)."""
        t = time.perf_counter()
        rc = self.proc.wait(timeout=DRY_WAIT_S)
        waited = time.perf_counter() - t
        if rc != 0:
            self.err.seek(0)
            raise RuntimeError(f"the dry-run process exited {rc}: "
                               f"{self.err.read()[-4000:]}")
        with open(self.path) as f:
            return json.load(f), time.perf_counter() - self.t0, waited

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        self._tmp.cleanup()


def _dry_plan(rank: int) -> dict:
    """(g) and (h) of ``_plan_rank`` for rank ``rank`` of the 2 x 2 grid,
    on meta copies of their trees under the recording mode: the same
    arguments (``_plan_args``, ``_plan_train_args``) and calls
    (``_plan_steps``, ``_plan_train_forward``); the bytes each rank holds,
    each collective sent, and the dry run's peak of live intermediates
    (over (h)'s whole train step)."""
    from repro_torch.launch import dist as D
    from repro_torch.launch.dist import dist_ctx
    from repro_torch.launch.dryrun import StepRecorder
    from repro_torch.launch.mesh import dry_context
    from repro_torch.launch.sharding import GridShape
    from repro_torch.models import specs as SP
    from repro_torch.training.train import make_train_step
    meta = torch.device("meta")
    grid = GridShape({"data": 2, "model": 2}, ("data", "model"))
    out = {}
    with D.dry_run():
        ctx0 = dry_context(grid, rank)
        out["coords"] = (ctx0.data_rank, ctx0.rank)
        cfg, params, banks = _plan_model(meta)
        for B in PLAN_ROWS:
            ctx, p, b, caches, inputs, steps, held, _ = _plan_args(
                cfg, params, banks, B, ctx0)
            # The specs' cache filled outside the recorder: it draws the
            # whole tree on meta once, which no step holds.
            SP.param_specs(cfg, ctx.planner)
            with StepRecorder() as rec:
                _, _, sent, _ = _plan_steps(cfg, p, b, caches, inputs,
                                            steps, ctx)
            out[("g", B)] = {"sent": sent, "held": held, "peak": rec.peak}
        hcfg, tcfg, ctx, p, opt, batch, held = _plan_train_args(ctx0)
        sent = _plan_train_forward(hcfg, tcfg, ctx, p, batch)
        with StepRecorder() as rec, dist_ctx(ctx):
            make_train_step(hcfg, tcfg)(p, opt, batch)
        out["h"] = {"sent": sent, "held": held, "peak": rec.peak}
    return out


def _dry_plan_check(fails, card) -> None:
    """(g) and (h) recorded on every rank of the 2 x 2 grid, held to the
    ep phase's runs on the card: the bytes each collective sent, by
    collective and axis, and the bytes each rank held, to the byte (to the
    formulas and ``rank_bytes`` where the ep phase did not run); the dry
    run's arguments plus peak beside each rank's device peak, and its peak
    of intermediates beside the device peak's rise over the run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import GridShape, ShardingPlanner
    dry = [_dry_plan(r) for r in range(4)]
    measured = bool(EP_PLAN)
    tcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PLAN_LAYERS)
    gcfg = dataclasses.replace(get_config(ARCH), n_layers=PLAN_LAYERS)
    for key in [("g", B) for B in PLAN_ROWS] + ["h"]:
        sent_ok = held_ok = True
        ratios, rises = [], []
        for r, d in enumerate(dry):
            got = d[key]
            if measured:
                want = next(e for e in EP_PLAN if e["coords"] ==
                            d["coords"])[key]
                sent_ok &= got["sent"] == want["sent"]
                held_ok &= all(got["held"][n][0] == want["held"][n][0]
                               for n in want["held"])
                args = sum(h[0] for h in got["held"].values())
                ratios.append(round((args + got["peak"]) / want["max_mem"],
                                    3))
                rises.append(want["max_mem"] - want["mem_start"])
            else:
                want_sent = _plan_sent_expected(gcfg, key[1]) \
                    if key != "h" else _plan_train_sent_expected(
                        tcfg, ShardingPlanner(tcfg, GridShape(
                            {"data": 2, "model": 2}, ("data", "model")),
                            fsdp=True))
                sent_ok &= got["sent"] == want_sent
                held_ok &= all(h == w for h, w in got["held"].values())
        what = "(h) forward" if key == "h" else \
            f"(g) {key[1]} rows, first decode step"
        against = "the ep phase's runs on the card" if measured else \
            "the formulas and rank_bytes (the ep phase did not run)"
        log("dryrun", f"{what} recorded on the 2 x 2 grid's 4 ranks, rank "
                      f"0 sent " + ", ".join(
                          f"{c} {v}" for c, v in dry[0][key]["sent"].items()
                          if any(v.values()))
                      + f" bytes; every rank's sent bytes = {against}: "
                        f"{sent_ok}; held bytes rank 0 "
                        f"{ {n: h[0] for n, h in dry[0][key]['held'].items()} }"
                        f" = theirs {held_ok}; dry run's arguments + peak / "
                        f"device peak per rank "
                      + (f"{ratios} (no bound; each rank's process also "
                         f"holds the whole tree it cut its shards from); the "
                         f"dry run's peak of intermediates rank 0 "
                         f"{dry[0][key]['peak']} B, the device peak's rise "
                         f"over the run per rank {rises} B"
                         if measured else "not measured") + f" | {card}")
        if not (sent_ok and held_ok):
            fails.append(f"dryrun {what}")


def _dry_fam(rank: int) -> dict:
    """(i) of ``_fam_runs`` for rank ``rank`` of the 2 x 2 grid on meta
    trees under the recording mode: the same arguments (``_fam_shard``,
    ``_fam_args``, ``_plan_train_args``) and calls (``_plan_steps``,
    ``_plan_train_forward``); the bytes each rank holds and each
    collective sent."""
    from repro_torch.launch import dist as D
    from repro_torch.launch.mesh import dry_context
    from repro_torch.launch.sharding import GridShape
    from repro_torch.models import specs as SP
    meta = torch.device("meta")
    grid = GridShape({"data": 2, "model": 2}, ("data", "model"))
    out = {}
    with D.dry_run():
        ctx0 = dry_context(grid, rank)
        out["coords"] = (ctx0.data_rank, ctx0.rank)
        for name, fam, f32 in FAM_RUNS:
            cfg, p, b, pl, held = _fam_variant(name, fam, f32, meta, ctx0)
            SP.param_specs(cfg, pl)
            for B in FAM_ROWS:
                ctx, p, b, caches, inputs, steps, h, _ = _fam_args(
                    fam, cfg, p, b, B, ctx0, pl, held)
                _, _, sent, sent_prefill = _plan_steps(
                    cfg, p, b, caches, inputs, steps, ctx)
                out[(name, B)] = {"sent": sent,
                                  "sent_prefill": sent_prefill, "held": h}
        for fam in FAM_TRAIN:
            cfg, tcfg, ctx, p, opt, batch, h = _plan_train_args(
                ctx0, model=_fam_train_model(fam))
            out[("train", fam)] = {"sent": _plan_train_forward(
                cfg, tcfg, ctx, p, batch), "sent_prefill": None, "held": h}
    return out


def _dry_fam_check(fam, fails, card) -> None:
    """(i) recorded on every rank of the 2 x 2 grid (``fam``: the dry-run
    process's JSON of ``_dry_fam``), held to the ep phase's runs on the
    card: the bytes each collective sent in each run's prefill and first
    decode step (a train step's forward), by collective and axis, and the
    bytes each rank held, to the byte (to ``rank_bytes`` alone where the
    ep phase did not run)."""
    dry = [dict({tuple(k): v for k, v in r["runs"]},
                coords=tuple(r["coords"])) for r in fam["ranks"]]
    measured = bool(EP_FAM)
    ep = json.loads(json.dumps([[list(e["coords"]),
                                 [[list(k), v] for k, v in e.items()
                                  if k != "coords"]] for e in EP_FAM]))
    ep = [dict({tuple(k): v for k, v in runs}, coords=tuple(c))
          for c, runs in ep]
    keys = [(r[0], B) for r in FAM_RUNS for B in FAM_ROWS] + \
        [("train", f) for f in FAM_TRAIN]
    for key in keys:
        sent_ok = held_ok = True
        for d in dry:
            got = d[key]
            if measured:
                want = next(e for e in ep
                            if e["coords"] == d["coords"])[key]
                sent_ok &= got["sent"] == want["sent"] and \
                    got["sent_prefill"] == want["sent_prefill"]
                held_ok &= all(got["held"][n][0] == want["held"][n][0]
                               for n in want["held"])
            else:
                held_ok &= all(h == w for h, w in got["held"].values())
        what = f"(i) {key[1]} train step's forward" if key[0] == "train" \
            else f"(i) {key[0]} {key[1]} rows, prefill and first decode step"
        against = "the ep phase's runs on the card" if measured else \
            "rank_bytes (the ep phase did not run; sent not held)"
        log("dryrun", f"{what} recorded on the 2 x 2 grid's 4 ranks, rank 0 "
                      f"sent " + _sent_str(dry[0][key]["sent"])
                      + f"; every rank's sent bytes = {against}: "
                        f"{sent_ok if measured else 'not measured'}; held "
                        f"bytes rank 0 "
                      + str({n: h[0] for n, h in dry[0][key]["held"].items()})
                      + f" = theirs {held_ok} | {card}")
        if not (sent_ok and held_ok):
            fails.append(f"dryrun {what}")
    log("dryrun", f"(i) recorded in {fam['s']:.1f} s in the dry-run "
                  f"process | {card}")


def phase_dryrun(card: str) -> None:
    """The dry run: (1) the 30B's four shapes and each family's decode_32k
    on 16 x 16 at full width and depth, priced per rank over meta tensors
    (from the process ``_DryBeside`` started after the build, or here);
    (2) (g), (h) and (i) on meta copies of their trees, held to what the
    ep phase measured."""
    t0 = time.perf_counter()
    fails: list = []
    _dry_plan_check(fails, card)
    t_plan = time.perf_counter() - t0
    beside = _DRY_BESIDE if _DRY_BESIDE is not None else _DryBeside()
    try:
        recs, proc_s, waited = beside.result()
    finally:
        if beside is not _DRY_BESIDE:
            beside.close()
    _dry_fam_check(recs["fam"], fails, card)
    for item in recs["cells"]:
        r = item["records"][0]
        rl = r["roofline"]
        axes: dict = {}
        for per in r["sent_bytes"].values():
            for a, b in per.items():
                axes[a] = axes.get(a, 0) + b
        ok = len(item["records"]) == 1 and r["ranks"] == [0, 255] and \
            r["largest_off_meta_bytes"] <= 1 << 20 and \
            rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0
        log("dryrun", f"{item['arch']} x {item['shape']} on 16x16 (ranks "
                      f"{r.get('ranks')} agree: {len(item['records']) == 1}"
                      f"): per rank {r['per_device_hbm_gb']} GB (arguments "
                      f"{r['argument_size_in_bytes'] / 1e9:.3f} GB + peak "
                      f"{r['temp_size_in_bytes'] / 1e9:.3f} GB; fits 80 GB "
                      f"{r['fits_80gb_hbm']}), sent MB by axis "
                      + str({a: round(b / 1e6, 3) for a, b in axes.items()})
                      + f", roofline compute {rl['t_compute_s']} s, memory "
                        f"{rl['t_memory_s']} s, collective "
                        f"{rl['t_collective_s']} s (H100 SXM data-sheet "
                        f"figures) -> {rl['bottleneck']}; regimes "
                        f"{r['regimes']}; kernels priced "
                      + str({k: v["calls"] for k, v in r["kernels"].items()})
                      + f"; largest tensor off meta "
                        f"{r['largest_off_meta_bytes']} B; recorded in "
                        f"{item['s']:.1f} s | {card}")
        if not ok:
            fails.append(f"dryrun {item['arch']} {item['shape']}")
    log("dryrun", f"phase done in {time.perf_counter() - t0:.1f} s ((g) "
                  f"and (h) {t_plan:.1f} s; the 16 x 16 records and (i)'s "
                  f"waited for {waited:.1f} s, their process {proc_s:.1f} "
                  f"s since its start, beside the phases) | {card}")
    if fails:
        raise AssertionError(f"dryrun: {fails}")


# ---------------------------------------------------------------------------
# 6. trace: where a decode step's device time goes
# ---------------------------------------------------------------------------

#: Kernel groups of the trace, matched on the kernel's name in this order
#: (the port's kernels first: cuBLAS names also hold "gemm"); the rest is
#: PyTorch's own elementwise, indexing, sort and scan kernels.
TRACE_GROUPS = (
    ("ragged FFN", ("ragged_ffn_kernel",)),
    ("decode attention", ("fd_paged_split_kernel", "fd_split_kernel",
                          "merge_splits_kernel")),
    ("grouped GEMM", ("gemm_kernel<", "sum_splits")),
    ("cuBLAS GEMM", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
    ("sort and scan", ("sort", "radix", "scan", "Scan")),
    ("index, scatter, gather", ("index", "scatter", "gather", "Index")),
    ("reductions", ("reduce", "Reduce")),
    ("copies", ("Memcpy", "memcpy", "Memset", "copy")),
)
TRACE_STEPS = 10

#: The port's kernels on the decode paths, by the wrappers that count them
#: in ``ops.LAUNCHES`` and the device kernel each launch starts (a split
#: attention or GEMM also starts a merge or sum, not counted here).
TRACE_COUNTED = (
    (("ragged_gateup", "ragged_down"), "ragged_ffn_kernel"),
    (("flash_decode_paged",), "fd_paged_split_kernel"),
    (("flash_decode",), "fd_split_kernel"),
    (("grouped_lo_matmul", "quant_matmul"), "gemm_kernel<"),
)

#: Clock cycles of the spin that holds the stream while a replay is
#: enqueued behind it (~50 ms at the H100's 1.98 GHz boost clock).
SPIN_CYCLES = 100_000_000

#: Noise allowed when the traced kernels' sum is held against the steps
#: that ran them.
TRACE_NOISE = 0.03

#: Clock cycles of the marker kernels (``torch.cuda._sleep``, device name
#: ``spin_kernel``) launched just inside both edges of the traced window:
#: the profiler has seen the whole window only if it saw both.
TRACE_MARK_CYCLES = 1000
#: Fresh engines traced before giving up when the profiler misses an edge
#: of the window (its start lags now and then: one run lost ~0.8 of the
#: first eager step's kernels).
TRACE_ATTEMPTS = 3
#: Host seconds of idle device on both sides of the traced window's opening
#: edge and before its closing edge. The profiler clips the device's activities to the window by the
#: host's clock, onto which their timestamps are mapped with an error that
#: can reach tens of ms (see ``TRACE_ATTEMPTS``): a marker launched within
#: microseconds of an edge can then fall outside the window, and a kernel
#: of the step before inside it. The gaps keep every launch of the window,
#: and nothing else, this far inside its edges; the kernels' sums and
#: counts do not change.
TRACE_EDGE_S = 0.5


def _group(name: str) -> str:
    for group, keys in TRACE_GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise and other"


def _queued_replays(graph, n: int = TRACE_STEPS):
    """Device ms of ``n`` replays, each enqueued behind a spin so that its
    whole launch is submitted before the device reaches its start event
    (the replays rerun the last step's inputs: its K/V rewritten with the
    same values), and the host ms each ``replay()`` call took. Fails if a
    launch call outlasted the spin that should hide it."""
    device_ms, host_ms = [], []
    for _ in range(n):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        e1.record()
        t = time.perf_counter()
        graph.replay()
        host_ms.append((time.perf_counter() - t) * 1e3)
        e2.record()
        torch.cuda.synchronize()
        if host_ms[-1] >= e0.elapsed_time(e1):
            raise AssertionError(f"a replay's launch took {host_ms[-1]:.3f} "
                                 f"host ms, longer than the "
                                 f"{e0.elapsed_time(e1):.3f} ms spin")
        device_ms.append(e1.elapsed_time(e2))
    return float(np.mean(device_ms)), float(np.mean(host_ms))


def _traced_steps(engine, mode):
    """``TRACE_STEPS`` decode-only steps of a running engine timed on the
    host, then one traced step whose trace is dropped (the tracer's start
    lags: it missed a few kernels of the first traced step in one run),
    then ``TRACE_STEPS`` traced (device activity only; the profiler slows
    the host, so the host time is read from the first set) between two
    marker kernels, ``TRACE_EDGE_S`` of idle device away from the window's
    edges, with the replays' CUDA events in both sets when
    graphed. Returns (kernel name → (device ms, launches) summed over the
    traced steps, ``ops.LAUNCHES`` over the traced steps, host ms per
    step, replay ms by events untraced and traced, or None, the markers
    the profiler saw)."""
    import contextlib
    import repro_torch.serving.engine as eng_mod
    from repro_torch.kernels import ops
    from torch.profiler import ProfilerActivity, profile, schedule
    graphed = mode == "graph"
    ctx = contextlib.nullcontext() if graphed else eng_mod.eager()
    events = [[], []]                     # untraced, traced
    with ctx:
        torch.cuda.synchronize()
        if graphed:
            engine.decode_graph.events = events[0]
        t0 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            engine.step()
        wall = (time.perf_counter() - t0) / TRACE_STEPS * 1e3
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            engine.step()
            torch.cuda.synchronize()
            time.sleep(TRACE_EDGE_S)
            prof.step()
            time.sleep(TRACE_EDGE_S)
            if graphed:
                engine.decode_graph.events = events[1]
            torch.cuda._sleep(TRACE_MARK_CYCLES)
            ops.reset_launches()
            for _ in range(TRACE_STEPS):
                engine.step()
            torch.cuda._sleep(TRACE_MARK_CYCLES)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            time.sleep(TRACE_EDGE_S)
            prof.step()
    kernels, marks = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
        if "spin_kernel" in e.key:
            marks += e.count
        elif us > 0:
            kernels[e.key] = (us / 1e3, e.count)
    engine.decode_graph.events = None
    replay = [float(np.mean([a.elapsed_time(b) for a, b in ev]))
              for ev in events] if graphed else None
    return kernels, launches, wall, replay, marks


def phase_trace(card: str) -> None:
    """On each path, the static backend: serve the serving phase's
    requests until every one is admitted and decoding, then time and
    trace decode steps graphed and under ``eager()`` (each on a fresh
    engine): device ms per step by kernel group and the busiest kernels;
    the port's kernels counted by the profiler against ``ops.LAUNCHES``
    (under the graph: the counts its capture recorded, added per replay);
    graphed, the kernels' sum against a replay by CUDA events as the engine
    issues it, enqueued behind a spin (device time alone) and traced, with
    the device's idle share in each, and the host ms of the launch call.
    Then the same for the flagship (4 layers, static int2) on its main
    path. Fails if the kernels' sum exceeds the steps that ran them
    (double counting) or a count disagrees."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.requests import make_prompts
    dev = torch.device("cuda")
    for arch, layers, lo_bits, paths in (
            (ARCH, SERVE_LAYERS, 4, PATHS),
            (FLAGSHIP, FLAGSHIP_SERVE_LAYERS, 2,
             {"paged/ragged": PATHS["paged/ragged"]})):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = init_params(cfg, seed=0, device=dev)
        rng = np.random.default_rng(0)
        prompts = [make_prompts("text", cfg.vocab_size, 1, int(n), seed=i)[0]
                   for i, n in enumerate(rng.integers(64, 257, 8))]
        for path, (paged, dispatch, _, _) in paths.items():
            for mode in ("graph", "eager"):
                _trace_one(cfg, params, prompts, f"{cfg.name} {path}", paged,
                           dispatch, mode, lo_bits, card)
        del params
    _trace_train_step(card)


def _trace_train_step(card) -> None:
    """The train phase's step (granite at full width and depth, seeded
    weights, 16 x 64 tokens) once warm, then once under ``torch.profiler``
    (device activity): the device's busy ms and kernels per step against
    the step's ms by CUDA events, and the five kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training import (AdamWConfig, SyntheticLMTask,
                                      TrainConfig, adamw_init,
                                      make_train_step)
    from repro_torch.training.train import to_batch
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        total_steps=TRAIN_STEPS)))
    batch = to_batch(next(SyntheticLMTask(cfg.vocab_size, seed=0).batches(
        TRAIN_BATCH, TRAIN_SEQ, 1, seed=TRAIN_STEPS)), dev)
    params = init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        prof.step()
        ev[0].record()
        params, opt, _ = step(params, opt, batch)
        ev[1].record()
        torch.cuda.synchronize()
        prof.step()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels[e.key] = (us / 1e3, e.count)
    busy = sum(v[0] for v in kernels.values())
    n = sum(v[1] for v in kernels.values())
    ms = ev[0].elapsed_time(ev[1])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log("trace", f"train step, traced ({cfg.name}, {TRAIN_BATCH} x "
                 f"{TRAIN_SEQ - 1} tokens): {ms:.2f} ms by events, device "
                 f"busy {busy:.2f} ms over {n} kernels (idle share "
                 f"{1 - busy / ms:.3f}); most device time: "
                 + "; ".join(f"{k[:60]} {v[0]:.2f} ms x{v[1]}"
                             for k, v in top) + f" | {card}")
    del params, opt


def _trace_one(cfg, params, prompts, what, paged, dispatch, mode, lo_bits,
               card) -> None:
    """One traced engine of ``phase_trace``: the static backend at int
    ``lo_bits`` on one path, graphed or eager."""
    import repro_torch.serving.engine as eng_mod
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.requests import Request
    dev = torch.device("cuda")
    seen_marks = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        engine = eng_mod.InferenceEngine(
            cfg, _fresh(params), make_backend("static", lo_bits=lo_bits,
                                              device=dev),
            eng_mod.EngineConfig(max_slots=8, max_len=288, paged=paged,
                                 moe_dispatch=dispatch), device=dev)
        for p in prompts:
            engine.submit(Request(tokens=p, max_new_tokens=32))
        while engine.queue or engine.counters["steps"] < 3:
            engine.step()
        kernels, launches, wall, replay, marks = _traced_steps(engine, mode)
        seen_marks.append(marks)
        if marks == 2:
            break
        del engine
        log("trace", f"{what} static {mode}: the profiler saw {marks} of "
                     f"the 2 marker kernels at the edges of the traced "
                     f"window (attempt {attempt} of {TRACE_ATTEMPTS}); "
                     f"tracing a fresh engine")
    else:
        raise AssertionError(f"{what} {mode}: the profiler missed an edge "
                             f"of the traced window in every attempt (it "
                             f"saw {seen_marks} of the 2 marker kernels)")
    queued = _queued_replays(engine.decode_graph.graph) \
        if mode == "graph" else None
    del engine
    total = sum(ms for ms, _ in kernels.values()) / TRACE_STEPS
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += ms / TRACE_STEPS
        g[1] += n / TRACE_STEPS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    if mode == "graph":
        (untraced, traced), (alone, launch) = replay, queued
        timing = (f"replay by events {untraced:.3f} ms as the "
                  f"engine issues it (device idle "
                  f"{(1 - total / untraced) * 100:.1f}%), "
                  f"{alone:.3f} enqueued behind a spin (device "
                  f"time alone; idle {(1 - total / alone) * 100:.1f}"
                  f"%), {traced:.3f} traced (idle "
                  f"{(1 - total / traced) * 100:.1f}%: the profiler "
                  f"slows the launch); the replay() call takes "
                  f"{launch:.3f} host ms")
        within, where = traced, "the traced replays that ran them"
    else:
        timing = "no replay: op by op"
        within, where = wall, "the host step"
    log("trace", f"{what} static {mode}, {TRACE_STEPS} decode steps "
                 f"of 8 rows: kernels {total:.3f} device ms per step "
                 f"(traced); host ms per step {wall:.3f} (untraced; "
                 f"{(1 - total / wall) * 100:.1f}% of it not covered "
                 f"by kernels); {timing}; by group (ms, launches per "
                 f"step) "
                 + ", ".join(f"{g} {ms:.3f}/{n:.0f}" for g, (ms, n)
                             in sorted(groups.items(),
                                       key=lambda kv: -kv[1][0]))
                 + "; top kernels (ms per step) "
                 + ", ".join(f"{k[:60]} {ms / TRACE_STEPS:.3f}"
                             for k, (ms, _) in top) + f" | {card}")
    if total <= 0:
        raise AssertionError(f"{what} {mode}: the trace saw no device time")
    if total > within * (1 + TRACE_NOISE):
        raise AssertionError(f"{what} {mode}: the kernels' "
                             f"{total:.3f} ms per step exceed "
                             f"{where} ({within:.3f} ms)")
    seen = []
    for keys, kname in TRACE_COUNTED:
        counted = sum(launches.get(k, 0) for k in keys)
        traced_n = sum(n for name, (_, n) in kernels.items()
                       if kname in name)
        if traced_n != counted:
            raise AssertionError(f"{what} {mode}: the profiler saw "
                                 f"{traced_n} launches of {kname} "
                                 f"but ops.LAUNCHES counts {counted} "
                                 f"for {keys}")
        seen.append(f"{kname} {traced_n}")
    log("trace", f"{what} static {mode}: launches over the traced "
                 f"steps, profiler = ops.LAUNCHES: {', '.join(seen)}")


PHASES = ("card", "build", "kernels", "splits", "gemms", "serving",
          "requests", "spec", "ladder", "obs", "hybrid", "model",
          "families", "multimodal", "train", "ep", "dryrun", "trace")
#: Phases that run only when named in ``--only``.
EXTRA_PHASES = ("dense",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run, of "
                         f"{PHASES + EXTRA_PHASES}")
    ap.add_argument("--parent", default=None,
                    help="the parent commit's tree (a git archive), for "
                         "the kernels, dense and hybrid phases' A/B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    only = args.only.split(",")
    t0 = time.perf_counter()
    card = phase_card()
    global _CPU_REFS
    jobs = _cpu_jobs(only)
    if jobs:                # it draws on the card while nvcc builds
        _CPU_REFS = _CpuRefs(jobs)
    global _DRY_BESIDE
    try:
        phase_build()
        if "dryrun" in only:        # host work only: beside the phases
            _DRY_BESIDE = _DryBeside()
        if _CPU_REFS is not None:
            _CPU_REFS.ready()
        return _run_phases(args, only, card, t0)
    finally:
        if _CPU_REFS is not None:
            _CPU_REFS.close()
        if _DRY_BESIDE is not None:
            _DRY_BESIDE.close()


def _run_phases(args, only, card, t0) -> int:
    """Every phase in ``only`` in order, then the contract's last lines."""
    took = {}
    # The functions that hold a phase's CPU half (the hybrid model check's,
    # the multimodal twins'), called at the run's end: they wait for the
    # CPU process's results.
    pending = []
    for name, run in (("kernels", lambda: phase_kernels(args.parent)),
                      ("splits", phase_splits),
                      ("gemms", phase_gemms),
                      ("dense", lambda: phase_dense(args.parent)),
                      ("serving", lambda: phase_serving(card)),
                      ("requests", lambda: phase_requests(card)),
                      ("spec", lambda: phase_spec(card)),
                      ("ladder", lambda: phase_ladder(card)),
                      ("obs", lambda: phase_obs(card)),
                      ("hybrid", lambda: phase_hybrid(card, args.parent)),
                      ("model", phase_model),
                      ("families", lambda: phase_families(card)),
                      ("multimodal", lambda: phase_multimodal(card)),
                      ("train", lambda: phase_train(card)),
                      ("ep", lambda: phase_ep(card)),
                      ("dryrun", lambda: phase_dryrun(card)),
                      ("trace", lambda: phase_trace(card))):
        if name in only:
            t = time.perf_counter()
            join = run()
            if join is not None:
                pending.append(join)
            took[name] = time.perf_counter() - t
            # What the phase built (engines, weights, their graphs) goes
            # before the next phase: reference cycles collected, the
            # allocator's cache returned.
            gc.collect()
            torch.cuda.empty_cache()
            log("mem", f"after {name} ({took[name]:.1f} s): device "
                       f"memory allocated "
                       f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, "
                       f"reserved {torch.cuda.memory_reserved() / 1e9:.2f} "
                       f"GB")
    t = time.perf_counter()
    while pending:
        pending.pop(0)()
    log("done", f"the CPU halves held {time.perf_counter() - t:.1f} s after "
                f"the last phase")
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
                + ")")
    print(json.dumps({"kernels": [RESULTS[k] for k in sorted(RESULTS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
