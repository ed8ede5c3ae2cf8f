"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only card,build,kernels
    python3 chip_smoke.py --only card,build,kernels,serving
    python3 chip_smoke.py --only card,build,model,requests
    python3 chip_smoke.py --only card,build,spec
    python3 chip_smoke.py --only card,build,ladder
    python3 chip_smoke.py --only card,build,obs

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
              one expert in two places, held to the plain version;
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
              depend on agrees;
5. serving  — the 8-layer full-width model served by ``static`` and
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
   requests — the request front on the main path (8 full-width layers,
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
              requests, healed); (b) at 8 layers, ``model_sensitivity``
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
              30B main path at 8 layers, ``static`` graphed with the
              recorder and registry off, on, on, off on fresh engines:
              identical tokens and launches, TPOT, replay ms and host ms
              per step; (c) ``dynaexq`` observed on the wall clock, a
              window every step, no flush until the end: every published
              promotion span ends after its copy's event completed, the
              publish latency and the bytes/token residual by bucket;
6. trace    — on each path, 10 decode steps of the static backend traced
              by ``torch.profiler``, graphed and eager: device time per
              step by kernel group, the port's kernels counted by the
              profiler against ``ops.LAUNCHES``, and the share of a replay
              the device idles, as issued and enqueued behind a spin.

The last two lines are a JSON object with one entry per kernel and the
contract line ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402,F401
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails at once outside a checkout)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor rate
ARCH = "qwen3-moe-30b-a3b"
SERVE_LAYERS = 8               # of 48: bf16 host masters 9.7 GB, not 58 GB
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


def _dense_decode_inputs(cfg, gen, dev, B, S, holes=False):
    """q, the (B, S, Hkv, hd) views of head-major caches and valid, plus the
    rows that must come out as zeros and SDPA's yardstick call. B=8:
    ragged rows, one full (the inputs of earlier runs); else full rows, or
    with ``holes`` row 0 valid only in [0, 100) ∪ [S-196, S), row 1 at
    valid[0] alone and row 2 all-masked."""
    H, Hkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    ck = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    zero_rows = []
    if B == 8:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lengths[0] = S                         # one full row
        valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    else:
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
    _attn_result("flash_decode",
                 "src/repro_torch/kernels/csrc/flash_decode.cu",
                 "src/repro/kernels/flash_decode.py:31", cases)


def _paged_decode_inputs(cfg, gen, dev, B, nb, holes=False, bt=16):
    """q, block pools, table and valid, plus the rows that must come out
    as zeros and SDPA's yardstick call over the gathered view: random
    lengths (row 0 full), -1 entries past each row's blocks; with
    ``holes`` row 0 valid only in its first 2 and last 56 blocks, row 1
    vacant (table -1, valid[0]: reads block 0), row 2 all-masked."""
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
    valid = torch.arange(nb * bt, device=dev)[None, :] < lengths[:, None]
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
    _attn_result("flash_decode_paged",
                 "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
                 "src/repro/kernels/flash_decode.py:92", cases)


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
    before any launch): every registered config at full width takes the
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


def phase_kernels() -> None:
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


def _parent_library(parent: pathlib.Path):
    """The parent tree's ragged FFN and all-hi libraries
    (``csrc/ragged_ffn.cu`` and ``csrc/ragged_dense_ffn.cu`` of a ``git
    archive`` of the parent commit), built at once with this tree's flags
    into ``build/kernels/parent/`` and loaded with this tree's C
    signatures (the same entries; the parent's all-hi occupancy takes E
    where this tree's takes the tile count). Returns ({name: library},
    {name: path})."""
    import ctypes
    from repro_torch.kernels import build
    out_dir = build.build_dir() / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = ("ragged_ffn", "ragged_dense_ffn")
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
        bad = [k for k in sm if sm[k] != sp.get(k)]
        if bad:
            raise AssertionError(f"quantized ragged kernels changed: {bad}")
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
            maps = [ops._tensor_map(x, ops.DENSE_X_BOX)] + \
                [ops._tensor_map(w, ops.DENSE_W_BOX) for w in ws]
            args = [*maps, te.data_ptr(), n.data_ptr(), out_p.data_ptr(),
                    Tt, K, N, E, pgrid, ops.DENSE_NT, s0, w0]
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
        _quant_ab(plib, dev, stream)


def _quant_ab(plib, dev, stream) -> None:
    """The quantized ragged kernels (rows 1–2) of the parent and this tree
    on the same inputs in turns: int4, g = 64, hi tiles from a 16-slot
    pool, Qwen3-30B-A3B widths, decode B=8 and prefill 512; outputs
    bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.ver import ExpertBankQ
    from repro_torch.kernels import build
    from repro_torch.models.moe import (RAGGED_BM, _sort_routing,
                                        _tile_slots, ragged_tile_map)
    from repro_torch.quant.qtensor import quantize
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(77)
    E, K, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    n_hi, bits, group, bm = 16, 4, 64, RAGGED_BM
    lo = {n: quantize((torch.randn((E,) + s, generator=gen, device=dev)
                       * s[0] ** -0.5).to(torch.bfloat16), bits, group)
          for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                       ("w_down", (F, K)))}
    hi = {n: (torch.randn((n_hi,) + s, generator=gen, device=dev)
              * s[0] ** -0.5).to(torch.bfloat16)
          for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                       ("w_down", (F, K)))}
    owner = torch.full((n_hi,), -1, dtype=torch.int32, device=dev)
    owner[:12] = torch.randperm(E, generator=gen, device=dev)[:12].to(
        torch.int32)
    qbank = ExpertBankQ(lo=lo, hi=hi, slot_owner=owner,
                        slot_map=torch.zeros((E,), dtype=torch.int32,
                                             device=dev))
    mine = build.library("ragged_ffn")
    for T in (8, 512):
        logits = torch.randn((T, E), generator=gen, device=dev)
        idx = torch.topk(logits, cfg.moe.top_k, dim=-1).indices
        _, _, counts, _, _ = _sort_routing(idx, E)
        _, te, n = ragged_tile_map(counts, bm, T * cfg.moe.top_k)
        ts = _tile_slots(qbank, te, E)
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
            hi["w_up"].data_ptr(), o.data_ptr(), Tt, K, F, n_hi, bits, group,
            stream())
        dn = lambda lib, o: lib.ragged_down(
            h[0].data_ptr(), te.data_ptr(), ts.data_ptr(), n.data_ptr(),
            ld.packed.data_ptr(), ld.scales.data_ptr(),
            hi["w_down"].data_ptr(), o.data_ptr(), Tt, F, K, n_hi, bits,
            group, stream())
        rows = int(n.item()) * bm
        for what, fn, outs in (("ragged_gateup", gu, h),
                               ("ragged_down", dn, y)):
            for lib, o in zip((plib, mine), outs):
                build.check(fn(lib, o), what)
            torch.cuda.synchronize()
            if not torch.equal(outs[0][:rows], outs[1][:rows]):
                raise AssertionError(f"{what} T={T}: parent and change "
                                     f"differ")
            t = _turns(lambda: fn(plib, outs[0]), lambda: fn(mine, outs[1]))
            log("dense", f"A/B {what} int4 T={T} (quantized, unchanged): "
                         f"parent/change/change/parent graph ms "
                         f"{[round(v, 5) for v in t]}, outputs bit-equal")


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
                    lo_bits=4, n_hi=None):
    """Same seeded weights on ``dev_ref`` and ``dev``: one S-token prefill
    and ``steps`` teacher-forced decode steps, on the paged pool or dense
    rows, with MoE dispatch ``dispatch`` (``dispatch_ref`` on ``dev_ref``,
    default the same). One bank for both, int ``lo_bits`` with ``n_hi``
    hi slots per layer, half of them published. The weights are drawn and
    the bank quantized on ``dev`` (on the CPU either takes minutes at full
    width), then copied. Returns per forward (max |Δlogit| on identically
    routed rows and on all rows, mean |Δlogit|, max |logit|, rows routed
    identically)."""
    from repro_torch.models.model import (decode_step, decode_step_paged,
                                          init_caches, init_paged_caches,
                                          init_params, prefill,
                                          prefill_paged)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, seed=seed, device=dev)
    experts = params["blocks"]["0"]["moe"].pop("experts")
    if n_hi is None:
        n_hi = 16 if cfg.moe.num_experts >= 64 else 2
    bank = _bank_with_hi(experts, n_hi, gen, lo_bits=lo_bits)
    del experts
    runs = [(d, _to(params, d), {"0": bank.to(d)}, disp)
            for d, disp in ((dev_ref, dispatch_ref or dispatch),
                            (dev, dispatch))]
    nb = (S + steps + bt - 1) // bt + 1
    N = 1 + B * nb
    table = torch.arange(1, N, dtype=torch.int32).reshape(B, nb)
    lengths = torch.randint(6, S + 1, (B,), generator=gen)
    lengths[0] = S
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen)
    out = []
    for d, prm, bk, disp in runs:
        t = lambda x, d=d: x.to(d)
        kw = dict(bank=bk, per_row_counts=True, moe_dispatch=disp)
        if paged:
            caches = init_paged_caches(cfg, N, bt, device=d)
            logits, counts = prefill_paged(
                prm, cfg, t(toks), caches, t(table),
                t(torch.zeros(B, dtype=torch.long)), t(lengths), **kw)
        else:
            caches = init_caches(cfg, B, nb * bt, device=d)
            logits, counts = prefill(prm, cfg, t(toks), caches, t(lengths),
                                     **kw)
        seq = [(logits.float().cpu(), counts["0"].cpu())]
        pos = lengths.clone()
        for j in range(steps):
            if paged:
                wb = table[torch.arange(B), pos // bt].long()
                logits, counts = decode_step_paged(
                    prm, cfg, t(feed[j]), t(pos), caches, t(table), t(wb),
                    t(pos % bt), **kw)
            else:
                logits, counts = decode_step(prm, cfg, t(feed[j]), t(pos),
                                             caches, **kw)
            seq.append((logits.float().cpu(), counts["0"].cpu()))
            pos = pos + 1
        out.append(seq)
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
                     lo_bits=4, n_hi=None):
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
    top_k)) on the CPU."""
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
    seen, route = [], moe_mod.route

    def route_seen(*a, **k):
        out = route(*a, **k)
        seen.append(out[1].sort(dim=-1).values.cpu())
        return out

    def experts_of(n_calls):
        L = cfg.n_layers
        got = seen[-n_calls * L:]
        return torch.cat([torch.stack(got[c * L:(c + 1) * L])
                          for c in range(n_calls)], dim=1)

    out = {}
    moe_mod.route = route_seen
    try:
        for d in (dev_ref, dev):
            key = d.type if isinstance(d, torch.device) else str(d)
            prm, bk = _to(params, d), {"0": bank.to(d)}
            kw = dict(bank=bk, per_row_counts=True, moe_dispatch="ragged",
                      capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
            t = lambda x, d=d: torch.as_tensor(x).to(d)
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
    finally:
        moe_mod.route = route
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


def check_model(phase, cfg, what, dev_ref, card, **kw) -> None:
    """``run_model_check`` of ``cfg`` on ``dev_ref`` against ``card``, its
    line logged under ``phase``; raises when the logits disagree."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    report = run_model_check(cfg, dev_ref, card, **kw)
    B = kw.get("B", 12)
    e_same = max(r["err_same"] for r in report)
    e_all = max(r["err_all"] for r in report)
    full = get_config(cfg.name)
    log(phase, f"{cfg.name} at full width, {cfg.n_layers} of "
               f"{full.n_layers} layers, {what}: prefill "
               f"+ {len(report) - 1} decode steps of {B} rows (prompts "
               f"6-32 tokens); max |dlogit| {e_same:.4f} on "
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


def phase_model() -> None:
    import dataclasses
    from repro_torch.configs import get_config
    card = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHECK_LAYERS)
    checks = [(cfg, f"{p}, CPU vs card", "cpu", dict(paged=pg, dispatch=disp))
              for p, (pg, disp, _, _) in PATHS.items()]
    # The two dispatch layouts against each other on the card, same
    # weights, same fresh dense caches.
    checks.append((cfg, "dense, padded vs ragged dispatch on the card", card,
                   dict(paged=False, dispatch="padded",
                        dispatch_ref="ragged")))
    # The flagship on its main path: the shared expert, 512 experts top-10,
    # int2 lo with 64 of a 128-slot pool published, 8 rows.
    cfg80 = dataclasses.replace(get_config(FLAGSHIP),
                                n_layers=FLAGSHIP_CHECK_LAYERS)
    checks.append((cfg80, "paged/ragged, CPU vs card", "cpu",
                   dict(paged=True, dispatch="ragged", B=8, lo_bits=2,
                        n_hi=128)))
    for cfg, what, dev_ref, kw in checks:
        check_model("model", cfg, what, dev_ref, card, **kw)
    _model_prefix(dataclasses.replace(get_config(ARCH),
                                      n_layers=CHECK_LAYERS), card)


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
    res = run_prefix_check(cfg, torch.device("cpu"), card)
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
                policy_every_step=True, obs=None):
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
    residents one layer held after a flush."""
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
        else engine.pool.capacity_bytes}
    if graphed and summary["replays"] != summary["steps"]:
        raise AssertionError(f"{name}: {summary['steps']} decode steps but "
                             f"{summary['replays']} graph replays")
    if name == "dynaexq":
        summary["hi_routed"] = engine.backend.hi_routed
        summary["n_hi"] = next(iter(engine.backend.controllers.values())) \
            .policy.n_hi
        summary["slots"] = engine.backend.banks["0"].slot_owner.shape[1]
        summary["global"] = engine.backend.allocator is not None
        engine.flush()
        for tm in tms:
            tm.check_invariants()
    del engine
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


def _flagship_envelope(params, kv_bytes, n_hi) -> float:
    """An ``hbm_gb`` envelope from which ``plan_budget`` leaves the hi tier
    ``n_hi`` int4-priced slots per layer (and half a slot over): the fixed
    bytes as the backend counts them (``envelope_fixed_bytes``, on the KV
    pool of an engine of the same shape) plus the int2 lo tier."""
    from repro_torch.core.ver import expert_hi_nbytes, expert_lo_nbytes
    from repro_torch.serving.backends import GiB, envelope_fixed_bytes
    shapes = {k: tuple(v.shape) for k, v in
              params["blocks"]["0"]["moe"]["experts"].items()}
    L, E = shapes["w_gate"][:2]
    hi_b = expert_hi_nbytes(shapes, hi_bits=4)
    lo = expert_lo_nbytes(shapes, 2) * L * E
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
            hbm_gb = _flagship_envelope(params, graphed[0]["kv_bytes"], n_hi)
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


def _spec_engine(cfg, params, backend, warm, *, paged, dispatch, **ecfg):
    """A fresh engine (8 slots) with ``static`` int4 or ``dynaexq`` (int4
    lo, n_hi 16). ``dynaexq``'s policy runs no window by itself: after 4
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
        kw.update(n_hi_per_layer=16, controller=ControllerConfig(
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
    """(b) the host tier and sensitivity on 8 full-width layers, then (c)
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


PHASES = ("card", "build", "kernels", "splits", "gemms", "model",
          "serving", "requests", "spec", "ladder", "obs", "trace")
#: Phases that run only when named in ``--only``.
EXTRA_PHASES = ("dense",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run, of "
                         f"{PHASES + EXTRA_PHASES}")
    ap.add_argument("--parent", default=None,
                    help="the parent commit's tree (a git archive), for "
                         "the dense phase's A/B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    only = args.only.split(",")
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    took = {}
    for name, run in (("kernels", phase_kernels), ("splits", phase_splits),
                      ("gemms", phase_gemms),
                      ("dense", lambda: phase_dense(args.parent)),
                      ("model", phase_model),
                      ("serving", lambda: phase_serving(card)),
                      ("requests", lambda: phase_requests(card)),
                      ("spec", lambda: phase_spec(card)),
                      ("ladder", lambda: phase_ladder(card)),
                      ("obs", lambda: phase_obs(card)),
                      ("trace", lambda: phase_trace(card))):
        if name in only:
            t = time.perf_counter()
            run()
            took[name] = time.perf_counter() - t
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
