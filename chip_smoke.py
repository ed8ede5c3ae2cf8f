"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only card,build,kernels
    python3 chip_smoke.py --only card,build,kernels,serving

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
              yardstick);
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
              against this tree's in turns, and their registers and HMMA
              counts (``cuobjdump``);
4. model    — a 2-layer full-width model, same seeded weights on the CPU
              (plain versions) and on the card (kernels): one 32-token
              prefill and 4 teacher-forced decode steps, logits compared,
              for the paged/ragged and the dense/padded path; then padded
              against ragged dispatch on the card; then 1 full-width layer
              of the flagship (its shared expert, int2 lo) on paged/ragged;
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


def _kernels_dense_ffn(dev, tol) -> None:
    """The all-hi mode at the baselines' shapes (``DENSE_CASES``):
    Qwen3-30B-A3B (top-8 of 128, K = 2048, F = 768) at decode B = 8,
    prefill 512 and a skewed prefill 512, and the flagship (top-10 of 512,
    F = 512) at decode B = 8 and prefill 512."""
    cases = {key: _dense_ffn_case(name, bank, inp, tol_rel=tol)
             for key, name, bank, inp in _dense_cases(dev)}
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"ragged dense FFN kernels disagree: {bad}")
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
            "cases": [dict(case=c["case"], tiles=c["tiles"],
                           experts=c["experts"], runs=c["runs"],
                           **{k: v for k, v in c[key].items()
                              if k != "graph_runs"})
                      for c in cases.values()]}


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
    """The parent tree's ragged FFN library (``csrc/ragged_ffn.cu`` of a
    ``git archive`` of the parent commit), built with this tree's flags
    into ``build/kernels/parent/`` and loaded with its C signatures: the
    quantized entries as today's, the all-hi ones as the parent had them
    (``ragged_dense_gateup(xs, tile_eid, n_tiles, w_gate, w_up, h, Tt, K,
    F, stream)``)."""
    import ctypes
    from repro_torch.kernels import build
    src = parent / "src/repro_torch/kernels/csrc/ragged_ffn.cu"
    out = build.build_dir() / "parent" / "libragged_ffn.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = dict(build.SIGNATURES["ragged_ffn"],
                ragged_dense_gateup=[P] * 6 + [I] * 3 + [P],
                ragged_dense_down=[P] * 5 + [I] * 3 + [P])
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, out


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
    plib = None
    if parent is not None:
        plib, ppath = _parent_library(pathlib.Path(parent))
        from repro_torch.kernels import build
        mine = build._target("ragged_ffn")
        sp, sm = _sass_summary(ppath), _sass_summary(mine)
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
                     len(ws), w, st, ws[0].shape[0]) <= ops.SMEM_MAX]
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
            if plib is None:
                continue
            out_p = torch.empty_like(want)
            ptrs = [x.data_ptr(), te.data_ptr(), n.data_ptr(),
                    *[w.data_ptr() for w in ws], out_p.data_ptr(), Tt,
                    x.shape[1], N]
            prun = lambda: getattr(plib, kname)(*ptrs, stream())
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
                    lo_bits=4, n_hi=None, bank_device="cpu"):
    """Same seeded weights on ``dev_ref`` and ``dev``: one S-token prefill
    and ``steps`` teacher-forced decode steps, on the paged pool or dense
    rows, with MoE dispatch ``dispatch`` (``dispatch_ref`` on ``dev_ref``,
    default the same). One bank for both, int ``lo_bits`` with ``n_hi``
    hi slots per layer, half of them published, quantized on
    ``bank_device``. Returns per forward (max |Δlogit| on identically
    routed rows and on all rows, mean |Δlogit|, max |logit|, rows routed
    identically)."""
    from repro_torch.models.model import (decode_step, decode_step_paged,
                                          init_caches, init_paged_caches,
                                          init_params, prefill,
                                          prefill_paged)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, device="cpu", generator=gen)
    experts = params["blocks"]["0"]["moe"].pop("experts")
    if n_hi is None:
        n_hi = 16 if cfg.moe.num_experts >= 64 else 2
    bank = _bank_with_hi({k: v.to(bank_device) for k, v in experts.items()},
                         n_hi, gen, lo_bits=lo_bits)
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
    # int2 lo with 64 of a 128-slot pool published (its bank quantized on
    # the card: the CPU would take minutes), 8 rows.
    cfg80 = dataclasses.replace(get_config(FLAGSHIP),
                                n_layers=FLAGSHIP_CHECK_LAYERS)
    checks.append((cfg80, "paged/ragged, CPU vs card", "cpu",
                   dict(paged=True, dispatch="ragged", B=8, lo_bits=2,
                        n_hi=128, bank_device=card)))
    for cfg, what, dev_ref, kw in checks:
        t0 = time.perf_counter()
        report = run_model_check(cfg, dev_ref, card, **kw)
        B = kw.get("B", 12)
        e_same = max(r["err_same"] for r in report)
        e_all = max(r["err_all"] for r in report)
        full = get_config(cfg.name)
        log("model", f"{cfg.name} at full width, {cfg.n_layers} of "
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
    from repro_torch.serving.requests import make_prompts

    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    prompts = [make_prompts("text", cfg.vocab_size, 1, int(n),
                            seed=seed + i)[0] for i, n in enumerate(lens)]
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


def _serve_once(cfg, device, params, prompts, name, mode, *, new_tokens,
                max_slots, max_len, backend_kw, paged, dispatch,
                policy_every_step=True):
    """One served run on a fresh engine with ``make_backend(name,
    **backend_kw)`` (``dynaexq``: a policy window every step, unless
    ``policy_every_step`` is False: then the controller's default), ``mode``
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
        device=device)
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
          "serving", "trace")
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
    if "kernels" in only:
        phase_kernels()
    if "splits" in only:
        phase_splits()
    if "gemms" in only:
        phase_gemms()
    if "dense" in only:
        phase_dense(args.parent)
    if "model" in only:
        phase_model()
    if "serving" in only:
        phase_serving(card)
    if "trace" in only:
        phase_trace(card)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [RESULTS[k] for k in sorted(RESULTS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
