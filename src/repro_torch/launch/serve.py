"""Serving launcher of the port: the reference's ``launch/serve.py`` on one
NVIDIA card (or, with ``--device cpu``, on the CPU's plain versions).

    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
        --backend dynaexq --batch 4 --prompt-len 32 --new-tokens 16 [--full]

It builds seeded random weights (or streams them from an expert-sharded
checkpoint, ``--stream-from``), serves ``--batch`` requests through
``InferenceEngine`` until they finish, and prints the reference's summary
lines: TTFT, TPOT and throughput; the dispatch's active experts and pad
ratio; the speculative decoder's acceptance; the resident expert bytes;
and, unless ``--no-obs``, the observability line (trace events, promotions
published and cancelled, publish latency p95, the bytes/token residual
against the roofline model, the requests' modeled stall exposure).
``--trace-out`` writes the flight recorder's Chrome trace and
``--metrics-jsonl`` one metrics row per engine step. ``main(argv)``
returns what it printed and measured, so a test or a harness can call it
in the same process.

Not ported: expert parallelism (``--ep-shards`` > 1 exits naming ROADMAP
Queue 1, item 7).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.controller import ControllerConfig
from repro_torch.models.model import init_params
from repro_torch.serving.backends import BACKENDS, OffloadConfig, make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request, make_prompts
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.streaming import (load_streaming_params,
                                           save_expert_shards)

EP_NOT_PORTED = ("expert parallelism (--ep-shards > 1) is not ported yet: "
                 "ROADMAP.md Queue 1, item 7")


def build_backend(args, device):
    """CLI name → residency backend (the engine itself is
    backend-agnostic)."""
    if args.backend == "dynaexq":
        return make_backend(
            "dynaexq", lo_bits=args.lo_bits,
            n_hi_per_layer=None if args.hbm_gb else args.n_hi,
            hbm_gb=args.hbm_gb,
            controller=ControllerConfig(update_interval_s=0.25),
            global_alloc=False if args.per_layer_alloc else None,
            sensitivity=args.sensitivity,
            lo_resident_total=args.lo_resident_total,
            hotness_path=args.hotness_path,
            stream=args.stream_from,
            fault=_fault_plan(args), device=device)
    if args.backend == "static":
        return make_backend("static", lo_bits=args.lo_bits, device=device)
    if args.backend == "offload":
        return make_backend("offload", ocfg=OffloadConfig(
            cache_experts_per_layer=args.n_hi * 2), device=device)
    return make_backend(args.backend, device=device)


def _fault_plan(args):
    """``--fault-plan`` (JSON string or path) → FaultPlan, ``--fault-seed``
    overriding the plan's seed when given."""
    if not args.fault_plan:
        return None
    from repro_torch.fault import FaultPlan
    return FaultPlan.parse(args.fault_plan, seed=args.fault_seed)


def parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m", choices=ARCH_IDS)
    ap.add_argument("--backend", "--mode", dest="backend", default="dynaexq",
                    choices=sorted(BACKENDS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (cpu: the plain PyTorch "
                         "versions of the kernels)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--lo-bits", type=int, default=4, choices=[2, 4, 8])
    ap.add_argument("--n-hi", type=int, default=2)
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="derive n_hi from a device envelope instead")
    ap.add_argument("--full", action="store_true",
                    help="the full configuration (else the 2-layer reduced "
                         "one)")
    ap.add_argument("--workload", default="text")
    ap.add_argument("--dense-kv", action="store_true",
                    help="dense per-slot KV rows instead of the paged pool")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="KV positions per paged block")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable trie-based cross-request prefix reuse")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="unified envelope shared by KV blocks and the "
                         "expert hi tier (promotion backpressure under KV "
                         "pressure)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["padded", "ragged"],
                    help="MoE token layout: padded (E,C,d) vs ragged "
                         "compacted dispatch + the fused mixed-precision "
                         "kernels (default: ragged)")
    ap.add_argument("--row-capacity", action="store_true",
                    help="normalize MoE capacity drops per request row "
                         "(batch-shape-independent token drops)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max speculative draft depth per round (drafts on "
                         "the all-lo expert tier, verifies against the "
                         "mixed-precision banks)")
    ap.add_argument("--no-spec", action="store_true",
                    help="disable speculative decoding (one token per step)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="sample only from the k most probable tokens")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = full vocab)")
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed base (request b uses "
                         "seed+b)")
    ap.add_argument("--qos-default", default="standard",
                    choices=["batch", "standard", "premium"],
                    help="QoS class for requests that carry none (batch "
                         "decodes on the all-lo banks, premium keeps the "
                         "hi tier + speculative bursts)")
    ap.add_argument("--shed-policy", default="none",
                    choices=["none", "downgrade", "reject"],
                    help="overload response: downgrade batch/standard "
                         "execution to the lo tier, or also reject "
                         "batch-tier submissions outright")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="split prompts longer than this many tokens into "
                         "chunked prefills interleaved with decode "
                         "(0 = single-shot; rounded down to a "
                         "block-aligned prefill bucket)")
    ap.add_argument("--per-layer-alloc", action="store_true",
                    help="use the paper's per-layer top-n policy instead "
                         "of the default global cross-layer knapsack "
                         "allocator (dynaexq)")
    ap.add_argument("--sensitivity", default=None,
                    help=".npz of per-expert quantization sensitivity "
                         "(quant.sensitivity.save_sensitivity): weights "
                         "the global allocator's hotness ranking")
    ap.add_argument("--lo-resident-total", type=int, default=None,
                    help="enable the host-DRAM third tier: only this many "
                         "(layer, expert) cells stay device-lo-resident; "
                         "the rest pay a modeled demand-fetch stall when "
                         "routed")
    ap.add_argument("--hotness-path", default=None,
                    help="prefix for hotness snapshots: restored at "
                         "startup (warm allocator prior + hottest-first "
                         "streaming) and saved after the run")
    ap.add_argument("--stream-from", default=None,
                    help="expert-sharded checkpoint dir (save_expert_"
                         "shards): stream the lo tier in at startup and "
                         "serve before the model fully materializes")
    ap.add_argument("--save-shards", default=None,
                    help="write the expert-sharded serving checkpoint to "
                         "this dir and exit (streaming cold-start source)")
    ap.add_argument("--trace-out", default=None,
                    help="write the flight-recorder trace here as Chrome "
                         "trace-event JSON (open in Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write per-step metric samples to this JSONL file")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability layer entirely (no "
                         "tracer, no metrics, no shutdown summary)")
    ap.add_argument("--fault-plan", default=None,
                    help="fault-injection plan for chaos runs: a JSON "
                         "string or a path to one, e.g. "
                         '\'{"seed": 7, "rules": [{"site": "host_lo", '
                         '"prob": 0.1}]}\' (dynaexq backend only)')
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="override the fault plan's seed")
    ap.add_argument("--promo-deadline-s", type=float, default=None,
                    help="watchdog: cancel promotions still unpublished "
                         "after this many seconds (refund + keep serving "
                         "lo)")
    ap.add_argument("--ep-shards", type=int, default=1,
                    help="expert-parallel serving over this many devices "
                         "(not ported: only 1)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (sys.argv when None), serve, print the summary lines.
    Returns {"lines": the printed lines, "stats": engine.stats(),
    "tokens": per request, "wall_s", "device_bytes", "obs": the
    observability summary or None}; ``{"lines", "shards"}`` after
    ``--save-shards``."""
    args = parser().parse_args(argv)
    if args.ep_shards > 1:
        raise SystemExit(f"--ep-shards {args.ep_shards}: {EP_NOT_PORTED}")
    device = resolve_device(args.device)
    lines: List[str] = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    cfg = get_config(args.arch, reduced=not args.full)
    spec_k = 0 if args.no_spec else max(0, args.spec_k)
    say(f"[serve] {cfg.name} backend={args.backend} device={device} "
        f"spec_k={spec_k} ep_shards={args.ep_shards}")
    if args.stream_from:
        # Streaming cold start: only the base (non-expert) params load
        # synchronously; the lo tier backfills behind the engine.
        params = load_streaming_params(args.stream_from, device=device)
    else:
        params = init_params(cfg, seed=0, device=device)
    if args.save_shards:
        positions = [p for p, _ in enumerate(cfg.superblock_or_default())
                     if cfg.ffn_kind(p) == "moe"]
        save_expert_shards(args.save_shards, params, positions,
                           lo_bits=args.lo_bits)
        say(f"[serve] expert-sharded checkpoint -> {args.save_shards}")
        return {"lines": lines, "shards": args.save_shards}
    obs = None
    if not args.no_obs:
        from repro_torch.obs import ObsConfig, Observability
        obs = Observability(ObsConfig(metrics_jsonl=args.metrics_jsonl))
    try:
        return _serve(args, cfg, params, device, spec_k, obs, say, lines)
    finally:
        if obs is not None:
            obs.close()


def _serve(args, cfg, params, device, spec_k, obs, say, lines) -> Dict:
    engine = InferenceEngine(
        cfg, params, build_backend(args, device),
        EngineConfig(max_slots=args.batch,
                     max_len=args.prompt_len + args.new_tokens + 8,
                     paged=not args.dense_kv,
                     block_tokens=args.block_tokens,
                     prefix_sharing=not args.no_prefix_sharing,
                     hbm_budget_bytes=None if args.hbm_budget_gb is None
                     else int(args.hbm_budget_gb * (1 << 30)),
                     spec_k=spec_k,
                     moe_dispatch=args.moe_dispatch,
                     row_capacity_norm=args.row_capacity,
                     promo_deadline_s=args.promo_deadline_s,
                     scheduler=SchedulerConfig(
                         qos_default=args.qos_default,
                         shed_policy=args.shed_policy,
                         prefill_chunk=args.prefill_chunk)),
        device=device, obs=obs)
    toks = make_prompts(args.workload, cfg.vocab_size, args.batch,
                        args.prompt_len)
    use_sampling = (args.temperature > 0 or args.top_k is not None or
                    args.top_p < 1.0)
    t0 = time.perf_counter()
    handles = [engine.submit(Request(
        tokens=toks[b], max_new_tokens=args.new_tokens,
        sampling=SamplingParams(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                seed=args.seed + b)
        if use_sampling else None))
        for b in range(args.batch)]
    engine.drain()
    engine.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    tput = sum(len(h.tokens) for h in handles) / wall
    st = engine.stats()
    say(f"[serve] TTFT {st['ttft_s']*1e3:.1f} ms  TPOT "
        f"{st['tpot_s']*1e3:.1f} ms  throughput {tput:.2f} tok/s")
    say(f"[serve] moe dispatch={engine.moe_dispatch}: "
        f"active_experts {st.get('active_experts', 0.0):.1f}"
        f"/{cfg.moe.num_experts}  "
        f"pad_ratio {st.get('dispatch_pad_ratio', 0.0):.2f}")
    if spec_k:
        row_rounds = max(1.0, st.get("spec_row_rounds", 0.0))
        say(f"[serve] spec: accept_rate {st['accept_rate']:.2f}  "
            f"tokens/row-round {st['verified_tokens']/row_rounds:.2f} "
            f"(1.0 = no speculation; {st['draft_tokens']:.0f} drafted "
            f"over {st['spec_rounds']:.0f} rounds)")
    say(f"[serve] resident expert bytes: {engine.device_bytes():,}")
    summ = None
    if obs is None:
        # No obs layer: the raw uniform stats instead.
        say(f"[serve] uniform stats: "
            f"{ {k: round(float(v), 4) for k, v in st.items()} }")
    else:
        summ = obs.summary()
        roof, prom = summ["roofline"], summ["promotions"]
        resid = max((abs(b["rel_residual"]) for b in roof["buckets"]),
                    default=0.0)
        stall = sum(h.stall_exposure_s for h in handles)
        say(f"[serve] obs: {summ['trace_events']} events "
            f"({summ['trace_dropped']} dropped)  "
            f"promotions {prom['n_published']} published / "
            f"{prom['n_cancelled']} cancelled "
            f"publish p95 {prom['publish_latency_p95_s']*1e3:.1f} ms  "
            f"bytes/token residual max {resid:.3f} "
            f"over {roof['n_steps']} decode steps  "
            f"stall exposure {stall*1e3:.1f} ms  "
            f"shed {st.get('shed_requests', 0.0):.0f}")
        if args.trace_out:
            obs.save_trace(args.trace_out)
            say(f"[serve] trace -> {args.trace_out}")
    if args.hotness_path and hasattr(engine.backend, "save_hotness"):
        engine.backend.save_hotness()
        say(f"[serve] hotness snapshot -> {args.hotness_path}_p*.npz")
    return {"lines": lines, "stats": st,
            "tokens": [list(h.tokens) for h in handles], "wall_s": wall,
            "device_bytes": engine.device_bytes(), "obs": summ}


if __name__ == "__main__":
    main()
