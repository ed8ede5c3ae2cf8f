"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only card,build,kernels

Phases (each prints one line; any failure exits non-zero):

1. card     — name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — each of the six kernels against its plain PyTorch version on
              the card at the paths' shapes (Qwen3-30B-A3B width), with
              times, the bound and the library yardstick;
4. model    — a 2-layer full-width model, same seeded weights on the CPU
              (plain versions) and on the card (kernels): one 32-token
              prefill and 4 teacher-forced decode steps, logits compared,
              for the paged/ragged and the dense/padded path; then padded
              against ragged dispatch on the card;
5. serving  — the 8-layer full-width model served by ``static`` and
              ``dynaexq`` (8 requests, 64–256-token prompts, 32 new tokens)
              on each path: paged KV with ragged dispatch, and dense KV rows
              with padded dispatch.

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
#: The two served paths: (KV layout paged?, MoE dispatch) → the kernels
#: each must launch, and the kernels it must not.
PATHS = {
    "paged/ragged": (True, "ragged",
                     ("ragged_gateup", "ragged_down", "flash_decode_paged"),
                     ("grouped_lo_matmul", "flash_decode")),
    "dense/padded": (False, "padded",
                     ("grouped_lo_matmul", "flash_decode"),
                     ("ragged_gateup", "ragged_down", "flash_decode_paged")),
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

def _ffn_case(name, gen, dev, *, bits, T, lo_w, hi_w, slot_owner, tol_rel):
    """Route T tokens top-8 over 128 experts, build the ragged tile map with
    the port's own dispatch helpers, and hold both FFN kernels against the
    plain versions. Returns a dict of the measurements."""
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
    idx = torch.topk(logits, 8, dim=-1).indices
    _, _, counts, _, _ = _sort_routing(idx, E)
    _, tile_eid, n_tiles = ragged_tile_map(counts, bm, T * 8)
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
    out = {"ok": ok, "tiles": n_live, "hi_tiles": n_hi_tiles,
           "err_gateup": e_h, "tol_gateup": tol_rel * m_h,
           "err_down": e_y, "tol_down": tol_rel * m_y,
           "err_ffn": e_f, "tol_ffn": tol_rel * m_f,
           "ms_gateup": time_ms(gateup_k), "plain_ms_gateup": time_ms(
               gateup_p, iters=3, warmup=1),
           "ms_down": time_ms(down_k), "plain_ms_down": time_ms(
               down_p, iters=3, warmup=1),
           "bound_gateup": bound(gu_bytes, 2 * rows * K * F * 2),
           "bound_down": bound(dn_bytes, 2 * rows * F * D)}
    log("kernels", f"ragged FFN {name}: {n_live}/{Tt} live tiles "
                   f"({n_hi_tiles} hi) | gateup err {e_h:.3g} "
                   f"(tol {tol_rel * m_h:.3g}) {out['ms_gateup']:.4f} ms "
                   f"plain {out['plain_ms_gateup']:.3f} ms bound "
                   f"{out['bound_gateup'][0]:.4f} ms | down err {e_y:.3g} "
                   f"(tol {tol_rel * m_y:.3g}) {out['ms_down']:.4f} ms plain "
                   f"{out['plain_ms_down']:.3f} ms bound "
                   f"{out['bound_down'][0]:.4f} ms | ffn err {e_f:.3g} | "
                   f"{'ok' if ok else 'FAIL'}")
    return out


def _gqmm_case(name, gen, dev, qt, C, tol_rel):
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
    out = {"ok": ok, "err": err, "tol": tol, "ms": time_ms(run_k),
           "plain_ms": time_ms(run_p, iters=3, warmup=1),
           "bound": bound(nbytes, 2 * E * C * K * N)}
    log("kernels", f"grouped_lo_matmul {name} E={E} C={C} K={K} N={N}: err "
                   f"{err:.3g} (tol {tol:.3g}) {out['ms']:.4f} ms plain "
                   f"{out['plain_ms']:.3f} ms bound {out['bound'][0]:.4f} ms "
                   f"({out['bound'][1]}) | {'ok' if ok else 'FAIL'}")
    return out


def _kernels_dense_decode(cfg, gen, dev) -> None:
    """The dense flash decode over the cache's head-major rows, seen as
    (B, S, Hkv, hd) without a copy, against the plain version and SDPA."""
    from repro_torch.kernels import ops, ref
    B, H, Hkv, hd = 8, cfg.attn.n_heads, cfg.attn.n_kv_heads, \
        cfg.attn.head_dim
    S = 288                      # the serving phase's max_len
    ck = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lengths[0] = S                             # one full row
    valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]

    def fd_k():
        return ops.flash_decode(q, k, v, valid)

    def fd_p():
        return ref.flash_decode_ref(q, k, v, valid)

    o_k, o_p = fd_k(), fd_p()
    masked = valid.clone()
    masked[1] = False                          # an all-masked row gives 0
    m_k = ops.flash_decode(q, k, v, masked)
    m_p = ref.flash_decode_ref(q, k, v, masked)
    torch.cuda.synchronize()
    e_fd = max(float((o_k.float() - o_p.float()).abs().max()),
               float((m_k.float() - m_p.float()).abs().max()))
    # Tolerance: float32 online softmax against float32 softmax, output
    # rounded to bf16 — within 2 bf16 ulps of the output magnitude.
    tol_fd = 2.0 ** -7 * float(o_p.float().abs().max())
    ok = bool(torch.isfinite(o_k.float()).all()) and e_fd <= tol_fd and \
        bool((m_k[1] == 0).all())
    kl = ck.repeat_interleave(H // Hkv, dim=1)
    vl = cv.repeat_interleave(H // Hkv, dim=1)
    mask = valid[:, None, None, :]

    def fd_lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=mask)

    n_valid = int(valid.sum().item())
    nbytes = q.numel() * 2 * 2 + n_valid * 2 * Hkv * hd * 2 + valid.numel()
    b = bound(nbytes, 4 * n_valid * H * hd)
    RESULTS["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:31",
        "launches": 0, "max_abs_err": e_fd, "ms": time_ms(fd_k),
        "plain_ms": time_ms(fd_p), "bound_ms": b[0], "bound_by": b[1],
        "library_ms": time_ms(fd_lib)}
    r = RESULTS["flash_decode"]
    log("kernels", f"flash_decode B={B} H={H} Hkv={Hkv} hd={hd} S={S} "
                   f"(strided cache view, one all-masked row): err {e_fd:.3g}"
                   f" (tol {tol_fd:.3g}) {r['ms']:.4f} ms plain "
                   f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms sdpa "
                   f"{r['library_ms']:.4f} ms | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_decode disagrees with its plain version")


def _kernels_quant_matmul(gen, dev, tol_rel) -> None:
    """The plain quantized GEMM at the reference's benchmark shape, bits
    8/4/2, against the plain version (dequantize-then-dot)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.qtensor import quantize
    M, K, N = 128, 2048, 768
    w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(
        torch.bfloat16)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    res = {}
    for bits in (8, 4, 2):
        qt = quantize(w, bits, 64)

        def run_k():
            return ops.quant_matmul_op(x, qt)

        def run_p():
            return ref.quant_matmul_ref(x, qt.packed, qt.scales, bits, 64)

        want, got = run_p(), run_k()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = tol_rel * float(want.float().abs().max())
        nbytes = x.numel() * 2 + qt.packed.numel() + qt.scales.numel() * 2 + \
            M * N * 2
        res[bits] = {"ok": bool(torch.isfinite(got.float()).all())
                     and err <= tol, "err": err, "ms": time_ms(run_k),
                     "plain_ms": time_ms(run_p),
                     "bound": bound(nbytes, 2 * M * K * N)}
        r = res[bits]
        log("kernels", f"quant_matmul int{bits} M={M} K={K} N={N}: err "
                       f"{err:.3g} (tol {tol:.3g}) {r['ms']:.4f} ms plain "
                       f"{r['plain_ms']:.4f} ms bound {r['bound'][0]:.4f} ms "
                       f"({r['bound'][1]}) | {'ok' if r['ok'] else 'FAIL'}")
    if not all(r["ok"] for r in res.values()):
        raise AssertionError("quant_matmul disagrees with its plain version")
    r = res[4]
    RESULTS["quant_matmul"] = {
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:79",
        "launches": 0, "max_abs_err": max(v["err"] for v in res.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1], "library_ms": None}
    log("kernels", "quant_matmul yardstick: none, no single library call "
                   "computes a dequantize-then-multiply")


def phase_kernels() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
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
            f"int{bits} gate/up decode", gen, dev, lo["w_gate"], 8, tol)
        if bits == 4:
            gq["int4 down C=8"] = _gqmm_case("int4 down decode", gen, dev,
                                             lo["w_down"], 8, tol)
            gq["int4 gate C=136"] = _gqmm_case("int4 gate/up prefill", gen,
                                               dev, lo["w_gate"], 136, tol)
        if bits == 4:
            cases["decode"] = _ffn_case("int4 decode B=8 mixed", gen, dev,
                                        bits=4, T=8, lo_w=lo, hi_w=hi_w,
                                        slot_owner=owner, tol_rel=tol)
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
            "max_abs_err": max(c[f"err_{key}"] for c in cases.values()),
            "ms": d[f"ms_{key}"], "plain_ms": d[f"plain_ms_{key}"],
            "bound_ms": d[f"bound_{key}"][0],
            "bound_by": d[f"bound_{key}"][1], "library_ms": None}
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
        "bound_by": d["bound"][1], "library_ms": None}
    log("kernels", "grouped_lo_matmul yardstick: none, no single library "
                   "call computes a grouped quantized GEMM")
    _kernels_dense_decode(cfg, gen, dev)
    _kernels_quant_matmul(gen, dev, tol)

    # -- flash_decode_paged ------------------------------------------------
    B, H, Hkv, hd, bt, nb = 8, cfg.attn.n_heads, cfg.attn.n_kv_heads, \
        cfg.attn.head_dim, 16, 32
    N = 1 + B * nb
    k = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((N, Hkv, bt, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    perm = (1 + torch.randperm(N - 1, generator=gen, device=dev)).to(
        torch.int32)
    table = perm[:B * nb].reshape(B, nb).clone()
    lengths = torch.randint(1, nb * bt + 1, (B,), generator=gen,
                            device=dev)
    lengths[0] = nb * bt                       # one full row
    used = (lengths + bt - 1) // bt
    blk_idx = torch.arange(nb, device=dev)[None, :]
    table = torch.where(blk_idx < used[:, None], table,
                        torch.full_like(table, -1))
    valid = torch.arange(nb * bt, device=dev)[None, :] < lengths[:, None]

    def fd_k():
        return ops.flash_decode_paged(q, k, v, table, valid)

    def fd_p():
        return ref.flash_decode_paged_ref(q, k, v, table, valid)

    o_k, o_p = fd_k(), fd_p()
    torch.cuda.synchronize()
    e_fd = float((o_k.float() - o_p.float()).abs().max())
    # Tolerance: float32 online softmax against float32 softmax, output
    # rounded to bf16 — within 2 bf16 ulps of the output magnitude.
    tol_fd = 2.0 ** -7 * float(o_p.float().abs().max())
    ok_fd = bool(torch.isfinite(o_k.float()).all()) and e_fd <= tol_fd
    # Yardstick: SDPA over the gathered view (timed here only).
    from repro_torch.models.layers import PagedKVCache, paged_view
    kl, vl = paged_view(PagedKVCache(k, v), table)
    kl = kl.repeat_interleave(H // Hkv, dim=1)
    vl = vl.repeat_interleave(H // Hkv, dim=1)
    mask = valid[:, None, None, :]

    def fd_lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=mask)

    n_blocks = int((table >= 0).sum().item())
    n_valid = int(valid.sum().item())
    fd_bytes = q.numel() * 2 * 2 + n_blocks * 2 * Hkv * bt * hd * 2 + \
        table.numel() * 4 + valid.numel()
    fd_ops = 4 * n_valid * H * hd
    b_fd = bound(fd_bytes, fd_ops)
    RESULTS["flash_decode_paged"] = {
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        "replaces": "src/repro/kernels/flash_decode.py:92",
        "launches": 0, "max_abs_err": e_fd, "ms": time_ms(fd_k),
        "plain_ms": time_ms(fd_p), "bound_ms": b_fd[0],
        "bound_by": b_fd[1], "library_ms": time_ms(fd_lib)}
    r = RESULTS["flash_decode_paged"]
    log("kernels", f"flash_decode_paged B={B} H={H} Hkv={Hkv} hd={hd} "
                   f"bt={bt} nb={nb}: err {e_fd:.3g} (tol {tol_fd:.3g}) "
                   f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
                   f"{r['bound_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms | "
                   f"{'ok' if ok_fd else 'FAIL'}")
    if not ok_fd:
        raise AssertionError("flash_decode_paged disagrees with its plain "
                             "version")


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
                    seed=7, paged=True, dispatch="ragged", dispatch_ref=None):
    """Same seeded weights on ``dev_ref`` and ``dev``: one S-token prefill
    and ``steps`` teacher-forced decode steps, on the paged pool or dense
    rows, with MoE dispatch ``dispatch`` (``dispatch_ref`` on ``dev_ref``,
    default the same). Returns per forward (max |Δlogit| on identically
    routed rows and on all rows, mean |Δlogit|, max |logit|, rows routed
    identically)."""
    from repro_torch.models.model import (decode_step, decode_step_paged,
                                          init_caches, init_paged_caches,
                                          init_params, prefill,
                                          prefill_paged)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, device="cpu", generator=gen)
    experts = params["blocks"]["0"]["moe"].pop("experts")
    bank = _bank_with_hi(experts, 16 if cfg.moe.num_experts >= 64 else 2,
                         gen)
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
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHECK_LAYERS)
    card = torch.device("cuda")
    checks = [(f"{p}, CPU vs card", "cpu", dict(paged=pg, dispatch=disp))
              for p, (pg, disp, _, _) in PATHS.items()]
    # The two dispatch layouts against each other on the card, same
    # weights, same fresh dense caches.
    checks.append(("dense, padded vs ragged dispatch on the card", card,
                   dict(paged=False, dispatch="padded",
                        dispatch_ref="ragged")))
    for what, dev_ref, kw in checks:
        t0 = time.perf_counter()
        report = run_model_check(cfg, dev_ref, card, **kw)
        e_same = max(r["err_same"] for r in report)
        e_all = max(r["err_all"] for r in report)
        log("model", f"{cfg.name} at full width, {CHECK_LAYERS} of "
                     f"{get_config(ARCH).n_layers} layers, {what}: prefill "
                     f"+ {len(report) - 1} decode steps of 12 rows (prompts "
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
                same < 12 * len(report) // 2:
            raise AssertionError(f"logits disagree: {what}")


# ---------------------------------------------------------------------------
# 5. serving
# ---------------------------------------------------------------------------

def run_serving(cfg, device, *, n_requests, prompt_range, new_tokens,
                max_slots, n_hi, seed=0, paged=True, dispatch="ragged"):
    """Serve ``n_requests`` greedy requests with ``static`` then
    ``dynaexq`` on one seeded model, on the paged pool or dense rows with
    MoE dispatch ``dispatch``. Returns {backend: summary}."""
    from repro_torch.models.model import init_params
    import repro_torch.serving.engine as eng_mod
    from repro_torch.serving.requests import make_prompts

    params = init_params(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    prompts = [make_prompts("text", cfg.vocab_size, 1, int(n),
                            seed=seed + i)[0] for i, n in enumerate(lens)]
    max_len = -(-(int(prompt_range[1]) + new_tokens) // 16) * 16
    finite = []

    def watch(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            finite.append(torch.isfinite(out[0]).all())
            return out
        return wrapped

    # The entry points of the path being served, watched for this run only.
    watched = ("prefill_paged", "decode_step_paged") if paged else \
        ("prefill", "decode_step")
    saved = {n: getattr(eng_mod, n) for n in watched}
    for n, fn in saved.items():
        setattr(eng_mod, n, watch(fn))
    try:
        return _serve_backends(cfg, device, params, prompts, finite,
                               n_requests=n_requests, new_tokens=new_tokens,
                               max_slots=max_slots, max_len=max_len,
                               n_hi=n_hi, paged=paged, dispatch=dispatch)
    finally:
        for n, fn in saved.items():
            setattr(eng_mod, n, fn)


def _serve_backends(cfg, device, params, prompts, finite, *, n_requests,
                    new_tokens, max_slots, max_len, n_hi, paged, dispatch):
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.serving.requests import Request
    out = {}
    for name in ("static", "dynaexq"):
        kw = dict(lo_bits=4, group_size=64, device=device)
        if name == "dynaexq":
            kw.update(n_hi_per_layer=n_hi,
                      controller=ControllerConfig(update_interval_s=0.0))
        engine = InferenceEngine(
            cfg, _fresh(params), make_backend(name, **kw),
            EngineConfig(max_slots=max_slots, max_len=max_len, paged=paged,
                         moe_dispatch=dispatch),
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        finite.clear()
        ops.reset_launches()                 # the main path starts here
        t0 = time.perf_counter()
        handles = [engine.submit(Request(tokens=p, max_new_tokens=new_tokens))
                   for p in prompts]
        engine.drain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)        # ... and ends here
        st = engine.stats()
        assert all(len(h.tokens) == new_tokens for h in handles), \
            [len(h.tokens) for h in handles]
        assert bool(torch.stack(finite).all()), f"{name}: NaN logits"
        summary = {
            "launches": launches, "wall_s": wall,
            "tokens_per_s": n_requests * new_tokens / wall,
            "ttft_s": st["ttft_s"], "tpot_s": st["tpot_s"],
            "expert_bytes": engine.device_bytes(),
            "max_mem": torch.cuda.max_memory_allocated()
            if device.type == "cuda" else 0,
            "promotions": st["promotions"], "demotions": st["demotions"]}
        if name == "dynaexq":
            summary["hi_routed"] = engine.backend.hi_routed
            engine.flush()
            for ctl in engine.backend.controllers.values():
                ctl.tm.check_invariants()
        out[name] = summary
        del engine
    return out


def phase_serving(card: str) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    host_gb = SERVE_LAYERS * cfg.moe.num_experts * 3 * cfg.d_model * \
        cfg.moe.d_ff_expert * 2 / 1e9
    log("serving", f"{cfg.name}: full width, depth cut to {SERVE_LAYERS} of "
                   f"{full.n_layers} layers (bf16 host masters {host_gb:.1f} "
                   f"GB instead of {host_gb * full.n_layers / SERVE_LAYERS:.0f}"
                   f" GB); random weights, seed 0")
    runs = []
    for path, (paged, dispatch, used, unused) in PATHS.items():
        res = run_serving(cfg, torch.device("cuda"), n_requests=8,
                          prompt_range=(64, 256), new_tokens=32, max_slots=8,
                          n_hi=16, paged=paged, dispatch=dispatch)
        for name, s in res.items():
            log("serving", f"{path} {name}: 8 requests x 32 tokens | TTFT "
                           f"{s['ttft_s'] * 1e3:.1f} ms TPOT "
                           f"{s['tpot_s'] * 1e3:.2f} ms "
                           f"{s['tokens_per_s']:.1f} tok/s | expert bytes "
                           f"{s['expert_bytes'] / 1e9:.3f} GB | max "
                           f"allocated {s['max_mem'] / 1e9:.2f} GB | "
                           f"promotions {s['promotions']:.0f} demotions "
                           f"{s['demotions']:.0f} | launches "
                           f"{s['launches']} | {card}")
            if not all(s["launches"][k] > 0 for k in used):
                raise AssertionError(f"{path} {name}: a kernel of the path "
                                     f"never ran")
            if any(s["launches"][k] for k in unused):
                raise AssertionError(f"{path} {name}: a kernel of the other "
                                     f"path ran")
        dyn = res["dynaexq"]
        if dyn["promotions"] < 1 or dyn["hi_routed"] < 1:
            raise AssertionError(f"{path}: dynaexq published no promotion "
                                 f"that a forward then served from hi")
        log("serving", f"{path} dynaexq: {dyn['promotions']:.0f} promotions "
                       f"published, {dyn['hi_routed']} routed (layer, "
                       f"expert) cells served from hi slots; invariants hold "
                       f"after flush")
        runs.extend(res.values())
    for k in RESULTS:
        RESULTS[k]["launches"] = sum(s["launches"][k] for s in runs)


PHASES = ("card", "build", "kernels", "model", "serving")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
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
    if "model" in only:
        phase_model()
    if "serving" in only:
        phase_serving(card)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [RESULTS[k] for k in sorted(RESULTS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
