"""Analytic roofline terms of the port on one NVIDIA H100.

The part of the reference's ``launch/roofline.py`` that reads no compiled
XLA artifact: the model's FLOPs per token, the expected active experts of
a uniform router, and the expert-weight bytes per token one MoE forward
must stream (``predict_moe_bytes_per_token``), the prediction the trace
cost model (``obs.costmodel``) holds the measured traffic to. The card's
peaks are the H100 SXM's data-sheet figures (dense bf16 on the tensor
cores, HBM3), not measurements. The reference's HLO parsers
(``convert_bytes``, ``collective_bytes``, ``analyze``) read XLA's compiled
artifacts and wait for the dry run (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12         # bf16 dense, H100 SXM (data sheet)
HBM_BW = 3.35e12            # bytes/s, H100 SXM HBM3 (data sheet)


def model_flops(cfg, kind: str, tokens: int) -> float:
    """6·N·D for training, 2·N_active·D for an inference forward."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def expected_active_experts(tokens: float, num_experts: int,
                            top_k: int) -> float:
    """Coupon-collector expectation: distinct experts activated by
    ``tokens`` independent top-k draws under a uniform router —
    ``E · (1 − (1 − k/E)^T)``. Real (skewed, temporally correlated) routing
    activates fewer; the gap is what the trace-driven cost model
    (``obs.costmodel``) measures as a residual."""
    if tokens <= 0:
        return 0.0
    E = float(num_experts)
    return E * (1.0 - (1.0 - top_k / E) ** tokens)


def predict_moe_bytes_per_token(tokens: float, layers: int, num_experts: int,
                                top_k: int, lo_bytes: int, hi_bytes: int,
                                published_hi: int = 0,
                                dispatch: str = "ragged") -> float:
    """Analytic expert-weight HBM traffic of ONE MoE forward, per routed
    token — the prediction the flight-recorder replay validates.

    ``layers`` is the number of MoE layer-steps in the forward (all
    positions × superblocks); ``published_hi`` the total published hi cells
    across those layers. ``padded`` streams every layer's full lo tier plus
    every published hi slot regardless of routing; ``ragged`` streams only
    the expected active experts at their resident tier (hi cells assumed
    uniformly spread, i.e. hit proportionally to their population)."""
    if tokens <= 0 or layers <= 0:
        return 0.0
    if dispatch == "padded":
        total = layers * num_experts * lo_bytes + published_hi * hi_bytes
        return total / tokens
    act = expected_active_experts(tokens, num_experts, top_k)
    hi_frac = published_hi / float(layers * num_experts)
    act_hi = act * hi_frac
    act_lo = act - act_hi
    return layers * (act_lo * lo_bytes + act_hi * hi_bytes) / tokens
