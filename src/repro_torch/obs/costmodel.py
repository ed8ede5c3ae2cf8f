"""Trace replayer: measured expert-weight traffic vs the roofline model.

``launch/roofline.py`` carries an analytic bytes/token model
(``predict_moe_bytes_per_token``); this module (the port's copy of the
reference's) validates it: it folds a flight-recorder trace's per-forward
``moe_forward`` events into **measured** bytes/token — the actual
routed-expert tier mix each step streamed — and compares against the
analytic prediction per (batch, residency-mix) bucket, reporting relative
residuals.

Measured traffic per forward (the byte decomposition of the kernels
benchmark's bytes per token):

* ``ragged``  — only active cells stream, at their resident tier:
  ``active_hi·hi_b + active_lo·lo_b``;
* ``padded``  — every layer streams its full lo tier plus every published
  hi slot: ``layers·E·lo_b + published_hi·hi_b``.

The prediction uses the same prices but *expected* activity (uniform-router
coupon collector), so the residual is routing skew + temporal correlation —
the quantity that decides ragged-vs-padded dispatch at a given batch.

Inputs are either a live ``FlightRecorder`` or a saved Chrome trace JSON;
byte prices and dispatch mode ride in the trace metadata
(``FlightRecorder.meta`` → ``otherData``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.launch.roofline import predict_moe_bytes_per_token
from repro_torch.obs.trace import FlightRecorder, load_chrome_trace

#: Metadata keys the replayer needs (written by the engine at attach time).
META_KEYS = ("moe_dispatch", "num_experts", "top_k", "lo_bytes", "hi_bytes")


def _extract(trace) -> Tuple[Dict, List[Dict]]:
    """Normalize a FlightRecorder / chrome-JSON dict / path into
    ``(meta, moe_forward arg dicts in order)``."""
    if isinstance(trace, FlightRecorder):
        meta = dict(trace.meta)
        evs = [dict(e.args or {}) for e in trace.instants("moe_forward")]
        return meta, evs
    obj = load_chrome_trace(trace) if isinstance(trace, str) else trace
    meta = dict(obj.get("otherData", {}))
    evs = [dict(e.get("args", {})) for e in obj.get("traceEvents", [])
           if e.get("name") == "moe_forward" and e.get("ph") == "i"]
    return meta, evs


def measured_bytes_per_token(ev: Dict, meta: Dict) -> Tuple[float, float]:
    """One forward's (tokens, measured expert bytes) under the configured
    dispatch. ``tokens`` derives from the routed assignment count (robust
    to speculative verify folding several steps into one event)."""
    lo_b, hi_b = meta["lo_bytes"], meta["hi_bytes"]
    layers = max(1, int(ev.get("layers", 1)))
    top_k = max(1, int(meta.get("top_k", 1)))
    tokens = ev.get("routed", 0) / (layers * top_k)
    if meta.get("moe_dispatch") == "padded":
        nbytes = (layers * meta["num_experts"] * lo_b +
                  ev.get("published_hi", 0) * hi_b)
    else:
        nbytes = ev.get("active_lo", 0) * lo_b + ev.get("active_hi", 0) * hi_b
    return tokens, float(nbytes)


def fold_steps(trace, decode_only: bool = True) -> List[Dict]:
    """Per-forward samples: tokens, measured/predicted bytes-per-token and
    the residency mix, one dict per ``moe_forward`` event (prefills skipped
    by default — the roofline question is decode traffic)."""
    meta, evs = _extract(trace)
    missing = [k for k in META_KEYS if k not in meta]
    if missing:
        raise ValueError(f"trace metadata missing {missing}; was the "
                         f"recorder attached to an engine?")
    out: List[Dict] = []
    for ev in evs:
        if decode_only and ev.get("prefill"):
            continue
        tokens, nbytes = measured_bytes_per_token(ev, meta)
        if tokens <= 0:
            continue
        layers = max(1, int(ev.get("layers", 1)))
        pred = predict_moe_bytes_per_token(
            tokens, layers, meta["num_experts"], meta["top_k"],
            meta["lo_bytes"], meta["hi_bytes"],
            published_hi=int(ev.get("published_hi", 0)),
            dispatch=meta["moe_dispatch"])
        out.append({
            "tokens": tokens,
            "layers": layers,
            "published_hi": int(ev.get("published_hi", 0)),
            "active_hi": int(ev.get("active_hi", 0)),
            "active_lo": int(ev.get("active_lo", 0)),
            "active_host": int(ev.get("active_host", 0)),
            "measured_bpt": nbytes / tokens,
            "predicted_bpt": pred,
        })
    return out


def _mix_bucket(s: Dict) -> float:
    """Residency-mix key: published-hi fraction of the model, rounded to
    1/16ths so windows with near-identical mixes pool together."""
    # layers in the sample counts layer-steps; cells = layers × E is not
    # carried per sample, so bucket on hi-per-layer instead (integer-ish).
    return round(s["published_hi"] / s["layers"], 2)


def residual_report(trace, decode_only: bool = True) -> Dict:
    """The measured-vs-roofline comparison: per (batch-tokens,
    residency-mix) bucket mean measured and predicted bytes/token plus the
    relative residual ``measured/predicted − 1``, and an overall
    |residual| summary. Empty traces yield ``n_steps == 0``."""
    samples = fold_steps(trace, decode_only=decode_only)
    buckets: Dict[Tuple[float, float], List[Dict]] = {}
    for s in samples:
        buckets.setdefault((round(s["tokens"], 1), _mix_bucket(s)),
                           []).append(s)
    rows = []
    for (tokens, mix), group in sorted(buckets.items()):
        meas = float(np.mean([g["measured_bpt"] for g in group]))
        pred = float(np.mean([g["predicted_bpt"] for g in group]))
        rows.append({
            "tokens": tokens,
            "hi_per_layer": mix,
            "n_steps": len(group),
            "measured_bpt": round(meas, 2),
            "predicted_bpt": round(pred, 2),
            "rel_residual": round(meas / pred - 1.0, 4) if pred else 0.0,
        })
    res = [abs(r["rel_residual"]) for r in rows for _ in range(r["n_steps"])]
    return {
        "n_steps": len(samples),
        "buckets": rows,
        "mean_abs_rel_residual": round(float(np.mean(res)), 4) if res
        else 0.0,
        "max_abs_rel_residual": round(float(np.max(res)), 4) if res else 0.0,
    }


def promotion_report(trace) -> Dict:
    """Promotion publish-latency percentiles from the lifecycle spans
    (copy issue → publish) plus the half-materialization audit: every
    publish event must carry ``published`` ∈ {0, 1} — a span that ended
    published implies its copy's result arrays were ready, i.e. no forward
    observed a half-materialized expert."""
    if isinstance(trace, FlightRecorder):
        spans = [(b.ts, e.ts, (e.args or {}))
                 for b, e in trace.spans("promotion")]
    else:
        obj = load_chrome_trace(trace) if isinstance(trace, str) else trace
        begins: Dict[int, float] = {}
        spans = []
        for ev in obj.get("traceEvents", []):
            if ev.get("name") != "promotion":
                continue
            if ev.get("ph") == "b":
                begins[ev["id"]] = ev["ts"] / 1e6
            elif ev.get("ph") == "e" and ev.get("id") in begins:
                spans.append((begins.pop(ev["id"]), ev["ts"] / 1e6,
                              ev.get("args", {})))
    lat = [e - b for b, e, a in spans if a.get("published")]
    cancelled = sum(1 for _, _, a in spans if not a.get("published"))
    arr = np.asarray(lat) if lat else np.zeros(0)
    return {
        "n_published": len(lat),
        "n_cancelled": cancelled,
        "publish_latency_p50_s": float(np.percentile(arr, 50)) if lat
        else 0.0,
        "publish_latency_p95_s": float(np.percentile(arr, 95)) if lat
        else 0.0,
        "publish_latency_max_s": float(arr.max()) if lat else 0.0,
    }


def report(trace) -> Dict:
    """Everything the shutdown summary / benchmark wants in one dict."""
    return {"roofline": residual_report(trace),
            "promotions": promotion_report(trace)}
