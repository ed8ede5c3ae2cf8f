"""Mixture-of-Experts layer, single device, two dispatch layouts (the port
of the reference's ``models/moe.py``), chosen per call by ``moe_apply(...,
dispatch=)``. Both share the stable sort-by-expert of the flattened top-k
assignments, the drop rule and the combine, so they agree per token.

* **ragged** (the default): the kept assignments compact into a (Tt·bm, d)
  buffer whose per-expert segments are aligned to the row tile
  ``RAGGED_BM``. Per-tile expert and hi-slot maps drive ONE mixed-precision
  FFN (``kernels.ops.ragged_quant_ffn``): only the experts that received
  tokens stream their weights, each from its resident tier. The tile budget
  ``Tt`` is static and the live tile count stays on the device — the host
  never waits on the routing.
* **padded** (the reference's oracle layout): the kept assignments scatter
  into a fixed-capacity (E, C, d) buffer and three grouped lo GEMMs
  (``kernels.ops.grouped_lo_matmul``) run over ALL experts; the published
  hi experts recompute in bf16 and replace their owners' outputs.

A bank is one layer's ``ExpertBankQ``, or a dense dict {'w_gate', 'w_up',
'w_down'} → (E, K, N) bf16 (the fp16 and offload backends, which have no
quantized tier): the ragged layout runs it through the FFN's all-hi mode
(``kernels.ops.ragged_dense_ffn``), the padded one as a batched SwiGLU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.ver import ExpertBankQ
from repro_torch.kernels import ops as kops
from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import swiglu

#: Row-tile height of the ragged layout (the kernels are built for 8).
RAGGED_BM = 8
#: Token layouts ``moe_apply`` takes (None means ragged).
DISPATCHES = ("ragged", "padded")


class MoEAux(NamedTuple):
    counts: torch.Tensor        # (E,) int32 router selections this call
    aux_loss: torch.Tensor      # scalar f32 load-balance loss
    dropped: torch.Tensor       # scalar f32 fraction of assignments dropped
    row_counts: Optional[torch.Tensor] = None       # (R, E) int32
    active_experts: Optional[torch.Tensor] = None   # experts with ≥1 token
    dispatch_pad_ratio: Optional[torch.Tensor] = None


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """x (T, d) → gates (T, k), idx (T, k), probs (T, E). Ties go to the
    lower expert index, as in the reference's ``jax.lax.top_k``: the first
    k of a stable descending sort (``torch.topk`` documents no tie order,
    and picks other experts of a uniform row)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, idx, probs


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 occurrences of each value of ``ids`` (ints in [0, n)):
    ``torch.bincount(ids, minlength=n)`` without its host read (on CUDA
    bincount sizes its output from ``ids.max().item()``, which a captured
    CUDA graph cannot do). Ones scatter-added into zeros of the static
    size; integer adds are exact in any order."""
    flat = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


def _sort_routing(idx: torch.Tensor, e_local: int):
    """Stable sort-by-expert of the flattened assignments: ``(order,
    sorted_eid, counts (e_local,), pos_in_e, tok)`` (``e_local`` is the
    out-of-range sentinel id)."""
    k = idx.shape[1]
    fidx = idx.reshape(-1).long()
    order = torch.argsort(fidx, stable=True)
    sorted_eid = fidx[order]
    counts_all = count_ids(fidx, e_local + 1)
    counts = counts_all[:e_local]
    starts = torch.cumsum(counts_all, 0) - counts_all
    pos_in_e = torch.arange(fidx.shape[0], device=idx.device) - \
        starts[sorted_eid]
    tok = order // k
    return order, sorted_eid, counts, pos_in_e, tok


def _row_capacity_keep(sorted_eid, tok, e_local: int, n_rows: int,
                       n_tokens: int, row_capacity: int) -> torch.Tensor:
    """Per-row drop rule: keep an assignment iff its rank among its own
    row's assignments to the same expert is < ``row_capacity``."""
    tpr = n_tokens // n_rows
    rid = tok // tpr
    key = torch.where(sorted_eid < e_local, sorted_eid * n_rows + rid,
                      torch.full_like(sorted_eid, e_local * n_rows))
    cnt = count_ids(key, e_local * n_rows + 1)
    kstart = torch.cumsum(cnt, 0) - cnt
    pos_re = torch.arange(key.shape[0], device=key.device) - kstart[key]
    return pos_re < row_capacity


def _keep_mask(sorted_eid, pos_in_e, tok, e_local: int, capacity: int,
               row_capacity: Optional[int], n_rows: Optional[int],
               n_tokens: int) -> torch.Tensor:
    if row_capacity is None:
        return (pos_in_e < capacity) & (sorted_eid < e_local)
    return _row_capacity_keep(sorted_eid, tok, e_local, n_rows, n_tokens,
                              row_capacity) & (sorted_eid < e_local)


def ragged_tile_map(counts: torch.Tensor, bm: int, n_assign: int):
    """bm-aligned ragged layout over per-expert ``counts`` ((E,) int).

    Returns ``(astart (E,), tile_eid (Tt,) int32, n_tiles (1,) int32)``:
    expert e's segment starts at compact row ``astart[e]``; row tile t
    computes with expert ``tile_eid[t]``; tiles past ``n_tiles`` repeat the
    last active expert and are skipped by the kernels. ``Tt = n_assign//bm
    + min(E, n_assign) + 1`` is static and covers every routing."""
    e_local = counts.shape[0]
    counts = counts.long()
    aligned = (counts + bm - 1) // bm * bm
    astart = torch.cumsum(aligned, 0) - aligned
    cum_t = torch.cumsum(aligned // bm, 0)
    n_tiles = cum_t[-1:]
    Tt = n_assign // bm + min(e_local, n_assign) + 1
    t_range = torch.arange(Tt, device=counts.device)
    tile_eid = torch.searchsorted(cum_t, t_range, right=True)
    ar = torch.arange(e_local, device=counts.device)
    e_last = torch.clamp(torch.where(counts > 0, ar, -1).max(), min=0)
    tile_eid = torch.where(t_range < n_tiles, tile_eid, e_last)
    tile_eid = torch.clamp(tile_eid, 0, e_local - 1)
    return astart, tile_eid.to(torch.int32), n_tiles.to(torch.int32)


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """Sum each token's k contributions in the order of the sorted
    assignment list, rounding to the working dtype after every add — the
    reference's scatter-add, without atomics (``index_add_`` on the card
    would make bf16 sums depend on thread timing)."""
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    pos, _ = torch.sort(inv.view(T, k), dim=1)          # sorted positions
    per_tok = contrib[pos]                               # (T, k, D)
    y = torch.zeros((T, contrib.shape[-1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(k):
        y = y + per_tok[:, j]
    return y


def _tile_slots(bank: ExpertBankQ, tile_eid: torch.Tensor,
                e_local: int) -> torch.Tensor:
    """Hi slot per tile from ``slot_owner`` (not ``slot_map``): the stable
    handles the forward reads, so a slot is used only once published."""
    owner = bank.slot_owner.long()
    n_hi = owner.shape[0]
    if n_hi == 0:
        return torch.full_like(tile_eid, -1)
    eff = torch.full((e_local + 1,), -1, dtype=torch.int32,
                     device=tile_eid.device)
    tgt = torch.where(owner >= 0, owner, torch.full_like(owner, e_local))
    eff[tgt] = torch.arange(n_hi, dtype=torch.int32, device=tile_eid.device)
    return eff[:e_local][tile_eid.long()]


def _dispatch_ragged(bank, x: torch.Tensor, idx: torch.Tensor,
                     gates: torch.Tensor, e_local: int, capacity: int,
                     row_capacity: Optional[int] = None,
                     n_rows: Optional[int] = None):
    """Padding-free ragged dispatch + the mixed-precision FFN kernels.
    ``bank`` holds ONE layer (lo leaves (E, ...), hi leaves (n_hi, ...),
    ``slot_owner`` (n_hi,)), or is a dense dict of (E, K, N) bf16 weights
    (every tile on its expert's weights). Returns (y (T, D), counts (E,)
    int32, dropped, pad_ratio)."""
    T, d = x.shape
    k = idx.shape[1]
    Tk = T * k
    bm = RAGGED_BM
    order, sorted_eid, counts, pos_in_e, tok = _sort_routing(idx, e_local)
    kept = _keep_mask(sorted_eid, pos_in_e, tok, e_local, capacity,
                      row_capacity, n_rows, T)
    astart, tile_eid, n_tiles = ragged_tile_map(counts, bm, Tk)
    R = tile_eid.shape[0] * bm
    live = sorted_eid < e_local
    safe_e = torch.clamp(sorted_eid, max=e_local - 1)
    rowpos = torch.where(live, astart[safe_e] + pos_in_e,
                         torch.full_like(pos_in_e, R))
    # One spare row takes the sentinel writes, so no host-side mask is
    # needed; it is sliced off before the kernel.
    xs = torch.zeros((R + 1, d), dtype=x.dtype, device=x.device)
    xs[rowpos] = x[tok]
    xs = xs[:R]
    if isinstance(bank, ExpertBankQ):
        tile_slot = _tile_slots(bank, tile_eid, e_local)
        n_hi = bank.slot_owner.shape[0]
        lo = bank.lo
        y_rows = kops.ragged_quant_ffn(
            xs, tile_eid, tile_slot, n_tiles, lo, bank.hi if n_hi else None,
            bits=lo["w_gate"].bits, group=lo["w_gate"].group_size, bm=bm)
    else:
        y_rows = kops.ragged_dense_ffn(xs, tile_eid, n_tiles, bank, bm=bm)
    y_asn = y_rows[torch.clamp(rowpos, max=R - 1)]
    gate_sorted = gates.reshape(-1)[order].to(x.dtype)
    # torch.where, never a multiply by the mask: rows of tail tiles are
    # left unwritten by the kernels and may hold NaN.
    contrib = torch.where(kept[:, None], y_asn * gate_sorted[:, None],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    y = _combine(contrib, order, T, k)
    routed = live.float().sum()
    dropped = 1.0 - kept.float().sum() / torch.clamp(routed, min=1.0)
    pad_ratio = 1.0 - routed / torch.clamp(n_tiles[0] * bm, min=1).float()
    return y, counts.to(torch.int32), dropped, pad_ratio


def _quant_expert_ffn(bank: ExpertBankQ, xg: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the padded (E, C, d) buffer: three grouped lo GEMMs for
    every expert, then the published hi experts (``slot_owner``) recompute
    in bf16 and replace their owners' outputs — the same result as swapping
    the weights, without dense per-expert weights (bf16 products with one
    rounding each, as the reference's einsums)."""
    E, C, d = xg.shape
    lo = bank.lo
    bits, group = lo["w_gate"].bits, lo["w_gate"].group_size

    def gemm(x, name):
        return kops.grouped_lo_matmul(x, lo[name].packed, lo[name].scales,
                                      bits, group)

    g = gemm(xg, "w_gate")
    h = torch.nn.functional.silu(g.float()).to(xg.dtype) * gemm(xg, "w_up")
    y = gemm(h, "w_down")
    owner = bank.slot_owner.long()
    if owner.shape[0] == 0:
        return y
    hi = bank.hi
    valid = (owner >= 0) & (owner < E)
    xh = xg[torch.where(valid, owner, torch.zeros_like(owner))]
    yh = swiglu(hi, xh)
    # Free and stale slots write to a spare expert row that is cut off.
    out = torch.cat([y, y.new_empty((1, C, y.shape[-1]))])
    out[torch.where(valid, owner, torch.full_like(owner, E))] = yh
    return out[:E]


def dispatch_compute(bank, x: torch.Tensor, idx: torch.Tensor,
                     gates: torch.Tensor, e_local: int, capacity: int,
                     row_capacity: Optional[int] = None):
    """Padded sort-scatter dispatch + the grouped expert FFN + the gated
    combine. x (T, d); idx (T, k) expert ids with ``e_local`` as the
    out-of-range sentinel; gates (T, k), zero on sentinel entries. Returns
    (y (T, d), counts (E,) int32, dropped). A dense dict bank runs the
    reference's three einsums over (E, C, d) as one batched SwiGLU."""
    if row_capacity is not None:
        raise NotImplementedError("the per-row capacity rule of the padded "
                                  "layout is not ported")
    T, d = x.shape
    k = idx.shape[1]
    order, sorted_eid, counts, pos_in_e, tok = _sort_routing(idx, e_local)
    kept = _keep_mask(sorted_eid, pos_in_e, tok, e_local, capacity, None,
                      None, T)
    # The reference scatters with mode="drop"; here dropped and sentinel
    # assignments write to one spare row past the (E·C, d) buffer, which
    # is cut off (a view: the buffer stays contiguous for the kernel).
    EC = e_local * capacity
    eid_safe = torch.clamp(sorted_eid, max=e_local - 1)
    flat = torch.where(kept, eid_safe * capacity + pos_in_e,
                       torch.full_like(pos_in_e, EC))
    xg = torch.zeros((EC + 1, d), dtype=x.dtype, device=x.device)
    xg[flat] = x[tok]
    xg = xg[:EC].view(e_local, capacity, d)
    yg = _quant_expert_ffn(bank, xg) if isinstance(bank, ExpertBankQ) \
        else swiglu(bank, xg)
    y_sorted = yg.reshape(EC, -1)[torch.clamp(flat, max=EC - 1)]
    gate_sorted = gates.reshape(-1)[order].to(x.dtype)
    contrib = torch.where(kept[:, None], y_sorted * gate_sorted[:, None],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    y = _combine(contrib, order, T, k)
    routed = (sorted_eid < e_local).float().sum()
    dropped = 1.0 - kept.float().sum() / torch.clamp(routed, min=1.0)
    return y, counts.to(torch.int32), dropped


def moe_apply(params, bank, x: torch.Tensor, cfg: MoEConfig,
              capacity: int, token_valid: Optional[torch.Tensor] = None,
              n_rows: Optional[int] = None, dispatch: Optional[str] = None):
    """Single-device MoE. ``params``: {'router', ['shared']}; x (T, d).
    ``token_valid`` masks tokens out of dispatch and every count;
    ``n_rows`` adds per-row (R, E) counts; ``dispatch`` ∈ {"ragged",
    "padded"} picks the token layout (None = ragged). A ``params["shared"]``
    SwiGLU (the shared expert) is added to every row after the combine,
    masked rows too, as the reference does. Returns (y (T, d), MoEAux)."""
    dispatch = "ragged" if dispatch is None else dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch={dispatch!r}; one of {DISPATCHES}")
    E, k = cfg.num_experts, cfg.top_k
    T = x.shape[0]
    gates, idx, probs = route(params["router"], x, cfg)
    sel = (idx >= 0) & (idx < E)
    if token_valid is not None:
        sel = sel & token_valid[:, None]
    idx_l = torch.where(sel, idx, torch.full_like(idx, E))
    gates_l = torch.where(sel, gates, torch.zeros_like(gates))
    if dispatch == "ragged":
        y, counts, dropped, pad_ratio = _dispatch_ragged(
            bank, x, idx_l, gates_l, E, capacity)
    else:
        y, counts, dropped = dispatch_compute(bank, x, idx_l, gates_l, E,
                                              capacity)
        kept_rows = torch.clamp(counts, 0, capacity).sum().float()
        pad_ratio = 1.0 - kept_rows / max(E * capacity, 1)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    active = (counts > 0).sum().to(torch.int32)

    if token_valid is None:
        full_idx = torch.clamp(idx.reshape(-1), 0, E)
        n_assign = torch.full((), float(T * k), device=x.device)
        mean_prob = probs.mean(dim=0)
    else:
        full_idx = torch.where(token_valid[:, None], torch.clamp(idx, 0, E),
                               torch.full_like(idx, E)).reshape(-1)
        n_valid = token_valid.sum().float()
        n_assign = torch.clamp(n_valid, min=1.0) * k
        tv = token_valid[:, None].float()
        mean_prob = (probs * tv).sum(dim=0) / torch.clamp(tv.sum(), min=1.0)
    full_counts = count_ids(full_idx, E + 1)[:E]
    frac = full_counts.float() / torch.clamp(n_assign, min=1.0)
    aux_loss = cfg.router_aux_coef * E * (frac * mean_prob).sum()

    row_counts = None
    if n_rows is not None:
        tpr = T // n_rows
        rid = (torch.arange(T, device=x.device) // tpr)[:, None].expand(T, k)
        eid = torch.where(sel, idx, torch.full_like(idx, E))
        flat = (rid * (E + 1) + eid).reshape(-1)
        row_counts = count_ids(flat, n_rows * (E + 1)) \
            .view(n_rows, E + 1)[:, :E].to(torch.int32)
    return y, MoEAux(counts=counts, aux_loss=aux_loss, dropped=dropped,
                     row_counts=row_counts, active_experts=active,
                     dispatch_pad_ratio=pad_ratio)


def moe_capacity(n_tokens: int, cfg: MoEConfig,
                 factor: float | None = None) -> int:
    f = factor if factor is not None else cfg.capacity_factor
    cap = int(n_tokens * cfg.top_k * f / cfg.num_experts) + 1
    return max(8, (cap + 7) // 8 * 8)
