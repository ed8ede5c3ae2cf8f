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
from repro_torch.launch import dist as D
from repro_torch.launch.dist import dist_ctx, get_dist, shard_range
from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import bf16_matmul, swiglu

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


def _tile_slots(bank: ExpertBankQ, tile_eid: torch.Tensor, e_local: int,
                e_offset: int = 0, slot_lo: int = 0) -> torch.Tensor:
    """Hi slot per tile from ``slot_owner`` (not ``slot_map``): the stable
    handles the forward reads, so a slot is used only once published.
    Under expert parallelism the bank holds this rank's slots
    ``[slot_lo, slot_lo + n)`` (``n`` its hi leaves' rows) and experts
    ``[e_offset, e_offset + e_local)``; ``slot_owner`` stays global, so the
    local slice's owners shift by ``e_offset`` and a slot index is local."""
    n_slot = bank.hi["w_gate"].shape[0] if bank.hi else 0
    if n_slot == 0:
        return torch.full_like(tile_eid, -1)
    owner = bank.slot_owner[slot_lo:slot_lo + n_slot].long() - e_offset
    eff = torch.full((e_local + 1,), -1, dtype=torch.int32,
                     device=tile_eid.device)
    valid = (owner >= 0) & (owner < e_local)
    tgt = torch.where(valid, owner, torch.full_like(owner, e_local))
    eff[tgt] = torch.arange(n_slot, dtype=torch.int32, device=tile_eid.device)
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


def _quant_expert_ffn(bank: ExpertBankQ, xg: torch.Tensor,
                      e_offset: int = 0, slot_lo: int = 0,
                      ff=None) -> torch.Tensor:
    """SwiGLU over the padded (E, C, d) buffer: three grouped lo GEMMs for
    every expert, then the published hi experts (``slot_owner``) recompute
    in bf16 and replace their owners' outputs — the same result as swapping
    the weights, without dense per-expert weights (bf16 products with one
    rounding each, as the reference's einsums). Under expert parallelism
    the bank holds this rank's experts from ``e_offset`` and its hi slots
    from ``slot_lo`` (``_tile_slots``' rule). ``ff`` (a ``DistContext``:
    the FF-sliced regime) means the bank holds F/dp of gate/up's columns
    and D/dp of down's: h, lo and hi alike, is gathered over the data axis
    along F before down (the reference's ``ff_axis``), and the output is
    this rank's D/dp columns."""
    E, C, d = xg.shape
    lo = bank.lo
    bits, group = lo["w_gate"].bits, lo["w_gate"].group_size

    def gemm(x, name):
        return kops.grouped_lo_matmul(x, lo[name].packed, lo[name].scales,
                                      bits, group)

    def gather_f(h):
        return h if ff is None else D.all_gather(h, ff, axis="data", dim=2)

    g = gemm(xg, "w_gate")
    h = torch.nn.functional.silu(g.float()).to(xg.dtype) * gemm(xg, "w_up")
    y = gemm(gather_f(h), "w_down")
    hi = bank.hi
    n_slot = hi["w_gate"].shape[0]
    if n_slot == 0:
        return y
    owner = bank.slot_owner[slot_lo:slot_lo + n_slot].long() - e_offset
    valid = (owner >= 0) & (owner < E)
    xh = xg[torch.where(valid, owner, torch.zeros_like(owner))]
    hh = torch.nn.functional.silu(          # swiglu's casts
        bf16_matmul(xh, hi["w_gate"]).float()).to(xh.dtype) * \
        bf16_matmul(xh, hi["w_up"])
    yh = bf16_matmul(gather_f(hh), hi["w_down"])
    # Free and stale slots write to a spare expert row that is cut off.
    out = torch.cat([y, y.new_empty((1, C, y.shape[-1]))])
    out[torch.where(valid, owner, torch.full_like(owner, E))] = yh
    return out[:E]


def dispatch_compute(bank, x: torch.Tensor, idx: torch.Tensor,
                     gates: torch.Tensor, e_local: int, capacity: int,
                     row_capacity: Optional[int] = None,
                     n_rows: Optional[int] = None, e_offset: int = 0,
                     slot_lo: int = 0, ff=None):
    """Padded sort-scatter dispatch + the grouped expert FFN + the gated
    combine. x (T, d); idx (T, k) expert ids with ``e_local`` as the
    out-of-range sentinel; gates (T, k), zero on sentinel entries.
    ``row_capacity`` (with ``n_rows``) switches to the per-row drop rule
    (``_row_capacity_keep``); ``capacity`` is then the physical bound the
    caller derived (``n_rows · row_capacity``), and the kept assignments
    of an expert fill its rows in order. Returns (y (T, d), counts (E,)
    int32, dropped). A dense dict bank runs the reference's three einsums
    over (E, C, d) as one batched SwiGLU. ``e_offset``/``slot_lo``: where
    this rank's experts and hi slots start under expert parallelism;
    ``ff``: the FF-sliced regime (``_quant_expert_ffn``), whose y holds
    this rank's D/dp columns."""
    T, d = x.shape
    k = idx.shape[1]
    order, sorted_eid, counts, pos_in_e, tok = _sort_routing(idx, e_local)
    kept = _keep_mask(sorted_eid, pos_in_e, tok, e_local, capacity,
                      row_capacity, n_rows, T)
    if row_capacity is None:
        scat_pos = pos_in_e
    else:
        # Rank among the expert's KEPT assignments: the buffer holds only
        # survivors.
        kept_i = kept.long()
        kept_e = torch.zeros(e_local + 1, dtype=torch.int64,
                             device=x.device).scatter_add_(0, sorted_eid,
                                                           kept_i)
        kstart = torch.cumsum(kept_e, 0) - kept_e
        scat_pos = torch.cumsum(kept_i, 0) - 1 - kstart[sorted_eid]
    # The reference scatters with mode="drop"; here dropped and sentinel
    # assignments write to one spare row past the (E·C, d) buffer, which
    # is cut off (a view: the buffer stays contiguous for the kernel).
    EC = e_local * capacity
    eid_safe = torch.clamp(sorted_eid, max=e_local - 1)
    flat = torch.where(kept, eid_safe * capacity + scat_pos,
                       torch.full_like(scat_pos, EC))
    xg = torch.zeros((EC + 1, d), dtype=x.dtype, device=x.device)
    xg[flat] = x[tok]
    xg = xg[:EC].view(e_local, capacity, d)
    yg = _quant_expert_ffn(bank, xg, e_offset, slot_lo, ff) \
        if isinstance(bank, ExpertBankQ) else swiglu(bank, xg)
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
              n_rows: Optional[int] = None, dispatch: Optional[str] = None,
              row_capacity: Optional[int] = None):
    """MoE forward. ``params``: {'router', ['shared']}; x (T, d).
    ``token_valid`` masks tokens out of dispatch and every count;
    ``n_rows`` adds per-row (R, E) counts; ``dispatch`` ∈ {"ragged",
    "padded"} picks the token layout (None = ragged); ``row_capacity``
    (needs ``n_rows``) makes the drop rule per row: whether a token's
    assignment drops no longer depends on the other rows of the batch. A
    ``params["shared"]`` SwiGLU (the shared expert) is added to every row
    after the combine, masked rows too, as the reference does. Returns
    (y (T, d), MoEAux).

    Under a distribution context (``launch.dist.get_dist()``, as the
    reference's ``moe_apply`` branches at trace time) ``bank`` holds this
    rank's slice of the experts (``launch.sharding.bank_shard``), and the
    layer runs one of the sharded regimes (``_moe_apply_sharded``); every
    rank returns the same y and aux."""
    dispatch = "ragged" if dispatch is None else dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch={dispatch!r}; one of {DISPATCHES}")
    if row_capacity is not None and n_rows is None:
        raise ValueError("row_capacity needs n_rows")
    dist = get_dist()
    if dist is not None:
        return _moe_apply_sharded(params, bank, x, cfg, capacity, dist,
                                  token_valid, n_rows, row_capacity,
                                  dispatch)
    if row_capacity is not None:
        # The physical capacity that covers the per-row rule's worst case
        # (every surviving assignment on one expert): drops come from the
        # row rule alone.
        capacity = n_rows * row_capacity
    E = cfg.num_experts
    gates, idx, probs = route(params["router"], x, cfg)
    sel = _selected(idx, token_valid, 0, E)
    idx_l = torch.where(sel, idx, torch.full_like(idx, E))
    gates_l = torch.where(sel, gates, torch.zeros_like(gates))
    if dispatch == "ragged":
        y, counts, dropped, pad_ratio = _dispatch_ragged(
            bank, x, idx_l, gates_l, E, capacity, row_capacity=row_capacity,
            n_rows=n_rows)
    else:
        y, counts, dropped = dispatch_compute(
            bank, x, idx_l, gates_l, E, capacity, row_capacity=row_capacity,
            n_rows=n_rows)
        kept_rows = torch.clamp(counts, 0, capacity).sum().float()
        pad_ratio = 1.0 - kept_rows / max(E * capacity, 1)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    row_counts = None if n_rows is None else \
        _row_counts(idx_l, E, n_rows, x.shape[0])
    return y, MoEAux(counts=counts,
                     aux_loss=_aux_loss(idx, probs, token_valid, cfg),
                     dropped=dropped, row_counts=row_counts,
                     active_experts=(counts > 0).sum().to(torch.int32),
                     dispatch_pad_ratio=pad_ratio)


def _selected(idx: torch.Tensor, token_valid: Optional[torch.Tensor],
              e_offset: int, e_local: int) -> torch.Tensor:
    """(T, k) mask of the assignments to experts ``[e_offset, e_offset +
    e_local)`` from valid tokens."""
    sel = (idx >= e_offset) & (idx < e_offset + e_local)
    if token_valid is not None:
        sel = sel & token_valid[:, None]
    return sel


def _aux_loss(idx: torch.Tensor, probs: torch.Tensor,
              token_valid: Optional[torch.Tensor],
              cfg: MoEConfig) -> torch.Tensor:
    """The load-balance loss over the full router distribution of valid
    tokens (the reference's formula)."""
    E, k = cfg.num_experts, cfg.top_k
    T = idx.shape[0]
    if token_valid is None:
        full_idx = torch.clamp(idx.reshape(-1), 0, E)
        n_assign = torch.full((), float(T * k), device=idx.device)
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
    return cfg.router_aux_coef * E * (frac * mean_prob).sum()


def _row_counts(eid: torch.Tensor, E: int, n_rows: int,
                T: int) -> torch.Tensor:
    """(n_rows, E) int32 selections per row of T/n_rows tokens; ``eid``
    (T, k) global expert ids with E for the assignments not counted."""
    k = eid.shape[1]
    rid = (torch.arange(T, device=eid.device) // (T // n_rows))[:, None] \
        .expand(T, k)
    flat = (rid * (E + 1) + eid).reshape(-1)
    return count_ids(flat, n_rows * (E + 1)).view(n_rows, E + 1)[:, :E] \
        .to(torch.int32)


#: Which sharded regime each MoE call under a distribution context ran,
#: counted as ``kernels.ops.LAUNCHES`` counts launches: "all_to_all" (the
#: expert-parallel ragged pipeline over the model axis) and "padded" (the
#: partial outputs summed over the model axis, tokens replicated) always;
#: the first call of a regime of the data axis adds its key —
#: "padded_dp" (tokens split over data), "padded_ff" (tokens replicated,
#: the experts' FF dims sliced over data), "all_to_all_dp" (tokens split
#: over data × model) — and "replicated" the whole-bank fallback for
#: experts that do not divide over the model axis.
REGIMES = {"all_to_all": 0, "padded": 0}


def reset_regimes() -> None:
    REGIMES.clear()
    REGIMES.update(all_to_all=0, padded=0)


def _ran(regime: str) -> None:
    REGIMES[regime] = REGIMES.get(regime, 0) + 1


def _moe_apply_sharded(params, bank, x: torch.Tensor, cfg: MoEConfig,
                       capacity: int, dist, token_valid, n_rows,
                       row_capacity, dispatch):
    """Expert parallelism over the (data × model) grid of ``dist``: model
    rank j holds experts ``[j·E/N, (j+1)·E/N)`` (the lo leaves, or a dense
    bank's rows) and hi slots ``[j·n_hi/N, (j+1)·n_hi/N)``, the same on
    every data rank; ``slot_owner`` and ``slot_map`` stay global
    (``launch.sharding.bank_shard`` cuts a bank so). The regime is chosen
    from shapes as the reference chooses (its ``_moe_apply_sharded``):

    * **replicated** (E not divisible by N): every rank holds the whole
      bank and runs the single-device layer (a rank holding a shard of
      such a bank raises).
    * **all_to_all** (``dist.tokens_ep_sharded`` and ragged dispatch, T
      divisible by the dp·N token shards, rows that tile over them):
      ``_moe_local_ep``; "all_to_all_dp" when the data axis has more than
      one rank.
    * **padded** (everything else): ``_moe_padded_ep`` — the tokens split
      over data when ``dist.tokens_dp_sharded`` ("padded_dp"), or stay
      replicated with the experts' FF dims sliced over data when the bank
      is quantized and F and d divide ("padded_ff"; the rank's bank then
      holds F/dp of gate/up's columns and D/dp of down's).

    The reference also leaves the all-to-all regime for a hi pool that
    does not divide over the shards (it replicates that pool); the port's
    ranks hold only their own slots, and its backends refuse such an
    n_hi, so the case raises here."""
    mn, dp = dist.model_size, dist.data_size
    E = cfg.num_experts
    T, d = x.shape
    is_q = isinstance(bank, ExpertBankQ)
    held = (bank.lo["w_gate"].packed if is_q else bank["w_gate"]).shape[0]
    if E % mn:
        if held != E:
            raise ValueError(f"num_experts={E} not divisible by {mn} shards: "
                             f"every rank holds the whole bank, rank "
                             f"{dist.rank} holds {held} experts")
        _ran("replicated")
        with dist_ctx(None):
            return moe_apply(params, bank, x, cfg, capacity, token_valid,
                             n_rows, dispatch, row_capacity)
    e_local = E // mn
    if held != e_local:
        raise ValueError(f"rank {dist.rank} holds {held} experts; under "
                         f"{mn} shards it holds its own {e_local}")
    nh_local = bank.hi["w_gate"].shape[0] if is_q and bank.hi else 0
    if is_q and bank.slot_owner.shape[0] != nh_local * mn:
        raise ValueError(f"hi pool of {bank.slot_owner.shape[0]} slots, "
                         f"{nh_local} held by this rank: it must divide "
                         f"over the {mn} shards")
    n_tok = dist.n_token_shards
    use_ep = dist.tokens_ep_sharded and dispatch == "ragged" and \
        T % n_tok == 0 and T // n_tok > 0
    if use_ep and n_rows is not None:
        # Rows must tile over the ranks, so that the per-row drop rule and
        # row_counts stay on one rank.
        use_ep = T % n_rows == 0 and n_rows % n_tok == 0 and \
            (T // n_tok) % (T // n_rows) == 0
    if use_ep:
        _ran("all_to_all" if dp == 1 else "all_to_all_dp")
        return _moe_local_ep(params, bank, x, cfg, capacity, dist,
                             token_valid, n_rows, row_capacity, e_local,
                             nh_local)
    F = cfg.d_ff_expert
    ff = is_q and not dist.tokens_dp_sharded and dp > 1 and \
        F % dp == 0 and d % dp == 0
    if is_q:
        want = (F // dp, d // dp) if ff else (F, d)
        got = (bank.lo["w_gate"].packed.shape[-1],
               bank.lo["w_down"].packed.shape[-1])
        if got != want:
            raise ValueError(f"rank {dist.rank} holds gate/down columns "
                             f"{got}; this regime takes {want}")
    split = dist.tokens_dp_sharded and dp > 1
    _ran("padded_ff" if ff else "padded_dp" if split else "padded")
    return _moe_padded_ep(params, bank, x, cfg, capacity, dist, token_valid,
                          n_rows, row_capacity, e_local, nh_local, ff, split)


def _moe_padded_ep(params, bank, x, cfg, capacity, dist, token_valid, n_rows,
                   row_capacity, e_local, nh_local, ff, split):
    """The padded regimes (the reference's shard_map body). Every rank
    routes every token (the single device's gates bit for bit, as in
    ``_moe_local_ep``); under ``split`` data rank i keeps tokens
    ``[i·T/dp, (i+1)·T/dp)`` and dispatches them at the per-shard capacity
    ``max(8, ceil8(capacity // dp))``. Each rank dispatches the
    assignments to its own experts into the (E/N, C, d) buffer, and the
    partial outputs are summed over the model axis in float32 (one
    rounding to bf16 after the sum; the single device adds each token's k
    contributions in bf16, so the two agree to a tolerance, as the
    reference's psum does). Under ``ff`` the sum is of this rank's D/dp
    columns, gathered over data after it; under ``split`` y is gathered
    over data back to (T, d). counts are summed over model and data; aux,
    dropped and the pad ratio are averaged over data, then dropped and the
    pad ratio over model (the reference's order); per-row counts split
    over data where the rows tile (else None; a ``row_capacity`` then
    raises)."""
    E = cfg.num_experts
    T = x.shape[0]
    dp = dist.data_size
    j = dist.rank
    e_off, slot_lo = j * e_local, j * nh_local
    gates, idx, probs = route(params["router"], x, cfg)
    n_rows_l = n_rows
    if split:
        if T % dp:
            raise ValueError(f"{T} tokens do not split over the {dp} data "
                             f"shards")
        sl = shard_range(T, dist, "data")
        x, gates, idx, probs = x[sl], gates[sl], idx[sl], probs[sl]
        token_valid = None if token_valid is None else token_valid[sl]
        capacity = max(8, (capacity // dp + 7) // 8 * 8)
        if n_rows is not None:
            if T % n_rows == 0 and n_rows % dp == 0 and \
                    (T // dp) % (T // n_rows) == 0:
                n_rows_l = n_rows // dp
            elif row_capacity is not None:
                raise ValueError(f"row_capacity requires rows to tile over "
                                 f"the {dp} data shards (T={T}, "
                                 f"n_rows={n_rows})")
            else:
                n_rows_l = None
    if row_capacity is not None:
        capacity = n_rows_l * row_capacity
    sel = _selected(idx, token_valid, e_off, e_local)
    idx_l = torch.where(sel, idx - e_off, torch.full_like(idx, e_local))
    gates_l = torch.where(sel, gates, torch.zeros_like(gates))
    y, counts_l, dropped = dispatch_compute(
        bank, x, idx_l, gates_l, e_local, capacity,
        row_capacity=row_capacity, n_rows=n_rows_l, e_offset=e_off,
        slot_lo=slot_lo, ff=dist if ff else None)
    y = D.all_reduce(y.float(), dist).to(x.dtype)
    if ff:
        y = D.all_gather(y, dist, axis="data", dim=1)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    counts = D.all_gather(counts_l, dist)
    kept_rows = torch.clamp(counts_l, 0, capacity).sum().float()
    pad = 1.0 - kept_rows / max(e_local * capacity, 1)
    aux = _aux_loss(idx, probs, token_valid, cfg)
    if split:
        y = D.all_gather(y, dist, axis="data")
        counts = D.all_reduce(counts.long(), dist, axis="data") \
            .to(torch.int32)
        m = D.all_reduce(torch.stack([aux.double(), dropped.double(),
                                      pad.double()]), dist, axis="data") / dp
        aux, dropped, pad = m[0].float(), m[1], m[2]
    means = D.all_reduce(torch.stack([dropped.double(), pad.double()]),
                         dist) / dist.model_size
    row_counts = None
    if n_rows_l is not None:
        eid = torch.where(sel, idx, torch.full_like(idx, E))
        row_counts = D.all_reduce(
            _row_counts(eid, E, n_rows_l, x.shape[0]).long(), dist)
        if split:
            row_counts = D.all_gather(row_counts, dist, axis="data")
        row_counts = row_counts.to(torch.int32)
    return y, MoEAux(counts=counts, aux_loss=aux, dropped=means[0].float(),
                     row_counts=row_counts,
                     active_experts=(counts > 0).sum().to(torch.int32),
                     dispatch_pad_ratio=means[1].float())


def _moe_local_ep(params, bank, x, cfg, capacity, dist, token_valid, n_rows,
                  row_capacity, e_local, nh_local):
    """The expert-parallel ragged pipeline (the reference's
    ``_moe_local_ep``). Rank (i, j) of a dp × N grid owns tokens
    ``[t·T/(dp·N), (t+1)·T/(dp·N))``, t = i·N + j (its index on the token
    axes, data major); its rows go only to the ranks of its model group,
    since the experts replicate over data.

    * **Sender**: sort its assignments by global expert id (grouped by
      destination rank, experts ascending within each), keep them under
      the drop rule (per (expert, sender) at ``ep_cap_shard``, or the
      per-row rule), and compact the kept rows into an (N·S, d) payload
      whose block s holds the rows for rank s (S = ``ep_payload_rows``).
      One ``all_to_all`` moves the rows, a second the (N, E/N) counts.
    * **Receiver**: rebuild per-expert segments with the same
      ``_sort_routing`` (stable by (expert, source, send order): each
      expert's rows in global token order, as on one device), lay them out
      with ``ragged_tile_map`` over the local ids, take each tile's slot
      from this rank's slice of ``slot_owner``, and run the ragged FFN
      kernels (the all-hi pair for a dense bank).
    * **Home**: a third ``all_to_all`` brings the result rows back, and
      the sender combines each token's assignments with its gates in the
      sorted order (``_combine``): the same sum, in the same order, as the
      single device, so drop-free calls are bit-equal to it.

    Then an ``all_gather`` over the token axes rebuilds y (T, d) on every
    rank, the counts and the routed/kept totals are summed over them, and
    the row counts gathered. The router runs on all T tokens on every
    rank and each rank takes its slice: its (T, d)·(d, E) product is
    small, and the full product gives every rank the single device's
    gates bit for bit (a GEMM over fewer rows may reduce in another order,
    on the card and on the CPU), and the single device's aux loss."""
    E, k = cfg.num_experts, cfg.top_k
    T, d = x.shape
    mn = dist.model_size
    n_tok = dist.n_token_shards
    bm = RAGGED_BM
    T_l = T // n_tok
    j = dist.rank
    tok_sl = shard_range(T, dist, "tokens")
    n_rows_l = None if n_rows is None else n_rows // n_tok
    cap_shard = 0 if row_capacity is not None else \
        ep_cap_shard(capacity, n_tok)
    S = ep_payload_rows(T, k, e_local, capacity, n_tok, bm=bm,
                        n_rows=n_rows, row_capacity=row_capacity)
    gates_all, idx_all, probs = route(params["router"], x, cfg)
    x_l, gates, idx = x[tok_sl], gates_all[tok_sl], idx_all[tok_sl]
    tv_l = None if token_valid is None else token_valid[tok_sl]
    sel = _selected(idx, tv_l, 0, E)
    idx_v = torch.where(sel, idx, torch.full_like(idx, E))
    gates_v = torch.where(sel, gates, torch.zeros_like(gates))

    # -- sender: the kept assignments, compacted per destination rank.
    order, sorted_eid, counts_l, pos_in_e, tok = _sort_routing(idx_v, E)
    kept = _keep_mask(sorted_eid, pos_in_e, tok, E, cap_shard, row_capacity,
                      n_rows_l, T_l)
    dest = torch.where(sorted_eid < E, sorted_eid // e_local,
                       torch.full_like(sorted_eid, mn))
    kept_i = kept.long()
    kept_d = torch.zeros(mn + 1, dtype=torch.int64, device=x.device) \
        .scatter_add_(0, dest, kept_i)
    dstart = torch.cumsum(kept_d, 0) - kept_d
    offs = torch.cumsum(kept_i, 0) - 1 - dstart[dest]
    send_row = torch.where(kept, dest * S + offs,
                           torch.full_like(offs, mn * S))
    # One spare row takes the dropped assignments' writes.
    send = torch.zeros((mn * S + 1, d), dtype=x.dtype, device=x.device)
    send[send_row] = x_l[tok]
    cnt_send = count_ids(torch.where(kept, sorted_eid,
                                     torch.full_like(sorted_eid, E)),
                         E + 1)[:E].view(mn, e_local)
    recv = D.all_to_all(send[:mn * S], dist)
    cnt_recv = D.all_to_all(cnt_send, dist)

    # -- receiver: each payload row's local expert from the count
    # boundaries (rows past a block's total → the e_local sentinel), then
    # the ragged layout over the local experts.
    r = torch.arange(mn * S, device=x.device)
    cum = torch.cumsum(cnt_recv, 1)
    eid_r = ((r % S)[:, None] >= cum[r // S]).sum(1)
    _, sorted_re, cnt_e, pos_re, rrow = _sort_routing(eid_r[:, None], e_local)
    astart, tile_eid, n_tiles = ragged_tile_map(cnt_e, bm, mn * S)
    R = tile_eid.shape[0] * bm
    live = sorted_re < e_local
    safe_e = torch.clamp(sorted_re, max=e_local - 1)
    rowpos = torch.where(live, astart[safe_e] + pos_re,
                         torch.full_like(pos_re, R))
    xs = torch.zeros((R + 1, d), dtype=x.dtype, device=x.device)
    xs[rowpos] = recv[rrow]
    xs = xs[:R]
    if isinstance(bank, ExpertBankQ):
        tile_slot = _tile_slots(bank, tile_eid, e_local, e_offset=j * e_local,
                                slot_lo=j * nh_local)
        lo = bank.lo
        y_rows = kops.ragged_quant_ffn(
            xs, tile_eid, tile_slot, n_tiles, lo,
            bank.hi if nh_local else None, bits=lo["w_gate"].bits,
            group=lo["w_gate"].group_size, bm=bm)
    else:
        y_rows = kops.ragged_dense_ffn(xs, tile_eid, n_tiles, bank, bm=bm)
    D_out = y_rows.shape[-1]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # torch.where, never a multiply: tail tiles' rows are unwritten.
    back = torch.where(live[:, None], y_rows[torch.clamp(rowpos, max=R - 1)],
                       zero)
    y_recv = torch.zeros((mn * S, D_out), dtype=x.dtype, device=x.device)
    y_recv[rrow] = back

    # -- home: block s of the return holds my rows' results from rank s, at
    # the offsets I sent them at.
    y_ret = D.all_to_all(y_recv, dist)
    y_asn = y_ret[torch.clamp(send_row, max=mn * S - 1)]
    gate_sorted = gates_v.reshape(-1)[order].to(x.dtype)
    contrib = torch.where(kept[:, None], y_asn * gate_sorted[:, None], zero)
    y = D.all_gather(_combine(contrib, order, T_l, k), dist, axis="tokens")
    if "shared" in params:
        y = y + swiglu(params["shared"], x)

    # -- exact global telemetry: counts and totals summed over the token
    # axes (integers, exact in float64), the pad ratio averaged.
    routed = (sorted_eid < E).sum()
    pad = 1.0 - cnt_e.sum().double() / \
        torch.clamp(n_tiles[0] * bm, min=1).double()
    stats = D.all_reduce(torch.cat([
        counts_l.double(), torch.stack([routed.double(),
                                        kept.sum().double(), pad])]), dist,
                         axis="tokens")
    counts = stats[:E].to(torch.int32)
    routed_g, kept_g = stats[E].float(), stats[E + 1].float()
    dropped = 1.0 - kept_g / torch.clamp(routed_g, min=1.0)
    row_counts = None
    if n_rows is not None:
        row_counts = D.all_gather(_row_counts(idx_v, E, n_rows_l, T_l), dist,
                                  axis="tokens")
    return y, MoEAux(counts=counts,
                     aux_loss=_aux_loss(idx_all, probs, token_valid, cfg),
                     dropped=dropped, row_counts=row_counts,
                     active_experts=(counts > 0).sum().to(torch.int32),
                     dispatch_pad_ratio=(stats[E + 2] / n_tok).float())


def moe_capacity(n_tokens: int, cfg: Optional[MoEConfig],
                 factor: float | None = None) -> int:
    """Slots per expert of a forward over ``n_tokens`` (0 on a stack
    without MoE, ``cfg`` None)."""
    if cfg is None:
        return 0
    f = factor if factor is not None else cfg.capacity_factor
    cap = int(n_tokens * cfg.top_k * f / cfg.num_experts) + 1
    return max(8, (cap + 7) // 8 * 8)


def ep_cap_shard(capacity: int, n_token_shards: int) -> int:
    """Per-(expert, sender) capacity under expert-parallel token sharding:
    the global per-expert ``capacity`` split evenly over the senders,
    floored at 8 so that small decode batches are always drop-free."""
    return max(8, (-(-capacity // n_token_shards) + 7) // 8 * 8)


def ep_payload_rows(n_tokens: int, top_k: int, e_local: int, capacity: int,
                    n_token_shards: int, bm: int = RAGGED_BM,
                    n_rows: Optional[int] = None,
                    row_capacity: Optional[int] = None) -> int:
    """Rows ``S`` per destination block of the all-to-all payload: a sender
    forwards at most min(its ``T_l·k`` assignments, what one destination
    keeps from it: ``e_local`` experts × ``ep_cap_shard``, or
    ``rows_l·row_capacity`` under the per-row rule), rounded up to whole
    row tiles. Each rank moves ``2·(N−1)·S·d`` payload elements per MoE
    layer, out and back (the reference's bytes-moved model)."""
    t_l = n_tokens // n_token_shards
    if row_capacity is not None:
        per_dest = e_local * (n_rows // n_token_shards) * row_capacity
    else:
        per_dest = e_local * ep_cap_shard(capacity, n_token_shards)
    s = min(t_l * top_k, per_dest)
    return max(bm, -(-s // bm) * bm)
