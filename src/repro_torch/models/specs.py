"""The batch entry points under the sharding planner's specs: what GSPMD
does with the reference's ``jax.jit(in_shardings=...)`` in
``build_dryrun`` (``src/repro/launch/shapes.py``), done by hand on one
rank of a (data × model) process grid.

A rank holds exactly its shards (``launch.sharding.shard_tree``): the
params by ``spec_for_param`` (FSDP for the train step), the expert bank
by ``bank_shard``'s rule, the dense caches by ``spec_for_cache`` and the
inputs by ``spec_for_input``. It computes only its share of the step:

* **Rows.** The hidden state holds the rank's *group rows*: the batch
  split over data (when it divides; else every row), the same on every
  rank of a model group, which shares the work of each layer (tensor
  parallelism). 1-D inputs and the caches may split further, over data ×
  model (*own rows*, ``_Layout``); no layer gathers rows back over data.
* **Embedding** over vocabulary rows on the model axis: a masked lookup
  of the rank's rows, then an all-reduce (one term is nonzero: exact).
  **LM head** over vocabulary columns: ``prefill``/``decode_step`` gather
  the last position's logits over model; the train loss is
  vocab-parallel (``vocab_parallel_ce``) and no rank holds (B, S, V).
* **Attention** with heads that divide the model axis: wq/wk/wv
  column-parallel (local heads; rope and qk-norm per head), wo
  row-parallel and an all-reduce; KV heads that do not divide stay
  replicated beside sharded q heads (the mixed case). Heads that do not
  divide: every head on every rank in prefill and decode, and the
  sequence-parallel attention of ``layers._attention_seq_parallel`` in
  ``forward_train`` (without its gather over data: the rows are already
  the rank's).
* **Caches.** Rows over data × model (case h): the cache holds every head
  of the own rows, and q/k/v go from local heads of the group rows to
  every head of the own rows by an all-to-all over model (and the
  attention output back before wo). Rows over data only with the
  sequence over model (case g): the rank holds C/N slots of every row;
  the new token's K/V is written by the owner of slot ``pos % C``, every
  q head attends over the rank's slots through ``ops.flash_decode(...,
  lse=True)``, and the partial outputs are combined over model by their
  log-sum-exp.
* **FFN.** Dense FFN and shared experts column/row parallel, then an
  all-reduce; the MoE layer runs its model-axis regimes
  (``moe._moe_apply_sharded``) on the group's tokens at the per-shard
  capacity (the reference's ``cap_local``), counts summed over data, the
  load-balance loss from the global routing statistics.
* **FSDP** (train): a leaf cut over data is all-gathered at use, per
  super-block inside ``torch.utils.checkpoint``; its gradient comes back
  reduce-scattered (the gather's backward).
* **Gradients.** Every collective has its adjoint (``launch.dist``), and
  each rank's loss is its share of the global loss (``loss_share``), so
  a rank's gradients are exact for the sum of the shares; a leaf held by
  several ranks (replicated over data, model, or both: the spec says
  which) sums its copies' gradients over those axes (``sum_grads``).

* **Mamba-2 mixer** (``in_proj``/``out_proj`` cut on their contraction
  axis, the reference's rule: the concatenated zxBCdt axis does not
  split): each rank multiplies its columns of the normed input by its
  rows of ``in_proj``, an all-reduce over model gives the group the whole
  zxBCdt; the conv, the SSD scan, ``D`` and the gated norm run whole on
  every rank (``ssm.ssd_scan`` / ``ssd_decode_scan``); ``out_proj``
  row-parallel over the d_inner channels, then an all-reduce. Its caches
  (``state``, ``conv``) are cut over the batch only: rows over data
  (case g) hold the group rows; rows over data × model (case h) hold the
  own rows, so the scan runs on the own rows of zxBCdt, and its output
  comes back to the group rows × this rank's channels by an all-to-all
  over model (an all-gather of the rows where ``out_proj`` is whole).
* **Encoder-decoder** (Whisper): the encoder on the group rows (its
  attention column/row parallel where the heads divide, else every head
  on every rank, sequence-parallel in ``forward_train``; its GELU MLP
  column/row parallel); each decoder layer's cross K/V written into the
  rank's shard of the cross cache (own rows, every head, in case h; the
  group rows, every head, else), the decode step's cross-attention
  through ``ops.flash_decode`` over that shard.
* **VLM** (LLaVA): the image prefix (the group rows of ``image_embeds``)
  ahead of the vocabulary-parallel embedding of the text; ``lengths``
  count it, and the train loss takes no terms at its positions.

Every family of the registry runs, and so does the per-row drop rule
(``row_capacity``): the MoE layers keep each group row's assignments by
``moe._row_capacity_keep`` on the rank's group rows (the whole batch's
rows where it does not split over data, as the reference's padded regime
runs the rule on every row when its tokens are replicated). The paged entry
points raise ``NotImplementedError`` (``model._no_specs``): the
reference's planner has no rule for a block pool and its engine never
runs under a planner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as tdist
import torch.utils.checkpoint

from repro_torch.launch import dist as D
from repro_torch.launch.dist import DistContext, dist_ctx, shard_range
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import moe as X
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig


def active() -> Optional[DistContext]:
    """The ambient context when it carries a planner, else None."""
    ctx = D.get_dist()
    return ctx if ctx is not None and ctx.planner is not None else None


_SPECS: Dict[tuple, Dict] = {}


def param_specs(cfg: ArchConfig, planner) -> Dict:
    """The planner's specs of ``cfg``'s param tree (global shapes, drawn on
    the ``meta`` device: no memory), as nested dicts of the tree's keys."""
    from repro_torch.launch.sharding import param_specs as specs_of
    from repro_torch.models.model import init_params
    key = (cfg, tuple(sorted(planner.mesh.shape.items())), planner.fsdp,
           planner.seq_shard_cache, planner.pad_heads)
    if key not in _SPECS:
        _SPECS[key] = specs_of(init_params(cfg, device="meta"), planner)
    return _SPECS[key]


def _has(entry, axis: str) -> bool:
    """Whether a spec entry names ``axis``: "model", or "data" for any data
    axis (the reference's ("pod", "data") are the context's one)."""
    if entry is None:
        return False
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    if axis == "model":
        return "model" in names
    return any(a != "model" for a in names)


def _on(spec: tuple, axis: str) -> bool:
    """Whether ``spec`` cuts some dim over ``axis`` ("model" or "data")."""
    return any(_has(e, axis) for e in spec)


def _at(spec: tuple, i: int):
    """Entry ``i`` of ``spec``; None past its end (a replicated leaf's
    spec may be shorter than its shape: ``P()``)."""
    return spec[i] if -len(spec) <= i < len(spec) else None


def _last_model(spec: tuple) -> bool:
    return _has(_at(spec, -1), "model")


# ---- rows ----------------------------------------------------------------
class _Layout(NamedTuple):
    """Which global rows this rank's tensors hold. ``group``: the hidden
    state's (2-D inputs: split over data when B divides, else all);
    ``own``: 1-D inputs' and the caches' (over data × model when B divides
    both, else ``group``); ``own_in_group``: ``own`` within ``group``;
    ``seq``: the caches' sequence is split over model."""
    B: int
    group: slice
    own: slice
    own_in_group: slice
    over_model: bool
    seq: bool

    @property
    def split(self) -> bool:
        """The rows split over data (each data rank holds its own)."""
        return self.group.stop - self.group.start < self.B


def layout(ctx: DistContext) -> _Layout:
    B = ctx.batch
    if B is None:
        raise ValueError("a context with a planner needs batch: the global "
                         "rows of the call's inputs")
    dp, mn = ctx.data_size, ctx.model_size
    group = shard_range(B, ctx, "data") if B % dp == 0 else slice(0, B)
    over = mn > 1 and B % (dp * mn) == 0
    if over:
        own = shard_range(B, ctx, "tokens")
        n = own.stop - own.start
        own_in = slice(ctx.rank * n, (ctx.rank + 1) * n)
    else:
        own, own_in = group, slice(0, group.stop - group.start)
    seq = (not over and B % dp == 0 and mn > 1 and
           ctx.planner.seq_shard_cache)
    return _Layout(B, group, own, own_in, over, seq)


def _rows_in(t: torch.Tensor, want: int, what: str) -> None:
    if t.shape[0] != want:
        raise ValueError(f"{what}: {t.shape[0]} rows, this rank's shard of "
                         f"the global batch holds {want}")


def to_group(t: torch.Tensor, lay: _Layout, ctx: DistContext
             ) -> torch.Tensor:
    """A 1-D input's rows (own) → the group's (gathered over model)."""
    return D.all_gather(t, ctx, "model") if lay.over_model else t


# ---- FSDP ----------------------------------------------------------------
def gather_fsdp(t: torch.Tensor, spec: tuple, ctx: DistContext
                ) -> torch.Tensor:
    """``t`` whole over the data axis: all-gathered along each dim whose
    spec entry is a data axis (the FSDP dim); itself where none is."""
    for dim, e in enumerate(spec):
        if _has(e, "data"):
            t = D.all_gather(t, ctx, "data", dim=dim)
    return t


def gather_tree(tree, specs, ctx: DistContext, lead: int = 0):
    """``gather_fsdp`` over a (per-layer) subtree; ``lead``: leading spec
    entries the views dropped (1 for a layer's views of stacked leaves)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], ctx, lead)
                for k, v in tree.items() if v is not None}
    return gather_fsdp(tree, specs[lead:], ctx)


# ---- embedding and head --------------------------------------------------
def embed(params: Dict, specs: Dict, tokens: torch.Tensor,
          ctx: DistContext) -> torch.Tensor:
    """Token embeddings over vocabulary rows cut on the model axis: the
    rank's rows looked up where a token falls in them, zeros elsewhere,
    summed over model (in float32: one term is nonzero, so exact)."""
    table = gather_fsdp(params["embed"], specs["embed"], ctx)
    if not _has(_at(specs["embed"], 0), "model"):
        return table[tokens]
    n = table.shape[0]
    local = tokens - ctx.rank * n
    hit = (local >= 0) & (local < n)
    x = table[torch.clamp(local, 0, n - 1)]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return D.all_reduce(x.float(), ctx).to(table.dtype)


def head_logits(params: Dict, specs: Dict, cfg: ArchConfig,
                x: torch.Tensor, ctx: DistContext):
    """The final norm and this rank's vocabulary columns of the logits
    (float32), and whether the columns are cut over model."""
    x = L.rmsnorm(gather_tree(params["final_norm"], specs["final_norm"],
                              ctx), x, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = gather_fsdp(params["embed"], specs["embed"], ctx).T
        cut = _has(_at(specs["embed"], 0), "model")
    else:
        w = gather_fsdp(params["lm_head"], specs["lm_head"], ctx)
        cut = _has(_at(specs["lm_head"], 1), "model")
    return (x @ w).float(), cut


def vocab_parallel_ce(logits: torch.Tensor, cut: bool, labels: torch.Tensor,
                      ctx: DistContext):
    """Per-position (logsumexp, label logit) over vocabulary columns cut
    on the model axis: the max (detached) and the sum of exponentials
    all-reduced over model, the label's logit from its owner (zeros
    elsewhere, summed). ``labels`` < 0 read logit 0."""
    if not cut:
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1,
                           torch.clamp(labels, min=0)[..., None])[..., 0]
        return lse, lab
    n = logits.shape[-1]
    m = D.all_reduce(logits.detach().amax(-1), ctx, op=tdist.ReduceOp.MAX)
    sum_exp = D.all_reduce(torch.exp(logits - m[..., None]).sum(-1), ctx)
    lse = m + torch.log(sum_exp)
    local = labels - ctx.rank * n
    hit = (local >= 0) & (local < n) & (labels >= 0)
    lab = torch.gather(logits, -1,
                       torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    lab = D.all_reduce(torch.where(hit, lab, torch.zeros_like(lab)), ctx)
    return lse, lab


# ---- dense FFN -----------------------------------------------------------
def row_parallel(x: torch.Tensor, w: torch.Tensor, cut: bool,
                 ctx: DistContext) -> torch.Tensor:
    """``x @ w`` where ``w``'s rows (and ``x``'s columns) are cut over
    model: the partial products in float32, summed over model, rounded
    once to ``x``'s dtype."""
    if not cut:
        return M.bf16_matmul(x, w)
    part = torch.matmul(x.float(), w.float())
    return D.all_reduce(part, ctx).to(x.dtype)


def swiglu(p: Dict, ps: Dict, x: torch.Tensor, ctx: DistContext
           ) -> torch.Tensor:
    """``mlp.swiglu`` column/row parallel when its F columns are cut over
    model (the casts of ``mlp.swiglu``), else whole."""
    if not _last_model(ps["w_gate"]):
        return M.swiglu(p, x)
    g = torch.nn.functional.silu(M.bf16_matmul(x, p["w_gate"]).float()) \
        .to(x.dtype)
    return row_parallel(g * M.bf16_matmul(x, p["w_up"]), p["w_down"], True,
                        ctx)


def gelu_mlp(p: Dict, ps: Dict, x: torch.Tensor, ctx: DistContext
             ) -> torch.Tensor:
    """``mlp.gelu_mlp`` (an encoder layer's; no biases) column/row
    parallel when its F columns are cut over model, else whole."""
    if not _last_model(ps["w_up"]):
        return M.gelu_mlp(p, x)
    h = torch.nn.functional.gelu(M.bf16_matmul(x, p["w_up"]).float(),
                                 approximate="tanh").to(x.dtype)
    return row_parallel(h, p["w_down"], True, ctx)


# ---- MoE -----------------------------------------------------------------
def _model_only(ctx: DistContext) -> DistContext:
    """``ctx``'s model group alone: the MoE regimes over the model axis on
    the group's tokens (already split over data)."""
    return dataclasses.replace(ctx, data_group=None, data_rank=0,
                               data_size=1, token_group=None, planner=None,
                               batch=None)


def cap_local(capacity: int, ctx: DistContext, lay: _Layout) -> int:
    """The per-shard capacity of tokens split over data (the reference's
    ``cap_local``): the global per-expert capacity's share, floored at 8."""
    return max(8, (capacity // ctx.data_size + 7) // 8 * 8) if lay.split \
        else capacity


def global_aux(router: torch.Tensor, x: torch.Tensor, cfg,
               token_valid: Optional[torch.Tensor], ctx: DistContext,
               split: bool) -> torch.Tensor:
    """The load-balance loss of the whole batch from the rank's tokens:
    the routing counts, the valid tokens and the sum of the router's
    probabilities summed over data where the rows ``split`` over it (the
    single device's formula)."""
    E, k = cfg.num_experts, cfg.top_k
    _, idx, probs = X.route(router, x, cfg)
    if token_valid is None:
        tv = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    else:
        tv = token_valid
    full = torch.where(tv[:, None], torch.clamp(idx, 0, E),
                       torch.full_like(idx, E))
    counts = X.count_ids(full, E + 1)[:E].double()
    n = tv.sum().double()[None]
    stats = torch.cat([counts, n])
    psum = (probs * tv[:, None].float()).sum(0)
    if split:
        stats = D.all_reduce(stats, ctx, axis="data")
        psum = D.all_reduce(psum, ctx, axis="data")
    n_tok = torch.clamp(stats[E], min=1.0).float()
    frac = stats[:E].float() / (n_tok * k)
    return cfg.router_aux_coef * E * (frac * psum / n_tok).sum()


def moe(p: Dict, ps: Dict, bank, x: torch.Tensor, cfg, capacity: int,
        ctx: DistContext, lay: _Layout, token_valid=None, dispatch=None,
        n_rows: Optional[int] = None, row_capacity: Optional[int] = None,
        per_row: bool = False):
    """The MoE layer on the group's tokens x (T_g, d) in ``n_rows`` group
    rows: the model-axis regimes at the per-shard capacity (``bank`` the
    rank's experts; ``row_capacity``: the per-row drop rule on those
    rows), the shared expert tensor-parallel, counts summed over data
    (``per_row``: per group row, (n_rows, E)), the global load-balance
    loss. Returns (y, counts, aux_loss)."""
    inner = {k: v for k, v in p.items() if k != "shared"}
    with dist_ctx(_model_only(ctx)):
        y, aux = X.moe_apply(inner, bank, x, cfg, cap_local(capacity, ctx,
                                                             lay),
                             token_valid=token_valid, n_rows=n_rows,
                             dispatch=dispatch, row_capacity=row_capacity)
    if "shared" in p:
        y = y + swiglu(p["shared"], ps["shared"], x, ctx)
    counts = aux.row_counts.long() if per_row else aux.counts.long()
    if lay.split and not per_row:
        counts = D.all_reduce(counts, ctx, axis="data")
    return y, counts.to(torch.int32), global_aux(p["router"], x, cfg,
                                                 token_valid, ctx, lay.split)


# ---- attention -----------------------------------------------------------
class _Heads(NamedTuple):
    q_cut: bool
    kv_cut: bool
    hq: int          # this rank's q heads
    qo: int          # the global index of its first
    hk: int          # its KV heads
    ko: int


def _heads(ps: Dict, a, ctx: DistContext) -> _Heads:
    mn, j = ctx.model_size, ctx.rank
    q_cut, kv_cut = _last_model(ps["wq"]), _last_model(ps["wk"])
    hq = a.n_heads // mn if q_cut else a.n_heads
    hk = a.n_kv_heads // mn if kv_cut else a.n_kv_heads
    return _Heads(q_cut, kv_cut, hq, j * hq if q_cut else 0, hk,
                  j * hk if kv_cut else 0)


def _local(a, hs: _Heads):
    """The attention config of this rank's heads."""
    return dataclasses.replace(a, n_heads=hs.hq, n_kv_heads=hs.hk)


def _kv_for_q(k: torch.Tensor, v: torch.Tensor, a, hs: _Heads):
    """The K/V heads this rank's q heads read (GQA), and the q heads per
    KV head of what is returned: the contiguous block when the rank's q
    heads are whole groups, else one KV head per q head."""
    rep = a.n_heads // a.n_kv_heads
    if hs.qo % rep == 0 and hs.hq % rep == 0:
        lo = hs.qo // rep - hs.ko
        return k[:, :, lo:lo + hs.hq // rep], v[:, :, lo:lo + hs.hq // rep]
    idx = (hs.qo + torch.arange(hs.hq, device=k.device)) // rep - hs.ko
    return k[:, :, idx], v[:, :, idx]


def _causal(q, k, v, a, hs: _Heads, positions) -> torch.Tensor:
    """Causal attention of this rank's q heads over the whole sequence
    (``layers._causal_attention`` over the K/V heads they read)."""
    kq, vq = _kv_for_q(k, v, a, hs)
    return L._causal_attention(q, kq, vq, _local(a, hs), positions)


def _to_own(t: torch.Tensor, cut: bool, lay: _Layout, ctx: DistContext
            ) -> torch.Tensor:
    """(group rows, this rank's heads, …) → (own rows, every head, …):
    an all-to-all over model when the heads are cut (block s of the rows
    to rank s; the heads come back in rank order), a row slice when not."""
    if not cut:
        return t[lay.own_in_group]
    mn = ctx.model_size
    got = D.all_to_all(t, ctx)                     # (mn·Bo, S, h, hd)
    Bo = t.shape[0] // mn
    got = got.reshape((mn, Bo) + tuple(t.shape[1:]))
    return torch.cat(list(got.unbind(0)), dim=2)


def _from_own(o: torch.Tensor, cut: bool, lay: _Layout, ctx: DistContext,
              dim: int = 1) -> torch.Tensor:
    """``_to_own``'s way back for the attention output (own rows, every
    head, hd) → (group rows, this rank's heads, hd), or along ``dim`` for
    another tensor of own rows (the Mamba mixer's channels): an
    all-to-all over model of the blocks along ``dim`` where they are cut,
    an all-gather of the rows where not."""
    if not cut:
        return D.all_gather(o, ctx, "model")
    mn = ctx.model_size
    parts = torch.chunk(o, mn, dim=dim)            # heads of rank s
    return D.all_to_all(torch.cat(parts, dim=0).contiguous(), ctx)


def _every_kv(k: torch.Tensor, hs: _Heads, ctx: DistContext
              ) -> torch.Tensor:
    """Every KV head of the group rows (gathered over model when cut)."""
    return D.all_gather(k, ctx, "model", dim=2) if hs.kv_cut else k


def attention_prefill(p: Dict, ps: Dict, a, h: torch.Tensor, cache,
                      lengths_own: torch.Tensor, ctx: DistContext,
                      lay: _Layout) -> torch.Tensor:
    """Prefill from position 0 on the group rows; writes the rank's cache
    (its rows, its slots) in place."""
    hs = _heads(ps, a, ctx)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    q, k, v = L._project_qkv(p, _local(a, hs), h, positions)
    out = _causal(q, k, v, a, hs, positions)
    if lay.over_model:
        kw, vw = _to_own(k, hs.kv_cut, lay, ctx), _to_own(v, hs.kv_cut, lay,
                                                          ctx)
    else:
        kw, vw = _every_kv(k, hs, ctx), _every_kv(v, hs, ctx)
    C_l = cache.k.shape[2]
    C = C_l * ctx.model_size if lay.seq else C_l
    lo = ctx.rank * C_l if lay.seq else 0
    L._write_prefill(cache, kw, vw, lengths_own, C, lo)
    return row_parallel(out, p["wo"], hs.q_cut, ctx)


def attention_decode(p: Dict, ps: Dict, a, h: torch.Tensor, pos_g,
                     cache, ctx: DistContext, lay: _Layout) -> torch.Tensor:
    """One token per group row against the rank's cache: case h (own rows,
    every head) through all-to-alls; case g (the rank's slots) through the
    kernel's log-sum-exp and a combine over model."""
    hs = _heads(ps, a, ctx)
    Bg = h.shape[0]
    q, k, v = L._project_qkv(p, _local(a, hs), h, pos_g[:, None])
    if lay.over_model:
        qo = _to_own(q, hs.q_cut, lay, ctx)[:, 0]
        ko = _to_own(k, hs.kv_cut, lay, ctx)[:, 0]
        vo = _to_own(v, hs.kv_cut, lay, ctx)[:, 0]
        pos_o = pos_g[lay.own_in_group]
        C = cache.capacity
        rows = torch.arange(qo.shape[0], device=h.device)
        slot = torch.remainder(pos_o, C).long()
        cache.k[rows, :, slot] = ko
        cache.v[rows, :, slot] = vo
        o = L.kops.flash_decode(qo.contiguous(), cache.k.transpose(1, 2),
                                cache.v.transpose(1, 2),
                                L.decode_valid(pos_o, C, a))
        o = _from_own(o, hs.q_cut, lay, ctx)
        return row_parallel(o.reshape(Bg, 1, -1), p["wo"], hs.q_cut, ctx)
    qa = D.all_gather(q, ctx, "model", dim=2) if hs.q_cut else q
    ka, va = _every_kv(k, hs, ctx)[:, 0], _every_kv(v, hs, ctx)[:, 0]
    C_l = cache.capacity
    C = C_l * ctx.model_size if lay.seq else C_l
    lo = ctx.rank * C_l if lay.seq else 0
    rows = torch.arange(Bg, device=h.device)
    slot = torch.remainder(pos_g, C).long()
    mine = ((slot >= lo) & (slot < lo + C_l))[:, None, None]
    ls = torch.clamp(slot - lo, 0, C_l - 1)
    cache.k[rows, :, ls] = torch.where(mine, ka, cache.k[rows, :, ls])
    cache.v[rows, :, ls] = torch.where(mine, va, cache.v[rows, :, ls])
    valid = L.decode_valid(pos_g, C, a)[:, lo:lo + C_l].contiguous()
    kv = (cache.k.transpose(1, 2), cache.v.transpose(1, 2))
    if lay.seq:
        o, lse = L.kops.flash_decode(qa[:, 0].contiguous(), *kv, valid,
                                     lse=True)
        o = combine_lse(o, lse, ctx)
    else:
        o = L.kops.flash_decode(qa[:, 0].contiguous(), *kv, valid)
    if hs.q_cut:
        o = o[:, hs.qo:hs.qo + hs.hq]
    return row_parallel(o.reshape(Bg, 1, -1), p["wo"], hs.q_cut, ctx)


def combine_lse(o: torch.Tensor, lse: torch.Tensor, ctx: DistContext
                ) -> torch.Tensor:
    """The attention over every rank's slots from each rank's output over
    its own (o (B, H, hd), lse (B, H) float32): gathered over model and
    weighed by exp(lse − max); a rank whose slots were all masked (lse
    -inf) weighs 0."""
    O = D.all_gather(o[None], ctx, "model")            # (mn, B, H, hd)
    Ls = D.all_gather(lse[None], ctx, "model")         # (mn, B, H)
    m = Ls.amax(0)
    w = torch.where(torch.isinf(Ls), torch.zeros_like(Ls),
                    torch.exp(Ls - torch.where(torch.isinf(m),
                                               torch.zeros_like(m), m)))
    num = (w[..., None] * O.float()).sum(0)
    return (num / torch.clamp(w.sum(0), min=1e-30)[..., None]).to(o.dtype)


def attention_seq(p: Dict, ps: Dict, a, h: torch.Tensor, ctx: DistContext,
                  causal: bool = True, seq_parallel: bool = True
                  ) -> torch.Tensor:
    """Attention over the group rows' whole sequences, no cache (causal,
    or over every position: an encoder's): local heads when they divide;
    else, with ``seq_parallel``, ``layers._attention_seq_parallel`` on
    these rows (gathered over model only), or every head where S does
    not divide (or without ``seq_parallel``: prefill's encoder)."""
    hs = _heads(ps, a, ctx)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    q, k, v = L._project_qkv(p, _local(a, hs), h, positions)
    if seq_parallel and not hs.q_cut and ctx.model_size > 1 and \
            S % ctx.model_size == 0:
        plan = (ctx, slice(0, h.shape[0]), shard_range(S, ctx, "model"),
                False)
        return L._attention_seq_parallel(p, a, q, k, v, positions, causal,
                                         plan)
    if causal:
        out = _causal(q, k, v, a, hs, positions)
    else:
        kq, vq = _kv_for_q(k, v, a, hs)
        mask = torch.ones((1, S, S), dtype=torch.bool, device=h.device)
        out = L._sdpa(q, kq, vq, mask.expand(h.shape[0], S, S), hs.hq)
    return row_parallel(out, p["wo"], hs.q_cut, ctx)


# ---- cross-attention and the encoder (Whisper) ---------------------------
def _cross_q(p: Dict, a, hs: _Heads, x: torch.Tensor) -> torch.Tensor:
    """This rank's q heads of the cross-attention, (B, Sq, hq, hd)."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, hs.hq, a.head_dim)
    return L.rmsnorm(p["q_norm"], q) if a.qk_norm else q


def cross_attend(p: Dict, ps: Dict, a, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """Cross-attention of the group rows x (B_g, Sq, d) over every frame
    of ``k``/``v`` (B_g, Senc, this rank's KV heads, hd), the plain masked
    attention of ``layers.cross_attention``'s prefill; wo row-parallel."""
    hs = _heads(ps, a, ctx)
    q = _cross_q(p, a, hs, x)
    kq, vq = _kv_for_q(k, v, a, hs)
    mask = torch.ones((x.shape[0], x.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return row_parallel(L._sdpa(q, kq, vq, mask, hs.hq), p["wo"], hs.q_cut,
                        ctx)


def cross_kv(p: Dict, ps: Dict, a, enc: torch.Tensor, ctx: DistContext):
    """``layers.encode_cross_kv`` of this rank's KV heads: enc (B_g, Senc,
    d) → K, V (B_g, Senc, hk, hd)."""
    return L.encode_cross_kv(p, _local(a, _heads(ps, a, ctx)), enc)


def cross_decode(p: Dict, ps: Dict, a, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, ctx: DistContext, lay: _Layout
                 ) -> torch.Tensor:
    """One token per group row over the rank's shard of the layer's cross
    K/V through ``ops.flash_decode`` (every frame valid): case h (own
    rows, every head) through all-to-alls; else the group rows' every
    head (q gathered over model where its heads are cut)."""
    hs = _heads(ps, a, ctx)
    Bg = x.shape[0]
    q = _cross_q(p, a, hs, x)
    if lay.over_model:
        qo = _to_own(q, hs.q_cut, lay, ctx)[:, 0]
        o = L.kops.flash_decode(qo.contiguous(), ck, cv, L.cross_valid(ck))
        o = _from_own(o, hs.q_cut, lay, ctx)
    else:
        qa = D.all_gather(q, ctx, "model", dim=2) if hs.q_cut else q
        o = L.kops.flash_decode(qa[:, 0].contiguous(), ck, cv,
                                L.cross_valid(ck))
        if hs.q_cut:
            o = o[:, hs.qo:hs.qo + hs.hq]
    return row_parallel(o.reshape(Bg, 1, -1), p["wo"], hs.q_cut, ctx)


def encode(params: Dict, specs: Dict, cfg: ArchConfig, frames: torch.Tensor,
           ctx: DistContext, train: bool = False) -> torch.Tensor:
    """``model.encode`` on the group rows' frames (B_g, Senc, d): per layer
    the attention over every frame (``attention_seq``, non-causal;
    sequence-parallel under ``train`` where the heads do not divide the
    model axis), the GELU MLP, each after its norm and each layer's
    leaves gathered over data where FSDP cut them; the final norm."""
    es = specs["encoder"]
    from repro_torch.models.model import _unbind
    layers = _unbind(_lead_gathered(params["encoder"], es, ctx),
                     cfg.n_encoder_layers)
    x = frames
    for l in range(cfg.n_encoder_layers):
        bp = gather_tree(layers[l], es, ctx, lead=1)
        h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        x = x + attention_seq(bp["attn"], es["attn"], cfg.attn, h, ctx,
                              causal=False, seq_parallel=train)
        h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + gelu_mlp(bp["mlp"], es["mlp"], h, ctx)
    return L.rmsnorm(gather_tree(params["enc_final_norm"],
                                 specs["enc_final_norm"], ctx), x,
                     cfg.norm_eps)


def fill_cross(params: Dict, specs: Dict, cfg: ArchConfig, caches: Dict,
               audio: torch.Tensor, ctx: DistContext, lay: _Layout) -> list:
    """``model._fill_cross`` on the rank's shards: encode the group rows'
    frames, and write each decoder layer's cross K/V into the rank's
    shard of ``caches[CROSS]`` (own rows every head in case h, else the
    group rows every head); position "0"'s cross weights, as the single
    process's. Returns each layer's (K, V) of the group rows and this
    rank's KV heads, which prefill's cross-attention reads."""
    from repro_torch.models.model import CROSS
    enc = encode(params, specs, cfg, audio.to(torch.bfloat16), ctx)
    cross, ps = caches[CROSS], specs["blocks"]["0"]["cross"]
    hs = _heads(ps, cfg.attn, ctx)
    out = []
    for l in range(cfg.n_superblocks()):
        p = gather_tree(_layer_of(params["blocks"]["0"]["cross"], l), ps,
                        ctx, lead=1)
        k, v = cross_kv(p, ps, cfg.attn, enc, ctx)
        for dst, t in ((cross.k[l], k), (cross.v[l], v)):
            dst.copy_(_to_own(t, hs.kv_cut, lay, ctx) if lay.over_model
                      else _every_kv(t, hs, ctx))
        out.append((k, v))
    return out


# ---- the Mamba-2 mixer ---------------------------------------------------
def _cols(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """This rank's block of ``t``'s last dim, cut evenly over model."""
    n = t.shape[-1] // ctx.model_size
    return t[..., ctx.rank * n:(ctx.rank + 1) * n]


def mamba_in(p: Dict, ps: Dict, h: torch.Tensor, ctx: DistContext
             ) -> torch.Tensor:
    """The whole zxBCdt on every rank of the group: ``in_proj`` cut on
    d_model (its rows) over model, so this rank's columns of ``h`` times
    its rows, summed over model in float32 (``row_parallel``); else
    whole."""
    cut = _has(_at(ps["in_proj"], -2), "model")
    return row_parallel(_cols(h, ctx) if cut else h, p["in_proj"], cut, ctx)


def mamba_out(p: Dict, ps: Dict, y: torch.Tensor, lay: _Layout,
              ctx: DistContext, own: bool) -> torch.Tensor:
    """``out_proj`` of the scan's output y (rows, S, d_inner): the own rows
    (``own``, case h) first brought to the group rows × this rank's
    channels by an all-to-all over model (an all-gather of the rows where
    ``out_proj`` is whole); then row-parallel over the channels."""
    cut = _has(_at(ps["out_proj"], -2), "model")
    if own:
        y = _from_own(y, cut, lay, ctx, dim=-1)
    elif cut:
        y = _cols(y, ctx)
    return row_parallel(y, p["out_proj"], cut, ctx)


def mamba_prefill(p: Dict, ps: Dict, cfg: ArchConfig, h: torch.Tensor,
                  cache, lengths_own: torch.Tensor, ctx: DistContext,
                  lay: _Layout) -> torch.Tensor:
    """The chunked SSD over the group rows' prompts: the scan on the rows
    the rank's cache holds (its own rows in case h), their final conv
    window and state written into it."""
    z = mamba_in(p, ps, h, ctx)
    if lay.over_model:
        z = z[lay.own_in_group]
    y, new = SSM.ssd_scan(p, cfg.ssm, cfg.d_model, z, lengths=lengths_own)
    cache.conv.copy_(new.conv)
    cache.state.copy_(new.state)
    return mamba_out(p, ps, y, lay, ctx, lay.over_model)


def mamba_decode(p: Dict, ps: Dict, cfg: ArchConfig, h: torch.Tensor, cache,
                 valid_g: Optional[torch.Tensor], ctx: DistContext,
                 lay: _Layout) -> torch.Tensor:
    """One token per group row: the recurrence on the rows the rank's
    cache holds, in place; rows outside ``valid_g`` (the group's) keep
    their state."""
    z = mamba_in(p, ps, h[:, 0], ctx)
    if lay.over_model:
        z = z[lay.own_in_group]
        valid_g = None if valid_g is None else valid_g[lay.own_in_group]
    y = SSM.ssd_decode_scan(p, cfg.ssm, cfg.d_model, z, cache,
                            row_valid=valid_g)
    return mamba_out(p, ps, y[:, None], lay, ctx, lay.over_model)


def mamba_train(p: Dict, ps: Dict, cfg: ArchConfig, h: torch.Tensor,
                ctx: DistContext, lay: _Layout) -> torch.Tensor:
    """The chunked SSD over the group rows' whole sequences, no cache."""
    y, _ = SSM.ssd_scan(p, cfg.ssm, cfg.d_model, mamba_in(p, ps, h, ctx))
    return mamba_out(p, ps, y, lay, ctx, False)


# ---- the entry points ----------------------------------------------------
def _layer_of(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer_of(v, l) for k, v in tree.items() if v is not None}
    return tree[l]


def _lead_gathered(tree, specs, ctx: DistContext):
    """Stacked leaves whose FSDP dim is the layer axis, gathered whole
    (their per-layer views would be another rank's layers)."""
    if isinstance(tree, dict):
        return {k: _lead_gathered(v, specs[k], ctx) for k, v in tree.items()
                if v is not None}
    return D.all_gather(tree, ctx, "data") if _has(_at(specs, 0), "data") \
        else tree


def _experts(bp: Dict, key: str, bank, l: int):
    if "moe" not in bp:
        return None
    return bp["moe"]["experts"] if bank is None else bank[key].layer(l)


def _ffn(bp: Dict, ps: Dict, cfg: ArchConfig, x, experts, capacity, ctx,
         lay, token_valid, dispatch, per_row=False, row_capacity=None):
    """The block's FFN after its norm: (x, counts or None, aux loss)."""
    B, S, d = x.shape
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" not in bp:
        if "mlp" not in bp:
            return x, None, zero
        return x + swiglu(bp["mlp"], ps["mlp"], h, ctx), None, zero
    y, counts, aux = moe(bp["moe"], ps["moe"], experts, h.reshape(B * S, d),
                         cfg.moe, capacity, ctx, lay, token_valid, dispatch,
                         B if per_row or row_capacity is not None else None,
                         row_capacity, per_row)
    return x + y.reshape(B, S, d), counts, aux


def _serve(params, cfg: ArchConfig, x, caches, bank, ctx, lay, *, capacity,
           token_valid, dispatch, per_row, row_capacity=None,
           lengths_own=None, pos_g=None, cross_kv=None):
    """The layer loop of ``prefill`` (``lengths_own`` given; ``cross_kv``:
    each layer's cross K/V from ``fill_cross``) or ``decode_step``
    (``pos_g``; an encoder-decoder stack reads the cross cache) on the
    group rows, each position by its kind (attention or Mamba), then the
    cross-attention where the block has one, then its FFN; ``per_row``:
    counts per group row; ``row_capacity``: the per-row drop rule."""
    from repro_torch.models.model import CROSS
    specs = param_specs(cfg, ctx.planner)
    sb = cfg.superblock_or_default()
    prefill = lengths_own is not None
    counts = {str(p): [] for p in range(len(sb))
              if "moe" in params["blocks"][str(p)]}
    cross = caches.get(CROSS)
    for l in range(cfg.n_superblocks()):
        for pos, kind in enumerate(sb):
            key = str(pos)
            ps = specs["blocks"][key]
            bp = gather_tree(_layer_of(params["blocks"][key], l), ps, ctx,
                             lead=1)
            c = caches[key]
            c = type(c)(*(t[l] for t in c))
            h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
            if kind == "mamba" and prefill:
                mix = mamba_prefill(bp["mamba"], ps["mamba"], cfg, h, c,
                                    lengths_own, ctx, lay)
            elif kind == "mamba":
                mix = mamba_decode(bp["mamba"], ps["mamba"], cfg, h, c,
                                   token_valid, ctx, lay)
            elif prefill:
                mix = attention_prefill(bp["attn"], ps["attn"], cfg.attn, h,
                                        c, lengths_own, ctx, lay)
            else:
                mix = attention_decode(bp["attn"], ps["attn"], cfg.attn, h,
                                       pos_g, c, ctx, lay)
            if "cross" in bp:
                x = x + mix
                hc = L.rmsnorm(bp["norm_cross"], x, cfg.norm_eps)
                if prefill:
                    mix = cross_attend(bp["cross"], ps["cross"], cfg.attn,
                                       hc, *cross_kv[l], ctx)
                else:
                    mix = cross_decode(bp["cross"], ps["cross"], cfg.attn,
                                       hc, cross.k[l], cross.v[l], ctx, lay)
            x, n, _ = _ffn(bp, ps, cfg, x + mix, _experts(bp, key, bank, l),
                           capacity, ctx, lay, token_valid, dispatch,
                           per_row, row_capacity)
            if n is not None:
                counts[key].append(n)
    return x, {p: torch.stack(v) for p, v in counts.items()}, specs


def embed_inputs(params: Dict, specs: Dict, cfg: ArchConfig,
                 tokens: torch.Tensor, image: Optional[torch.Tensor],
                 ctx: DistContext, lay: _Layout) -> torch.Tensor:
    """``model._embed_inputs`` on the group rows: the vocabulary-parallel
    embedding of the tokens, and on a VLM stack the group rows of
    ``image`` (B_g, n, d) ahead of them."""
    x = embed(params, specs, tokens, ctx)
    if image is None:
        return x
    if cfg.family != "vlm":
        raise ValueError(f"{cfg.name}: image_embeds on a {cfg.family!r} "
                         f"stack (only a VLM takes them)")
    _rows_in(image, lay.group.stop - lay.group.start, "image_embeds")
    return torch.cat([image.to(x.dtype), x], dim=1)


def _last_logits(params, specs, cfg, x, ctx) -> torch.Tensor:
    logits, cut = head_logits(params, specs, cfg, x, ctx)
    return D.all_gather(logits, ctx, "model", dim=-1) if cut else logits


def prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            caches: Dict, lengths: torch.Tensor, bank=None,
            capacity_factor: Optional[float] = None,
            per_row_counts: bool = False, moe_dispatch: Optional[str] = None,
            row_capacity: Optional[int] = None, image_embeds=None,
            audio_embeds=None):
    """``model.prefill`` on this rank's shards: ``tokens`` (B_g, S) its
    group rows (``spec_for_input`` of a 2-D grid), ``lengths`` its rows of
    the 1-D input, ``caches`` its cache shards (written in place);
    ``image_embeds`` / ``audio_embeds`` (a VLM's prefix, an
    encoder-decoder's frames) the group rows, as ``tokens``. The MoE
    capacity is the global batch's (``ctx.batch`` · S), cut per data
    shard. Returns (the group rows' last-token logits (B_g, V) float32,
    gathered over model; counts {pos: (nsb, E)} of the whole batch, or
    with ``per_row_counts`` (nsb, B_g, E) of the group rows)."""
    ctx = active()
    lay = layout(ctx)
    _rows_in(tokens, lay.group.stop - lay.group.start, "tokens")
    _rows_in(lengths, lay.own.stop - lay.own.start, "lengths")
    specs = param_specs(cfg, ctx.planner)
    cross_kv = None
    if cfg.is_encoder_decoder:
        if audio_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                             f"audio_embeds (the group's rows)")
        _rows_in(audio_embeds, lay.group.stop - lay.group.start,
                 "audio_embeds")
        cross_kv = fill_cross(params, specs, cfg, caches, audio_embeds, ctx,
                              lay)
    x = embed_inputs(params, specs, cfg, tokens, image_embeds, ctx, lay)
    Bg, S, _ = x.shape
    lengths = lengths.to(torch.int64)
    lengths_g = to_group(lengths, lay, ctx)
    token_valid = (torch.arange(S, device=x.device)[None, :] <
                   lengths_g[:, None]).reshape(-1)
    cap = X.moe_capacity(lay.B * S, cfg.moe, capacity_factor)
    x, counts, specs = _serve(params, cfg, x, caches, bank, ctx, lay,
                              capacity=cap, token_valid=token_valid,
                              dispatch=moe_dispatch, per_row=per_row_counts,
                              row_capacity=row_capacity, lengths_own=lengths,
                              cross_kv=cross_kv)
    last = torch.clamp(lengths_g - 1, 0, S - 1)
    x_last = x[torch.arange(Bg, device=x.device), last][:, None, :]
    return _last_logits(params, specs, cfg, x_last, ctx)[:, 0], counts


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                pos_idx: torch.Tensor, caches: Dict, bank=None,
                capacity_factor: float = 2.0,
                row_valid: Optional[torch.Tensor] = None,
                per_row_counts: bool = False,
                moe_dispatch: Optional[str] = None,
                row_capacity: Optional[int] = None):
    """``model.decode_step`` on this rank's shards: ``token``, ``pos_idx``
    ((B,) or a scalar) and ``row_valid`` its rows of the 1-D inputs (over
    data × model when the batch divides both), ``caches`` its cache
    shards. Returns (the group rows' logits (B_g, V) float32, counts)."""
    ctx = active()
    lay = layout(ctx)
    _rows_in(token, lay.own.stop - lay.own.start, "token")
    specs = param_specs(cfg, ctx.planner)
    tok = to_group(token, lay, ctx)
    Bg = tok.shape[0]
    pos = pos_idx.expand(Bg) if pos_idx.dim() == 0 else \
        to_group(pos_idx, lay, ctx)
    valid = None if row_valid is None else to_group(row_valid, lay, ctx)
    x = embed(params, specs, tok, ctx)[:, None, :]
    cap = X.moe_capacity(lay.B, cfg.moe, capacity_factor)
    x, counts, specs = _serve(params, cfg, x, caches, bank, ctx, lay,
                              capacity=cap, token_valid=valid,
                              dispatch=moe_dispatch, per_row=per_row_counts,
                              row_capacity=row_capacity, pos_g=pos)
    return _last_logits(params, specs, cfg, x, ctx)[:, 0], counts


def vocab_cut(cfg: ArchConfig, specs: Dict) -> bool:
    """Whether the LM head's vocabulary columns are cut over model."""
    if cfg.tie_embeddings:
        return _has(_at(specs["embed"], 0), "model")
    return _has(_at(specs["lm_head"], 1), "model")


def forward_train(params: Dict, cfg: ArchConfig, batch: Dict,
                  capacity_factor: Optional[float] = None,
                  remat: bool = True, dispatch: str = "padded", bank=None):
    """``model.forward_train`` on this rank's shards: ``batch["tokens"]``
    (and "image_embeds" / "audio_embeds") its group rows; leaves cut over
    data (FSDP) gathered per super-block inside the checkpoint (the
    encoder's per layer, before it). Returns (this rank's logits (B_g, S, V_l)
    float32: its rows, its vocabulary columns when they are cut over
    model, see ``vocab_cut``; {"aux_loss": the whole batch's, summed over
    layers, "counts": {pos: (nsb, E)} of the whole batch})."""
    ctx = active()
    lay = layout(ctx)
    tokens = batch["tokens"]
    _rows_in(tokens, lay.group.stop - lay.group.start, "tokens")
    specs = param_specs(cfg, ctx.planner)
    x = embed_inputs(params, specs, cfg, tokens,
                     batch.get("image_embeds") if cfg.family == "vlm"
                     else None, ctx, lay)
    Bg, S, _ = x.shape
    enc_out = None
    if cfg.is_encoder_decoder:
        audio = batch["audio_embeds"]
        _rows_in(audio, Bg, "audio_embeds")
        enc_out = encode(params, specs, cfg, audio.to(torch.bfloat16), ctx,
                         train=True)
    cap = X.moe_capacity(lay.B * S, cfg.moe, capacity_factor)
    sb = cfg.superblock_or_default()
    nsb = cfg.n_superblocks()
    from repro_torch.models.model import _unbind
    layers = {str(p): _unbind(_lead_gathered(params["blocks"][str(p)],
                                             specs["blocks"][str(p)], ctx),
                              nsb)
              for p in range(len(sb))}

    def sb_body(x, aux_sum, l):
        counts = []
        for pos, kind in enumerate(sb):
            key = str(pos)
            ps = specs["blocks"][key]
            bp = gather_tree(layers[key][l], ps, ctx, lead=1)
            h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
            if kind == "mamba":
                mix = mamba_train(bp["mamba"], ps["mamba"], cfg, h, ctx, lay)
            else:
                mix = attention_seq(bp["attn"], ps["attn"], cfg.attn, h, ctx)
            if enc_out is not None and kind == "attn":
                x = x + mix
                hc = L.rmsnorm(bp["norm_cross"], x, cfg.norm_eps)
                k, v = cross_kv(bp["cross"], ps["cross"], cfg.attn, enc_out,
                                ctx)
                mix = cross_attend(bp["cross"], ps["cross"], cfg.attn, hc, k,
                                   v, ctx)
            x = x + mix
            x, c, a = _ffn(bp, ps, cfg, x, _experts(bp, key, bank, l), cap,
                           ctx, lay, None, dispatch)
            aux_sum = aux_sum + a
            counts.append(c)
        return x, aux_sum, counts

    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = {str(p): [] for p in range(len(sb))
              if "moe" in params["blocks"][str(p)]}
    for l in range(nsb):
        if remat:
            x, aux_sum, cs = torch.utils.checkpoint.checkpoint(
                sb_body, x, aux_sum, l, use_reentrant=False)
        else:
            x, aux_sum, cs = sb_body(x, aux_sum, l)
        for pos, c in enumerate(cs):
            if c is not None:
                counts[str(pos)].append(c)
    logits, _ = head_logits(params, specs, cfg, x, ctx)
    return logits, {"aux_loss": aux_sum,
                    "counts": {p: torch.stack(v) for p, v in counts.items()}}


def _row_copies(ctx: DistContext, lay: _Layout) -> int:
    """Ranks that compute each row's loss terms: its model group, and every
    data rank where the rows do not split over data."""
    return ctx.model_size * (1 if lay.split else ctx.data_size)


def loss_share(params, cfg: ArchConfig, batch: Dict, tcfg):
    """This rank's share of ``training.train.loss_fn``'s loss: the shares of
    every rank sum to the whole batch's loss (cross-entropy through the
    vocab-parallel logsumexp, the load-balance loss, the z-loss), so the
    gradients autograd gives each rank through the collectives' adjoints
    are those of the whole loss. Returns (share, {"loss", "ce", "aux", "z"}
    the whole batch's values, detached)."""
    ctx = active()
    lay = layout(ctx)
    logits, aux = forward_train(params, cfg, batch,
                                capacity_factor=tcfg.capacity_factor,
                                remat=tcfg.remat)
    specs = param_specs(cfg, ctx.planner)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # a VLM's image positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    lse, lab = vocab_parallel_ce(logits, vocab_cut(cfg, specs), labels, ctx)
    valid = labels >= 0
    nll = lse - torch.where(valid, lab, torch.zeros_like(lse))
    n_valid = valid.sum().double()
    if lay.split:
        n_valid = D.all_reduce(n_valid, ctx, axis="data")
    n_valid = torch.clamp(n_valid, min=1.0).float()
    copies = _row_copies(ctx, lay)
    ce = torch.sum(nll * valid.float()) / n_valid / copies
    z = tcfg.z_loss * torch.sum(lse ** 2) / (lay.B * labels.shape[1]) / \
        copies
    a = aux["aux_loss"] / (ctx.data_size * ctx.model_size)
    share = ce + a + z
    parts = D.all_reduce(torch.stack([share, ce, a, z]).detach().double(),
                         ctx, axis="tokens").float()
    return share, {"loss": parts[0], "ce": parts[1], "aux": parts[2],
                   "z": parts[3], "counts": aux["counts"]}


def _leaf_specs(params, cfg: ArchConfig, ctx: DistContext) -> list:
    """The spec of each leaf of ``params`` in flatten order."""
    from repro_torch.core import tree as T
    specs = param_specs(cfg, ctx.planner)
    out = []
    for path in T.flatten(params)[0]:
        node = specs
        for k in path.split("/"):
            node = node[k]
        out.append(node)
    return out


def sum_grads(params, grads: list, cfg: ArchConfig, ctx: DistContext):
    """Each leaf's gradient summed over the ranks that hold a copy of it
    (the axes its spec does not cut: data, model or both), and the global
    gradient norm (each copy's square counted once). Returns (grads,
    gnorm)."""
    out, sq = [], []
    for g, spec in zip(grads, _leaf_specs(params, cfg, ctx)):
        on_d, on_m = _on(spec, "data"), _on(spec, "model")
        axis = None
        if not on_d and not on_m and ctx.data_size * ctx.model_size > 1:
            axis = "tokens"
        elif not on_d and ctx.data_size > 1:
            axis = "data"
        elif not on_m and ctx.model_size > 1:
            axis = "model"
        if axis is not None:
            g = D.all_reduce(g.float(), ctx, axis=axis).to(g.dtype)
        copies = (1 if on_d else ctx.data_size) * \
            (1 if on_m else ctx.model_size)
        sq.append(torch.sum(torch.square(g.float())).double() / copies)
        out.append(g)
    total = D.all_reduce(torch.stack(sq).sum(), ctx, axis="tokens")
    return out, torch.sqrt(total).float()
