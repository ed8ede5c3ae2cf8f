"""Norms, RoPE and GQA attention over the paged KV pool or dense KV rows;
the full-sequence attention of encoder layers and the cross-attention of
encoder-decoder stacks.

Parameters are plain dicts of tensors in the reference's layout (weights
(in, out), bf16). Compute dtype is bf16 with float32 norm and softmax
accumulation, rounding where the reference rounds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import dist as D
from repro_torch.models.config import AttnConfig


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Split-half rotary embedding. x (..., S, H, hd); positions
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # A device-side fill, not ``torch.tensor``: no host→device copy, so
    # the decode step can be captured in a CUDA graph.
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    angles = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class KVCache(NamedTuple):
    """Dense KV rows of one layer, head-major (B, Hkv, C, hd) as the
    reference lays them out: row b's slot i holds position i (full cache,
    ``C`` = the engine's ``max_len``)."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_kv_cache(lead: tuple, capacity: int, cfg: AttnConfig,
                  device) -> KVCache:
    """Zeroed rows (*lead, Hkv, capacity, hd) bf16, e.g. ``lead`` = (B,)
    for one layer or (nsb, B) for a stack."""
    shape = tuple(lead) + (cfg.n_kv_heads, capacity, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))


class PagedKVCache(NamedTuple):
    """Physical KV block pool of one layer, (N, Hkv, bt, hd): ``N`` blocks
    of ``bt`` positions shared by every request through block tables
    ((nb,) int32 rows, -1 = unallocated). Block 0 is the trash block."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def block_tokens(self) -> int:
        return self.k.shape[2]


def paged_view(cache: PagedKVCache, table: torch.Tensor):
    """Gather-by-block-table: (B, nb) → (B, Hkv, nb·bt, hd) logical K/V."""
    B, nb = table.shape
    idx = torch.clamp(table.long(), min=0)
    k, v = cache.k[idx], cache.v[idx]                  # (B, nb, Hkv, bt, hd)
    Hkv, bt, hd = k.shape[2], k.shape[3], k.shape[4]
    k = k.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bt, hd)
    v = v.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bt, hd)
    return k, v


def _project_qkv(p: dict, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """qk_norm (when configured) before rope, as the reference orders it."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_heads: int) -> torch.Tensor:
    """Grouped GQA attention for prefill. q (B, Sq, H, hd); k, v
    (B, Skv, Hkv, hd); mask (B, Sq, Skv) bool. Logits are bf16 products
    widened to float32, masked with -1e30, softmax in float32, probs in
    bf16 — the reference's arithmetic."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    rep = n_heads // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, hd).permute(0, 2, 3, 1, 4)  # b g r q d
    kg = k.permute(0, 2, 3, 1)[:, :, None]                       # b g 1 d k
    logits = torch.matmul(qg, kg).float() * hd ** -0.5           # b g r q k
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    vg = v.permute(0, 2, 1, 3)[:, :, None]                       # b g 1 k d
    out = torch.matmul(probs, vg)                                # b g r q d
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * hd)


def _sdpa_chunked(q, k, v, n_heads: int, sliding_window, chunk: int
                  ) -> torch.Tensor:
    """Causal attention as a loop over query chunks (the reference's
    ``_sdpa_chunked``): each chunk's logits over every key, (B, Hkv, rep,
    chunk, S), never the whole (S, S). q (B, S, H, hd), k/v (B, S, Hkv,
    hd), S a multiple of ``chunk``; the window keeps ``kpos > qpos -
    window``. The same arithmetic as ``_sdpa`` per chunk."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = n_heads // Hkv
    kpos = torch.arange(S, device=q.device)
    kg = k.permute(0, 2, 3, 1)[:, :, None]                       # b g 1 d k
    vg = v.permute(0, 2, 1, 3)[:, :, None]                       # b g 1 k d
    outs = []
    for i in range(S // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk].reshape(
            B, chunk, Hkv, rep, hd).permute(0, 2, 3, 1, 4)       # b g r q d
        logits = torch.matmul(qi, kg).float() * hd ** -0.5       # b g r q k
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if sliding_window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.matmul(probs, vg))                     # b g r q d
    out = torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


#: Prefills longer than this whose length is a multiple of
#: ``PREFILL_CHUNK`` run the q-chunked attention (the reference's rule);
#: every other length runs the whole masked attention.
PREFILL_CHUNK_THRESHOLD = 2048
PREFILL_CHUNK = 256


#: Calls of ``attention_full`` that ran sequence-parallel
#: (``_seq_parallel_constraint``), counted as ``moe.REGIMES`` counts the
#: MoE layer's regimes.
SEQ_PARALLEL = {"attention_full": 0}


def _seq_parallel_constraint(q: torch.Tensor, n_heads: int):
    """Sequence parallelism for stacks whose head count does not divide
    the model axis (24, 56 or 6 heads against 16; the reference's
    ``_seq_parallel_constraint``): the attention weights stay replicated
    and model rank j computes every head for query positions ``[j·S/N,
    (j+1)·S/N)`` against the whole K/V; under ``tokens_dp_sharded`` data
    rank i also takes rows ``[i·B/dp, (i+1)·B/dp)`` when they divide.
    Returns (context, row slice, query slice, whether the rows split), or
    None where it does not apply: no context, heads that divide, or S not
    divisible by the model axis."""
    ctx = D.get_dist()
    if ctx is None or n_heads % ctx.model_size == 0:
        return None
    B, S = q.shape[:2]
    if S % ctx.model_size:
        return None
    rows = ctx.tokens_dp_sharded and ctx.data_size > 1 and \
        B % ctx.data_size == 0
    bsl = D.shard_range(B, ctx, "data") if rows else slice(0, B)
    return ctx, bsl, D.shard_range(S, ctx, "model"), rows


def _attention_seq_parallel(p: dict, cfg: AttnConfig, q, k, v, positions,
                            causal: bool, plan) -> torch.Tensor:
    """``attention_full``'s output computed on this rank's rows and query
    positions (``plan`` from ``_seq_parallel_constraint``), then gathered
    over the model axis along S and over the data axis along B: the whole
    (B, S, d) on every rank. Every length runs the masked attention (a
    rank's queries against every key), which gives each query row what
    the single device's masked or chunked attention gives it."""
    ctx, bsl, ssl, rows = plan
    S = q.shape[1]
    q, k, v = q[bsl, ssl], k[bsl], v[bsl]
    if positions.shape[0] != 1:
        positions = positions[bsl]
    if causal:
        qpos, kpos = positions[..., ssl, None], positions[..., None, :]
        mask = kpos <= qpos
        if cfg.sliding_window is not None:
            mask = mask & (kpos > qpos - cfg.sliding_window)
    else:
        mask = torch.ones((1, q.shape[1], S), dtype=torch.bool,
                          device=q.device)
    out = _sdpa(q, k, v, mask.expand(q.shape[0], q.shape[1], S),
                cfg.n_heads) @ p["wo"]
    SEQ_PARALLEL["attention_full"] += 1
    out = D.all_gather(out, ctx, axis="model", dim=1)
    return D.all_gather(out, ctx, axis="data") if rows else out


def _causal_attention(q, k, v, cfg: AttnConfig, positions
                      ) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k/v (B, S, Hkv, hd) at
    ``positions`` (the reference's arithmetic): past
    ``PREFILL_CHUNK_THRESHOLD`` tokens, at a multiple of ``PREFILL_CHUNK``,
    chunk by chunk; else the whole masked attention. A window masks keys
    more than ``window - 1`` positions back. ``cfg.n_heads`` is q's heads
    (a rank's, under tensor parallelism)."""
    B, S = q.shape[:2]
    if S > PREFILL_CHUNK_THRESHOLD and S % PREFILL_CHUNK == 0:
        return _sdpa_chunked(q, k, v, cfg.n_heads, cfg.sliding_window,
                             PREFILL_CHUNK)
    qpos, kpos = positions[..., :, None], positions[..., None, :]
    mask = kpos <= qpos
    if cfg.sliding_window is not None:
        mask = mask & (kpos > qpos - cfg.sliding_window)
    return _sdpa(q, k, v, mask.expand(B, S, S), cfg.n_heads)


def attention_full(p: dict, cfg: AttnConfig, x: torch.Tensor,
                   causal: bool = True,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over a whole sequence, no cache (the reference's
    ``attention_full``): x (B, S, d), rope at ``positions`` (default 0 ..
    S-1). ``causal``: each query sees the keys at or before it (and within
    the window); past ``PREFILL_CHUNK_THRESHOLD`` tokens, at a multiple of
    ``PREFILL_CHUNK``, chunk by chunk. ``causal=False`` (an encoder): every
    key. Under a distribution context whose model axis does not divide
    the heads, sequence-parallel (``_seq_parallel_constraint``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    plan = _seq_parallel_constraint(q, cfg.n_heads)
    if plan is not None:
        return _attention_seq_parallel(p, cfg, q, k, v, positions, causal,
                                       plan)
    if causal:
        return _causal_attention(q, k, v, cfg, positions) @ p["wo"]
    mask = torch.ones((1, S, S), dtype=torch.bool, device=x.device)
    return _sdpa(q, k, v, mask.expand(B, S, S), cfg.n_heads) @ p["wo"]


def _write_prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, C: int, lo: int = 0) -> None:
    """A prefill's masked write of k/v (B, S, Hkv, hd) into ``cache``,
    whose slots are ``[lo, lo + cache.capacity)`` of capacity-``C`` rows
    (a rank's cut of the sequence; the whole row where ``lo`` = 0 and C is
    the cache's own): slot i of row b takes the row's largest real
    position p < length with p % C == i; slots no real position maps to
    keep their contents."""
    S = k.shape[1]
    idx = torch.arange(lo, lo + cache.capacity, device=k.device)[None, :]
    last = lengths[:, None] - 1 - torch.remainder(lengths[:, None] - 1 - idx,
                                                  C)                 # (B, C)
    keep = ((last >= 0) & (lengths[:, None] > 0))[:, None, :, None]
    src = torch.clamp(last, 0, S - 1)[:, None, :, None]
    for dst, new in ((cache.k, k), (cache.v, v)):
        hm = new.transpose(1, 2)                              # (B, Hkv, S, hd)
        g = torch.gather(hm, 2, src.expand(-1, hm.shape[1], -1, hm.shape[3]))
        dst.copy_(torch.where(keep, g, dst))


def attention_prefill(p: dict, cfg: AttnConfig, x: torch.Tensor,
                      cache: KVCache, lengths: torch.Tensor) -> torch.Tensor:
    """Causal prefill from position 0 into dense rows: a full cache, or a
    sliding-window ring (capacity ``min(max_len, window)``, which may be
    shorter than the bucket).

    x (B, S, d); ``lengths`` (B,) true prompt lengths of a right-padded
    batch (0 = inert pad row). Slot i of row b takes the row's
    largest real position p < length with p % C == i (a ring keeps each
    row's last C real positions); slots no real position maps to keep
    their contents (the reference's masked write, in place). A window
    masks keys more than ``window - 1`` positions back. Past
    ``PREFILL_CHUNK_THRESHOLD`` tokens, at a multiple of ``PREFILL_CHUNK``,
    the attention runs chunk by chunk (``_sdpa_chunked``). Outputs at
    padded positions are garbage."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _causal_attention(q, k, v, cfg, positions)
    _write_prefill(cache, k, v, lengths, cache.capacity)
    return out @ p["wo"]


def attention_prefill_paged(p: dict, cfg: AttnConfig, x: torch.Tensor,
                            cache: PagedKVCache, table: torch.Tensor,
                            start: torch.Tensor, lengths: torch.Tensor,
                            has_prefix: bool = False) -> torch.Tensor:
    """Masked prefill of prompt SUFFIXES into pool blocks.

    x (B, S, d): embeds of tokens ``start[b] .. lengths[b]-1`` right-padded
    to the bucket S; ``start`` (B,) prefix-hit offsets (0 = whole prompt);
    ``lengths`` (B,) TOTAL prompt lengths (``lengths == start``: an inert
    pad row). For a prefix hit the leading entries of ``table`` alias
    blocks an earlier request wrote (any block this call writes was
    copied-on-write or freshly allocated by the engine first). Slot s of a
    row takes the row's largest real position p in [start, length) with
    p % C == s (ring wrap included); unowned lanes write to the trash
    block, so the shared prefix slots are never touched. With
    ``has_prefix`` the suffix queries also attend over the row's cached
    prefix K/V, gathered BEFORE the suffix scatter: the pool is updated in
    place here, where the reference (``attention_prefill_paged`` in
    ``repro.models.layers``) orders the gather ahead of the scatter by
    their data dependency inside one jit. Outputs at padded positions are
    garbage."""
    B, S, _ = x.shape
    bt = cache.block_tokens
    C = table.shape[1] * bt
    positions = start[:, None] + torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    if has_prefix:
        pk, pv = paged_view(cache, table)   # (B, Hkv, C, hd) copies

    idx = torch.arange(C, device=x.device)[None, :]
    last = lengths[:, None] - 1 - torch.remainder(lengths[:, None] - 1 - idx,
                                                  C)
    own = (last >= start[:, None]) & (lengths[:, None] > start[:, None])
    src = torch.clamp(last - start[:, None], 0, S - 1)              # (B, C)
    gk = torch.gather(k, 1, src[:, :, None, None].expand(-1, -1, k.shape[2],
                                                         k.shape[3]))
    gv = torch.gather(v, 1, src[:, :, None, None].expand(-1, -1, v.shape[2],
                                                         v.shape[3]))
    blk = torch.gather(table.long(), 1, (idx // bt).expand(B, C))
    phys = torch.where(own, torch.clamp(blk, min=0), torch.zeros_like(blk))
    offs = (idx % bt).expand(B, C)
    cache.k[phys, :, offs] = gk
    cache.v[phys, :, offs] = gv

    qpos = positions[:, :, None]
    kpos = positions[:, None, :]
    mask = (kpos <= qpos) & (kpos < lengths[:, None, None])
    if cfg.sliding_window is not None:
        mask = mask & (kpos > qpos - cfg.sliding_window)
    if not has_prefix:
        return _sdpa(q, k, v, mask, cfg.n_heads) @ p["wo"]
    # Slot s of the pre-write view holds prefix position p_s = the largest
    # p < start with p % C == s (ring and full alike).
    ppos = start[:, None] - 1 - torch.remainder(start[:, None] - 1 - idx, C)
    pmask = (ppos >= 0)[:, None, :].expand(B, S, C)
    if cfg.sliding_window is not None:
        pmask = pmask & (ppos[:, None, :] > qpos - cfg.sliding_window)
    k_cat = torch.cat([pk.transpose(1, 2), k], dim=1)
    v_cat = torch.cat([pv.transpose(1, 2), v], dim=1)
    mask = torch.cat([pmask, mask.expand(B, S, S)], dim=-1)
    return _sdpa(q, k_cat, v_cat, mask, cfg.n_heads) @ p["wo"]


def decode_valid(pos_b: torch.Tensor, C: int, cfg: AttnConfig) -> torch.Tensor:
    """(B, C) slots each row may attend after writing position ``pos_b``:
    slot i holds the largest position p <= pos with p % C == i."""
    idx = torch.arange(C, device=pos_b.device)[None, :]
    if cfg.sliding_window is None:
        return idx <= pos_b[:, None]
    slot_pos = pos_b[:, None] - torch.remainder(pos_b[:, None] - idx, C)
    return (slot_pos >= 0) & (slot_pos > pos_b[:, None] - cfg.sliding_window)


def attention_decode_paged(p: dict, cfg: AttnConfig, x: torch.Tensor,
                           pos: torch.Tensor, cache: PagedKVCache,
                           table: torch.Tensor, write_blk: torch.Tensor,
                           write_off: torch.Tensor) -> torch.Tensor:
    """One-token decode against the paged pool. ``table`` (B, nb);
    ``write_blk``/``write_off`` (B,) each row's physical write target
    (vacant rows point at the trash block). Writes K/V in place, then
    attends through the ``flash_decode_paged`` kernel."""
    B = x.shape[0]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    q, k, v = _project_qkv(p, cfg, x, pos_b[:, None])
    wb, wo = write_blk.long(), write_off.long()
    cache.k[wb, :, wo] = k[:, 0]
    cache.v[wb, :, wo] = v[:, 0]
    valid = decode_valid(pos_b, table.shape[1] * cache.block_tokens, cfg)
    out = kops.flash_decode_paged(q[:, 0].contiguous(), cache.k, cache.v,
                                  table, valid)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


def attention_decode(p: dict, cfg: AttnConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One-token decode against dense rows. ``pos`` scalar or (B,). Writes
    each row's new K/V in place at slot ``pos % C`` (where the reference
    builds a new cache with a full-cache ``where``), then attends through
    the ``flash_decode`` kernel over the cache seen as (B, C, Hkv, hd)
    without a copy."""
    B = x.shape[0]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    q, k, v = _project_qkv(p, cfg, x, pos_b[:, None])
    C = cache.capacity
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(pos_b, C).long()
    cache.k[rows, :, slot] = k[:, 0]
    cache.v[rows, :, slot] = v[:, 0]
    valid = decode_valid(pos_b, C, cfg)
    out = kops.flash_decode(q[:, 0].contiguous(), cache.k.transpose(1, 2),
                            cache.v.transpose(1, 2), valid)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


# --------------------------------------------------------------------------
# Cross-attention (encoder-decoder): the decoder's queries over the
# encoder's K/V, computed once per prefill. Neither side takes rope.
# --------------------------------------------------------------------------


class CrossKV(NamedTuple):
    """Every decoder layer's cross K/V, (nsb, B, Senc, Hkv, hd) bf16: the
    reference's ``{"k", "v"}`` (every encoder frame is valid: the decode
    step's kernel reads an all-true mask, ``cross_valid``)."""
    k: torch.Tensor
    v: torch.Tensor


def cross_valid(enc_k: torch.Tensor) -> torch.Tensor:
    """The all-true (B, Senc) mask of cross K/V ``enc_k`` (B, Senc, Hkv,
    hd): a device-side fill, which a CUDA graph can capture."""
    return torch.ones(enc_k.shape[:2], dtype=torch.bool, device=enc_k.device)


def encode_cross_kv(p: dict, cfg: AttnConfig, enc_out: torch.Tensor):
    """enc_out (B, Senc, d) → K, V (B, Senc, Hkv, hd); k-norm on K when
    configured."""
    B, Senc, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, Senc, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, Senc, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k)
    return k, v


def cross_attention(p: dict, cfg: AttnConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, Sq, d) over ``enc_k``/``enc_v`` (B, Senc, Hkv, hd); q-norm on
    q when configured. Without ``valid`` (prefill) the plain masked
    attention over every frame, as the reference computes it; with
    ``valid`` ((B, Senc) bool; Sq = 1: the decode step) the dense
    decode-attention kernel ``flash_decode`` over the layer's view."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    if valid is None:
        mask = torch.ones((B, Sq, enc_k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, enc_k, enc_v, mask, cfg.n_heads)
    else:
        out = kops.flash_decode(q[:, 0].contiguous(), enc_k, enc_v, valid
                                ).reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]
