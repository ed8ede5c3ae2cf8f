"""Norms, RoPE and GQA attention over the paged KV pool or dense KV rows.

Parameters are plain dicts of tensors in the reference's layout (weights
(in, out), bf16). Compute dtype is bf16 with float32 norm and softmax
accumulation, rounding where the reference rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
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


#: Longest prefill the plain attention takes: the reference switches to a
#: q-chunked scan above it (``_sdpa_chunked``), which is not ported.
PREFILL_CHUNK_THRESHOLD = 2048


def attention_prefill(p: dict, cfg: AttnConfig, x: torch.Tensor,
                      cache: KVCache, lengths: torch.Tensor) -> torch.Tensor:
    """Causal prefill from position 0 into dense rows (full cache only).

    x (B, S, d); ``lengths`` (B,) true prompt lengths of a right-padded
    batch (0 = inert pad row). Slot i of row b takes the row's
    largest real position p < length with p % C == i; slots no real
    position maps to keep their contents (the reference's masked write, in
    place). Outputs at padded positions are garbage."""
    B, S, _ = x.shape
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window rings on dense rows are "
                                  "not ported")
    if S > PREFILL_CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"prefill of {S} > {PREFILL_CHUNK_THRESHOLD} tokens needs the "
            f"chunked attention, which the port does not have yet")
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    qpos, kpos = positions[:, :, None], positions[:, None, :]
    out = _sdpa(q, k, v, (kpos <= qpos).expand(B, S, S), cfg.n_heads)

    C = cache.capacity
    idx = torch.arange(C, device=x.device)[None, :]
    last = lengths[:, None] - 1 - torch.remainder(lengths[:, None] - 1 - idx,
                                                  C)                 # (B, C)
    keep = ((last >= 0) & (lengths[:, None] > 0))[:, None, :, None]
    src = torch.clamp(last, 0, S - 1)[:, None, :, None]
    for dst, new in ((cache.k, k), (cache.v, v)):
        hm = new.transpose(1, 2)                              # (B, Hkv, S, hd)
        g = torch.gather(hm, 2, src.expand(-1, hm.shape[1], -1, hm.shape[3]))
        dst.copy_(torch.where(keep, g, dst))
    return out @ p["wo"]


def attention_prefill_paged(p: dict, cfg: AttnConfig, x: torch.Tensor,
                            cache: PagedKVCache, table: torch.Tensor,
                            start: torch.Tensor, lengths: torch.Tensor
                            ) -> torch.Tensor:
    """Masked prefill of whole prompts (no cached prefix) into pool blocks.

    x (B, S, d) right-padded to the bucket S; ``lengths`` (B,) true prompt
    lengths (0 = inert pad row); ``start`` (B,) must be 0. Slot s of a row
    takes the row's largest real position p < length with p % C == s (ring
    wrap included); unowned lanes write to the trash block. The pool is
    updated in place. Outputs at padded positions are garbage."""
    B, S, _ = x.shape
    bt = cache.block_tokens
    C = table.shape[1] * bt
    positions = start[:, None] + torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)

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
    out = _sdpa(q, k, v, mask, cfg.n_heads)
    return out @ p["wo"]


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
