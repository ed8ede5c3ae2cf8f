"""Decoder-only attention + MoE model over the paged KV pool or dense KV
rows.

Parameters keep the reference's tree: per super-block position a dict of
leaves stacked over layers (leading ``nsb`` axis). The reference's
``lax.scan`` over that axis becomes a Python loop over per-layer views.

Entry points:

* ``init_params``        — random weights from a seeded ``torch.Generator``;
* ``init_paged_caches``  — the shared (nsb, N, Hkv, bt, hd) block pools;
* ``prefill_paged``      — masked, bucketed prefill of whole prompts;
* ``decode_step_paged``  — one token per row (the serving hot path);
* ``init_caches``        — dense (nsb, B, Hkv, C, hd) KV rows;
* ``prefill`` / ``decode_step`` — the same over dense rows.

Every MoE layer runs through its mixed-precision bank (``bank``: MoE
position → stacked ``ExpertBankQ``), or with ``bank=None`` through the
dense bf16 experts in ``params`` (the fp16 and offload backends), with the
token layout ``moe_dispatch`` names ("ragged", the default, or "padded";
either KV layout takes either) and returns its router counts — the
hotness signal.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as X
from repro_torch.models.config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    if cfg.superblock_or_default() != ("attn",) or cfg.attn is None \
            or cfg.moe is None or cfg.d_ff or cfg.attn.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: the port serves full-attention MoE stacks only")


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters in the reference's layout and scales (normal ·
    fan_in^-1/2 in bf16, router float32, embedding · 0.02, norms ones),
    drawn from ``generator`` or a generator seeded with ``seed`` on the
    target device. Large leaves are drawn one layer at a time so the
    float32 scratch stays one layer's worth at full width."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    gdev = gen.device

    def normal(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=gdev) * scale
                ).to(dtype).to(dev)

    def stacked(shape, scale, dtype=torch.bfloat16):
        out = torch.empty((nsb,) + shape, dtype=dtype, device=dev)
        for l in range(nsb):
            out[l] = normal(shape, scale, dtype)
        return out

    d, a, m = cfg.d_model, cfg.attn, cfg.moe
    nsb = cfg.n_superblocks()
    ones = lambda n: torch.ones((nsb, n), dtype=torch.bfloat16, device=dev)
    attn = {"wq": stacked((d, a.q_dim), d ** -0.5),
            "wk": stacked((d, a.kv_dim), d ** -0.5),
            "wv": stacked((d, a.kv_dim), d ** -0.5),
            "wo": stacked((a.q_dim, d), a.q_dim ** -0.5)}
    if a.qk_norm:
        attn["q_norm"] = {"scale": ones(a.head_dim)}
        attn["k_norm"] = {"scale": ones(a.head_dim)}
    E, f = m.num_experts, m.d_ff_expert
    # The reference draws expert stacks (E, K, N) with fan_in = E.
    experts = {"w_gate": stacked((E, d, f), E ** -0.5),
               "w_up": stacked((E, d, f), E ** -0.5),
               "w_down": stacked((E, f, d), E ** -0.5)}
    moe = {"router": stacked((d, E), d ** -0.5, torch.float32),
           "experts": experts}
    if m.n_shared_experts:
        # The reference's init_swiglu: (d, F_sh), (d, F_sh), (F_sh, d) per
        # layer, scaled by each matrix's fan_in^-1/2.
        fs = m.d_ff_shared * m.n_shared_experts
        moe["shared"] = {"w_gate": stacked((d, fs), d ** -0.5),
                         "w_up": stacked((d, fs), d ** -0.5),
                         "w_down": stacked((fs, d), fs ** -0.5)}
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": torch.ones((d,), dtype=torch.bfloat16,
                                           device=dev)},
        "blocks": {"0": {
            "norm1": {"scale": ones(d)}, "norm2": {"scale": ones(d)},
            "attn": attn, "moe": moe}},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def init_paged_caches(cfg: ArchConfig, n_blocks: int, block_tokens: int,
                      device=None) -> Dict[str, L.PagedKVCache]:
    """One shared block pool per attention position, (nsb, N, Hkv, bt, hd)
    bf16 K and V."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_superblocks(), n_blocks, cfg.attn.n_kv_heads,
             block_tokens, cfg.attn.head_dim)
    return {"0": L.PagedKVCache(
        torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        torch.zeros(shape, dtype=torch.bfloat16, device=dev))}


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device=None) -> Dict[str, L.KVCache]:
    """Dense KV rows per attention position, (nsb, B, Hkv, max_len, hd)
    bf16 K and V (full attention: slot = position)."""
    _check_family(cfg)
    dev = resolve_device(device)
    return {"0": L.init_kv_cache((cfg.n_superblocks(), batch), max_len,
                                 cfg.attn, dev)}


def _layer(tree, l: int):
    """Per-layer views of a stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items() if v is not None}
    return tree[l]


def _block_step(bp: Dict, cfg: ArchConfig, x: torch.Tensor, cache,
                pos_idx, capacity: int, bank, prefill: bool,
                paged: Optional[Dict] = None, lengths=None, token_valid=None,
                n_rows=None, moe_dispatch=None):
    """One attention + MoE layer. x (B, S, d); ``cache`` a ``PagedKVCache``
    with ``paged`` holding the block tables and write targets, or dense
    ``KVCache`` rows with ``paged`` None. Returns (x, counts) with counts
    (E,) or (n_rows, E)."""
    B, S, d = x.shape
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if paged is not None and prefill:
        attn_out = L.attention_prefill_paged(
            bp["attn"], cfg.attn, h, cache, paged["table"], paged["start"],
            paged["lengths"])
    elif paged is not None:
        attn_out = L.attention_decode_paged(
            bp["attn"], cfg.attn, h, pos_idx, cache, paged["table"],
            paged["write_blk"], paged["write_off"])
    elif prefill:
        attn_out = L.attention_prefill(bp["attn"], cfg.attn, h, cache,
                                       lengths)
    else:
        attn_out = L.attention_decode(bp["attn"], cfg.attn, h, pos_idx,
                                      cache)
    x = x + attn_out
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    y, aux = X.moe_apply(bp["moe"], bank, h.reshape(B * S, d), cfg.moe,
                         capacity, token_valid=token_valid, n_rows=n_rows,
                         dispatch=moe_dispatch)
    counts = aux.row_counts if n_rows is not None else aux.counts
    return x + y.reshape(B, S, d), counts


def _run_layers(params, cfg, x, caches, bank, **kw):
    """The layer loop (the reference's scan): per-layer views of the
    stacked parameters, caches and bank; with ``bank=None`` each layer's
    experts come from ``params`` (the reference's rule). Returns (x, {pos:
    stacked counts})."""
    bp_all, cache = params["blocks"]["0"], caches["0"]
    if bank is None and bp_all["moe"].get("experts") is None:
        raise ValueError("bank=None serves the dense experts in params, "
                         "but a backend has dropped them: pass its banks")
    counts = []
    for l in range(cfg.n_superblocks()):
        bp = _layer(bp_all, l)
        x, c = _block_step(bp, cfg, x, type(cache)(cache.k[l], cache.v[l]),
                           bank=bp["moe"]["experts"] if bank is None
                           else bank["0"].layer(l), **kw)
        counts.append(c)
    return x, {"0": torch.stack(counts)}


def _lm_logits(params: Dict, cfg: ArchConfig, x: torch.Tensor):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def prefill_paged(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                  caches: Dict, block_table: torch.Tensor,
                  start: torch.Tensor, lengths: torch.Tensor, bank=None,
                  capacity_factor: Optional[float] = None,
                  per_row_counts: bool = False,
                  moe_dispatch: Optional[str] = None):
    """Masked prefill of whole prompts into the paged pool (updated in
    place). ``tokens`` (R, S) right-padded to the bucket S; ``lengths``
    (R,) prompt lengths (0 = inert pad row); ``start`` (R,) zeros.
    Returns (last-token logits (R, V) float32, counts {pos: (nsb, R, E) or
    (nsb, E)})."""
    _check_family(cfg)
    x = params["embed"][tokens]
    R, S, _ = x.shape
    start = start.to(torch.int64)
    lengths = lengths.to(torch.int64)
    suffix = lengths - start
    token_valid = (torch.arange(S, device=x.device)[None, :] <
                   suffix[:, None]).reshape(-1)
    cap = X.moe_capacity(R * S, cfg.moe, capacity_factor)
    paged = {"table": block_table, "start": start, "lengths": lengths}
    x, counts = _run_layers(params, cfg, x, caches, bank, capacity=cap,
                            pos_idx=None, prefill=True, paged=paged,
                            token_valid=token_valid,
                            n_rows=R if per_row_counts else None,
                            moe_dispatch=moe_dispatch)
    last = torch.clamp(suffix - 1, 0, S - 1)
    x_last = x[torch.arange(R, device=x.device), last][:, None, :]
    return _lm_logits(params, cfg, x_last)[:, 0], counts


def decode_step_paged(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                      pos_idx: torch.Tensor, caches: Dict,
                      block_table: torch.Tensor, write_blk: torch.Tensor,
                      write_off: torch.Tensor, bank=None,
                      capacity_factor: float = 2.0,
                      row_valid: Optional[torch.Tensor] = None,
                      per_row_counts: bool = False,
                      moe_dispatch: Optional[str] = None):
    """One token per row against the paged pool. ``token``/``pos_idx``
    (B,); ``write_blk``/``write_off`` (B,) pre-resolved write targets;
    ``row_valid`` (B,) masks vacant rows out of dispatch and counts.
    Returns (logits (B, V) float32, counts)."""
    _check_family(cfg)
    x = params["embed"][token][:, None, :]
    B = x.shape[0]
    cap = X.moe_capacity(B, cfg.moe, capacity_factor)
    paged = {"table": block_table, "write_blk": write_blk,
             "write_off": write_off}
    x, counts = _run_layers(params, cfg, x, caches, bank, capacity=cap,
                            pos_idx=pos_idx, prefill=False, paged=paged,
                            token_valid=row_valid,
                            n_rows=B if per_row_counts else None,
                            moe_dispatch=moe_dispatch)
    return _lm_logits(params, cfg, x)[:, 0], counts


def prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            caches: Dict, lengths: torch.Tensor, bank=None,
            capacity_factor: Optional[float] = None,
            per_row_counts: bool = False,
            moe_dispatch: Optional[str] = None):
    """Masked prefill from position 0 into dense rows (updated in place).
    ``tokens`` (B, S) right-padded; ``lengths`` (B,) prompt lengths (0 =
    inert pad row). Returns (last-token logits (B, V) float32, counts
    {pos: (nsb, B, E) or (nsb, E)})."""
    _check_family(cfg)
    x = params["embed"][tokens]
    B, S, _ = x.shape
    lengths = lengths.to(torch.int64)
    token_valid = (torch.arange(S, device=x.device)[None, :] <
                   lengths[:, None]).reshape(-1)
    cap = X.moe_capacity(B * S, cfg.moe, capacity_factor)
    x, counts = _run_layers(params, cfg, x, caches, bank, capacity=cap,
                            pos_idx=None, prefill=True, lengths=lengths,
                            token_valid=token_valid,
                            n_rows=B if per_row_counts else None,
                            moe_dispatch=moe_dispatch)
    last = torch.clamp(lengths - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return _lm_logits(params, cfg, x_last)[:, 0], counts


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                pos_idx: torch.Tensor, caches: Dict, bank=None,
                capacity_factor: float = 2.0,
                row_valid: Optional[torch.Tensor] = None,
                per_row_counts: bool = False,
                moe_dispatch: Optional[str] = None):
    """One token per row against dense rows, written in place at slot
    ``pos % C``. ``token``/``pos_idx`` (B,); ``row_valid`` (B,) masks
    vacant rows out of dispatch and counts. Returns (logits (B, V)
    float32, counts)."""
    _check_family(cfg)
    x = params["embed"][token][:, None, :]
    B = x.shape[0]
    cap = X.moe_capacity(B, cfg.moe, capacity_factor)
    x, counts = _run_layers(params, cfg, x, caches, bank, capacity=cap,
                            pos_idx=pos_idx, prefill=False,
                            token_valid=row_valid,
                            n_rows=B if per_row_counts else None,
                            moe_dispatch=moe_dispatch)
    return _lm_logits(params, cfg, x)[:, 0], counts
