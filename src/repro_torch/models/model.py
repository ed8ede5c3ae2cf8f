"""Decoder-only stacks over the paged KV pool or dense KV rows: attention
+ MoE stacks, hybrid Mamba/attention stacks of repeating super-blocks
(e.g. Jamba: seven Mamba-2 layers then one attention layer, MoE FFNs on
the odd positions and dense SwiGLU FFNs on the even ones), dense
attention stacks (a SwiGLU FFN at every layer) and pure Mamba-2 stacks
(no attention, no FFN where ``d_ff`` is 0).

Parameters keep the reference's tree: per super-block position a dict of
leaves stacked over super-blocks (leading ``nsb`` axis). The reference's
``lax.scan`` over that axis becomes a Python loop over per-layer views.

Entry points:

* ``init_params``        — random weights from a seeded ``torch.Generator``;
* ``init_paged_caches``  — the shared (nsb, N, Hkv, bt, hd) block pools of
                           the attention positions, and per-slot Mamba
                           rows (nsb, B, ...) of the Mamba positions;
* ``prefill_paged``      — masked, bucketed prefill of prompt suffixes
                           (whole prompts, or over cached prefix blocks);
* ``decode_step_paged``  — one token per row (the serving hot path);
* ``init_caches``        — dense (nsb, B, Hkv, C, hd) KV rows (C =
                           ``max_len``, or the sliding window's ring) and
                           the Mamba rows;
* ``prefill`` / ``decode_step`` — the same over dense rows;
* ``spec_draft`` / ``spec_verify`` — S chained decode steps (paged or
                           dense): the draft and verify of self-speculative
                           decoding (the verify also returns each step's
                           Mamba rows).

Every MoE layer runs through its mixed-precision bank (``bank``: MoE
position → stacked ``ExpertBankQ``), or with ``bank=None`` through the
dense bf16 experts in ``params`` (the fp16 and offload backends), with the
token layout ``moe_dispatch`` names ("ragged", the default, or "padded";
either KV layout takes either) and returns its router counts — the
hotness signal. A Mamba layer's prefill writes its final state into the
caches given (the engine hands it fresh rows and copies them into the
admitted slots); its decode step updates the rows in place, only where
``row_valid`` holds.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import moe as X
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig

#: Where the encoder-decoder and VLM families stand.
ENC_DEC_VLM_ITEM = "ROADMAP Queue 1 item 8 (e)"


def _check_family(cfg: ArchConfig) -> None:
    """Decoder-only stacks of ``attn``/``mamba`` positions: MoE and hybrid
    stacks, dense attention stacks (``cfg.moe is None``: a SwiGLU FFN at
    every position) and pure Mamba-2 stacks (no attention position; no
    FFN where ``d_ff`` is 0). Encoder-decoder and VLM stacks are not
    ported."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family (encoder-decoder or VLM "
            f"frontend) is not ported ({ENC_DEC_VLM_ITEM})")
    sb = cfg.superblock_or_default()
    if any(k not in ("attn", "mamba") for k in sb) \
            or ("attn" in sb and cfg.attn is None) \
            or ("mamba" in sb and cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name}: super-block {sb} is not a stack of attention "
            f"and Mamba positions with their configurations")


def attn_positions(cfg: ArchConfig):
    return [str(p) for p, k in enumerate(cfg.superblock_or_default())
            if k == "attn"]


def mamba_positions(cfg: ArchConfig):
    return [str(p) for p, k in enumerate(cfg.superblock_or_default())
            if k == "mamba"]


def attn_logical_capacity(cfg: ArchConfig, max_len: int,
                          block_tokens: int) -> int:
    """Per-sequence logical KV capacity under paging: the dense capacity
    (``max_len``, or the sliding window) rounded up to whole blocks. The
    extra slots are never valid, so attention matches the dense rows."""
    return -(-attn_capacity(cfg, max_len) // block_tokens) * block_tokens


def attn_capacity(cfg: ArchConfig, max_len: int) -> int:
    """Dense KV row capacity: ``max_len``, or the sliding window's ring
    when it is shorter (0 on a stack without attention)."""
    if cfg.attn is None:
        return 0
    w = cfg.attn.sliding_window
    return max_len if w is None else min(max_len, w)


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters in the reference's layout and scales (normal ·
    fan_in^-1/2 in bf16, router float32, embedding · 0.02, norms ones,
    the Mamba layers' A_log/dt_bias/D as the reference sets them), drawn
    from ``generator`` or a generator seeded with ``seed`` on the target
    device, position by position. Large leaves are drawn one layer at a
    time so the float32 scratch stays one layer's worth at full width."""
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

    def attention():
        p = {"wq": stacked((d, a.q_dim), d ** -0.5),
             "wk": stacked((d, a.kv_dim), d ** -0.5),
             "wv": stacked((d, a.kv_dim), d ** -0.5),
             "wo": stacked((a.q_dim, d), a.q_dim ** -0.5)}
        if a.qk_norm:
            p["q_norm"] = {"scale": ones(a.head_dim)}
            p["k_norm"] = {"scale": ones(a.head_dim)}
        return p

    def moe():
        E, f = m.num_experts, m.d_ff_expert
        # The reference draws expert stacks (E, K, N) with fan_in = E.
        experts = {"w_gate": stacked((E, d, f), E ** -0.5),
                   "w_up": stacked((E, d, f), E ** -0.5),
                   "w_down": stacked((E, f, d), E ** -0.5)}
        p = {"router": stacked((d, E), d ** -0.5, torch.float32),
             "experts": experts}
        if m.n_shared_experts:
            p["shared"] = M.init_swiglu(stacked, d,
                                        m.d_ff_shared * m.n_shared_experts)
        return p

    blocks = {}
    for pos, kind in enumerate(cfg.superblock_or_default()):
        bp = {"norm1": {"scale": ones(d)}, "norm2": {"scale": ones(d)}}
        if kind == "attn":
            bp["attn"] = attention()
        else:
            bp["mamba"] = SSM.init_mamba(stacked, d, cfg.ssm, (nsb,), dev)
        if cfg.ffn_kind(pos) == "moe":
            bp["moe"] = moe()
        elif cfg.d_ff:
            bp["mlp"] = M.init_swiglu(stacked, d, cfg.d_ff)
        blocks[str(pos)] = bp
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": torch.ones((d,), dtype=torch.bfloat16,
                                           device=dev)},
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def init_mamba_rows(cfg: ArchConfig, batch: Optional[int], device=None
                    ) -> Dict:
    """Per-slot Mamba rows of every Mamba position, (nsb, batch, ...), each
    from a zero state ({} on a stack without Mamba positions)."""
    dev = resolve_device(device)
    pos = mamba_positions(cfg)
    if pos and batch is None:
        raise ValueError(f"{cfg.name} has Mamba positions: its caches need "
                         f"the batch (slots)")
    return {p: SSM.init_mamba_cache((cfg.n_superblocks(), batch),
                                    cfg.d_model, cfg.ssm, dev) for p in pos}


def init_paged_caches(cfg: ArchConfig, n_blocks: int, block_tokens: int,
                      device=None, batch: Optional[int] = None) -> Dict:
    """One shared block pool per attention position, (nsb, N, Hkv, bt, hd)
    bf16 K and V; per-slot rows of ``batch`` slots per Mamba position
    (recurrent state is O(1) per slot: paging it buys nothing). A stack
    without attention positions gets no pool."""
    _check_family(cfg)
    dev = resolve_device(device)
    caches = {}
    for p in attn_positions(cfg):
        shape = (cfg.n_superblocks(), n_blocks, cfg.attn.n_kv_heads,
                 block_tokens, cfg.attn.head_dim)
        caches[p] = L.PagedKVCache(
            torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            torch.zeros(shape, dtype=torch.bfloat16, device=dev))
    caches.update(init_mamba_rows(cfg, batch, dev))
    return caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device=None) -> Dict:
    """Dense rows: KV (nsb, B, Hkv, C, hd) bf16 per attention position (C
    = ``max_len``, or the sliding window's ring: slot = position % C), and
    the Mamba rows per Mamba position."""
    _check_family(cfg)
    dev = resolve_device(device)
    C = attn_capacity(cfg, max_len)
    caches = {p: L.init_kv_cache((cfg.n_superblocks(), batch), C, cfg.attn,
                                 dev) for p in attn_positions(cfg)}
    caches.update(init_mamba_rows(cfg, batch, dev))
    return caches


def _layer(tree, l: int):
    """Per-layer views of a stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items() if v is not None}
    return tree[l]


def _block_step(bp: Dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
                cache, pos_idx, capacity: int, bank, prefill: bool,
                paged: Optional[Dict] = None, lengths=None, token_valid=None,
                n_rows=None, moe_dispatch=None, row_capacity=None):
    """One layer: attention (``kind`` "attn") or Mamba, then its FFN (MoE
    when ``bp`` has "moe", else the dense SwiGLU). x (B, S, d); an
    attention ``cache`` is a ``PagedKVCache`` with ``paged`` holding the
    block tables and write targets, or dense ``KVCache`` rows with
    ``paged`` None; a Mamba cache is the layer's ``MambaCache`` rows
    (prefill: ``lengths`` the rows' suffix lengths). ``row_capacity``: the
    per-row MoE drop rule over the B rows. Returns (x, counts) with counts
    (E,) or (n_rows, E), or None for a dense FFN."""
    B, S, d = x.shape
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if kind == "mamba" and prefill:
        mix, new = SSM.ssd_forward(bp["mamba"], cfg.ssm, d, h,
                                   lengths=lengths)
        cache.conv.copy_(new.conv)
        cache.state.copy_(new.state)
    elif kind == "mamba":
        mix = SSM.ssd_decode_step(bp["mamba"], cfg.ssm, d, h, cache,
                                  row_valid=token_valid)
    elif paged is not None and prefill:
        mix = L.attention_prefill_paged(
            bp["attn"], cfg.attn, h, cache, paged["table"], paged["start"],
            paged["lengths"], has_prefix=paged["has_prefix"])
    elif paged is not None:
        mix = L.attention_decode_paged(
            bp["attn"], cfg.attn, h, pos_idx, cache, paged["table"],
            paged["write_blk"], paged["write_off"])
    elif prefill:
        mix = L.attention_prefill(bp["attn"], cfg.attn, h, cache, lengths)
    else:
        mix = L.attention_decode(bp["attn"], cfg.attn, h, pos_idx, cache)
    x = x + mix
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if "moe" not in bp:
        # A block with neither FFN adds zeros (the reference's
        # ``_apply_ffn``): x + 0 is x.
        return (x + M.swiglu(bp["mlp"], h) if "mlp" in bp else x), None
    # Per-row capacity needs the row count even where per-row counts were
    # not asked for; the counts returned still follow ``n_rows``.
    y, aux = X.moe_apply(bp["moe"], bank, h.reshape(B * S, d), cfg.moe,
                         capacity, token_valid=token_valid,
                         n_rows=n_rows if n_rows is not None or
                         row_capacity is None else B,
                         dispatch=moe_dispatch, row_capacity=row_capacity)
    counts = aux.row_counts if n_rows is not None else aux.counts
    return x + y.reshape(B, S, d), counts


def _run_layers(params, cfg, x, caches, bank, **kw):
    """The layer loop (the reference's scan over super-blocks, each running
    its positions in order): per-layer views of the stacked parameters,
    caches and bank; with ``bank=None`` each MoE layer's experts come from
    ``params`` (the reference's rule). Returns (x, {MoE position: stacked
    counts})."""
    sb = cfg.superblock_or_default()
    blocks = params["blocks"]
    moe_pos = [str(p) for p in range(len(sb)) if "moe" in blocks[str(p)]]
    if bank is None and any(blocks[p]["moe"].get("experts") is None
                            for p in moe_pos):
        raise ValueError("bank=None serves the dense experts in params, "
                         "but a backend has dropped them: pass its banks")
    counts = {p: [] for p in moe_pos}
    for l in range(cfg.n_superblocks()):
        for pos, kind in enumerate(sb):
            key = str(pos)
            bp = _layer(blocks[key], l)
            c = caches[key]
            b = None
            if key in counts:
                b = bp["moe"]["experts"] if bank is None \
                    else bank[key].layer(l)
            x, n = _block_step(bp, cfg, kind, x, type(c)(*(t[l] for t in c)),
                               bank=b, **kw)
            if n is not None:
                counts[key].append(n)
    return x, {p: torch.stack(v) for p, v in counts.items()}


def _lm_logits(params: Dict, cfg: ArchConfig, x: torch.Tensor):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def prefill_paged(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                  caches: Dict, block_table: torch.Tensor,
                  start: torch.Tensor, lengths: torch.Tensor, bank=None,
                  capacity_factor: Optional[float] = None,
                  per_row_counts: bool = False, has_prefix: bool = False,
                  moe_dispatch: Optional[str] = None,
                  row_capacity: Optional[int] = None):
    """Masked prefill of prompt SUFFIXES into the paged pool (updated in
    place). ``tokens`` (R, S) hold tokens ``start[r]`` .. ``lengths[r]-1``
    right-padded to the bucket S; ``lengths`` (R,) are TOTAL prompt
    lengths, so ``lengths - start`` are the suffix lengths (0 = inert pad
    row). ``has_prefix`` also attends each suffix over its row's cached
    prefix blocks (the prefix-sharing and chunked-prefill path; every MoE
    layer runs on the suffix rows only). ``row_capacity``: the per-row MoE
    drop rule. Returns (suffix-last-token logits (R, V) float32, counts
    {pos: (nsb, R, E) or (nsb, E)})."""
    _check_family(cfg)
    x = params["embed"][tokens]
    R, S, _ = x.shape
    start = start.to(torch.int64)
    lengths = lengths.to(torch.int64)
    suffix = lengths - start
    token_valid = (torch.arange(S, device=x.device)[None, :] <
                   suffix[:, None]).reshape(-1)
    cap = X.moe_capacity(R * S, cfg.moe, capacity_factor)
    paged = {"table": block_table, "start": start, "lengths": lengths,
             "has_prefix": has_prefix}
    x, counts = _run_layers(params, cfg, x, caches, bank, capacity=cap,
                            pos_idx=None, prefill=True, paged=paged,
                            lengths=suffix, token_valid=token_valid,
                            n_rows=R if per_row_counts else None,
                            moe_dispatch=moe_dispatch,
                            row_capacity=row_capacity)
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
                      moe_dispatch: Optional[str] = None,
                      row_capacity: Optional[int] = None):
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
                            moe_dispatch=moe_dispatch,
                            row_capacity=row_capacity)
    return _lm_logits(params, cfg, x)[:, 0], counts


def prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            caches: Dict, lengths: torch.Tensor, bank=None,
            capacity_factor: Optional[float] = None,
            per_row_counts: bool = False,
            moe_dispatch: Optional[str] = None,
            row_capacity: Optional[int] = None):
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
                            moe_dispatch=moe_dispatch,
                            row_capacity=row_capacity)
    last = torch.clamp(lengths - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return _lm_logits(params, cfg, x_last)[:, 0], counts


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                pos_idx: torch.Tensor, caches: Dict, bank=None,
                capacity_factor: float = 2.0,
                row_valid: Optional[torch.Tensor] = None,
                per_row_counts: bool = False,
                moe_dispatch: Optional[str] = None,
                row_capacity: Optional[int] = None):
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
                            moe_dispatch=moe_dispatch,
                            row_capacity=row_capacity)
    return _lm_logits(params, cfg, x)[:, 0], counts


# --------------------------------------------------------------------------
# Self-speculative decoding: S chained decode steps. Each step IS
# ``decode_step``/``decode_step_paged`` (the same attention, the same MoE
# capacity moe_capacity(B), the same masked writes), so a verified prefix
# computes exactly what the plain decode would have: token parity with the
# non-speculative path by construction. A sliding-window ring needs
# nothing more (a rejected position's slot is rewritten by the next
# accepted one before any read). The Mamba positions' recurrent rows are
# stacked per verify step (the reference's ``ssm_states``), so that a
# rejection rolls each row back to its last accepted step
# (``serving.spec.select_rows``); a row outside ``row_valid`` at a step
# keeps its state through it.
# --------------------------------------------------------------------------


def _spec_step(params, cfg, tok, pos, caches, j: int, row_valid, paged,
               **kw):
    """Step ``j`` of a burst: one decode step at ``pos + j``, written where
    ``paged["write_blk"][j]``/``["write_off"][j]`` say (paged) or at slot
    ``(pos + j) % C`` (dense)."""
    if paged is None:
        return decode_step(params, cfg, tok, pos + j, caches,
                           row_valid=row_valid[j], **kw)
    return decode_step_paged(params, cfg, tok, pos + j, caches,
                             paged["table"], paged["write_blk"][j],
                             paged["write_off"][j], row_valid=row_valid[j],
                             **kw)


def spec_draft(params: Dict, cfg: ArchConfig, token: torch.Tensor,
               pos: torch.Tensor, caches: Dict, row_valid: torch.Tensor,
               bank=None, capacity_factor: float = 2.0,
               paged: Optional[Dict] = None,
               row_capacity: Optional[int] = None,
               moe_dispatch: Optional[str] = None) -> torch.Tensor:
    """Draft ``S = row_valid.shape[0]`` greedy tokens per row by chaining
    decode steps: each step's argmax (on the device) is the next step's
    token. ``token`` (B,) the last emitted token per row; ``pos`` (B,) the
    first write position; ``row_valid`` (S, B) per-step validity (a row
    past its own depth is masked out of MoE dispatch and counts but rides
    along); ``paged``: {"table": (B, nb), "write_blk"/"write_off": (S, B)}
    pre-resolved write lanes. With the all-lo view of the served banks
    (``serving.lobanks``) the always-resident lo tier is the draft model.
    Emits no counts: draft traffic never feeds hotness. Returns drafted
    (S, B) int64; the caches (the Mamba rows too) are written in place."""
    _check_family(cfg)
    kw = dict(bank=bank, capacity_factor=capacity_factor,
              row_capacity=row_capacity, moe_dispatch=moe_dispatch)
    out, tok = [], token
    for j in range(row_valid.shape[0]):
        logits, _ = _spec_step(params, cfg, tok, pos, caches, j, row_valid,
                               paged, **kw)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    return torch.stack(out)


def spec_verify(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                pos: torch.Tensor, caches: Dict, row_valid: torch.Tensor,
                bank=None, capacity_factor: float = 2.0,
                paged: Optional[Dict] = None,
                row_capacity: Optional[int] = None,
                moe_dispatch: Optional[str] = None):
    """Verify ``S`` positions: chained decode steps over the given tokens
    (row r, step j consumes ``tokens[j, r]`` at position ``pos[r] + j``)
    on the served (mixed-precision) banks. Returns (logits (S, B, V)
    float32, counts {pos: (S, nsb, B, E)}, ssm_states {Mamba position:
    ``MambaCache`` of (S, nsb, B, ...) leaves}): ``logits[j]`` is the
    next-token distribution after ``tokens[:j+1]``; the counts are per
    step, so the engine keeps rejected positions out of the hotness
    signal; ``ssm_states[p]`` leaf ``[j]`` is position p's rows after step
    j. The caches are written in place."""
    _check_family(cfg)
    kw = dict(bank=bank, capacity_factor=capacity_factor,
              per_row_counts=True, row_capacity=row_capacity,
              moe_dispatch=moe_dispatch)
    S = tokens.shape[0]
    ssm = {p: SSM.MambaCache(*(torch.empty((S,) + tuple(t.shape),
                                           dtype=t.dtype, device=t.device)
                               for t in caches[p]))
           for p in mamba_positions(cfg)}
    logits, counts = [], []
    for j in range(S):
        lg, c = _spec_step(params, cfg, tokens[j], pos, caches, j,
                           row_valid, paged, **kw)
        logits.append(lg)
        counts.append(c)
        for p, st in ssm.items():
            for out, now in zip(st, caches[p]):
                out[j].copy_(now)
    return torch.stack(logits), {k: torch.stack([c[k] for c in counts])
                                 for k in counts[0]}, ssm
