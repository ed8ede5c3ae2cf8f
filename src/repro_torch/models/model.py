"""Model stacks over the paged KV pool or dense KV rows: attention + MoE
stacks, hybrid Mamba/attention stacks of repeating super-blocks (e.g.
Jamba: seven Mamba-2 layers then one attention layer, MoE FFNs on the odd
positions and dense SwiGLU FFNs on the even ones), dense attention stacks
(a SwiGLU FFN at every layer), pure Mamba-2 stacks (no attention, no FFN
where ``d_ff`` is 0), the VLM language backbone (image embeddings ahead of
the prompt's tokens, ``image_embeds=``) and the encoder-decoder audio
stack (an encoder over the frontend's frames, ``encode``; each decoder
layer cross-attends its K/V, filled by ``prefill(audio_embeds=...)``, on
dense rows only, as the reference).

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
                           ``max_len``, or the sliding window's ring), the
                           Mamba rows, and an encoder-decoder stack's
                           cross K/V (nsb, B, Senc, Hkv, hd) under
                           ``CROSS``;
* ``prefill`` / ``decode_step`` — the same over dense rows;
* ``spec_draft`` / ``spec_verify`` — S chained decode steps (paged or
                           dense): the draft and verify of self-speculative
                           decoding (the verify also returns each step's
                           Mamba rows);
* ``forward_train``      — the full causal forward of training and quality
                           evaluation (no cache), differentiable on the
                           padded MoE dispatch.

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
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import moe as X
from repro_torch.models import specs as SP
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig

#: The key of the dense caches that holds an encoder-decoder stack's
#: cross K/V (no super-block position uses it).
CROSS = "cross"


def _check_family(cfg: ArchConfig) -> None:
    """Stacks of ``attn``/``mamba`` positions: MoE and hybrid stacks,
    dense attention stacks (``cfg.moe is None``: a SwiGLU FFN at every
    position), pure Mamba-2 stacks (no attention position; no FFN where
    ``d_ff`` is 0), the VLM backbone (a dense stack) and an
    encoder-decoder stack of attention layers."""
    sb = cfg.superblock_or_default()
    if any(k not in ("attn", "mamba") for k in sb) \
            or ("attn" in sb and cfg.attn is None) \
            or ("mamba" in sb and cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name}: super-block {sb} is not a stack of attention "
            f"and Mamba positions with their configurations")
    if cfg.is_encoder_decoder and sb != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder stack is one of attention "
            f"layers, not of super-block {sb}")


def _no_specs(what: str) -> None:
    """The paged pool has no spec in the planner: its entry points run
    without one (the engine over a grid holds the pool whole on every
    rank)."""
    if SP.active() is not None:
        raise NotImplementedError(
            f"{what} under the planner's specs: the reference's planner "
            f"has no rule for a block pool (its spec_for_cache cuts "
            f"(nsb, B, Hkv, C, hd) caches only) and its engine never runs "
            f"under a planner")


def _decoder_only(cfg: ArchConfig, what: str) -> None:
    """The paged entry points serve decoder-only stacks (the reference's
    rule): an encoder-decoder stack runs ``prefill``/``decode_step`` on
    dense rows."""
    _check_family(cfg)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {what} is decoder-only")


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
                generator: Optional[torch.Generator] = None,
                experts: bool = True) -> Dict:
    """Random parameters in the reference's layout and scales (normal ·
    fan_in^-1/2 in bf16, router float32, embedding · 0.02, norms ones,
    the Mamba layers' A_log/dt_bias/D as the reference sets them), drawn
    from ``generator`` or a generator seeded with ``seed`` on the target
    device, position by position (an encoder-decoder stack's encoder
    last). Large leaves are drawn one layer at a time so the float32
    scratch stays one layer's worth at full width. ``device="meta"``: the
    tree's shapes and dtypes only, no memory and no draw (the reference's
    ``jax.eval_shape`` of it, what the sharding planner reads).
    ``experts=False``: each MoE layer's dense experts are None and not
    drawn (a quantized bank serves them; the leaves drawn after them take
    other bits than with them)."""
    _check_family(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = None if meta else generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale, dtype=torch.bfloat16):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        return (torch.randn(shape, generator=gen, device=gen.device) * scale
                ).to(dtype).to(dev)

    def stacked(shape, scale, dtype=torch.bfloat16, n=None):
        n = nsb if n is None else n
        out = torch.empty((n,) + shape, dtype=dtype, device=dev)
        for l in range(n):
            out[l] = normal(shape, scale, dtype)
        return out

    d, a, m = cfg.d_model, cfg.attn, cfg.moe
    nsb = cfg.n_superblocks()

    def ones(k, n=None):
        return torch.ones((nsb if n is None else n, k), dtype=torch.bfloat16,
                          device=dev)

    def attention(n=None):
        p = {"wq": stacked((d, a.q_dim), d ** -0.5, n=n),
             "wk": stacked((d, a.kv_dim), d ** -0.5, n=n),
             "wv": stacked((d, a.kv_dim), d ** -0.5, n=n),
             "wo": stacked((a.q_dim, d), a.q_dim ** -0.5, n=n)}
        if a.qk_norm:
            p["q_norm"] = {"scale": ones(a.head_dim, n)}
            p["k_norm"] = {"scale": ones(a.head_dim, n)}
        return p

    def moe():
        E, f = m.num_experts, m.d_ff_expert
        # The reference draws expert stacks (E, K, N) with fan_in = E.
        dense = {"w_gate": stacked((E, d, f), E ** -0.5),
                 "w_up": stacked((E, d, f), E ** -0.5),
                 "w_down": stacked((E, f, d), E ** -0.5)} if experts \
            else None
        p = {"router": stacked((d, E), d ** -0.5, torch.float32),
             "experts": dense}
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
        if cfg.is_encoder_decoder and kind == "attn":
            bp["norm_cross"] = {"scale": ones(d)}
            bp["cross"] = attention()
        blocks[str(pos)] = bp
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": torch.ones((d,), dtype=torch.bfloat16,
                                           device=dev)},
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    if cfg.is_encoder_decoder:
        n = cfg.n_encoder_layers
        params["encoder"] = {
            "norm1": {"scale": ones(d, n)}, "attn": attention(n),
            "norm2": {"scale": ones(d, n)},
            "mlp": M.init_gelu_mlp(
                lambda shape, scale: stacked(shape, scale, n=n), d,
                cfg.d_ff or 4 * d)}
        params["enc_final_norm"] = {"scale": torch.ones(
            (d,), dtype=torch.bfloat16, device=dev)}
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
    without attention positions gets no pool; an encoder-decoder stack
    raises (its cross K/V live in dense rows)."""
    _decoder_only(cfg, "paged caches")
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
    = ``max_len``, or the sliding window's ring: slot = position % C), the
    Mamba rows per Mamba position, and on an encoder-decoder stack the
    cross K/V under ``CROSS`` (``layers.CrossKV``: zeros until a prefill
    fills them)."""
    _check_family(cfg)
    dev = resolve_device(device)
    C = attn_capacity(cfg, max_len)
    nsb = cfg.n_superblocks()
    caches = {p: L.init_kv_cache((nsb, batch), C, cfg.attn, dev)
              for p in attn_positions(cfg)}
    caches.update(init_mamba_rows(cfg, batch, dev))
    if cfg.is_encoder_decoder:
        a = cfg.attn
        shape = (nsb, batch, cfg.encoder_seq, a.n_kv_heads, a.head_dim)
        caches[CROSS] = L.CrossKV(
            torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            torch.zeros(shape, dtype=torch.bfloat16, device=dev))
    return caches


def _layer(tree, l: int):
    """Per-layer views of a stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items() if v is not None}
    return tree[l]


def _block_step(bp: Dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
                cache, pos_idx, capacity: int, bank, prefill: bool,
                paged: Optional[Dict] = None, lengths=None, token_valid=None,
                n_rows=None, moe_dispatch=None, row_capacity=None,
                cross=None):
    """One layer: attention (``kind`` "attn") or Mamba, then, on an
    encoder-decoder stack, cross-attention over the layer's ``cross``
    (K, V, valid) (the reference's order: x += self-attention, then the
    ``norm_cross`` norm, x += cross-attention), then its FFN (MoE when
    ``bp`` has "moe", else the dense SwiGLU). x (B, S, d); an
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
    if cross is not None:
        x = x + mix
        hc = L.rmsnorm(bp["norm_cross"], x, cfg.norm_eps)
        ek, ev, valid = cross
        mix = L.cross_attention(bp["cross"], cfg.attn, hc, ek, ev,
                                None if prefill else valid)
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
    # Per-row counts unavailable (a padded regime whose rows do not tile
    # over data): the aggregated (E,) counts, as the reference's block.
    counts = aux.row_counts if n_rows is not None and \
        aux.row_counts is not None else aux.counts
    return x + y.reshape(B, S, d), counts


def _run_layers(params, cfg, x, caches, bank, **kw):
    """The layer loop (the reference's scan over super-blocks, each running
    its positions in order): per-layer views of the stacked parameters,
    caches and bank; with ``bank=None`` each MoE layer's experts come from
    ``params`` (the reference's rule); an encoder-decoder stack's layers
    read their slice of ``caches[CROSS]``. Returns (x, {MoE position:
    stacked counts})."""
    sb = cfg.superblock_or_default()
    blocks = params["blocks"]
    moe_pos = [str(p) for p in range(len(sb)) if "moe" in blocks[str(p)]]
    if bank is None and any(blocks[p]["moe"].get("experts") is None
                            for p in moe_pos):
        raise ValueError("bank=None serves the dense experts in params, "
                         "but a backend has dropped them: pass its banks")
    counts = {p: [] for p in moe_pos}
    cross = caches.get(CROSS)
    valid = None if cross is None else L.cross_valid(cross.k[0])
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
                               bank=b, cross=None if cross is None else
                               (cross.k[l], cross.v[l], valid), **kw)
            if n is not None:
                counts[key].append(n)
    return x, {p: torch.stack(v) for p, v in counts.items()}


def encode(params: Dict, cfg: ArchConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, Senc, d): the stub frontend's output → the encoder's
    hidden states (B, Senc, d): per layer x += attention over every frame
    (rope at frame positions), x += GELU MLP, each after its norm; then
    the final norm."""
    enc = params["encoder"]
    x = frames
    for l in range(cfg.n_encoder_layers):
        bp = _layer(enc, l)
        h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        x = x + L.attention_full(bp["attn"], cfg.attn, h, causal=False)
        h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + M.gelu_mlp(bp["mlp"], h)
    return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _fill_cross(params: Dict, cfg: ArchConfig, caches: Dict,
                audio_embeds: Optional[torch.Tensor]) -> None:
    """Encode the frames and write every decoder layer's cross K/V into
    ``caches[CROSS]`` in place (the reference's ``fill_cross``)."""
    if audio_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                         f"audio_embeds (B, {cfg.encoder_seq}, "
                         f"{cfg.d_model})")
    enc_out = encode(params, cfg, audio_embeds.to(torch.bfloat16))
    cross, blocks = caches[CROSS], params["blocks"]["0"]["cross"]
    for l in range(cfg.n_superblocks()):
        k, v = L.encode_cross_kv(_layer(blocks, l), cfg.attn, enc_out)
        cross.k[l].copy_(k)
        cross.v[l].copy_(v)


def _embed_inputs(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                  image_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token embeddings (B, S, d); on a VLM stack, ``image_embeds`` (B, n,
    d) go first: (B, n + S, d) (the reference's ``_embed_inputs``)."""
    x = params["embed"][tokens]
    if image_embeds is None:
        return x
    if cfg.family != "vlm":
        raise ValueError(f"{cfg.name}: image_embeds on a {cfg.family!r} "
                         f"stack (only a VLM takes them)")
    return torch.cat([image_embeds.to(x.dtype), x], dim=1)


def _lm_logits(params: Dict, cfg: ArchConfig, x: torch.Tensor):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


# --------------------------------------------------------------------------
# Full-sequence causal forward (training and quality evaluation)
# --------------------------------------------------------------------------


def _unbind(tree, n: int) -> list:
    """Per-layer views of a stacked parameter subtree, one ``torch.unbind``
    per leaf: autograd then stacks the layers' gradients into the leaf in
    one pass, where a ``select`` per layer would add a zero-padded
    full-size gradient per layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items() if v is not None}
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    return list(torch.unbind(tree, 0))


def _block_train(bp: Dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
                 capacity: int, bank, enc_out: Optional[torch.Tensor],
                 dispatch: str):
    """One layer over a whole sequence, no cache (the reference's
    ``_block_train``): causal attention or the chunked SSD, on an
    encoder-decoder stack cross-attention over ``enc_out``, then the FFN
    (MoE on ``bank``, or on the layer's dense experts when ``bank`` is
    None; a dense SwiGLU; or none). Returns (x, counts (E,) or None,
    the load-balance loss (float32 scalar, 0 without MoE))."""
    B, S, d = x.shape
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        mix = L.attention_full(bp["attn"], cfg.attn, h)
        if enc_out is not None:
            x = x + mix
            hc = L.rmsnorm(bp["norm_cross"], x, cfg.norm_eps)
            ek, ev = L.encode_cross_kv(bp["cross"], cfg.attn, enc_out)
            mix = L.cross_attention(bp["cross"], cfg.attn, hc, ek, ev)
    else:
        mix, _ = SSM.ssd_forward(bp["mamba"], cfg.ssm, d, h)
    x = x + mix
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" not in bp:
        return (x + M.swiglu(bp["mlp"], h) if "mlp" in bp else x), None, zero
    experts = bp["moe"]["experts"] if bank is None else bank
    y, aux = X.moe_apply(bp["moe"], experts, h.reshape(B * S, d), cfg.moe,
                         capacity, dispatch=dispatch)
    return x + y.reshape(B, S, d), aux.counts, aux.aux_loss


def _refuse_kernels_under_grad(params: Dict, what: str) -> None:
    """The kernels have no backward: a forward that reaches one while
    autograd records would leave its weights without a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in T.leaves(params)):
        raise RuntimeError(f"{what} runs the ragged kernels, which have no "
                           f"backward: differentiate on the padded dispatch "
                           f"(dispatch='padded'), or run under "
                           f"torch.no_grad()")


def forward_train(params: Dict, cfg: ArchConfig, batch: Dict,
                  capacity_factor: Optional[float] = None,
                  remat: bool = True, dispatch: str = "padded", bank=None):
    """Full causal forward (the reference's ``forward_train``). ``batch``:
    "tokens" (B, S); on a VLM stack optionally "image_embeds" (B, n, d)
    ahead of the tokens; on an encoder-decoder stack "audio_embeds" (B,
    Senc, d), encoded once. ``dispatch``: the MoE token layout, "padded"
    (the default, the one autograd can differentiate: batched einsums over
    (E, C, d)) or "ragged" (the kernels; refused while autograd records
    parameter gradients). ``bank``: MoE position → stacked
    ``ExpertBankQ`` in place of the dense experts (the reference's
    ``_forward_with_bank``). ``remat`` recomputes each super-block in the
    backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint``).
    Returns (logits (B, S_total, V) float32, {"aux_loss": float32 scalar,
    "counts": {MoE position: (nsb, E) int32}}). Under a context with a
    planner, this rank's share (``specs.forward_train``)."""
    _check_family(cfg)
    if SP.active() is not None:
        if dispatch == "ragged":
            _refuse_kernels_under_grad(params,
                                       "forward_train(dispatch='ragged')")
        return SP.forward_train(params, cfg, batch, capacity_factor, remat,
                                dispatch, bank)
    if dispatch not in X.DISPATCHES:
        raise ValueError(f"dispatch={dispatch!r}; one of {X.DISPATCHES}")
    if dispatch == "ragged":
        _refuse_kernels_under_grad(params, "forward_train(dispatch='ragged')")
    image = batch.get("image_embeds") if cfg.family == "vlm" else None
    x = _embed_inputs(params, cfg, batch["tokens"], image)
    B, S, _ = x.shape
    cap = X.moe_capacity(B * S, cfg.moe, capacity_factor)
    enc_out = encode(params, cfg, batch["audio_embeds"].to(torch.bfloat16)) \
        if cfg.is_encoder_decoder else None
    sb = cfg.superblock_or_default()
    nsb = cfg.n_superblocks()
    layers = {str(p): _unbind(params["blocks"][str(p)], nsb)
              for p in range(len(sb))}

    def sb_body(x, aux_sum, l):
        counts = []
        for pos, kind in enumerate(sb):
            key = str(pos)
            b = bank[key].layer(l) if bank is not None and key in bank \
                else None
            x, c, a = _block_train(layers[key][l], cfg, kind, x, cap, b,
                                   enc_out, dispatch)
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
    logits = _lm_logits(params, cfg, x)
    return logits, {"aux_loss": aux_sum,
                    "counts": {p: torch.stack(v) for p, v in counts.items()}}


def prefill_paged(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                  caches: Dict, block_table: torch.Tensor,
                  start: torch.Tensor, lengths: torch.Tensor, bank=None,
                  capacity_factor: Optional[float] = None,
                  per_row_counts: bool = False, has_prefix: bool = False,
                  moe_dispatch: Optional[str] = None,
                  row_capacity: Optional[int] = None,
                  image_embeds: Optional[torch.Tensor] = None):
    """Masked prefill of prompt SUFFIXES into the paged pool (updated in
    place). ``tokens`` (R, S) hold tokens ``start[r]`` .. ``lengths[r]-1``
    right-padded to the bucket S; ``lengths`` (R,) are TOTAL prompt
    lengths, so ``lengths - start`` are the suffix lengths (0 = inert pad
    row). ``has_prefix`` also attends each suffix over its row's cached
    prefix blocks (the prefix-sharing and chunked-prefill path; every MoE
    layer runs on the suffix rows only). ``row_capacity``: the per-row MoE
    drop rule. ``image_embeds`` (R, n, d), on a VLM stack: ahead of the
    tokens, and counted in ``lengths``. Decoder-only: an encoder-decoder
    stack raises. Returns (suffix-last-token logits (R, V) float32, counts
    {pos: (nsb, R, E) or (nsb, E)})."""
    _no_specs("prefill_paged")
    _decoder_only(cfg, "paged prefill")
    x = _embed_inputs(params, cfg, tokens, image_embeds)
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
    Decoder-only. Returns (logits (B, V) float32, counts)."""
    _no_specs("decode_step_paged")
    _decoder_only(cfg, "paged decode")
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
            row_capacity: Optional[int] = None,
            image_embeds: Optional[torch.Tensor] = None,
            audio_embeds: Optional[torch.Tensor] = None):
    """Masked prefill from position 0 into dense rows (updated in place).
    ``tokens`` (B, S) right-padded; ``lengths`` (B,) prompt lengths (0 =
    inert pad row). On a VLM stack ``image_embeds`` (B, n, d) go ahead of
    the tokens and ``lengths`` count them. On an encoder-decoder stack
    ``audio_embeds`` (B, Senc, d) are encoded and every layer's cross K/V
    written into ``caches[CROSS]``. Returns (last-token logits (B, V)
    float32, counts {pos: (nsb, B, E) or (nsb, E)}). Under a context with
    a planner, this rank's share (``specs.prefill``)."""
    _check_family(cfg)
    if SP.active() is not None:
        return SP.prefill(params, cfg, tokens, caches, lengths, bank,
                          capacity_factor, per_row_counts, moe_dispatch,
                          row_capacity, image_embeds, audio_embeds)
    if cfg.is_encoder_decoder:
        _fill_cross(params, cfg, caches, audio_embeds)
    x = _embed_inputs(params, cfg, tokens, image_embeds)
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
    vacant rows out of dispatch and counts. An encoder-decoder stack reads
    the cross K/V its prefill wrote. Returns (logits (B, V) float32,
    counts). Under a context with a planner, this rank's share
    (``specs.decode_step``)."""
    _check_family(cfg)
    if SP.active() is not None:
        return SP.decode_step(params, cfg, token, pos_idx, caches, bank,
                              capacity_factor, row_valid, per_row_counts,
                              moe_dispatch, row_capacity)
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
