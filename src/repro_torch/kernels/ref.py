"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, in the reference's arithmetic:
the CPU tests hold them against the JAX oracles, and ``chip_smoke.py``
holds the kernels against them on the card.

* ``grouped_lo_gemm`` — the group-blocked quantized GEMM: per scale group
  a partial dot with float32 results, the group's scale applied after.
* ``ragged_gateup_ref`` / ``ragged_down_ref`` / ``ragged_quant_ffn_ref`` —
  the ragged mixed-precision SwiGLU FFN over bm-row tiles, each tile on its
  expert's hi bf16 slot (``tile_slot >= 0``) or its packed lo codes.
* ``ragged_dense_gateup_ref`` / ``ragged_dense_down_ref`` /
  ``ragged_dense_ffn_ref`` — its all-hi mode: every tile on its expert's
  dense bf16 weights, an (E, K, N) bank (the fp16 and offload backends).
* ``flash_decode_ref`` / ``flash_decode_paged_ref`` — one-query GQA
  attention over a dense (B, S, Hkv, hd) cache view or through a block
  table: float32 softmax with -inf masking, all-masked rows give zeros.
* ``ragged_gateup_mma`` / ``ragged_down_mma`` — the ragged kernels'
  arithmetic order in plain form, for the CPU tests (slow; small shapes):
  yᵀ = Wᵀ·xᵀ as k16 block products summed in turn, each scale group's sum
  scaled into the accumulator (``ragged_dense_gateup_mma`` /
  ``ragged_dense_down_mma``: the all-hi mode's); ``decode_biased`` — their code decode by
  an exponent bias; ``lo_fragment_map`` / ``hi_fragment_map`` — which
  weights each lane's mma A fragment holds on each tier.
* ``grouped_lo_mma`` — the GEMM kernels' arithmetic order in plain form
  (the ragged kernels' swap-AB order per K range, the ranges added in
  order), for the CPU tests.
* ``quant_matmul_ref`` — the plain quantized GEMM: weights dequantized to
  float32 (code · scale), then a float32 product (not the group-blocked
  rule).
* ``flash_decode_split_ref`` / ``flash_decode_paged_split_ref`` — the
  split-KV arithmetic of the decode-attention kernels in plain form
  (``split_partials`` then ``merge_splits``), for the tests: the kernels
  themselves are held against ``flash_decode_ref`` /
  ``flash_decode_paged_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.qtensor import dequant_arrays, unpack_codes_int8

# The plain versions run float32 products on the card as the oracle of the
# kernels. TF32 keeps ~10 mantissa bits and a reduced-precision bf16 GEMM
# reduction rounds partial sums to bf16; either would make the oracle less
# exact than the kernels it judges, so both stay off wherever this module
# is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cudnn.allow_tf32 = False

#: Tiles dequantized at once by the plain GEMM (bounds its scratch memory at
#: full model width: one tile of a 2048×768 expert is 6 MB in float32).
_TILE_CHUNK = 32


def _codes_f32(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """``unpack_codes_int8(packed, bits)`` as float32 (..., K, N), shifted
    and masked in uint8 and written once as float32: the codes are small
    integers, so the values are the same, at a fraction of the int32
    passes."""
    if bits == 8:
        return packed.to(torch.float32) - 128
    epb = 8 // bits
    *lead, kp, n = packed.shape
    out = torch.empty((*lead, kp, epb, n), dtype=torch.float32,
                      device=packed.device)
    for j in range(epb):
        out[..., j, :] = (packed >> (j * bits)) & ((1 << bits) - 1)
    out -= 1 << (bits - 1)
    return out.reshape(*lead, kp * epb, n)


def grouped_lo_gemm(xg: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, bits: int, group: int,
                    index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xg (B, C, K) × codes (B, K//epb, N) / scales (B, K//g, N) → (B, C, N)
    in xg's dtype: Σ_g scale_g · (x_g @ q_g) with float32 partial dots.
    Products of bf16 activations and small integer codes are exact in
    float32, so only the summation order differs from the reference.
    ``index`` ((B,) long) gathers the weight rows per batch entry (tile →
    expert) chunk by chunk instead of materializing the gather."""
    B, C, K = xg.shape
    N = packed.shape[-1]
    G = K // group
    out = torch.empty((B, C, N), dtype=xg.dtype, device=xg.device)
    for b0 in range(0, B, _TILE_CHUNK):
        b1 = min(B, b0 + _TILE_CHUNK)
        sel = slice(b0, b1) if index is None else index[b0:b1]
        q = _codes_f32(packed[sel], bits).reshape(b1 - b0, G, group, N)
        x = xg[b0:b1].to(torch.float32).reshape(b1 - b0, C, G, group) \
            .permute(0, 2, 1, 3)                          # (b, G, C, g)
        part = torch.matmul(x, q)                         # (b, G, C, N)
        acc = (part * scales[sel].to(torch.float32)[:, :, None, :]).sum(1)
        out[b0:b1] = acc.to(xg.dtype)
    return out


def _dense_tiles(xt: torch.Tensor, w: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """bf16 (T, bm, K) × bf16 w[index] (T, K, N) with float32 accumulation,
    rounded to bf16 once (the reference's bf16 einsum)."""
    out = torch.empty((xt.shape[0], xt.shape[1], w.shape[-1]),
                      dtype=xt.dtype, device=xt.device)
    for b0 in range(0, xt.shape[0], _TILE_CHUNK):
        b1 = min(xt.shape[0], b0 + _TILE_CHUNK)
        out[b0:b1] = torch.matmul(xt[b0:b1].float(),
                                  w[index[b0:b1]].float()).to(xt.dtype)
    return out


def _silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """bf16(silu(f32(g))) · u in bf16 — the reference epilogue."""
    return torch.nn.functional.silu(g.float()).to(g.dtype) * u


def _tiles(xs: torch.Tensor, bm: int) -> torch.Tensor:
    R, K = xs.shape
    if R % bm:
        raise ValueError(f"rows {R} not a multiple of bm={bm}")
    return xs.reshape(R // bm, bm, K)


def _hi_rows(tile_slot: torch.Tensor, hi: Optional[torch.Tensor]):
    if hi is None or hi.shape[0] == 0:
        return None
    return tile_slot >= 0


def ragged_gateup_ref(xs, tile_eid, tile_slot, gate_packed, gate_scales,
                      up_packed, up_scales, hi_gate=None, hi_up=None, *,
                      bits: int, group: int, bm: int) -> torch.Tensor:
    """h = bf16(silu(g)) · u over every tile: (R, K) → (R, F) bf16."""
    xt = _tiles(xs, bm)
    eid = tile_eid.long()
    g = grouped_lo_gemm(xt, gate_packed, gate_scales, bits, group, eid)
    u = grouped_lo_gemm(xt, up_packed, up_scales, bits, group, eid)
    h = _silu_mul(g, u)
    is_hi = _hi_rows(tile_slot, hi_gate)
    if is_hi is not None:
        safe = torch.clamp(tile_slot, 0, hi_gate.shape[0] - 1).long()
        hh = _silu_mul(_dense_tiles(xt, hi_gate, safe),
                       _dense_tiles(xt, hi_up, safe))
        h = torch.where(is_hi[:, None, None], hh, h)
    return h.reshape(xs.shape[0], h.shape[-1])


def ragged_down_ref(h, tile_eid, tile_slot, down_packed, down_scales,
                    hi_down=None, *, bits: int, group: int,
                    bm: int) -> torch.Tensor:
    """y = h · W_down per tile on its tier: (R, F) → (R, D) bf16."""
    ht = _tiles(h, bm)
    y = grouped_lo_gemm(ht, down_packed, down_scales, bits, group,
                        tile_eid.long())
    is_hi = _hi_rows(tile_slot, hi_down)
    if is_hi is not None:
        safe = torch.clamp(tile_slot, 0, hi_down.shape[0] - 1).long()
        y = torch.where(is_hi[:, None, None],
                        _dense_tiles(ht, hi_down, safe), y)
    return y.reshape(h.shape[0], y.shape[-1])


def ragged_quant_ffn_ref(xs, tile_eid, tile_slot, gate_packed, gate_scales,
                         up_packed, up_scales, down_packed, down_scales,
                         hi_gate=None, hi_up=None, hi_down=None, *,
                         bits: int, group: int, bm: int) -> torch.Tensor:
    """The whole ragged FFN: ``ragged_down_ref ∘ ragged_gateup_ref``."""
    h = ragged_gateup_ref(xs, tile_eid, tile_slot, gate_packed, gate_scales,
                          up_packed, up_scales, hi_gate, hi_up,
                          bits=bits, group=group, bm=bm)
    return ragged_down_ref(h, tile_eid, tile_slot, down_packed, down_scales,
                           hi_down, bits=bits, group=group, bm=bm)


def ragged_dense_gateup_ref(xs, tile_eid, w_gate, w_up, *,
                            bm: int) -> torch.Tensor:
    """The all-hi mode's gate/up: h = bf16(silu(xs·W_gate[e])) ·
    bf16(xs·W_up[e]) per tile, e = ``tile_eid[t]``, from (E, K, F) bf16
    banks: (R, K) → (R, F) bf16 (the reference's bf16 einsums)."""
    xt = _tiles(xs, bm)
    eid = tile_eid.long()
    h = _silu_mul(_dense_tiles(xt, w_gate, eid), _dense_tiles(xt, w_up, eid))
    return h.reshape(xs.shape[0], h.shape[-1])


def ragged_dense_down_ref(h, tile_eid, w_down, *, bm: int) -> torch.Tensor:
    """The all-hi mode's down: y = h · W_down[e] per tile: (R, F) → (R, D)
    bf16."""
    y = _dense_tiles(_tiles(h, bm), w_down, tile_eid.long())
    return y.reshape(h.shape[0], y.shape[-1])


def ragged_dense_ffn_ref(xs, tile_eid, w_gate, w_up, w_down, *,
                         bm: int) -> torch.Tensor:
    """The ragged dense FFN: ``ragged_dense_down_ref ∘
    ragged_dense_gateup_ref`` (the reference's ``ragged_dense_ffn_ref``)."""
    h = ragged_dense_gateup_ref(xs, tile_eid, w_gate, w_up, bm=bm)
    return ragged_dense_down_ref(h, tile_eid, w_down, bm=bm)


def _swap_ab(xt: torch.Tensor, w: torch.Tensor,
             scales: Optional[torch.Tensor], group: int,
             acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-core order of one weight over tiles: xt (T, bm, K), w
    (T, K, N) (codes or bf16 weights, any float dtype), scales (T, K//g,
    N) or None (hi) → float32 (T, bm, N). Each k16 block's product Wᵀ·xᵀ
    (an mma's float32 result) is added in turn: into a zeroed partial per
    scale group, which is then scaled per column into the accumulator
    (lo), or straight into the accumulator (hi). ``acc`` (T, bm, N): the
    accumulator to continue (a later piece of K), else zeros."""
    T, bm, K = xt.shape
    N = w.shape[-1]
    wt = w.float().transpose(1, 2).reshape(T, N, K // 16, 16)
    xtt = xt.float().transpose(1, 2).reshape(T, K // 16, 16, bm)
    blocks = torch.matmul(wt.permute(0, 2, 1, 3), xtt)   # (T, K/16, N, bm)
    acc = torch.zeros((T, N, bm), dtype=torch.float32) if acc is None \
        else acc.transpose(1, 2)
    if scales is None:
        for b in range(K // 16):
            acc = acc + blocks[:, b]
        return acc.transpose(1, 2)
    spg = group // 16
    for g0 in range(0, K // 16, spg):
        part = torch.zeros_like(acc)
        for b in range(g0, g0 + spg):
            part = part + blocks[:, b]
        s = scales[:, g0 // spg].float()[:, :, None]
        acc = torch.addcmul(acc, part, s)
    return acc.transpose(1, 2)


def grouped_lo_mma(xg: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, bits: int, group: int,
                   n_split: int = 1) -> torch.Tensor:
    """``grouped_lo_gemm`` in the GEMM kernels' arithmetic order (group a
    multiple of 16): K cut into ``n_split`` ranges of ``ceil(G / n_split)``
    scale groups (the last may be shorter; ``ops.gemm_plan``'s ranges);
    per range the swap-AB order of ``_swap_ab`` (k16 block products summed
    in turn within each group, each group scaled into the range's float32
    accumulator); then the ranges added in order, one rounding to xg's
    dtype. (E, C, K) → (E, C, N)."""
    K = xg.shape[-1]
    G = K // group
    gps = -(-G // n_split)
    codes = unpack_codes_int8(packed, bits)
    acc = None
    for g0 in range(0, G, gps):
        g1 = min(G, g0 + gps)
        k0, k1 = g0 * group, g1 * group
        part = _swap_ab(xg[..., k0:k1], codes[:, k0:k1], scales[:, g0:g1],
                        group)
        acc = part if acc is None else acc + part
    return acc.to(xg.dtype)


def _pieces(xt, w, scales, group: int, gpc: Optional[int]):
    """``_swap_ab`` over K in pieces of ``gpc`` scale groups (None: one
    piece), the float32 accumulator carried across pieces, as the ragged
    FFN kernels walk a K whose row does not fit shared memory."""
    K = xt.shape[-1]
    step = K if gpc is None else gpc * group
    acc = None
    for k0 in range(0, K, step):
        k1 = min(K, k0 + step)
        sc = None if scales is None else \
            scales[:, k0 // group:k1 // group]
        acc = _swap_ab(xt[..., k0:k1], w[:, k0:k1], sc, group, acc)
    return acc


def _tiers_mma(xt, tile_eid, tile_slot, packed, scales, hi, bits, group,
               gpc=None):
    """float32 (T, bm, N) of one weight per tile on its tier."""
    eid = tile_eid.long()
    codes = unpack_codes_int8(packed[eid], bits)
    y = _pieces(xt, codes, scales[eid], group, gpc)
    is_hi = _hi_rows(tile_slot, hi)
    if is_hi is not None:
        safe = torch.clamp(tile_slot, 0, hi.shape[0] - 1).long()
        y = torch.where(is_hi[:, None, None],
                        _pieces(xt, hi[safe], None, group, gpc), y)
    return y


def ragged_gateup_mma(xs, tile_eid, tile_slot, gate_packed, gate_scales,
                      up_packed, up_scales, hi_gate=None, hi_up=None, *,
                      bits: int, group: int, bm: int,
                      gpc: Optional[int] = None) -> torch.Tensor:
    """``ragged_gateup_ref`` in the kernel's arithmetic order (group a
    multiple of 16): the same epilogue on g and u. ``gpc``: K walked in
    pieces of that many scale groups (``ops.ragged_piece``; None: one)."""
    xt = _tiles(xs, bm)
    g = _tiers_mma(xt, tile_eid, tile_slot, gate_packed, gate_scales,
                   hi_gate, bits, group, gpc)
    u = _tiers_mma(xt, tile_eid, tile_slot, up_packed, up_scales, hi_up,
                   bits, group, gpc)
    h = _silu_mul(g.to(xs.dtype), u.to(xs.dtype))
    return h.reshape(xs.shape[0], h.shape[-1])


def ragged_down_mma(h, tile_eid, tile_slot, down_packed, down_scales,
                    hi_down=None, *, bits: int, group: int, bm: int,
                    gpc: Optional[int] = None) -> torch.Tensor:
    """``ragged_down_ref`` in the kernel's arithmetic order."""
    y = _tiers_mma(_tiles(h, bm), tile_eid, tile_slot, down_packed,
                   down_scales, hi_down, bits, group, gpc)
    return y.to(h.dtype).reshape(h.shape[0], y.shape[-1])


def ragged_dense_gateup_mma(xs, tile_eid, w_gate, w_up, *,
                            bm: int) -> torch.Tensor:
    """``ragged_dense_gateup_ref`` in the kernel's arithmetic order: every
    tile on the hi branch (k16 block products summed in turn straight into
    the float32 accumulator), the same epilogue."""
    xt = _tiles(xs, bm)
    eid = tile_eid.long()
    g = _swap_ab(xt, w_gate[eid], None, 16)
    u = _swap_ab(xt, w_up[eid], None, 16)
    h = _silu_mul(g.to(xs.dtype), u.to(xs.dtype))
    return h.reshape(xs.shape[0], h.shape[-1])


def ragged_dense_down_mma(h, tile_eid, w_down, *, bm: int) -> torch.Tensor:
    """``ragged_dense_down_ref`` in the kernel's arithmetic order."""
    y = _swap_ab(_tiles(h, bm), w_down[tile_eid.long()], None, 16)
    return y.to(h.dtype).reshape(h.shape[0], y.shape[-1])


def decode_biased(byte: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernels' code decode in plain form: uint8 bytes (...) → the
    centred codes of each byte as bf16 (..., 8/bits), K rows in order. A
    value u < 128 becomes bf16 bits 0x4300 | u (= 128 + u), minus the bias
    128 + 2^(bits−1) in bf16; an int8 byte is split into nibbles,
    (128 + hi − 136)·16 + (128 + lo − 128), the product and sum exact."""
    def biased(u):
        return (u.to(torch.int32) | 0x4300).to(torch.int16) \
            .view(torch.bfloat16)

    b = byte.to(torch.int32)
    if bits == 8:
        hi = biased(b >> 4) - torch.tensor(136.0, dtype=torch.bfloat16)
        lo = biased(b & 15) - torch.tensor(128.0, dtype=torch.bfloat16)
        return (hi.float() * 16 + lo.float()).to(torch.bfloat16)[..., None]
    mask, bias = (1 << bits) - 1, 128.0 + (1 << (bits - 1))
    return torch.stack([biased((b >> (bits * j)) & mask)
                        - torch.tensor(bias, dtype=torch.bfloat16)
                        for j in range(8 // bits)], -1)


def lo_fragment_map(bits: int):
    """The kernels' lo A fragment of one k16 chunk (16/epb packed rows of
    a warp's 16 code bytes): ``{(lane, register, half): (k, column, byte
    offset, shift)}``. Columns are permuted: the mma's M row gid is column
    2·gid, M row gid + 8 is column 2·gid + 1. Lane 4·gid + tid loads 16-bit
    pairs of columns (2·gid, 2·gid + 1) of the packed rows holding K rows
    2·tid + 8·h and the next (h = 0, 1); the four codes of a row pair,
    [k even column, k odd, k + 1 even, k + 1 odd], are paired by byte
    selectors into registers 2h (even column) and 2h + 1 (odd)."""
    out = {}
    for lane in range(32):
        gid, tid = lane >> 2, lane & 3
        for h in range(2):
            if bits == 4:
                o = (tid + 4 * h) * 16 + 2 * gid
                x = [(o, 0), (o + 1, 0), (o, 4), (o + 1, 4)]
            elif bits == 2:
                o, sh = ((tid >> 1) + 2 * h) * 16 + 2 * gid, 4 * (tid & 1)
                x = [(o, sh), (o + 1, sh), (o, sh + 2), (o + 1, sh + 2)]
            else:
                o = (2 * tid + 8 * h) * 16 + 2 * gid
                x = [(o, 0), (o + 1, 0), (o + 16, 0), (o + 17, 0)]
            for p, sel in ((0, (0, 2)), (1, (1, 3))):
                for half in range(2):
                    off, shift = x[sel[half]]
                    out[(lane, 2 * h + p, half)] = (
                        2 * tid + 8 * h + half, 2 * gid + p, off, shift)
    return out


def hi_fragment_map():
    """The kernels' hi A fragment of one stage (16 K rows of a warp's 16
    bf16 columns, 32 bytes a row, the 16-byte halves of rows 4–7 and 12–15
    swapped): ``{(lane, register, half): (k, column)}``, found by following
    the bytes. Column half c of row r is stored at r·32 + 16·(c ^ ((r >> 2)
    & 1)); lane l gives ``ldmatrix.x4.trans`` the address of row (l & 7) +
    8·(l >> 4), logical half (l >> 3) & 1, swizzled the same way, for matrix
    l >> 3; from each matrix i a lane receives the elements of rows
    2·(l % 4) + half of that matrix's 8 addressed rows, at column l // 4 of
    each 16-byte row."""
    def address(r, half):
        return r * 32 + 16 * (half ^ ((r >> 2) & 1))

    def element(off):
        r, half, e = off // 32, (off % 32) // 16, (off % 16) // 2
        return r, 8 * (half ^ ((r >> 2) & 1)) + e

    rows = {}
    for lane in range(32):
        r = (lane & 7) + ((lane >> 4) << 3)
        rows.setdefault(lane >> 3, []).append(address(r, (lane >> 3) & 1))
    out = {}
    for lane in range(32):
        for i in range(4):
            for half in range(2):
                out[(lane, i, half)] = element(
                    rows[i][2 * (lane % 4) + half] + 2 * (lane // 4))
    return out


def quant_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, bits: int,
                     group: int) -> torch.Tensor:
    """x (M, K) × codes (K//epb, N) / scales (K//g, N) → (M, N) in x's
    dtype: the weight dequantized to float32 (code · scale), a float32
    product, one rounding."""
    w = dequant_arrays(packed, scales, bits, group, dtype=torch.float32)
    return torch.matmul(x.float(), w).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, lse: bool = False):
    """q (B, H, hd); k/v (B, Hkv, S, hd) views; valid (B, S) → (B, H, hd)
    in q's dtype. A row with no valid slot returns zeros (the kernels'
    guarded online softmax does the same). ``lse``: also each head's
    log-sum-exp of its masked logits, (B, H) float32, -inf for a row with
    no valid slot: returns (out, lse)."""
    B, H, hd = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) * hd ** -0.5
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    out = torch.matmul(p, v.float())              # (B, Hkv, rep, hd)
    out = out.reshape(B, H, hd).to(q.dtype)
    if not lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H)


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, tile: int, n_split: int,
                   tps: int):
    """The first pass of the split-KV kernels: q (B, H, hd); k/v (B, Hkv,
    S, hd) views; valid (B, S). Split ``s`` covers positions
    ``[s·tps·tile, (s+1)·tps·tile) ∩ [0, S)``. Returns float32 (m, l, acc)
    of shapes (B, H, n_split), (B, H, n_split), (B, H, n_split, hd): the
    split's max logit, its sum of exp(logit − m) and its unnormalized
    output; a split without a valid slot has m = -inf and l = acc = 0."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) * hd ** -0.5
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    ms, ls, accs = [], [], []
    for s in range(n_split):
        a, e = min(S, s * tps * tile), min(S, (s + 1) * tps * tile)
        x = logits[..., a:e]
        m = x.amax(-1) if e > a else torch.full(x.shape[:-1], float("-inf"))
        p = torch.exp(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, v.float()[:, :, a:e]))
    m, l = torch.stack(ms, -1), torch.stack(ls, -1)
    acc = torch.stack(accs, -2)                   # (B, Hkv, rep, n, hd)
    return (m.reshape(B, H, n_split), l.reshape(B, H, n_split),
            acc.reshape(B, H, n_split, hd))


def merge_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """The merge pass: out = Σ e^{m_i−M} acc_i / max(Σ e^{m_i−M} l_i,
    1e-30) with M = max_i m_i, a split with m = -inf weighing 0; (B, H, n),
    (B, H, n), (B, H, n, hd) → (B, H, hd) in ``dtype``."""
    M = m.amax(-1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(M), 0.0, M)))
    num = (w[..., None] * acc).sum(-2)
    den = (w * l).sum(-1).clamp(min=1e-30)
    return (num / den[..., None]).to(dtype)


def flash_decode_split_ref(q, k, v, valid, n_split: int, tps: int,
                           tile: int) -> torch.Tensor:
    """``flash_decode_ref`` computed split by split and merged: k/v
    (B, S, Hkv, hd) views as the dense kernel takes them."""
    m, l, acc = split_partials(q, k.transpose(1, 2), v.transpose(1, 2),
                               valid, tile, n_split, tps)
    return merge_splits(m, l, acc, q.dtype)


def flash_decode_paged_split_ref(q, k, v, table, valid, n_split: int,
                                 tps: int) -> torch.Tensor:
    """``flash_decode_paged_ref`` computed split by split (a tile is one
    block) and merged."""
    kl, vl = _paged_rows(k, v, table)
    m, l, acc = split_partials(q, kl, vl, valid, k.shape[2], n_split, tps)
    return merge_splits(m, l, acc, q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, lse: bool = False):
    """q (B, H, hd); k/v (B, S, Hkv, hd), strided views allowed; valid
    (B, S) bool → (B, H, hd); with ``lse`` also the (B, H) float32
    log-sum-exp (``_attend``)."""
    return _attend(q, k.transpose(1, 2), v.transpose(1, 2), valid, lse)


def flash_decode_paged_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k/v (N, Hkv, bt, hd) block pools; table (B, nb) int32
    (-1 = unallocated, read as block 0 and masked by ``valid``); valid
    (B, nb·bt) bool → (B, H, hd) in q's dtype."""
    return _attend(q, *_paged_rows(k, v, table), valid)


def _paged_rows(k: torch.Tensor, v: torch.Tensor, table: torch.Tensor):
    """The block pools gathered through the table as (B, Hkv, nb·bt, hd)
    rows; -1 entries read block 0."""
    B, nb = table.shape
    Hkv, bt, hd = k.shape[1], k.shape[2], k.shape[3]
    idx = torch.clamp(table.long(), min=0)
    kl = k[idx].permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bt, hd)
    vl = v[idx].permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bt, hd)
    return kl, vl
