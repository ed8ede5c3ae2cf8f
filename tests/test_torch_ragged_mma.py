"""The ragged FFN kernels' tensor-core arithmetic and lane maps in plain
form (``kernels.ref``), on the CPU: the swap-AB order (k16 block products,
a float32 partial per scale group, scaled per column) against the plain
versions and the reference's jnp oracle, the lanes' decode and A-fragment
maps, and the shape rules the CUDA wrappers add. The kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant.qtensor import quantize as jquantize
from repro_torch.convert import to_torch
from repro_torch.kernels import ops, ref
from repro_torch.quant.qtensor import QuantizedTensor, unpack_codes_int8
from torch_threads import _one_thread  # noqa: F401

BM = 8


def _inputs(bits, group, seed, E=4, K=256, F=128, D=128, n_hi=2):
    """Hi and lo tiles interleaved, two tail tiles past n_live."""
    rng = np.random.default_rng(seed)
    w = {n: rng.standard_normal((E,) + s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                      ("w_down", (F, D)))}
    jlo = {n: jquantize(jnp.asarray(v, jnp.bfloat16), bits=bits,
                        group_size=group) for n, v in w.items()}
    jhi = {n: jnp.asarray(rng.standard_normal((n_hi,) + v.shape[1:]) * 0.1,
                          jnp.bfloat16) for n, v in w.items()}
    tile_eid = np.array([0, 1, 1, 3, 2, 3, 0, 2, 2, 2], np.int32)
    tile_slot = np.array([0, -1, -1, 1, -1, 1, 0, -1, -1, -1], np.int32)
    xs = jnp.asarray(rng.standard_normal((len(tile_eid) * BM, K)),
                     jnp.bfloat16)
    tlo = {n: QuantizedTensor(to_torch(q.packed), to_torch(q.scales), bits,
                              group, tuple(q.shape)) for n, q in jlo.items()}
    thi = {n: to_torch(h) for n, h in jhi.items()}
    return jlo, jhi, tlo, thi, tile_eid, tile_slot, xs


def _close(got, want, rows):
    # Float32 sums in another order, bf16 roundings that may flip: the
    # tolerance the card holds the kernels to, 2^-6 × max |want|.
    got, want = got[:rows].float(), want[:rows].float()
    tol = 2 ** -6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("case", ["mixed", "all_lo"])
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_swap_ab_order_matches_plain_and_reference(bits, group, case):
    jlo, jhi, tlo, thi, tile_eid, tile_slot, xs = _inputs(
        bits, group, seed=bits * 10 + group)
    if case == "all_lo":
        tile_slot = np.full_like(tile_slot, -1)
    n_live = len(tile_eid) - 2
    rows = n_live * BM
    x = to_torch(xs)
    te, ts = torch.from_numpy(tile_eid), torch.from_numpy(tile_slot)
    lo = [tlo[n] for n in ("w_gate", "w_up", "w_down")]
    kw = dict(bits=bits, group=group, bm=BM)
    h = ref.ragged_gateup_mma(x, te, ts, lo[0].packed, lo[0].scales,
                              lo[1].packed, lo[1].scales, thi["w_gate"],
                              thi["w_up"], **kw)
    h_ref = ref.ragged_gateup_ref(x, te, ts, lo[0].packed, lo[0].scales,
                                  lo[1].packed, lo[1].scales, thi["w_gate"],
                                  thi["w_up"], **kw)
    _close(h, h_ref, rows)
    y = ref.ragged_down_mma(h_ref, te, ts, lo[2].packed, lo[2].scales,
                            thi["w_down"], **kw)
    y_ref = ref.ragged_down_ref(h_ref, te, ts, lo[2].packed, lo[2].scales,
                                thi["w_down"], **kw)
    _close(y, y_ref, rows)
    # The whole FFN in the kernels' order against the reference's oracle.
    y_full = ref.ragged_down_mma(h, te, ts, lo[2].packed, lo[2].scales,
                                 thi["w_down"], **kw)
    y_jnp = jops.ragged_quant_ffn_op(xs, jnp.asarray(tile_eid),
                                     jnp.asarray(tile_slot), jlo, jhi,
                                     bits=bits, group=group, bm=BM,
                                     backend="jnp")
    _close(y_full, torch.from_numpy(np.asarray(y_jnp, np.float32)), rows)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_biased_decode_gives_qtensor_codes(bits):
    """Every one of the 256 byte values decodes, bit for bit, to the
    centred codes ``qtensor`` unpacks from it."""
    byte = torch.arange(256, dtype=torch.uint8)
    want = unpack_codes_int8(byte[:, None], bits)          # (256·epb, 1)
    got = ref.decode_biased(byte, bits).reshape(-1, 1)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def _covers_once(frag):
    cells = [v[:2] for v in frag.values()]
    assert len(frag) == 256 and len(set(cells)) == 256
    assert set(cells) == {(k, c) for k in range(16) for c in range(16)}


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lo_fragment_map_reads_the_packed_codes(bits):
    """The lo A fragment: register r, half h of lane 4·gid + tid holds
    K row 2·tid + h + 8·(r >> 1) of column 2·gid + (r & 1) (M row
    gid + 8·(r & 1), the permutation the epilogue undoes), each element of
    the 16×16 chunk once, read from the byte and bits ``qtensor`` packs it
    in; decoded from a random chunk, it gives ``qtensor``'s codes."""
    epb = 8 // bits
    frag = ref.lo_fragment_map(bits)
    _covers_once(frag)
    chunk = np.random.default_rng(bits).integers(
        0, 256, (16 // epb, 16), dtype=np.uint8)
    want = unpack_codes_int8(torch.from_numpy(chunk), bits)
    codes = ref.decode_biased(torch.from_numpy(chunk.reshape(-1)), bits)
    for (lane, r, h), (k, col, off, shift) in frag.items():
        gid, tid = lane >> 2, lane & 3
        assert (k, col) == (2 * tid + h + 8 * (r >> 1), 2 * gid + (r & 1))
        assert off == (k // epb) * 16 + col and shift == (k % epb) * bits
        assert float(codes[off, shift // bits]) == float(want[k, col])


def test_hi_fragment_map_is_the_mma_layout():
    """``ldmatrix.x4.trans`` from the hi ring's swizzled rows gives each
    lane the m16n8k16 A fragment of Wᵀ (rows = columns of w, columns = K):
    register r, half h of lane 4·gid + tid holds A[gid + 8·(r & 1)][2·tid +
    h + 8·(r >> 1)], each element once."""
    frag = ref.hi_fragment_map()
    _covers_once(frag)
    for (lane, r, h), (k, col) in frag.items():
        gid, tid = lane >> 2, lane & 3
        assert (k, col) == (2 * tid + h + 8 * (r >> 1), gid + 8 * (r & 1))


@pytest.mark.parametrize("bm,N,group,why", [
    (8, 128, 40, "multiple of 16"), (8, 96, 64, "multiple of 64"),
    (4, 128, 64, "bm=8"), (8, 128, 8, "multiple of 16")])
def test_cuda_shape_rules_reject(bm, N, group, why):
    with pytest.raises(ValueError, match=why):
        ops._cuda_shape_rules(bm, N, group)


def test_cuda_shape_rules_accept_and_check_alignment():
    buf = torch.zeros(64, dtype=torch.bfloat16)
    ops._cuda_shape_rules(8, 768, 64, buf, None)
    ops._cuda_shape_rules(8, 2048, 128, buf[8:])      # 16 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        ops._cuda_shape_rules(8, 768, 64, buf[1:])


@pytest.mark.parametrize("case", ["mixed", "all_lo"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pieces_of_k_keep_the_whole_k_order(bits, case):
    """K walked in pieces of whole scale groups (K = 12 groups, pieces of
    4 and of 5 groups, the last shorter), the float32 accumulators carried
    across pieces, gives the whole-K order bit for bit on both tiers."""
    group = 64
    jlo, jhi, tlo, thi, tile_eid, tile_slot, xs = _inputs(
        bits, group, seed=bits + 3, K=12 * group, F=12 * group)
    if case == "all_lo":
        tile_slot = np.full_like(tile_slot, -1)
    x = to_torch(xs)
    te, ts = torch.from_numpy(tile_eid), torch.from_numpy(tile_slot)
    lo = [tlo[n] for n in ("w_gate", "w_up", "w_down")]
    kw = dict(bits=bits, group=group, bm=BM)
    h = ref.ragged_gateup_mma(x, te, ts, lo[0].packed, lo[0].scales,
                              lo[1].packed, lo[1].scales, thi["w_gate"],
                              thi["w_up"], **kw)
    y = ref.ragged_down_mma(h, te, ts, lo[2].packed, lo[2].scales,
                            thi["w_down"], **kw)
    for gpc in (4, 5):
        hp = ref.ragged_gateup_mma(x, te, ts, lo[0].packed, lo[0].scales,
                                   lo[1].packed, lo[1].scales,
                                   thi["w_gate"], thi["w_up"], gpc=gpc, **kw)
        yp = ref.ragged_down_mma(h, te, ts, lo[2].packed, lo[2].scales,
                                 thi["w_down"], gpc=gpc, **kw)
        assert torch.equal(hp, h) and torch.equal(yp, y)


@pytest.mark.parametrize("nmat,K,pieces", [
    (2, 2048, 1), (1, 768, 1), (2, 4096, 1), (1, 12416, 1),
    (2, 10752, 1), (1, 14336, 2), (2, 14336, 2), (1, 512, 1)])
def test_ragged_piece_rule(nmat, K, pieces):
    """The shapes that fitted one piece still take one (the 30B's, the
    80B's and granite's K, and the old limits: down 12416, gate/up 10752
    at g = 64); Jamba's down and gate/up at K = 14336 take two equal
    pieces within the card's shared memory."""
    gpc = ops.ragged_piece(nmat, K, 64)
    G = K // 64
    assert -(-G // gpc) == pieces
    assert ops.ragged_smem_bytes(nmat, 64, gpc) <= ops.SMEM_MAX
    if pieces == 1:
        assert gpc == G
    # The old single-tile formula agrees where K fitted one piece.
    old = 8 * (K + 8) * 2 + 4 * nmat * (2048 + G * 32)
    assert (old <= ops.SMEM_MAX) == (pieces == 1)


def test_ragged_piece_rejects_a_group_beyond_shared_memory():
    with pytest.raises(ValueError, match="K=14336"):
        ops.ragged_piece(1, 14336, 14336)
