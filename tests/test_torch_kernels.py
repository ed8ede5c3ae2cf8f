"""The port's kernels (their plain versions, on the CPU) against the
reference's oracles and Pallas kernels (interpret mode). The CUDA kernels
against these plain versions: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.config import AttnConfig
from repro.quant.qtensor import quantize as jquantize
from repro_torch.convert import to_torch
from repro_torch.kernels import ops
from repro_torch.quant.qtensor import QuantizedTensor

BM = 8


def _ffn_inputs(bits, seed=0, E=4, K=128, F=128, D=128, n_hi=2):
    rng = np.random.default_rng(seed)
    w = {n: rng.standard_normal((E,) + s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                      ("w_down", (F, D)))}
    jlo = {n: jquantize(jnp.asarray(v, jnp.bfloat16), bits=bits,
                        group_size=64) for n, v in w.items()}
    jhi = {n: jnp.asarray(rng.standard_normal((n_hi,) + v.shape[1:]) * 0.1,
                          jnp.bfloat16) for n, v in w.items()}
    tile_eid = np.array([0, 1, 1, 3, 2, 2, 2], np.int32)
    tile_slot = np.array([0, -1, -1, 1, -1, -1, -1], np.int32)
    xs = jnp.asarray(rng.standard_normal((len(tile_eid) * BM, K)),
                     jnp.bfloat16)
    tlo = {n: QuantizedTensor(to_torch(q.packed), to_torch(q.scales), bits,
                              64, tuple(q.shape)) for n, q in jlo.items()}
    thi = {n: to_torch(h) for n, h in jhi.items()}
    return jlo, jhi, tlo, thi, tile_eid, tile_slot, xs


CASES = [(bits, case) for bits in (2, 4, 8)
         for case in ("mixed", "all_lo", "no_hi")]


@pytest.mark.parametrize("bits,case", CASES)
def test_ragged_ffn_matches_reference(bits, case):
    jlo, jhi, tlo, thi, tile_eid, tile_slot, xs = _ffn_inputs(bits)
    if case == "all_lo":
        tile_slot = np.full_like(tile_slot, -1)
    use_hi = case != "no_hi"
    args = (jnp.asarray(tile_eid), jnp.asarray(tile_slot), jlo,
            jhi if use_hi else None)
    y_jnp = jops.ragged_quant_ffn_op(xs, *args, bits=bits, group=64, bm=BM,
                                     backend="jnp")
    y_pal = jops.ragged_quant_ffn_op(xs, *args, bits=bits, group=64, bm=BM,
                                     backend="pallas")
    # Two live tiles fewer than the budget: tail rows are not compared.
    n_live = len(tile_eid) - 2
    y = ops.ragged_quant_ffn(to_torch(xs), torch.from_numpy(tile_eid),
                             torch.from_numpy(tile_slot),
                             torch.tensor([n_live], dtype=torch.int32),
                             tlo, thi if use_hi else None, bits=bits,
                             group=64, bm=BM)
    rows = n_live * BM
    got = y[:rows].float().numpy()
    # The plain version repeats the reference's arithmetic (float32 group
    # partials of exact products, bf16 roundings in the same places): on
    # the CPU it is bit-equal to the jnp oracle.
    np.testing.assert_array_equal(got, np.asarray(y_jnp, np.float32)[:rows])
    # The Pallas kernel sums groups in another order: one bf16 ulp.
    want = np.asarray(y_pal, np.float32)[:rows]
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_ragged_ffn_wrapper_rejects_bad_inputs():
    _, _, tlo, thi, tile_eid, tile_slot, xs = _ffn_inputs(4)
    x = to_torch(xs)
    args = (torch.from_numpy(tile_eid), torch.from_numpy(tile_slot),
            torch.tensor([7], dtype=torch.int32), tlo, thi)
    with pytest.raises(TypeError):
        ops.ragged_quant_ffn(x.float(), *args, bits=4, group=64, bm=BM)
    with pytest.raises(ValueError):
        ops.ragged_quant_ffn(x[:-BM], *args, bits=4, group=64, bm=BM)
    with pytest.raises(ValueError):
        ops.ragged_quant_ffn(x.t().contiguous().t(), *args, bits=4,
                             group=64, bm=BM)


def _paged_inputs(rep, seed=0, B=3, Hkv=2, hd=64, bt=16, nb=4):
    rng = np.random.default_rng(seed)
    H = Hkv * rep
    N = 1 + B * nb
    q = jnp.asarray(rng.standard_normal((B, H, hd)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((N, Hkv, bt, hd)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((N, Hkv, bt, hd)), jnp.bfloat16)
    table = (1 + rng.permutation(N - 1)[:B * nb]).reshape(B, nb) \
        .astype(np.int32)
    lengths = np.array([nb * bt, 21, 5])[:B]
    pos = lengths - 1
    table[np.arange(nb)[None, :] * bt >= lengths[:, None]] = -1
    valid = np.arange(nb * bt)[None, :] <= pos[:, None]
    return q, k, v, table, valid, pos, H, Hkv, hd


@pytest.mark.parametrize("rep", [1, 2, 8])
def test_flash_decode_paged_matches_reference(rep):
    q, k, v, table, valid, pos, H, Hkv, hd = _paged_inputs(rep)
    got = ops.flash_decode_paged(to_torch(q), to_torch(k), to_torch(v),
                                 torch.from_numpy(table),
                                 torch.from_numpy(valid)).float().numpy()
    want = np.asarray(jops.flash_decode_paged_op(
        q, k, v, jnp.asarray(table), jnp.asarray(valid)), np.float32)
    # Both: float32 softmax, one bf16 rounding of the output; the online
    # and the one-pass softmax differ by float32 rounding: one bf16 ulp.
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8)
    # Against the reference's decode attention (paged_view + _attend_cache):
    # it rounds logits and probabilities to bf16 before the PV dot, so the
    # two agree to a few bf16 ulps of the output only.
    acfg = AttnConfig(n_heads=H, n_kv_heads=Hkv, head_dim=hd)
    kl, vl = jlayers.paged_view(jlayers.PagedKVCache(k, v),
                                jnp.asarray(table))
    att = np.asarray(jlayers._attend_cache(
        q[:, None], kl, vl, jnp.asarray(pos, jnp.int32), acfg),
        np.float32).reshape(got.shape)
    np.testing.assert_allclose(got, att, rtol=0.05, atol=0.03)


def test_paged_view_matches_reference():
    from repro_torch.models.layers import PagedKVCache, paged_view
    q, k, v, table, *_ = _paged_inputs(2)
    jk, jv = jlayers.paged_view(jlayers.PagedKVCache(k, v),
                                jnp.asarray(table))
    tk, tv = paged_view(PagedKVCache(to_torch(k), to_torch(v)),
                        torch.from_numpy(table))
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


def test_flash_decode_paged_all_masked_row_is_zero():
    q, k, v, table, valid, *_ = _paged_inputs(2)
    valid[1] = False
    out = ops.flash_decode_paged(to_torch(q), to_torch(k), to_torch(v),
                                 torch.from_numpy(table),
                                 torch.from_numpy(valid))
    assert torch.isfinite(out.float()).all()
    assert (out[1] == 0).all()


def _gqmm_inputs(bits, C, seed=0, E=4, K=128, N=128):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((E, K, N)).astype(np.float32) * 0.1
    jq = jquantize(jnp.asarray(w, jnp.bfloat16), bits=bits, group_size=64)
    xg = jnp.asarray(rng.standard_normal((E, C, K)), jnp.bfloat16)
    return jq, xg


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("C", [8, 136])
def test_grouped_lo_gemm_matches_reference(bits, C):
    """The padded dispatch's grouped GEMM at its decode capacity (8) and at
    a prefill capacity (136) that the TPU kernel's tiling refuses."""
    jq, xg = _gqmm_inputs(bits, C)
    got = ops.grouped_lo_matmul(to_torch(xg), to_torch(jq.packed),
                                to_torch(jq.scales), bits, 64)
    got = got.float().numpy()
    want = np.asarray(jref.grouped_lo_gemm_jnp(xg, jq.packed, jq.scales,
                                               bits, 64), np.float32)
    # Same group-blocked arithmetic (float32 partials of exact products,
    # the scale after, one bf16 rounding); the float32 sum over the groups
    # runs in another order, so the rounding may flip: one bf16 ulp.
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8)
    if C % min(128, C):
        with pytest.raises(ValueError, match="not tileable"):
            jops.grouped_quant_matmul_op(xg, jq)
        return
    # The Pallas kernel sums the groups in another order: one bf16 ulp.
    pal = np.asarray(jops.grouped_quant_matmul_op(xg, jq), np.float32)
    np.testing.assert_allclose(got, pal, rtol=2 ** -7, atol=2 ** -7)


def _dense_inputs(rep, seed=0, B=3, Hkv=2, hd=64, S=48):
    """q (B, H, hd); the head-major cache (B, Hkv, S, hd) the port keeps
    and the (B, S, Hkv, hd) arrays the reference's kernel takes."""
    rng = np.random.default_rng(seed)
    H = Hkv * rep
    q = jnp.asarray(rng.standard_normal((B, H, hd)), jnp.bfloat16)
    ck = jnp.asarray(rng.standard_normal((B, Hkv, S, hd)), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal((B, Hkv, S, hd)), jnp.bfloat16)
    lengths = np.array([S, 21, 5])[:B]
    valid = np.arange(S)[None, :] < lengths[:, None]
    return q, ck, cv, valid


@pytest.mark.parametrize("rep", [1, 2, 8])
def test_flash_decode_matches_reference(rep):
    q, ck, cv, valid = _dense_inputs(rep)
    valid[2] = False                               # an all-masked row
    tk, tv = to_torch(ck), to_torch(cv)
    got = ops.flash_decode(to_torch(q), tk.transpose(1, 2),
                           tv.transpose(1, 2), torch.from_numpy(valid))
    got = got.float().numpy()
    k, v = ck.transpose(0, 2, 1, 3), cv.transpose(0, 2, 1, 3)
    pal = np.asarray(jops.flash_decode_op(q, k, v, jnp.asarray(valid),
                                          bs=16), np.float32)
    # Online (kernel) and one-pass (plain) float32 softmax, one bf16
    # rounding of the output: one bf16 ulp. The all-masked row is 0 in
    # both (the kernel's denominator floor).
    np.testing.assert_allclose(got, pal, rtol=2 ** -7, atol=2 ** -8)
    assert (got[2] == 0).all()
    # The reference's oracle leaves an all-masked row NaN: rows 0 and 1.
    want = np.asarray(jref.flash_decode_ref(q, k, v, jnp.asarray(valid)),
                      np.float32)
    np.testing.assert_allclose(got[:2], want[:2], rtol=2 ** -7, atol=2 ** -8)


def _qmm_inputs(bits, seed=0, M=16, K=256, N=128):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    jq = jquantize(jnp.asarray(w, jnp.bfloat16), bits=bits, group_size=64)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    tq = QuantizedTensor(to_torch(jq.packed), to_torch(jq.scales), bits, 64,
                         (K, N))
    return jq, x, tq


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_matmul_matches_reference(bits):
    jq, x, tq = _qmm_inputs(bits)
    got = ops.quant_matmul_op(to_torch(x), tq).float().numpy()
    # Dequantize to float32, then a float32 product: the float32 sums run
    # in other orders, so the one bf16 rounding may flip: one bf16 ulp.
    want = np.asarray(jref.quant_matmul_ref(x, jq.packed, jq.scales, bits,
                                            64), np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8)
    pal = np.asarray(jops.quant_matmul_op(x, jq), np.float32)
    np.testing.assert_allclose(got, pal, rtol=2 ** -7, atol=2 ** -8)


def test_new_wrappers_reject_bad_inputs():
    jq, xg = _gqmm_inputs(4, 8)
    x, p, sc = to_torch(xg), to_torch(jq.packed), to_torch(jq.scales)
    with pytest.raises(TypeError):
        ops.grouped_lo_matmul(x.float(), p, sc, 4, 64)
    with pytest.raises(ValueError):
        ops.grouped_lo_matmul(x[:2], p, sc, 4, 64)        # E disagrees
    with pytest.raises(ValueError):
        ops.grouped_lo_matmul(x, p, sc, 4, 48)            # K % group
    q, ck, cv, valid = _dense_inputs(2)
    tq, tk, tv = to_torch(q), to_torch(ck), to_torch(cv)
    tval = torch.from_numpy(valid)
    with pytest.raises(ValueError):                       # hd not last
        ops.flash_decode(tq, tk.permute(0, 2, 3, 1), tv.permute(0, 2, 3, 1),
                         tval)
    with pytest.raises(ValueError):                       # unlike views
        ops.flash_decode(tq, tk.transpose(1, 2),
                         tv.transpose(1, 2).contiguous(), tval)
    with pytest.raises(ValueError):
        ops.flash_decode(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                         tval[:, :-1])
    _, xm, tqm = _qmm_inputs(4)
    with pytest.raises(ValueError):
        ops.quant_matmul_op(to_torch(xm).t().contiguous().t(), tqm)
    with pytest.raises(ValueError):
        ops.quant_matmul_op(to_torch(xm)[:, :128], tqm)    # K disagrees


def test_launch_counts_only_on_the_card():
    """CPU tensors take the plain version and launch nothing."""
    ops.reset_launches()
    q, k, v, table, valid, *_ = _paged_inputs(2)
    ops.flash_decode_paged(to_torch(q), to_torch(k), to_torch(v),
                           torch.from_numpy(table), torch.from_numpy(valid))
    jq, xg = _gqmm_inputs(4, 8)
    ops.grouped_lo_matmul(to_torch(xg), to_torch(jq.packed),
                          to_torch(jq.scales), 4, 64)
    q, ck, cv, dvalid = _dense_inputs(2)
    ops.flash_decode(to_torch(q), to_torch(ck).transpose(1, 2),
                     to_torch(cv).transpose(1, 2), torch.from_numpy(dvalid))
    _, x, tq = _qmm_inputs(4)
    ops.quant_matmul_op(to_torch(x), tq)
    bank = {n: torch.zeros((2,) + s, dtype=torch.bfloat16)
            for n, s in (("w_gate", (64, 64)), ("w_up", (64, 64)),
                         ("w_down", (64, 64)))}
    ops.ragged_dense_ffn(torch.zeros((16, 64), dtype=torch.bfloat16),
                         torch.zeros(2, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32), bank, bm=8)
    assert ops.LAUNCHES == {"ragged_gateup": 0, "ragged_down": 0,
                            "ragged_dense_gateup": 0, "ragged_dense_down": 0,
                            "flash_decode_paged": 0, "grouped_lo_matmul": 0,
                            "flash_decode": 0, "quant_matmul": 0}
