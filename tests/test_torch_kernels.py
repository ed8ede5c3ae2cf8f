"""The port's kernels (their plain versions, on the CPU) against the
reference's oracles and Pallas kernels (interpret mode). The CUDA kernels
against these plain versions: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
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


def test_launch_counts_only_on_the_card():
    """CPU tensors take the plain version and launch nothing."""
    ops.reset_launches()
    q, k, v, table, valid, *_ = _paged_inputs(2)
    ops.flash_decode_paged(to_torch(q), to_torch(k), to_torch(v),
                           torch.from_numpy(table), torch.from_numpy(valid))
    assert ops.LAUNCHES == {"ragged_gateup": 0, "ragged_down": 0,
                            "flash_decode_paged": 0}
