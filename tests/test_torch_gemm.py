"""The quantized GEMM kernels' launch plan and arithmetic order in plain
form, on the CPU: ``ops.gemm_plan`` (NT chunks of 8 rows per CTA, S ranges
of scale groups across K, each walked in pieces) covers every (expert,
row, scale group) once;
``ref.grouped_lo_mma`` (the kernels' swap-AB order per K range, the ranges
added in order) against the plain versions and the reference's jnp and
Pallas (interpret) GEMMs; the shape rules of the CUDA branch. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul as jquant_matmul
from repro.quant.qtensor import quantize as jquantize
from repro_torch.convert import to_torch
from repro_torch.kernels import ops, ref

SHAPES = [(K, N, g) for K, N, g in ((256, 64, 64), (2048, 768, 64),
                                    (768, 2048, 64), (2048, 768, 128),
                                    (512, 128, 16), (4096, 64, 32))]
CAPACITIES = (1, 5, 8, 9, 13, 16, 64, 136, 512)


def _cta_cells(E, C, K, N, group, plan):
    """The kernel's decode of blockIdx.x (column blocks fastest, then the
    chunk group j, then the expert e) and blockIdx.y (the K range z), as
    numpy arrays over the whole grid, and each CTA's rows and groups."""
    n_cb, n_j = -(-N // ops.GEMM_CTA_N), -(-C // (8 * plan.nt))
    bx = np.arange(E * n_j * n_cb)
    cb, j, e = bx % n_cb, (bx // n_cb) % n_j, bx // (n_cb * n_j)
    G = K // group
    rows = [(8 * plan.nt * jj, min(C, 8 * plan.nt * (jj + 1)))
            for jj in range(n_j)]
    groups = [(z * plan.gps, min(G, (z + 1) * plan.gps))
              for z in range(plan.n_split)]
    return (e, j, cb), rows, groups


def _partition(intervals, n):
    """Every interval non-empty, and in order they tile [0, n) once."""
    assert all(a < b for a, b in intervals)
    assert intervals[0][0] == 0 and intervals[-1][1] == n
    assert all(b == a2 for (_, b), (a2, _) in zip(intervals, intervals[1:]))


@pytest.mark.parametrize("n_sm", [132, 8])
@pytest.mark.parametrize("E", [1, 3, 128])
def test_gemm_plan_covers_every_cell_once(E, n_sm):
    for K, N, group in SHAPES:
        for C in CAPACITIES:
            plan = ops.gemm_plan(E, C, K, N, group, n_sm)
            assert plan == ops.gemm_plan(E, C, K, N, group, n_sm)
            assert plan.nt in ops.GEMM_NT
            if C <= 8:
                assert plan.nt == 1
            assert 1 <= plan.gpc <= plan.gps
            assert ops.gemm_smem_bytes(plan.nt, group, plan.gpc) <= \
                ops.GEMM_CTA_SMEM or plan.gpc == 1
            (e, j, cb), rows, groups = _cta_cells(E, C, K, N, group, plan)
            # (e, j, cb) runs over every expert × chunk group × column
            # block exactly once ...
            key = (e * len(rows) + j) * -(-N // ops.GEMM_CTA_N) + cb
            assert np.array_equal(np.sort(key), np.arange(key.size))
            assert e.max() == E - 1
            # ... each chunk group's rows and each range's scale groups
            # are non-empty and tile the expert's C rows and K/group groups.
            _partition(rows, C)
            _partition(groups, K // group)
            assert len(groups) == plan.n_split
            for a, b in groups:                # the pieces of each range
                _partition([(g - a, min(b, g + plan.gpc) - a)
                            for g in range(a, b, plan.gpc)], b - a)


def test_gemm_plan_splits_only_small_grids():
    """Decode of the padded dispatch (E = 128) needs no split and no
    pieces; a prefill capacity walks K = 2048 in pieces, not in ranges;
    the plain GEMM at one row cuts K across CTAs; the plan picks NT > 1
    only for more than 8 rows."""
    assert ops.gemm_plan(128, 8, 2048, 768, 64, 132) == (1, 1, 32, 32)
    assert ops.gemm_plan(128, 8, 768, 2048, 64, 132).n_split == 1
    prefill = ops.gemm_plan(128, 136, 2048, 768, 64, 132)
    assert prefill.nt == 4 and prefill.n_split == 1 and prefill.gpc < 32
    assert ops.gemm_plan(1, 1, 2048, 768, 64, 132).n_split > 1


def _gqmm_inputs(bits, C, seed, E=3, K=256, N=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((E, K, N)).astype(np.float32) * 0.1
    jq = jquantize(jnp.asarray(w, jnp.bfloat16), bits=bits, group_size=64)
    xg = jnp.asarray(rng.standard_normal((E, C, K)), jnp.bfloat16)
    return jq, xg


@pytest.mark.parametrize("n_split", [1, 4])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("C", [1, 8, 13, 136])
def test_grouped_lo_mma_matches_plain_and_reference(C, bits, n_split):
    jq, xg = _gqmm_inputs(bits, C, seed=C * 10 + bits)
    x, p, sc = to_torch(xg), to_torch(jq.packed), to_torch(jq.scales)
    got = ref.grouped_lo_mma(x, p, sc, bits, 64, n_split).float().numpy()
    plain = ref.grouped_lo_gemm(x, p, sc, bits, 64).float().numpy()
    want = np.asarray(jref.grouped_lo_gemm_jnp(xg, jq.packed, jq.scales,
                                               bits, 64), np.float32)
    # The same exact products and float32 sums in another order (k16
    # blocks, groups, ranges), one bf16 rounding that may flip: one bf16
    # ulp.
    np.testing.assert_allclose(got, plain, rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8)


@pytest.mark.parametrize("split", ["none", "plan"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 13, 128])
def test_split_form_matches_quant_matmul(M, bits, split):
    """The plain GEMM's kernel order (E = 1, C = M, K cut as the plan cuts
    it for 132 SMs) against the plain version (dequantize first) and the
    reference's Pallas kernel in interpret mode."""
    K, N = 256, 128
    rng = np.random.default_rng(M * 10 + bits)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    jq = jquantize(jnp.asarray(w, jnp.bfloat16), bits=bits, group_size=64)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    n_split = 1 if split == "none" else \
        ops.gemm_plan(1, M, K, N, 64, 132).n_split
    tx, tp, ts = to_torch(x), to_torch(jq.packed), to_torch(jq.scales)
    got = ref.grouped_lo_mma(tx[None], tp[None], ts[None], bits, 64,
                             n_split)[0].float().numpy()
    plain = ref.quant_matmul_ref(tx, tp, ts, bits, 64).float().numpy()
    pal = np.asarray(jquant_matmul(x, jq.packed, jq.scales, bits=bits,
                                   group=64, interpret=True), np.float32)
    # Products exact in both; the reference rounds code · scale to float32
    # first, and sums in another order: one bf16 ulp after the rounding.
    np.testing.assert_allclose(got, plain, rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(got, pal, rtol=2 ** -7, atol=2 ** -8)


@pytest.mark.parametrize("K,N,group,why", [
    (2048, 768, 8, "multiple of 16"), (2048, 768, 48, "multiple of group"),
    (2048, 96, 64, "multiple of 64"), (256, 128, 40, "multiple of group")])
def test_gemm_shape_rules_reject(K, N, group, why):
    with pytest.raises(ValueError, match=why):
        ops._gemm_shape_rules(K, N, group)


def test_gemm_shape_rules_accept_main_shapes_and_check_alignment():
    buf = torch.zeros(64, dtype=torch.uint8)
    for K, N, group in ((2048, 768, 64), (768, 2048, 64), (2048, 768, 128),
                        (768, 2048, 48)):
        ops._gemm_shape_rules(K, N, group, buf, buf[16:])
    with pytest.raises(ValueError, match="16-byte"):
        ops._gemm_shape_rules(2048, 768, 64, buf, buf[8:])
    with pytest.raises(ValueError, match="16-byte"):
        ops._gemm_shape_rules(2048, 768, 64,
                              torch.zeros(64, dtype=torch.bfloat16)[1:])
