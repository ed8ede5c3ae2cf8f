"""The ragged FFN's all-hi (dense bf16) mode, the fp16 and offload
backends' expert compute, on the CPU: the plain versions against the
reference's ``ragged_dense_ffn_op`` (its jnp oracle, as the reference's
own tests run it), the kernel's arithmetic order (``ref.*_mma``) against
the plain versions, the wrapper's checks, and dense dict banks through
both MoE dispatches against each other and the reference's ``moe_apply``.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-30b-a3b"
BM = 8


@pytest.fixture(scope="module")
def model():
    """The reduced 30B's reference weights (4 experts, d 256, F 512) and
    their conversion."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tp


def _bf16_close(got, want):
    """The float32 products run in another summation order than XLA's:
    about one bf16 rounding in 10^3 flips (measured: 8 of 18,432 gate
    outputs at K = 256), and a flipped h moves y by about one bf16 ulp of
    its magnitude. So: at most 1% of elements differ, each by at most
    2^-7 relative (or 2^-7 of the largest magnitude)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.mean(got != want) <= 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def _layer(tree, l=0):
    return {k: v[l] for k, v in tree.items()}


def _tiles(tile_eid, K, seed):
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(rng.standard_normal((len(tile_eid) * BM, K)),
                     jnp.bfloat16)
    return xs, np.asarray(tile_eid, np.int32)


# Every expert, one twice in a row; the last two tiles are tail tiles
# (repeating the last live expert, as ``ragged_tile_map`` leaves them).
TILE_EID = [0, 1, 1, 3, 2, 3, 0, 2, 2]
N_LIVE = 7


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_ffn_plain_matches_reference(model, layer):
    """``ops.ragged_dense_ffn`` on the CPU (the plain version) against the
    reference's ``ragged_dense_ffn_op`` on every row: both take each tile's
    product in float32 and round to bf16 once, with the same SiLU
    epilogue, up to the summation order (``_bf16_close``)."""
    jcfg, jp, tp = model
    jbank = _layer(jp["blocks"]["0"]["moe"]["experts"], layer)
    tbank = _layer(tp["blocks"]["0"]["moe"]["experts"], layer)
    xs, te = _tiles(TILE_EID, jcfg.d_model, seed=layer)
    want = jops.ragged_dense_ffn_op(xs, jnp.asarray(te), jbank, bm=BM,
                                    backend="jnp")
    n = torch.tensor([N_LIVE], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    got = ops.ragged_dense_ffn(to_torch(xs), torch.from_numpy(te), n, tbank,
                               bm=BM)
    assert ops.LAUNCHES == before            # the CPU launches no kernel
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want)
    # The two halves compose into the whole.
    h = ref.ragged_dense_gateup_ref(to_torch(xs), torch.from_numpy(te),
                                    tbank["w_gate"], tbank["w_up"], bm=BM)
    assert torch.equal(ref.ragged_dense_down_ref(
        h, torch.from_numpy(te), tbank["w_down"], bm=BM), got)


def _close(got, want, rows):
    # Float32 sums in another order, bf16 roundings that may flip: the
    # tolerance the card holds the kernels to, 2^-6 × max |want|.
    got, want = got[:rows].float(), want[:rows].float()
    tol = 2 ** -6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_dense_mma_order_matches_plain(model):
    """The kernel's arithmetic order (k16 block products summed in turn
    into a float32 accumulator, every tile on the hi branch) against the
    plain versions: within the card's tolerance, not bit-equal (the plain
    product sums K in another order)."""
    jcfg, _, tp = model
    bank = _layer(tp["blocks"]["0"]["moe"]["experts"])
    xs, te = _tiles(TILE_EID, jcfg.d_model, seed=5)
    x, t = to_torch(xs), torch.from_numpy(te)
    rows = N_LIVE * BM
    h = ref.ragged_dense_gateup_mma(x, t, bank["w_gate"], bank["w_up"],
                                    bm=BM)
    h_ref = ref.ragged_dense_gateup_ref(x, t, bank["w_gate"], bank["w_up"],
                                        bm=BM)
    _close(h, h_ref, rows)
    y = ref.ragged_dense_down_mma(h_ref, t, bank["w_down"], bm=BM)
    y_ref = ref.ragged_dense_down_ref(h_ref, t, bank["w_down"], bm=BM)
    _close(y, y_ref, rows)
    # The whole FFN in the kernel's order against the reference's oracle.
    y_full = ref.ragged_dense_down_mma(h, t, bank["w_down"], bm=BM)
    want = jops.ragged_dense_ffn_op(
        xs, jnp.asarray(te), _layer(model[1]["blocks"]["0"]["moe"]
                                    ["experts"]), bm=BM, backend="jnp")
    _close(y_full, torch.from_numpy(np.asarray(want, np.float32)), rows)


def test_dense_wrapper_checks(model):
    _, _, tp = model
    bank = _layer(tp["blocks"]["0"]["moe"]["experts"])
    te = torch.tensor(TILE_EID, dtype=torch.int32)
    n = torch.tensor([N_LIVE], dtype=torch.int32)
    x = torch.zeros((len(TILE_EID) * BM, 256), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        ops.ragged_dense_ffn(x.float(), te, n, bank, bm=BM)
    with pytest.raises(ValueError, match="rows"):
        ops.ragged_dense_ffn(x[:-BM], te, n, bank, bm=BM)
    with pytest.raises(ValueError, match="dense weights"):
        ops.ragged_dense_gateup(x, te, n, bank["w_gate"],
                                bank["w_up"][:, :128], bm=BM)
    with pytest.raises(ValueError, match="one element"):
        ops.ragged_dense_ffn(x, te, torch.zeros(2, dtype=torch.int32), bank,
                             bm=BM)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ragged_dense_down(torch.zeros((len(TILE_EID) * BM, 512),
                                          dtype=torch.bfloat16), te, n,
                              bank["w_down"].transpose(1, 2)
                              .contiguous().transpose(1, 2), bm=BM)


@pytest.mark.parametrize("K,N,bm,ok", [
    (256, 512, 8, True), (2048, 768, 8, True), (256, 96, 8, False),
    (200, 512, 8, False), (256, 512, 16, False)])
def test_dense_cuda_shape_rules(K, N, bm, ok):
    """What the CUDA entries take beyond the plain versions (checked
    before any launch): bm = 8, N a multiple of 64, K a multiple of 16,
    16-byte aligned operands."""
    x = torch.zeros((bm, K), dtype=torch.bfloat16)
    if ok:
        ops._dense_shape_rules(bm, K, N, x)
    else:
        with pytest.raises(ValueError):
            ops._dense_shape_rules(bm, K, N, x)
    with pytest.raises(ValueError, match="aligned"):
        ops._dense_shape_rules(8, 256, 512, torch.zeros(
            9, dtype=torch.bfloat16)[1:])


def _moe_inputs(model, T, seed):
    jcfg, jp, tp = model
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((T, jcfg.d_model)), jnp.bfloat16)
    valid = np.ones(T, bool)
    valid[1::3] = False                           # masked rows
    moe = jp["blocks"]["0"]["moe"]
    jrouter = {"router": moe["router"][0]}
    jbank = _layer(moe["experts"])
    trouter = {"router": tp["blocks"]["0"]["moe"]["router"][0]}
    tbank = _layer(tp["blocks"]["0"]["moe"]["experts"])
    return x, valid, jrouter, jbank, trouter, tbank


@pytest.mark.parametrize("capacity", [64, 8], ids=["drop_free", "drops"])
def test_dense_bank_ragged_matches_padded(model, capacity):
    """A dense dict bank (fp16 / offload) through the port's two layouts:
    the same sort, drop rule and combine, and on the CPU the same float32
    products rounded once, so every token is bit-equal, masked rows and
    ``row_counts`` included (the reference's
    ``test_dense_bank_ragged_matches_padded``)."""
    cfg = get_config(ARCH, reduced=True)
    T = 24
    x, valid, _, _, trouter, tbank = _moe_inputs(model, T, seed=capacity)
    for tv, n_rows in ((None, None), (valid, T)):
        kw = dict(n_rows=n_rows, token_valid=None if tv is None
                  else torch.from_numpy(tv))
        yp, ap = tmoe.moe_apply(trouter, tbank, to_torch(x), cfg.moe,
                                capacity, dispatch="padded", **kw)
        yr, ar = tmoe.moe_apply(trouter, tbank, to_torch(x), cfg.moe,
                                capacity, dispatch="ragged", **kw)
        assert torch.equal(yp, yr)
        assert torch.equal(ap.counts, ar.counts)
        assert float(ap.dropped) == float(ar.dropped)
        if n_rows is not None:
            assert torch.equal(ap.row_counts, ar.row_counts)
            assert not yp[torch.from_numpy(~tv)].any()
        if capacity == 8:
            assert float(ap.dropped) > 0


@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
@pytest.mark.parametrize("capacity", [64, 8], ids=["drop_free", "drops"])
def test_dense_bank_matches_reference_moe_apply(model, dispatch, capacity):
    """Each layout against the reference's ``moe_apply`` on the same dense
    bank (op by op, jnp backend): routing, counts, drops and row counts
    equal; every token's output up to the float32 summation order of the
    expert products (``_bf16_close``)."""
    jcfg = model[0]
    cfg = get_config(ARCH, reduced=True)
    T, n_rows = 24, 24
    x, valid, jrouter, jbank, trouter, tbank = _moe_inputs(model, T,
                                                           seed=11)
    yj, aj = jmoe.moe_apply(jrouter, jbank, x, jcfg.moe, capacity,
                            token_valid=jnp.asarray(valid), n_rows=n_rows,
                            dispatch=dispatch, gemm="jnp")
    yt, at = tmoe.moe_apply(trouter, tbank, to_torch(x), cfg.moe, capacity,
                            token_valid=torch.from_numpy(valid),
                            n_rows=n_rows, dispatch=dispatch)
    np.testing.assert_array_equal(np.asarray(aj.counts), at.counts.numpy())
    np.testing.assert_array_equal(np.asarray(aj.row_counts),
                                  at.row_counts.numpy())
    assert float(aj.dropped) == float(at.dropped)
    _bf16_close(yt.float().numpy(), yj)


@pytest.mark.parametrize("rows", [[1, 8, 9, 64, 65, 0, 513, 3],
                                  [0, 0, 7], [64] * 4, [1]])
def test_dense_runs_cover_the_live_tiles(rows):
    """The all-hi kernels' runs (``ops.dense_runs``, the kernel's run list
    in plain form) over the dispatch's tile map: every live tile in
    exactly one run, a run is one expert's consecutive tiles, at most
    ``DENSE_NT`` of them, in tile order; ceil(tiles / NT) runs per
    expert."""
    counts = torch.tensor(rows, dtype=torch.int64)
    _, te, n = tmoe.ragged_tile_map(counts, BM, int(counts.sum()))
    n = int(n)
    for cap in (ops.DENSE_NT, 3, 1):
        runs = ops.dense_runs(te, n, cap)
        covered = [t0 + i for _, t0, nt in runs for i in range(nt)]
        assert covered == list(range(n))
        assert all(1 <= nt <= cap for _, _, nt in runs)
        assert all(int(te[t0 + i]) == e for e, t0, nt in runs
                   for i in range(nt))
        tiles = [-(-r // BM) for r in rows]
        assert len(runs) == sum(-(-t // cap) for t in tiles)


def test_dense_runs_reject_an_unsorted_map():
    """The kernel needs each expert's tiles in one segment; the plain
    versions do not, so the order is checked where runs are formed."""
    te = torch.tensor(TILE_EID, dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.dense_runs(te, N_LIVE)
    # Tail tiles are not looked at.
    assert ops.dense_runs(torch.tensor([0, 2, 2, 1], dtype=torch.int32),
                          3) == [(0, 0, 1), (2, 1, 2)]


def test_dense_grid_is_persistent_and_static():
    """One wave of CTAs (per SM × SMs), never more than the items any
    routing of Tt tiles gives, at least one; shapes only."""
    assert ops.dense_grid(132, 1, 73, 12) == 132
    assert ops.dense_grid(132, 1, 641, 32) == 132
    assert ops.dense_grid(132, 2, 3, 12) == 36
    assert ops.dense_grid(132, 0, 5, 1) == 5
    assert ops.dense_grid(132, 1, 0, 12) == 1


def test_tensor_map_key_and_geometry():
    """A tensor map's cache key changes with the address, shape and strides
    (so a reallocated bank or another view gets its own map) and the box;
    the geometry is the tensor's dims and byte strides innermost first."""
    w = torch.zeros((4, 256, 128), dtype=torch.bfloat16)
    assert ops.tensor_map_geometry(w) == ((128, 256, 4), (256, 65536))
    x = torch.zeros((24, 80), dtype=torch.bfloat16)
    assert ops.tensor_map_geometry(x) == ((80, 24), (160,))
    key = ops.tensor_map_key(w, ops.DENSE_W_BOX)
    assert key == ops.tensor_map_key(w, ops.DENSE_W_BOX)
    assert key != ops.tensor_map_key(w.clone(), ops.DENSE_W_BOX)
    assert key != ops.tensor_map_key(w[:2], ops.DENSE_W_BOX)
    assert key != ops.tensor_map_key(w.view(4, 128, 256), ops.DENSE_W_BOX)
    assert key != ops.tensor_map_key(w, ops.DENSE_X_BOX)


def test_dense_plans_fit_in_shared_memory():
    """Each all-hi kernel's plan (consumer warps, ring slots) fits a CTA's
    shared memory at the most experts the wrappers take; the byte count is
    the kernels' layout (a gate/up slot of 8 warps: two matrices × two
    8 KB boxes, then 8 KB of rows)."""
    assert ops.dense_smem_bytes(2, 8, 4, 128) == \
        1024 + 4 * (2 * 2 * 8192 + 8 * 1024) + 256 + 4 * (3 * 128 + 17)
    for name, (warps, stages) in ops.DENSE_PLAN.items():
        nmat = 2 if name == "ragged_dense_gateup" else 1
        assert warps in (4, 8) and 2 <= stages <= 16
        assert ops.dense_smem_bytes(nmat, warps, stages,
                                    ops.DENSE_MAX_EXPERTS) <= ops.SMEM_MAX
