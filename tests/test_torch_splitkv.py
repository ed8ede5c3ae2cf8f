"""The split-KV arithmetic of the decode-attention kernels, on the CPU.

The CUDA kernels cut each (row, KV head)'s tiles across CTAs
(``ops.decode_splits``) and merge float32 partials (m, l, acc); they run
only on a card (tests/test_torch_cuda.py). Here the split rule is checked
on its own, and the plain split-then-merge mirror (``ref.split_partials``,
``ref.merge_splits``) is held against the one-pass plain versions and the
reference's oracles on the same numpy inputs, including splits and rows
with no valid slot and a vacant paged row (a table of -1 with ``valid[0]``
true, which reads block 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_torch
from repro_torch.kernels import ops, ref
from torch_threads import _one_thread  # noqa: F401

N_SM = 132                                  # an H100 SXM's SMs
HKV = 4


def _ranges(n_tiles, n_split, tps):
    return [(s * tps, min(n_tiles, (s + 1) * tps)) for s in range(n_split)]


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("n_tiles", [1, 18, 32, 256])
def test_decode_splits_cover_every_tile_once(B, n_tiles):
    n_split, tps = ops.decode_splits(B, HKV, n_tiles, N_SM)
    assert n_split >= 1 and tps >= 1
    assert (n_split, tps) == ops.decode_splits(B, HKV, n_tiles, N_SM)
    spans = _ranges(n_tiles, n_split, tps)
    assert all(e > a for a, e in spans)                  # none is empty
    covered = [t for a, e in spans for t in range(a, e)]
    assert covered == list(range(n_tiles))               # each tile once
    if n_split > 1:                  # >= 2 tiles each, ~1 CTA per SM
        assert all(e - a >= 2 for a, e in spans[:-1])
        assert n_split <= -(-N_SM // (B * HKV))
        # More tiles than warps: a whole number of tiles per warp.
        assert tps <= ops.DECODE_WARPS or tps % ops.DECODE_WARPS == 0
    if B * HKV >= N_SM:
        assert n_split == 1


@pytest.mark.parametrize("B,Hkv", [(64, 8), (33, 4), (132, 1)])
def test_decode_splits_one_when_rows_fill_the_card(B, Hkv):
    for n_tiles in (1, 18, 256):
        assert ops.decode_splits(B, Hkv, n_tiles, N_SM) == (1, n_tiles)


def test_decode_splits_small_batch_spreads_over_the_card():
    # One row of 4 KV heads over 256 blocks: 4 CTAs before the split, 128
    # after (33 wanted, in splits of 8 blocks).
    assert ops.decode_splits(1, HKV, 256, N_SM) == (32, 8)
    # The serving shapes: 8 rows over 18 blocks, 160 CTAs; over 32 blocks,
    # 5 splits of 7 would leave the warps uneven: 4 of 8.
    assert ops.decode_splits(8, HKV, 18, N_SM) == (5, 4)
    assert ops.decode_splits(8, HKV, 32, N_SM) == (4, 8)
    assert ops.decode_splits(1, HKV, 0, N_SM)[0] == 1    # nothing to split


# --------------------------------------------------------------------------
# the plain split-then-merge mirror
# --------------------------------------------------------------------------

def _dense(rep, S, lengths, seed=0, Hkv=2, hd=64):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, Hkv * rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    valid = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), valid)


def _close(got, want):
    # Split and one-pass float32 softmax, one bf16 rounding of the output:
    # one bf16 ulp, as the kernels are held to.
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -8)


@pytest.mark.parametrize("rep", [1, 3, 8])
def test_dense_split_merge_matches_reference(rep):
    S = 300
    q, k, v, valid = _dense(rep, S, [S, 161, 7])
    tq, tk, tv, tval = to_torch(q), to_torch(k), to_torch(v), \
        torch.from_numpy(valid)
    n_tiles = -(-S // ops.DECODE_TILE)
    n_split, tps = ops.decode_splits(3, 2, n_tiles, N_SM)
    assert n_split > 1
    got = ref.flash_decode_split_ref(tq, tk, tv, tval, n_split, tps,
                                     ops.DECODE_TILE).float().numpy()
    _close(got, ref.flash_decode_ref(tq, tk, tv, tval).float())
    _close(got, jref.flash_decode_ref(q, k, v, jnp.asarray(valid)))
    _close(got, jops.flash_decode_op(q, k, v, jnp.asarray(valid), bs=60))


@pytest.mark.parametrize("n_split,tps", [(1, 10), (2, 5), (5, 2), (10, 1)])
def test_dense_split_merge_any_split_count(n_split, tps):
    """Every cut of the same 10 tiles merges to the one-pass result."""
    S = 10 * ops.DECODE_TILE - 3
    q, k, v, valid = _dense(8, S, [S, 40])
    tq, tk, tv, tval = to_torch(q), to_torch(k), to_torch(v), \
        torch.from_numpy(valid)
    got = ref.flash_decode_split_ref(tq, tk, tv, tval, n_split, tps,
                                     ops.DECODE_TILE).float().numpy()
    _close(got, jref.flash_decode_ref(q, k, v, jnp.asarray(valid)))


def test_split_merge_masked_splits_and_rows():
    """Holes in ``valid`` leave whole splits without a valid slot (m =
    -inf, weight 0); a row with no valid slot gives zeros."""
    S, tile = 640, ops.DECODE_TILE
    q, k, v, valid = _dense(8, S, [S, S, S])
    valid[0, 100:600] = False          # splits 1-3 of row 0 all masked
    valid[1, :] = False                # an all-masked row
    valid[2, 1:] = False               # one valid slot
    tq, tk, tv, tval = to_torch(q), to_torch(k), to_torch(v), \
        torch.from_numpy(valid)
    n_split, tps = 5, 4                # 20 tiles, 128 positions per split
    m, l, acc = ref.split_partials(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                                   tval, tile, n_split, tps)
    assert torch.isinf(m[0, :, 1:4]).all() and (l[0, :, 1:4] == 0).all()
    assert (acc[0, :, 1:4] == 0).all() and torch.isfinite(m[0, :, 0]).all()
    assert torch.isinf(m[1]).all()
    got = ref.merge_splits(m, l, acc).float().numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    _close(got, ref.flash_decode_ref(tq, tk, tv, tval).float())
    want = np.asarray(jref.flash_decode_ref(q, k, v, jnp.asarray(valid)),
                      np.float32)
    _close(got[[0, 2]], want[[0, 2]])  # the oracle leaves row 1 NaN
    # One valid slot: the output is that slot's V row for every head.
    vrow = np.repeat(np.asarray(v, np.float32)[2, 0], 8, axis=0)
    _close(got[2], vrow)


def _paged(rep, nb, lengths, seed=0, Hkv=2, hd=64, bt=16):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    N = 1 + B * nb
    q = rng.standard_normal((B, Hkv * rep, hd)).astype(np.float32)
    k = rng.standard_normal((N, Hkv, bt, hd)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, bt, hd)).astype(np.float32)
    table = (1 + rng.permutation(N - 1)[:B * nb]).reshape(B, nb) \
        .astype(np.int32)
    lengths = np.asarray(lengths)
    table[np.arange(nb)[None, :] * bt >= lengths[:, None]] = -1
    valid = np.arange(nb * bt)[None, :] < lengths[:, None]
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), table, valid)


@pytest.mark.parametrize("rep", [1, 3, 8])
def test_paged_split_merge_matches_reference(rep):
    nb, bt = 18, 16
    q, k, v, table, valid = _paged(rep, nb, [nb * bt, 100, 17, 0])
    valid[3, 0] = True                 # a vacant row: table -1, valid[0]
    assert (table[3] == -1).all()
    args = (to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table),
            torch.from_numpy(valid))
    n_split, tps = ops.decode_splits(4, 2, nb, N_SM)
    assert n_split > 1
    got = ref.flash_decode_paged_split_ref(*args, n_split, tps)
    got = got.float().numpy()
    _close(got, ref.flash_decode_paged_ref(*args).float())
    _close(got, ops.flash_decode_paged(*args).float())
    _close(got, jops.flash_decode_paged_op(q, k, v, jnp.asarray(table),
                                           jnp.asarray(valid)))
    # The vacant row attends slot 0 of block 0 alone: its V row.
    vrow = np.repeat(np.asarray(v, np.float32)[0, :, 0], rep, axis=0)
    _close(got[3], vrow)


def test_paged_split_merge_holes_and_empty_rows():
    nb, bt = 32, 16
    q, k, v, table, valid = _paged(8, nb, [nb * bt, nb * bt, 40])
    valid[0, 48:400] = False           # blocks 3-24 of row 0 all masked
    valid[2] = False                   # an all-masked row
    args = (to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table),
            torch.from_numpy(valid))
    for n_split, tps in ((16, 2), (8, 4), ops.decode_splits(3, 2, nb, N_SM)):
        got = ref.flash_decode_paged_split_ref(*args, n_split, tps)
        got = got.float().numpy()
        assert np.isfinite(got).all() and (got[2] == 0).all()
        _close(got, ref.flash_decode_paged_ref(*args).float())
    _close(got[:2], jops.flash_decode_paged_op(
        q, k, v, jnp.asarray(table), jnp.asarray(valid))[:2])
