"""The port's CUDA kernels and its serving path on a card, against the
plain PyTorch versions on the CPU. Needs an NVIDIA card: every test skips
without one. Imports no JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.quant.qtensor import quantize

BM = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _ffn_inputs(bits, E=6, K=256, F=128, D=256, n_hi=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lo = {n: quantize((torch.randn((E,) + s, generator=gen) * 0.1)
                      .to(torch.bfloat16), bits, 64)
          for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                       ("w_down", (F, D)))}
    hi = {n: (torch.randn((n_hi,) + tuple(q.shape[1:]), generator=gen)
              * 0.1).to(torch.bfloat16) for n, q in lo.items()}
    tile_eid = torch.tensor([0, 1, 1, 3, 2, 5, 5, 5], dtype=torch.int32)
    tile_slot = torch.tensor([0, -1, -1, 1, -1, -1, -1, -1],
                             dtype=torch.int32)
    xs = torch.randn((len(tile_eid) * BM, K), generator=gen) \
        .to(torch.bfloat16)
    return lo, hi, tile_eid, tile_slot, xs


def _to(d, dev):
    return {n: v.to(dev) for n, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("with_hi", [True, False])
def test_ragged_kernels_match_plain(cuda, bits, with_hi):
    lo, hi, tile_eid, tile_slot, xs = _ffn_inputs(bits)
    hi = hi if with_hi else None
    n_live = torch.tensor([len(tile_eid) - 1], dtype=torch.int32)
    want = ops.ragged_quant_ffn(xs, tile_eid, tile_slot, n_live, lo, hi,
                                bits=bits, group=64, bm=BM)
    before = dict(ops.LAUNCHES)
    got = ops.ragged_quant_ffn(xs.to(cuda), tile_eid.to(cuda),
                               tile_slot.to(cuda), n_live.to(cuda),
                               _to(lo, cuda), None if hi is None
                               else _to(hi, cuda), bits=bits, group=64,
                               bm=BM).cpu()
    rows = int(n_live) * BM
    # Float32 accumulation in another order; bf16 roundings may flip:
    # a few bf16 ulps at the largest magnitude.
    tol = 2 ** -6 * float(want[:rows].float().abs().max())
    assert float((got[:rows].float() - want[:rows].float()).abs().max()) \
        <= tol
    assert ops.LAUNCHES["ragged_gateup"] == before["ragged_gateup"] + 1
    assert ops.LAUNCHES["ragged_down"] == before["ragged_down"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 8, 16])
def test_flash_decode_paged_matches_plain(cuda, rep):
    rng = np.random.default_rng(rep)
    B, Hkv, hd, bt, nb = 3, 2, 128, 16, 4
    N = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, hd))) \
        .to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    table = torch.from_numpy((1 + rng.permutation(N - 1)[:B * nb])
                             .reshape(B, nb).astype(np.int32))
    lengths = torch.tensor([nb * bt, 21, 5])
    table[torch.arange(nb)[None, :] * bt >= lengths[:, None]] = -1
    valid = torch.arange(nb * bt)[None, :] < lengths[:, None]
    valid[2] = False                                  # an all-masked row
    want = ops.flash_decode_paged(q, k, v, table, valid)
    got = ops.flash_decode_paged(q.to(cuda), k.to(cuda), v.to(cuda),
                                 table.to(cuda), valid.to(cuda)).cpu()
    # Online vs one-pass float32 softmax, one bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("C", [1, 8, 13, 136])
def test_grouped_lo_matmul_matches_plain(cuda, bits, C):
    gen = torch.Generator().manual_seed(C)
    E, K, N = 3, 256, 192
    qt = quantize((torch.randn((E, K, N), generator=gen) * K ** -0.5)
                  .to(torch.bfloat16), bits, 64)
    xg = torch.randn((E, C, K), generator=gen).to(torch.bfloat16)
    want = ops.grouped_lo_matmul(xg, qt.packed, qt.scales, bits, 64)
    before = ops.LAUNCHES["grouped_lo_matmul"]
    got = ops.grouped_lo_matmul(xg.to(cuda), qt.packed.to(cuda),
                                qt.scales.to(cuda), bits, 64).cpu()
    # Float32 sums in another order, one bf16 rounding: a few bf16 ulps
    # at the largest magnitude.
    tol = 2 ** -6 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert ops.LAUNCHES["grouped_lo_matmul"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 8, 16])
@pytest.mark.parametrize("S", [5, 48, 300])
def test_flash_decode_matches_plain(cuda, rep, S):
    rng = np.random.default_rng(rep * 1000 + S)
    B, Hkv, hd = 3, 2, 128
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, hd))) \
        .to(torch.bfloat16)
    # Head-major caches, attended through (B, S, Hkv, hd) views.
    ck = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))) \
        .to(torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))) \
        .to(torch.bfloat16)
    valid = torch.arange(S)[None, :] < torch.tensor([S, S // 2 + 1, S])[
        :, None]
    valid[2] = False                                  # an all-masked row
    want = ops.flash_decode(q, ck.transpose(1, 2), cv.transpose(1, 2),
                            valid)
    ckd, cvd = ck.to(cuda), cv.to(cuda)
    got = ops.flash_decode(q.to(cuda), ckd.transpose(1, 2),
                           cvd.transpose(1, 2), valid.to(cuda)).cpu()
    # Online vs one-pass float32 softmax, one bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 13, 128])
def test_quant_matmul_matches_plain(cuda, bits, M):
    gen = torch.Generator().manual_seed(M)
    K, N = 512, 128
    qt = quantize((torch.randn((K, N), generator=gen) * K ** -0.5)
                  .to(torch.bfloat16), bits, 64)
    x = torch.randn((M, K), generator=gen).to(torch.bfloat16)
    want = ops.quant_matmul_op(x, qt)
    got = ops.quant_matmul_op(x.to(cuda), qt.to(cuda)).cpu()
    # Float32 sums in another order, one bf16 rounding.
    tol = 2 ** -6 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def _serve(cuda, name, **ecfg):
    """Serve three requests on a reduced model through the card; returns
    the launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.serving.requests import Request, make_prompts
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    kw = {"device": cuda}
    if name == "dynaexq":
        kw.update(n_hi_per_layer=2,
                  controller=ControllerConfig(update_interval_s=0.0))
    eng = InferenceEngine(cfg, init_params(cfg, device=cuda),
                          make_backend(name, **kw),
                          EngineConfig(max_slots=2, max_len=64, **ecfg),
                          device=cuda)
    ops.reset_launches()
    hs = [eng.submit(Request(tokens=make_prompts("text", cfg.vocab_size, 1,
                                                 n, seed=n)[0],
                             max_new_tokens=6)) for n in (20, 13, 37)]
    eng.drain()
    launches = dict(ops.LAUNCHES)
    assert all(len(h.tokens) == 6 for h in hs)
    if name == "dynaexq":
        eng.flush()
        for ctl in eng.backend.controllers.values():
            ctl.tm.check_invariants()
        assert eng.stats()["promotions"] > 0
    return launches


PAGED_KERNELS = ("ragged_gateup", "ragged_down", "flash_decode_paged")
DENSE_KERNELS = ("grouped_lo_matmul", "flash_decode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_engine_serves_on_the_card(cuda, name):
    launches = _serve(cuda, name)
    assert all(launches[k] > 0 for k in PAGED_KERNELS), launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_dense_padded_engine_serves_on_the_card(cuda, name):
    launches = _serve(cuda, name, paged=False, moe_dispatch="padded")
    assert all(launches[k] > 0 for k in DENSE_KERNELS), launches
    assert not any(launches[k] for k in PAGED_KERNELS), launches
