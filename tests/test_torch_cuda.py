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


def _bank(bits, group, E, K, F, D, n_hi, seed):
    gen = torch.Generator().manual_seed(seed)
    lo = {n: quantize((torch.randn((E,) + s, generator=gen) * s[0] ** -0.5)
                      .to(torch.bfloat16), bits, group)
          for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                       ("w_down", (F, D)))}
    hi = {n: (torch.randn((n_hi,) + tuple(q.shape[1:]), generator=gen)
              * q.shape[1] ** -0.5).to(torch.bfloat16)
          for n, q in lo.items()}
    return lo, hi, gen


# Hi and lo tiles interleaved; the last two tiles are tail tiles.
TILE_EID = [0, 1, 1, 3, 2, 3, 0, 2, 2, 2]
TILE_SLOT = [0, -1, -1, 1, -1, 1, 0, -1, -1, -1]


def _ragged_pair(cuda, lo, hi, tile_eid, tile_slot, n_live, xs, bits,
                 group):
    """The whole FFN on the CPU (plain versions) and on the card, and the
    rows to compare."""
    n = torch.tensor([n_live], dtype=torch.int32)
    te = torch.tensor(tile_eid, dtype=torch.int32)
    ts = torch.tensor(tile_slot, dtype=torch.int32)
    kw = dict(bits=bits, group=group, bm=BM)
    want = ops.ragged_quant_ffn(xs, te, ts, n, lo, hi, **kw)
    got = ops.ragged_quant_ffn(xs.to(cuda), te.to(cuda), ts.to(cuda),
                               n.to(cuda), _to(lo, cuda), _to(hi, cuda),
                               **kw).cpu()
    return got, want, n_live * BM


def _assert_ffn_close(got, want, rows):
    # Float32 accumulation in another order; bf16 roundings may flip:
    # a few bf16 ulps at the largest magnitude.
    tol = 2 ** -6 * float(want[:rows].float().abs().max())
    assert torch.isfinite(got[:rows].float()).all()
    assert float((got[:rows].float() - want[:rows].float()).abs().max()) \
        <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ragged_kernels_widths_and_groups(cuda, bits, group, width):
    """Hi and lo tiles interleaved with tail tiles, at the small test
    shape and at Qwen3-30B-A3B width (K = D = 2048, F = 768: many K
    stages of every ring)."""
    K, F, D = (256, 128, 256) if width == "small" else (2048, 768, 2048)
    lo, hi, gen = _bank(bits, group, 4, K, F, D, 2, bits * 1000 + group)
    xs = torch.randn((len(TILE_EID) * BM, K), generator=gen) \
        .to(torch.bfloat16)
    got, want, rows = _ragged_pair(cuda, lo, hi, TILE_EID, TILE_SLOT,
                                   len(TILE_EID) - 2, xs, bits, group)
    _assert_ffn_close(got, want, rows)


@pytest.mark.cuda
def test_ragged_kernels_without_live_tiles(cuda):
    """n_tiles = 0: every tile is a tail tile; both kernels launch and
    return without error."""
    lo, hi, gen = _bank(4, 64, 4, 256, 128, 256, 2, 7)
    xs = torch.randn((len(TILE_EID) * BM, 256), generator=gen) \
        .to(torch.bfloat16)
    before = dict(ops.LAUNCHES)
    got, _, rows = _ragged_pair(cuda, lo, hi, TILE_EID, TILE_SLOT, 0, xs, 4,
                                64)
    torch.cuda.synchronize()
    assert rows == 0 and got.shape == (len(TILE_EID) * BM, 256)
    assert ops.LAUNCHES["ragged_gateup"] == before["ragged_gateup"] + 1
    assert ops.LAUNCHES["ragged_down"] == before["ragged_down"] + 1


# The all-hi kernels' segments, in rows per expert: lengths that straddle
# a run of NT = 8 tiles (64 rows) and the 64-row K slots (1, 8, 9, 64, 65,
# 513: one hot expert of 9 runs), an expert with no rows, and a short last
# segment; ``ragged_tile_map`` adds the tail tiles.
DENSE_ROWS = [1, 8, 9, 64, 65, 0, 513, 3]


def _dense_bank(E, K, F, D, seed):
    gen = torch.Generator().manual_seed(seed)
    bank = {n: (torch.randn((E,) + s, generator=gen) * s[0] ** -0.5)
            .to(torch.bfloat16) for n, s in (("w_gate", (K, F)),
                                            ("w_up", (K, F)),
                                            ("w_down", (F, D)))}
    return bank, gen


def _dense_map(rows):
    """The dispatch's tile map for these segment lengths (rows per
    expert): (tile_eid, n_tiles) on the CPU."""
    from repro_torch.models.moe import ragged_tile_map
    counts = torch.tensor(rows, dtype=torch.int64)
    _, te, n = ragged_tile_map(counts, BM, int(counts.sum()))
    return te, n


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "30b", "80b"])
def test_ragged_dense_kernels_match_plain(cuda, width):
    """The all-hi (dense bf16) mode: every tile on its expert's weights of
    an (E, K, N) bank, runs of up to 8 tiles over segments of 1 … 513
    rows, an expert without rows, tail tiles left out; at the small test
    shape (K = 80: a partial K slot) and at the widths of Qwen3-30B-A3B
    (K = D = 2048, F = 768) and the flagship (F = 512). Also under forced
    grids (one CTA, and one per run), runs of one and three tiles, rings of
    two, three and six slots, and 4 and 8 consumer warps (items of 64 and
    128 columns: D = 192 leaves a partial item)."""
    K, F, D = {"small": (80, 128, 192), "30b": (2048, 768, 2048),
               "80b": (2048, 512, 2048)}[width]
    bank, gen = _dense_bank(len(DENSE_ROWS), K, F, D, K + F)
    te, n = _dense_map(DENSE_ROWS)
    xs = torch.randn((te.shape[0] * BM, K), generator=gen) \
        .to(torch.bfloat16)
    want = ops.ragged_dense_ffn(xs, te, n, bank, bm=BM)
    before = dict(ops.LAUNCHES)
    x, t, nd, bd = xs.to(cuda), te.to(cuda), n.to(cuda), _to(bank, cuda)
    got = ops.ragged_dense_ffn(x, t, nd, bd, bm=BM).cpu()
    rows = int(n) * BM
    _assert_ffn_close(got, want, rows)
    assert ops.LAUNCHES["ragged_dense_gateup"] == \
        before["ragged_dense_gateup"] + 1
    assert ops.LAUNCHES["ragged_dense_down"] == \
        before["ragged_dense_down"] + 1
    assert ops.LAUNCHES["ragged_gateup"] == before["ragged_gateup"]
    h = ops.ragged_dense_gateup(x, t, nd, bd["w_gate"], bd["w_up"], bm=BM)
    n_runs = len(ops.dense_runs(te, int(n)))
    for grid, cap, warps, stages in (
            (1, ops.DENSE_NT, None, None), (n_runs, ops.DENSE_NT, None, None),
            (None, 1, None, None), (None, 3, None, 2), (None, 8, 4, 6),
            (None, 8, 8, 3), (None, 2, 8, 2)):
        kw = dict(grid=grid, cap=cap, warps=warps, stages=stages)
        h2 = ops.ragged_dense_launch("ragged_dense_gateup", x, t, nd,
                                     (bd["w_gate"], bd["w_up"]), **kw)
        y2 = ops.ragged_dense_launch("ragged_dense_down", h2, t, nd,
                                     (bd["w_down"],), **kw)
        # The same sums in the same order, whatever CTA takes an item.
        assert torch.equal(h2[:rows], h[:rows]), kw
        _assert_ffn_close(y2.cpu(), want, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["shuffled", "split", "sorted"])
def test_ragged_dense_kernels_take_any_tile_order(cuda, order):
    """Tile maps in no sorted order: the dispatch's map of ``DENSE_ROWS``
    shuffled, and one with an expert in two separate places. Each is held
    to the plain version at 2^-6 of its largest magnitude, under the
    default launch and under runs of one and three tiles (the same sums
    per tile, so bit-equal to the default); ``sorted`` is the dispatch's
    own map through the same checks. The kernel then still launches
    cleanly (no trap ended the context)."""
    K, F, D = 256, 128, 192
    bank, gen = _dense_bank(len(DENSE_ROWS), K, F, D, 5)
    te, n = _dense_map(DENSE_ROWS)
    live = int(n)
    if order == "shuffled":
        perm = torch.randperm(live, generator=gen)
        te = torch.cat([te[:live][perm], te[live:]])
    elif order == "split":
        te = te.clone()
        te[:live] = torch.cat([te[live // 2:live], te[:live // 2]])
    xs = torch.randn((te.shape[0] * BM, K), generator=gen) \
        .to(torch.bfloat16)
    want = ops.ragged_dense_ffn(xs, te, n, bank, bm=BM)
    x, t, nd, bd = xs.to(cuda), te.to(cuda), n.to(cuda), _to(bank, cuda)
    got = ops.ragged_dense_ffn(x, t, nd, bd, bm=BM)
    rows = live * BM
    _assert_ffn_close(got.cpu(), want, rows)
    h = ops.ragged_dense_gateup(x, t, nd, bd["w_gate"], bd["w_up"], bm=BM)
    for cap in (1, 3):
        h2 = ops.ragged_dense_launch("ragged_dense_gateup", x, t, nd,
                                     (bd["w_gate"], bd["w_up"]), cap=cap)
        assert torch.equal(h2[:rows], h[:rows]), cap
    torch.cuda.synchronize()
    ids = te[:live].tolist()
    segments = 1 + sum(a != b for a, b in zip(ids, ids[1:]))
    n_experts = len([r for r in DENSE_ROWS if r])
    assert segments > n_experts if order != "sorted" else \
        segments == n_experts


@pytest.mark.cuda
def test_ragged_dense_kernels_reject_what_they_do_not_take(cuda):
    """The kernels never launch on a shape they cannot tile as it is: bm
    other than 8 and more than ``DENSE_MAX_TILES`` tiles raise before
    any launch; K that is not whole k16 steps, N that is not whole
    64-column boxes and a misaligned operand go to the kernel as
    zero-padded aligned copies, and equal the kernel on operands padded
    by hand (and the plain version to its tolerance)."""
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(4)

    def bank_of(E, K, N):
        return {n: (torch.randn((E,) + s, generator=gen) * 0.1).bfloat16()
                .to(cuda) for n, s in (("w_gate", (K, N)), ("w_up", (K, N)),
                                       ("w_down", (N, K)))}

    te = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    n = torch.full((1,), 2, dtype=torch.int32, device=cuda)
    rows = 2 * BM
    big = bank_of(2, 64, 64)
    xs = (torch.randn((rows, 64), generator=gen) * 0.5).bfloat16().to(cuda)
    many = torch.zeros(ops.DENSE_MAX_TILES + 1, dtype=torch.int32,
                       device=cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="tiles"):
        ops.ragged_dense_ffn(torch.zeros((many.shape[0] * BM, 64),
                                         dtype=torch.bfloat16, device=cuda),
                             many, n, big, bm=BM)
    with pytest.raises(ValueError, match="bm="):
        ops.ragged_dense_gateup(xs[:BM // 2], te[:1], n - 1,
                                big["w_gate"][:2], big["w_up"][:2],
                                bm=BM // 2)
    assert not any(ops.LAUNCHES.values())
    del big
    pad = torch.nn.functional.pad
    # (E, K, N): N = 96 is no whole number of 64-column boxes (gate/up's
    # F), K = 200 no whole number of k16 steps (then down's D).
    for E, K, N in ((2, 256, 96), (2, 200, 64)):
        bank = bank_of(E, K, N)
        xs = (torch.randn((rows, K), generator=gen) * 0.5).bfloat16() \
            .to(cuda)
        # Gate/up multiply over K and write N columns; down over N and K.
        Kp, Np = -(-K // 16) * 16, -(-N // 64) * 64
        Fp, Dp = -(-N // 16) * 16, -(-K // 64) * 64
        ops.reset_launches()
        h = ops.ragged_dense_gateup(xs, te, n, bank["w_gate"], bank["w_up"],
                                    bm=BM)
        y = ops.ragged_dense_down(h, te, n, bank["w_down"], bm=BM)
        hp = ops.ragged_dense_launch(
            "ragged_dense_gateup", pad(xs, (0, Kp - K)), te, n,
            tuple(pad(bank[w], (0, Np - N, 0, Kp - K))
                  for w in ("w_gate", "w_up")))
        yp = ops.ragged_dense_launch(
            "ragged_dense_down", pad(h, (0, Fp - N)), te, n,
            (pad(bank["w_down"], (0, Dp - K, 0, Fp - N)),))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ragged_dense_gateup"] == 2, (E, K, N)
        assert ops.LAUNCHES["ragged_dense_down"] == 2, (E, K, N)
        assert h.shape == (rows, N) and y.shape == (rows, K)
        assert torch.equal(h, hp[:, :N]) and torch.equal(y, yp[:, :K])
        hr = ref.ragged_dense_gateup_ref(xs.cpu(), te.cpu(),
                                         bank["w_gate"].cpu(),
                                         bank["w_up"].cpu(), bm=BM)
        _assert_ffn_close(h.cpu(), hr, rows)
        _assert_ffn_close(y.cpu(), ref.ragged_dense_down_ref(
            h.cpu(), te.cpu(), bank["w_down"].cpu(), bm=BM), rows)
    bank = bank_of(2, 64, 64)
    xs = (torch.randn((rows, 64), generator=gen) * 0.5).bfloat16().to(cuda)
    xm = torch.zeros(rows * 64 + 1, dtype=torch.bfloat16,
                     device=cuda)[1:].view(rows, 64)
    xm.copy_(xs)
    assert ops.dense_route(BM, 64, 64, 2, xm) == "copy"
    ops.reset_launches()
    got = ops.ragged_dense_ffn(xm, te, n, bank, bm=BM)
    want = ops.ragged_dense_ffn(xs, te, n, bank, bm=BM)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ragged_dense_gateup"] == 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ragged_dense_kernels_replay_in_a_cuda_graph(cuda):
    """Capture the all-hi FFN once, then rewrite tile_eid, n_tiles and the
    activations in place and replay: the output follows the new routing
    (the kernels read the map and n_tiles on the device, and the grid does
    not depend on them)."""
    E, K, F, D = 6, 256, 128, 256
    bank, gen = _dense_bank(E, K, F, D, 21)
    maps = [_dense_map(r) for r in ([3, 70, 0, 9, 1, 24],
                                    [0, 0, 130, 0, 0, 2],
                                    [8, 8, 8, 8, 8, 8],
                                    [0, 0, 0, 0, 0, 1])]
    Tt = max(te.shape[0] for te, _ in maps)
    pad = [torch.cat([te, te[-1:].expand(Tt - te.shape[0])]) for te, _ in maps]
    te_d = pad[0].to(cuda)
    n_d = maps[0][1].to(cuda)
    x_d = torch.randn((Tt * BM, K), generator=gen).to(torch.bfloat16).to(cuda)
    bd = _to(bank, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.ragged_dense_ffn(x_d, te_d, n_d, bd, bm=BM)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.ragged_dense_ffn(x_d, te_d, n_d, bd, bm=BM)
    for te, (_, n) in zip(pad, maps):
        xs = torch.randn((Tt * BM, K), generator=gen).to(torch.bfloat16)
        te_d.copy_(te)
        n_d.copy_(n)
        x_d.copy_(xs)
        before = dict(ops.LAUNCHES)
        graph.replay()
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before    # a replay calls no wrapper
        want = ops.ragged_dense_ffn(xs, te, n, bank, bm=BM)
        _assert_ffn_close(y.cpu(), want, int(n) * BM)


@pytest.mark.cuda
def test_ragged_ffn_replays_in_a_cuda_graph(cuda):
    """Capture the ragged FFN once, rewrite the tile map, the hi slots,
    n_tiles and the activations in place, replay: the output follows the
    new inputs (the kernels read the maps and n_tiles on the device)."""
    bits, group = 4, 64
    lo, hi, gen = _bank(bits, group, 4, 256, 128, 256, 2, 11)
    Tt = len(TILE_EID)
    xs = torch.randn((Tt * BM, 256), generator=gen).to(torch.bfloat16)
    te = torch.tensor(TILE_EID, dtype=torch.int32, device=cuda)
    ts = torch.tensor(TILE_SLOT, dtype=torch.int32, device=cuda)
    n = torch.tensor([Tt - 2], dtype=torch.int32, device=cuda)
    x = xs.to(cuda)
    lo_d, hi_d = _to(lo, cuda), _to(hi, cuda)
    kw = dict(bits=bits, group=group, bm=BM)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.ragged_quant_ffn(x, te, ts, n, lo_d, hi_d, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.ragged_quant_ffn(x, te, ts, n, lo_d, hi_d, **kw)
    new_eid = [3, 3, 0, 1, 2, 2, 1, 1, 1, 1]
    new_slot = [1, 1, -1, -1, 0, 0, -1, -1, -1, -1]
    new_x = torch.randn((Tt * BM, 256), generator=gen).to(torch.bfloat16)
    for live in (Tt - 4, Tt):
        te.copy_(torch.tensor(new_eid, dtype=torch.int32))
        ts.copy_(torch.tensor(new_slot, dtype=torch.int32))
        n.fill_(live)
        x.copy_(new_x)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.ragged_quant_ffn(
            new_x, torch.tensor(new_eid, dtype=torch.int32),
            torch.tensor(new_slot, dtype=torch.int32),
            torch.tensor([live], dtype=torch.int32), lo, hi, **kw)
        _assert_ffn_close(y.cpu(), want, live * BM)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 40])
def test_ragged_kernels_flagship_width(cuda, T):
    """The flagship's experts: 512 of them, T tokens routed top-10, K =
    2048, F = 512, int2 lo, g = 64; hi tiles from a pool of 2·n_hi = 128
    slots whose owners sit in slots 0-95 (past n_hi = 64); the tile map
    the port's dispatch builds, tail tiles included. Both kernels against
    their plain versions on the card, on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.models.moe import (_sort_routing, _tile_slots,
                                        ragged_tile_map)
    from repro_torch.core.ver import ExpertBankQ
    gen = torch.Generator(device=cuda).manual_seed(T)
    E, K, F, pool = 512, 2048, 512, 128
    lo = {n: quantize((torch.randn((E,) + s, generator=gen, device=cuda)
                       * s[0] ** -0.5).to(torch.bfloat16), 2, 64)
          for n, s in (("w_gate", (K, F)), ("w_up", (K, F)),
                       ("w_down", (F, K)))}
    hi = {n: (torch.randn((pool,) + tuple(q.shape[1:]), generator=gen,
                          device=cuda) * q.shape[1] ** -0.5)
          .to(torch.bfloat16) for n, q in lo.items()}
    owner = torch.full((pool,), -1, dtype=torch.int32, device=cuda)
    owner[:96] = torch.randperm(E, generator=gen, device=cuda)[:96] \
        .to(torch.int32)
    idx = torch.topk(torch.randn((T, E), generator=gen, device=cuda), 10,
                     dim=-1).indices
    # Route some tokens to owners of the highest slots.
    idx[0, :4] = owner[92:96].long()
    _, _, counts, _, _ = _sort_routing(idx, E)
    _, tile_eid, n_tiles = ragged_tile_map(counts, BM, T * 10)
    bank = ExpertBankQ(lo=lo, hi=hi, slot_owner=owner,
                       slot_map=torch.zeros((E,), dtype=torch.int32,
                                            device=cuda))
    tile_slot = _tile_slots(bank, tile_eid, E)
    live = int(n_tiles.item())
    assert live < tile_eid.shape[0]                      # tail tiles
    assert int(tile_slot[:live].max()) >= pool // 2      # a slot past n_hi
    xs = torch.randn((tile_eid.shape[0] * BM, K), generator=gen,
                     device=cuda).to(torch.bfloat16)
    kw = dict(bits=2, group=64, bm=BM)
    args = (lo["w_gate"].packed, lo["w_gate"].scales, lo["w_up"].packed,
            lo["w_up"].scales, hi["w_gate"], hi["w_up"])
    h_want = ref.ragged_gateup_ref(xs, tile_eid, tile_slot, *args, **kw)
    h_got = ops.ragged_gateup(xs, tile_eid, tile_slot, n_tiles, *args, **kw)
    dn = (lo["w_down"].packed, lo["w_down"].scales, hi["w_down"])
    y_want = ref.ragged_down_ref(h_want, tile_eid, tile_slot, *dn, **kw)
    y_got = ops.ragged_down(h_want, tile_eid, tile_slot, n_tiles, *dn, **kw)
    rows = live * BM
    _assert_ffn_close(h_got.cpu(), h_want.cpu(), rows)
    _assert_ffn_close(y_got.cpu(), y_want.cpu(), rows)


def _paged_case(case, rep, hd, rng, Hkv=2, bt=16):
    """q, k, v, table, valid of one paged decode case, and the rows that
    must come out as zeros. ``short``: 3 rows over 4 blocks, one
    all-masked; ``long``: one row over 256 blocks (several splits);
    ``holes``: 256 blocks of which only the first 2 and the last 56 hold
    valid slots (whole splits masked) and an all-masked row; ``vacant``: a
    row with a table of -1 and ``valid[0]`` true, which reads block 0."""
    B, nb = {"short": (3, 4), "long": (1, 256), "holes": (2, 256),
             "vacant": (3, 18)}[case]
    N = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, hd))) \
        .to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    table = torch.from_numpy((1 + rng.permutation(N - 1)[:B * nb])
                             .reshape(B, nb).astype(np.int32))
    lengths = {"short": [nb * bt, 21, 5], "long": [nb * bt],
               "holes": [nb * bt, nb * bt], "vacant": [nb * bt, 0, 40]}[case]
    lengths = torch.tensor(lengths)
    table[torch.arange(nb)[None, :] * bt >= lengths[:, None]] = -1
    valid = torch.arange(nb * bt)[None, :] < lengths[:, None]
    zero_rows = []
    if case == "short":
        valid[2] = False
        zero_rows = [2]
    elif case == "holes":
        valid[0, 2 * bt:200 * bt] = False
        valid[1] = False
        zero_rows = [1]
    elif case == "vacant":
        valid[1, 0] = True
    return q, k, v, table, valid, zero_rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short", "long", "holes", "vacant"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 3, 8, 16])
def test_flash_decode_paged_matches_plain(cuda, rep, hd, case):
    rng = np.random.default_rng(rep * 100 + hd)
    q, k, v, table, valid, zero_rows = _paged_case(case, rep, hd, rng)
    want = ops.flash_decode_paged(q, k, v, table, valid)
    before = ops.LAUNCHES["flash_decode_paged"]
    got = ops.flash_decode_paged(q.to(cuda), k.to(cuda), v.to(cuda),
                                 table.to(cuda), valid.to(cuda)).cpu()
    # Online vs one-pass float32 softmax, one bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)
    for r in zero_rows:
        assert (got[r] == 0).all()
    # One count per call, whether the merge pass ran or not.
    assert ops.LAUNCHES["flash_decode_paged"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [18, 32])
def test_flash_decode_paged_flagship_heads(cuda, nb):
    """The flagship's heads (H = 16, Hkv = 2, hd = 256: rep 8) at its
    serving shape, 8 rows of random lengths (row 0 full), -1 entries past
    each row's blocks."""
    rng = np.random.default_rng(nb)
    B, H, Hkv, hd, bt = 8, 16, 2, 256, 16
    N = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, H, hd))).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    table = torch.from_numpy((1 + rng.permutation(N - 1)[:B * nb])
                             .reshape(B, nb).astype(np.int32))
    lengths = torch.from_numpy(rng.integers(1, nb * bt + 1, B))
    lengths[0] = nb * bt
    table[torch.arange(nb)[None, :] * bt >= lengths[:, None]] = -1
    valid = torch.arange(nb * bt)[None, :] < lengths[:, None]
    want = ops.flash_decode_paged(q, k, v, table, valid)
    got = ops.flash_decode_paged(q.to(cuda), k.to(cuda), v.to(cuda),
                                 table.to(cuda), valid.to(cuda)).cpu()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 48, 80, 128])
@pytest.mark.parametrize("rep", [1, 8])
def test_flash_decode_paged_wide_blocks(cuda, rep, bt):
    """Blocks of more than 16 slots at hd=64 (bt·hd up to 8192): row 0
    full, row 1 valid only in the last 16 slots of each block (past slot
    64 when bt=128), row 2 valid only in the last slot of block 3."""
    rng = np.random.default_rng(rep * 10 + bt)
    B, nb, Hkv, hd = 3, 6, 2, 64
    N = 1 + B * nb
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, hd))) \
        .to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((N, Hkv, bt, hd))) \
        .to(torch.bfloat16)
    table = torch.from_numpy((1 + rng.permutation(N - 1)[:B * nb])
                             .reshape(B, nb).astype(np.int32))
    valid = torch.zeros((B, nb, bt), dtype=torch.bool)
    valid[0] = True
    valid[1, :, bt - 16:] = True
    valid[2, 3, bt - 1] = True
    valid = valid.reshape(B, nb * bt)
    want = ops.flash_decode_paged(q, k, v, table, valid)
    got = ops.flash_decode_paged(q.to(cuda), k.to(cuda), v.to(cuda),
                                 table.to(cuda), valid.to(cuda)).cpu()
    # Online vs one-pass float32 softmax, one bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)


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


def _gqmm(bits, E, C, K, N, seed, group=64):
    gen = torch.Generator().manual_seed(seed)
    qt = quantize((torch.randn((E, K, N), generator=gen) * K ** -0.5)
                  .to(torch.bfloat16), bits, group)
    xg = torch.randn((E, C, K), generator=gen).to(torch.bfloat16)
    return qt, xg


def _forced(monkeypatch, nt=None, n_split=None, pieces=None):
    """Make ``ops.gemm_plan`` return its plan with NT, the number of K
    ranges and/or the pieces per range forced."""
    rule = ops.gemm_plan

    def plan(E, C, K, N, group, n_sm):
        p = rule(E, C, K, N, group, n_sm)
        G = K // group
        t = p.nt if nt is None else nt
        gps = p.gps if n_split is None else -(-G // n_split)
        gpc = ops.gemm_piece(t, group, gps) if pieces is None else \
            -(-gps // pieces)
        return ops.GemmPlan(t, -(-G // gps), gps, gpc)

    monkeypatch.setattr(ops, "gemm_plan", plan)


def _assert_gemm_close(got, want):
    # Float32 sums in another order, one bf16 rounding: a few bf16 ulps at
    # the largest magnitude.
    tol = 2 ** -6 * float(want.float().abs().max())
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [1, 3])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("nt", [1, 2, 4])
def test_grouped_lo_matmul_forced_nt(cuda, monkeypatch, nt, bits, pieces):
    """Every NT the kernel is built for, at C = 37 (chunk groups of NT·8
    rows, the last one partial) and at a decode C = 8, each CTA walking
    K = 512 whole or in pieces of 3, 3 and 2 scale groups."""
    _forced(monkeypatch, nt=nt, pieces=pieces)
    for C in (37, 8):
        qt, xg = _gqmm(bits, 3, C, 512, 192, seed=nt * 10 + bits + C)
        want = ops.grouped_lo_matmul(xg, qt.packed, qt.scales, bits, 64)
        got = ops.grouped_lo_matmul(xg.to(cuda), qt.packed.to(cuda),
                                    qt.scales.to(cuda), bits, 64).cpu()
        _assert_gemm_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [13, 128])
@pytest.mark.parametrize("n_split", [1, 2, 8])
def test_quant_matmul_forced_splits(cuda, monkeypatch, n_split, M):
    """The plain GEMM with K cut into 1, 2 and 8 ranges (float32 partials
    added in order by the second kernel), against the plain version."""
    _forced(monkeypatch, n_split=n_split)
    assert ops.gemm_plan(1, M, 512, 128, 64, 132).n_split == n_split
    gen = torch.Generator().manual_seed(n_split * 100 + M)
    qt = quantize((torch.randn((512, 128), generator=gen) * 512 ** -0.5)
                  .to(torch.bfloat16), 4, 64)
    x = torch.randn((M, 512), generator=gen).to(torch.bfloat16)
    before = ops.LAUNCHES["quant_matmul"]
    got = ops.quant_matmul_op(x.to(cuda), qt.to(cuda)).cpu()
    assert ops.LAUNCHES["quant_matmul"] == before + 1
    _assert_gemm_close(got, ops.quant_matmul_op(x, qt))


@pytest.mark.cuda
def test_grouped_lo_matmul_replays_in_a_cuda_graph(cuda):
    """Capture the grouped GEMM once (with a split of K, so both kernels
    are in the graph), rewrite the activations in place, replay: the
    output follows the new input."""
    qt, xg = _gqmm(4, 2, 13, 512, 128, seed=3)
    n_split = ops.gemm_plan(2, 13, 512, 128, 64, 132).n_split
    assert n_split > 1
    x = xg.to(cuda)
    p, sc = qt.packed.to(cuda), qt.scales.to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.grouped_lo_matmul(x, p, sc, 4, 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.grouped_lo_matmul(x, p, sc, 4, 64)
    for seed in (4, 5):
        new_x = torch.randn(xg.shape, generator=torch.Generator()
                            .manual_seed(seed)).to(torch.bfloat16)
        x.copy_(new_x)
        graph.replay()
        torch.cuda.synchronize()
        _assert_gemm_close(y.cpu(), ops.grouped_lo_matmul(
            new_x, qt.packed, qt.scales, 4, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 13, 21])
def test_grouped_gemm_stores_only_rows_below_c(cuda, C):
    """C not a multiple of 8: the kernel, called through its C entry on an
    output buffer longer than (E, C, N) and filled with NaN, writes every
    row of every expert (none is left NaN or takes a padding row's zeros
    from the expert before it) and nothing past the last expert's rows."""
    from repro_torch.kernels import build
    E, K, N, bits = 4, 256, 128, 4
    qt, xg = _gqmm(bits, E, C, K, N, seed=C)
    want = ops.grouped_lo_matmul(xg, qt.packed, qt.scales, bits, 64)
    x, p, sc = xg.to(cuda), qt.packed.to(cuda), qt.scales.to(cuda)
    for nt in (1, 2, 4):
        out = torch.full(((E * C + 24) * N,), float("nan"),
                         dtype=torch.bfloat16, device=cuda)
        err = build.library("grouped_quant_matmul").grouped_quant_matmul(
            x.data_ptr(), p.data_ptr(), sc.data_ptr(), out.data_ptr(), None,
            E, C, K, N, bits, 64, nt, 1, K // 64, K // 64, ops._stream())
        build.check(err, "grouped_quant_matmul")
        torch.cuda.synchronize()
        got = out[:E * C * N].view(E, C, N).cpu()
        _assert_gemm_close(got, want)
        assert torch.isnan(out[E * C * N:].float()).all()


def _dense_case(case, rep, hd, rng, Hkv=2):
    """q, head-major caches (B, Hkv, S, hd), valid and the rows that must
    come out as zeros. ``S5``/``S48``/``S300``: 3 rows, ragged, one
    all-masked; ``long``: one row of 4096 positions (several splits);
    ``holes``: 4096 positions valid only in [0, 100) and [3900, 4096)
    (whole splits masked), and a row with ``valid[0]`` alone."""
    B, S = {"S5": (3, 5), "S48": (3, 48), "S300": (3, 300),
            "long": (1, 4096), "holes": (2, 4096)}[case]
    q = torch.from_numpy(rng.standard_normal((B, Hkv * rep, hd))) \
        .to(torch.bfloat16)
    ck = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))) \
        .to(torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))) \
        .to(torch.bfloat16)
    valid = torch.ones((B, S), dtype=torch.bool)
    zero_rows = []
    if B == 3:
        valid[1, S // 2 + 1:] = False
        valid[2] = False
        zero_rows = [2]
    elif case == "holes":
        valid[0, 100:3900] = False
        valid[1, 1:] = False
    return q, ck, cv, valid, zero_rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S5", "S48", "S300", "long", "holes"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 3, 8, 16])
def test_flash_decode_matches_plain(cuda, rep, hd, case):
    rng = np.random.default_rng(rep * 1000 + hd)
    q, ck, cv, valid, zero_rows = _dense_case(case, rep, hd, rng)
    # Head-major caches, attended through (B, S, Hkv, hd) views.
    want = ops.flash_decode(q, ck.transpose(1, 2), cv.transpose(1, 2),
                            valid)
    ckd, cvd = ck.to(cuda), cv.to(cuda)
    before = ops.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q.to(cuda), ckd.transpose(1, 2),
                           cvd.transpose(1, 2), valid.to(cuda)).cpu()
    # Online vs one-pass float32 softmax, one bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8)
    for r in zero_rows:
        assert (got[r] == 0).all()
    assert ops.LAUNCHES["flash_decode"] == before + 1


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


# --------------------------------------------------------------------------
# The decode step as one CUDA graph, against eager decode
# --------------------------------------------------------------------------

PATHS = {"paged-ragged": dict(paged=True, moe_dispatch="ragged"),
         "dense-padded": dict(paged=False, moe_dispatch="padded")}


def _engine(cuda, name, path, update_interval_s=0.0, **ecfg):
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    kw = {"device": cuda}
    if name == "dynaexq":
        kw.update(n_hi_per_layer=2, controller=ControllerConfig(
            update_interval_s=update_interval_s))
    return InferenceEngine(cfg, init_params(cfg, seed=0, device=cuda),
                           make_backend(name, **kw),
                           EngineConfig(max_slots=2, max_len=64,
                                        **PATHS[path], **ecfg),
                           device=cuda)


def _submit(eng):
    from repro_torch.serving.requests import Request, make_prompts
    return [eng.submit(Request(tokens=make_prompts(
        "text", eng.cfg.vocab_size, 1, n, seed=n)[0], max_new_tokens=6))
        for n in (20, 13, 37)]


def _step(eng, graphed):
    """One engine step, graphed or under ``eager()``; returns the decode
    step's logits of the rows it decoded (None when it decoded nothing).
    Vacant rows are left out: they attend to whatever the trash block or
    their own unused row holds (the warm-up before capture writes there
    too), and nothing reads their logits."""
    import contextlib
    from repro_torch.serving.engine import eager
    steps = eng.counters["steps"]
    with contextlib.nullcontext() if graphed else eager():
        eng.step()
    if eng.counters["steps"] == steps:
        return None
    valid = torch.from_numpy(eng.decode_graph.inputs.host["row_valid"]
                             .copy()).to(eng.last_logits.device)
    return eng.last_logits[valid]


def _flagship_engine(cuda, name, path):
    """The reduced flagship (16 experts, a shared expert) with the
    default ``dynaexq`` (the global allocator) at int2 lo and int4-priced
    hi, a policy window every step."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("qwen3-moe-80b-a3b").reduced(num_experts=16)
    be = make_backend(name, lo_bits=2, hi_bits=4, device=cuda,
                      controller=ControllerConfig(update_interval_s=0.0))
    return InferenceEngine(cfg, init_params(cfg, seed=0, device=cuda), be,
                           EngineConfig(max_slots=2, max_len=64,
                                        **PATHS[path]), device=cuda)


def _serve_steps(cuda, name, path, graphed, make=None):
    """Serve three requests step by step on ``make(cuda, name, path)``
    (default ``_engine``); dynaexq flushes after every step, so what it
    publishes is a function of the tokens alone. Returns (tokens per
    request, logits per decode step, launches, engine)."""
    eng = (make or _engine)(cuda, name, path)
    ops.reset_launches()
    hs = _submit(eng)
    logits = []
    while eng.queue or any(h is not None for h in eng.slots):
        lg = _step(eng, graphed)
        if lg is not None:
            logits.append(lg)
        if name == "dynaexq":
            eng.flush()
    torch.cuda.synchronize()
    return [h.tokens for h in hs], logits, dict(ops.LAUNCHES), eng


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static", "dynaexq", "fp16", "offload"])
@pytest.mark.parametrize("path", list(PATHS))
def test_graph_matches_eager(cuda, path, name):
    toks_g, lg_g, launches_g, eng_g = _serve_steps(cuda, name, path, True)
    toks_e, lg_e, launches_e, eng_e = _serve_steps(cuda, name, path, False)
    assert eng_g.decode_graph.graph is not None
    assert eng_e.decode_graph.graph is None
    assert toks_g == toks_e
    assert launches_g == launches_e
    assert len(lg_g) == len(lg_e) > 0
    for step, (a, b) in enumerate(zip(lg_g, lg_e)):
        assert torch.equal(a, b), (step, float((a - b).abs().max()))
    if name == "dynaexq":
        assert eng_g.backend.hi_routed == eng_e.backend.hi_routed > 0
        for eng in (eng_g, eng_e):
            for ctl in eng.backend.controllers.values():
                ctl.tm.check_invariants()
    dense = ("ragged_dense_gateup", "ragged_dense_down")
    quant = ("ragged_gateup", "ragged_down", "grouped_lo_matmul")
    if name in ("fp16", "offload"):
        # The baselines' experts are dense: the all-hi mode on the ragged
        # path, a batched SwiGLU on the padded one; no quantized kernel.
        assert not any(launches_g[k] for k in quant), launches_g
        assert all(launches_g[k] > 0 for k in dense) == \
            (path == "paged-ragged"), launches_g
        assert eng_g.banks is None
    else:
        assert not any(launches_g[k] for k in dense), launches_g


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_flagship_global_dynaexq_graph_matches_eager(cuda, path):
    """The global allocator's bank (2·n_hi slots per layer, skewed across
    layers) and the shared expert under the graph: tokens, launches and
    decoded rows' logits as eager decode gives them."""
    toks_g, lg_g, launches_g, eng_g = _serve_steps(
        cuda, "dynaexq", path, True, make=_flagship_engine)
    toks_e, lg_e, launches_e, eng_e = _serve_steps(
        cuda, "dynaexq", path, False, make=_flagship_engine)
    assert eng_g.backend.allocator is not None
    assert eng_g.decode_graph.graph is not None
    assert toks_g == toks_e
    assert launches_g == launches_e
    assert len(lg_g) == len(lg_e) > 0
    for step, (a, b) in enumerate(zip(lg_g, lg_e)):
        assert torch.equal(a, b), (step, float((a - b).abs().max()))
    assert eng_g.backend.hi_routed == eng_e.backend.hi_routed > 0
    assert eng_g.backend.hi_sets() == eng_e.backend.hi_sets()
    assert eng_g.backend.device_bytes() == eng_e.backend.device_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_promotion_published_between_replays_is_served(cuda, path):
    """Capture with nothing published, publish between two replays: the
    next replay reads the new hi slots (``hi_routed`` rises), with logits
    equal to eager decode under the same published set."""
    engines = [_engine(cuda, "dynaexq", path, update_interval_s=1e9)
               for _ in range(2)]                  # graphed, eager
    for eng in engines:
        _submit(eng)
    for _ in range(2):
        for eng, graphed in zip(engines, (True, False)):
            _step(eng, graphed)
    assert engines[0].decode_graph.graph is not None
    assert [e.backend.hi_routed for e in engines] == [0, 0]
    for eng in engines:
        eng.backend.force_update()
        eng.flush()
    sets = [e.backend.hi_sets() for e in engines]
    assert sets[0] == sets[1]
    assert any(s for layers in sets[0].values() for s in layers)
    a, b = (_step(eng, graphed)
            for eng, graphed in zip(engines, (True, False)))
    assert engines[0].backend.hi_routed == engines[1].backend.hi_routed > 0
    assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_replays_run_while_promotion_copies_are_pending(cuda, path):
    """Hi copies held in flight on the side stream (queued behind a ~2 s
    spin) while replays run on the compute stream: the replays read only
    published slots, so their logits equal eager decode's under the same
    (empty) published set; once the copies land and publish, the next
    replay serves them from hi, again equal to eager."""
    engines = [_engine(cuda, "dynaexq", path, update_interval_s=1e9)
               for _ in range(2)]                  # graphed, eager
    for eng in engines:
        _submit(eng)
    for _ in range(2):
        for eng, graphed in zip(engines, (True, False)):
            _step(eng, graphed)
    assert engines[0].decode_graph.graph is not None
    tms = [[c.tm for c in e.backend.controllers.values()] for e in engines]
    for eng, managers in zip(engines, tms):
        for tm in managers:
            with torch.cuda.stream(tm._side):
                torch.cuda._sleep(4_000_000_000)
        eng.backend.force_update()               # copies queue behind it
        assert any(tm.inflight_bytes for tm in managers)
    for _ in range(2):
        a, b = (_step(eng, graphed)
                for eng, graphed in zip(engines, (True, False)))
        assert torch.equal(a, b), float((a - b).abs().max())
    # Still in flight after both replays: they ran while copies pended.
    assert all(any(tm.inflight_bytes for tm in m) for m in tms)
    assert [e.backend.hi_routed for e in engines] == [0, 0]
    for eng in engines:
        eng.flush()
    assert engines[0].backend.hi_sets() == engines[1].backend.hi_sets()
    a, b = (_step(eng, graphed)
            for eng, graphed in zip(engines, (True, False)))
    assert engines[0].backend.hi_routed == engines[1].backend.hi_routed > 0
    assert torch.equal(a, b), float((a - b).abs().max())
    for managers in tms:
        for tm in managers:
            tm.check_invariants()


@pytest.mark.cuda
def test_promotion_span_ends_after_its_copy_completes(cuda):
    """With a flight recorder on the engine, hi copies held in flight
    behind a ~2 s spin on the side stream open their ``promotion`` spans
    at issue and close none while their events have not completed
    (replays and policy ticks run meanwhile); every ``published=1`` end
    comes after its own copy's event completed, and the publish-latency
    histogram records each, spin included."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    from repro_torch.obs import ObsConfig, Observability
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    obs = Observability(ObsConfig())
    eng = InferenceEngine(
        cfg, init_params(cfg, seed=0, device=cuda),
        make_backend("dynaexq", n_hi_per_layer=2, device=cuda,
                     controller=ControllerConfig(update_interval_s=1e9)),
        EngineConfig(max_slots=2, max_len=64), device=cuda, obs=obs)
    _submit(eng)
    for _ in range(2):
        _step(eng, graphed=True)
    tms = [c.tm for c in eng.backend.controllers.values()]
    for tm in tms:
        with torch.cuda.stream(tm._side):
            torch.cuda._sleep(4_000_000_000)
    eng.backend.force_update()                  # copies queue behind it
    pending = [p for tm in tms for p in tm._pending]
    assert pending and not any(p.event.query() for p in pending)
    ends = []
    end = obs.tracer.async_end

    def audited(name, span_id, cat="", **args):
        if name == "promotion" and args.get("published"):
            p = next(p for p in pending if p.seq == span_id)
            ends.append(p.event.query())
        end(name, span_id, cat, **args)

    obs.tracer.async_end = audited
    for _ in range(2):
        _step(eng, graphed=True)
        eng.backend.tick()
    begun = [b for b in obs.tracer.events()
             if b.name == "promotion" and b.ph == "b"]
    assert len(begun) == len(pending) and not obs.tracer.spans("promotion")
    assert not ends
    eng.flush()
    spans = obs.tracer.spans("promotion")
    assert ends and all(ends) and len(ends) == len(pending)
    assert sum(e.args["published"] for _, e in spans) == len(pending)
    snap = obs.metrics.snapshot()
    assert snap["promotion_publish_latency_seconds_count"] == len(pending)
    assert min(e.ts - b.ts for b, e in spans) > 0.5     # the spin
    assert snap["promotion_publish_latency_seconds_p50"] > 0.5
    for tm in tms:
        tm.check_invariants()


@pytest.mark.cuda
def test_capture_refuses_a_host_read(cuda, monkeypatch):
    """A host read in the step (``torch.bincount`` sizes its output from
    ``ids.max().item()``) makes the capture raise; the step is not run
    eagerly instead."""
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "count_ids", lambda ids, n: torch.bincount(
        ids.reshape(-1).long(), minlength=n))
    eng = _engine(cuda, "static", "paged-ragged")
    hs = _submit(eng)
    with pytest.raises(RuntimeError, match="could not be captured"):
        while eng.counters["steps"] == 0:
            eng.step()
    assert eng.decode_graph.graph is None
    assert all(len(h.tokens) <= 1 for h in hs)


def _front_engine(cuda):
    """The reduced 30B on the main path with the request front: dynaexq
    (a policy window every step), prefix sharing, chunked prefill at 32
    tokens, preemption."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.serving.scheduler import SchedulerConfig
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    be = make_backend("dynaexq", n_hi_per_layer=2, device=cuda,
                      controller=ControllerConfig(update_interval_s=0.0))
    return InferenceEngine(cfg, init_params(cfg, seed=0, device=cuda), be,
                           EngineConfig(max_slots=2, max_len=128,
                                        scheduler=SchedulerConfig(
                                            prefill_chunk=32)),
                           device=cuda)


def _front_stream(vocab):
    """Two batch requests sharing a 16-token prefix (one block), the
    second one sampled, then a standard one with a 70-token prompt
    (chunked) arriving while they hold both slots (it preempts one)."""
    from repro_torch.serving.requests import Request, make_prompts
    from repro_torch.serving.sampler import SamplingParams
    system = make_prompts("text", vocab, 1, 16, seed=1)[0]
    reqs = [Request(tokens=np.concatenate([system, make_prompts(
        "code", vocab, 1, 6 + i, seed=10 + i)[0]]), max_new_tokens=8,
        qos="batch", arrival_s=0.002 * i - 0.001 if i else 0.0,
        sampling=SamplingParams(temperature=0.8, top_k=20, seed=3)
        if i else None) for i in range(2)]
    reqs.append(Request(tokens=make_prompts("math", vocab, 1, 70, seed=5)[0],
                        max_new_tokens=8, qos="standard", arrival_s=0.007))
    return reqs


@pytest.mark.cuda
def test_request_front_graphs_match_eager(cuda):
    """The request front on the card: trie hits, chunks, a preemption and
    its resume, a sampled row, and the batch tier on the all-lo view;
    graphed (the two decode graphs sharing one memory pool) and under
    ``eager()``, dynaexq flushed after every step: identical tokens and
    launches, both graphs captured, the pool's invariants kept."""
    import contextlib
    from repro_torch.serving.engine import eager
    runs = []
    for graphed in (True, False):
        eng = _front_engine(cuda)
        ops.reset_launches()
        flush = eng.step

        def step(flush=flush, eng=eng):
            out = flush()
            eng.flush()
            return out

        eng.step = step
        with contextlib.nullcontext() if graphed else eager():
            hs = eng.replay(_front_stream(eng.cfg.vocab_size),
                            realtime=False)
        torch.cuda.synchronize()
        st = eng.stats()
        assert st["prefix_hit_tokens"] > 0 and st["chunk_prefills"] >= 2
        assert st["preemptions"] == st["resumes"] >= 1
        assert st["promotions"] > 0
        eng.pool.check_invariants()
        assert all(int((b.slot_owner >= 0).sum()) == 0
                   for b in eng.lo_banks.values())
        captured = (eng.decode_graph.graph is not None,
                    eng.lo_graph.graph is not None)
        assert captured == ((True, True) if graphed else (False, False))
        runs.append(([h.tokens for h in hs], dict(ops.LAUNCHES)))
    assert runs[0] == runs[1]
    assert runs[0][1]["ragged_gateup"] > 0


# --------------------------------------------------------------------------
# Self-speculative decoding: the draft and verify graphs against eager()
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_spec_graphs_match_eager(cuda, path, name):
    """spec_k = 4 on the reduced 30B (dynaexq with its hi sets published
    and then fixed, so drafts on the all-lo view are rejected at times):
    the draft and verify graphs of every ladder width used against the
    same rounds under ``eager()``, in a fresh engine each: identical tokens
    and launches, identical spec counters; the tokens equal spec off's."""
    import contextlib
    import dataclasses
    from repro_torch.serving.engine import eager
    out = []
    for spec_k, graphed in ((4, True), (4, False), (0, True)):
        eng = _engine(cuda, name, path, update_interval_s=1e9,
                      spec_k=spec_k)
        if name == "dynaexq":
            eng.generate({"tokens": np.stack([np.arange(16) % 7] * 2)}, 3)
            eng.backend.force_update()
            eng.backend.flush()
            for ctl in eng.backend.controllers.values():
                ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
        ops.reset_launches()
        with contextlib.nullcontext() if graphed else eager():
            hs = _submit(eng)
            eng.drain()
        torch.cuda.synchronize()
        st = eng.stats()
        out.append(([h.tokens for h in hs], dict(ops.LAUNCHES),
                    {k: st[k] for k in ("spec_rounds", "draft_tokens",
                                        "verified_tokens", "accept_rate")}))
        if spec_k:
            assert st["spec_rounds"] > 0
            if graphed:
                assert any(d.graph is not None and v.graph is not None
                           for d, v in eng._spec.graphs.values())
        if eng.pool is not None:
            eng.pool.check_invariants()
    assert out[0] == out[1]
    assert out[0][0] == out[2][0]
    kernels = PAGED_KERNELS if path == "paged-ragged" else DENSE_KERNELS
    assert all(out[0][1][k] > 0 for k in kernels), out[0][1]


def _lo_rows(shapes, layer, seed=0):
    """One layer's packed lo rows as a shard holds them: uint8 codes and
    float32 scales (bf16 values)."""
    gen = torch.Generator().manual_seed(seed + layer)
    rows = {}
    for n, (L, E, K, N) in shapes.items():
        rows[f"{n}.packed"] = torch.randint(
            0, 256, (E, K // 2, N), generator=gen, dtype=torch.uint8).numpy()
        rows[f"{n}.scales"] = torch.rand(
            (E, K // 64, N), generator=gen).to(torch.bfloat16).float().numpy()
    return rows


@pytest.mark.cuda
def test_lo_staging_publishes_after_its_copy(cuda):
    """Staged lo rows held in flight behind a spin on the side stream are
    not published by a non-blocking ``publish_lo`` (the entry's own event
    has not completed); a blocking one publishes them, equal to the
    source rows, in place. A heal's copy starts only after the forwards
    already queued on the compute stream: a read queued before it (behind
    a spin) sees the old rows."""
    from repro_torch.core.ver import build_bank_empty
    from repro_torch.serving.hoststore import HostExpertStore
    shapes = {n: (2, 4, 128, 64) for n in ("w_down", "w_gate", "w_up")}
    bank = build_bank_empty(shapes, n_hi=1, lo_bits=4, device=cuda)
    rows = {l: _lo_rows(shapes, l) for l in range(2)}
    store = HostExpertStore(shapes, hi_loader=lambda l, e: {},
                            lo_loader=lambda l: rows[l],
                            lo_valid_init=False, device=cuda)
    ptrs = [t.data_ptr() for q in bank.lo.values()
            for t in (q.packed, q.scales)]
    store.side = torch.cuda.Stream()
    with torch.cuda.stream(store.side):
        torch.cuda._sleep(4_000_000_000)
    store.stage_lo_batch(bank, 0, [0, 1, 2, 3], [True] * 4)
    assert store.publish_lo() == 0 and store.staging_inflight == 1
    assert not store.lo_valid.any() and not store.lo_complete
    assert store.publish_lo(wait=True) == 4
    assert store.lo_valid[0].all() and not store.lo_valid[1].any()
    for n, q in bank.lo.items():
        assert torch.equal(q.packed[0].cpu(),
                           torch.from_numpy(rows[0][f"{n}.packed"]))
        assert torch.equal(q.scales[0].cpu().float(),
                           torch.from_numpy(rows[0][f"{n}.scales"]))
    # Ordering against the compute stream (the heal of a quarantined cell).
    assert store.quarantine(1, [2]) == 1
    torch.cuda._sleep(4_000_000_000)
    snap = bank.lo["w_up"].packed[1, 2].clone()     # queued behind the spin
    store.stage_lo(bank, 1, 2)
    assert store.publish_lo(wait=True) == 1
    torch.cuda.synchronize()
    assert not snap.any()
    assert torch.equal(bank.lo["w_up"].packed[1, 2].cpu(),
                       torch.from_numpy(rows[1]["w_up.packed"][2]))
    assert not store.quarantined.any() and store.lo_valid[1, 2]
    assert [t.data_ptr() for q in bank.lo.values()
            for t in (q.packed, q.scales)] == ptrs
    store.check_invariants()
