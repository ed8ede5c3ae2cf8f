"""What the port's decode step needs to run as one captured CUDA graph,
checked on the CPU: the MoE counts without ``torch.bincount``, ``rope``
without a host→device copy, both decode steps free of host reads, and the
engine's static-buffer step equal to the entry points on fresh tensors.
(The graph itself is held against eager decode on the card, in
``test_torch_cuda.py``.)"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import rope as jrope
from repro_torch.configs import get_config
from repro_torch.core.ver import build_bank
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.model import (decode_step, decode_step_paged,
                                      init_caches, init_paged_caches,
                                      init_params)
from repro_torch.models.moe import count_ids
from repro_torch.serving import engine as tengine
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request, make_prompts

ARCH = "granite-moe-1b-a400m"


# --------------------------------------------------------------------------
# 1. counts without bincount
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,size,shape", [
    (1, 5, (5,)),            # only the sentinel's bin
    (9, 64, (8, 8)),         # ragged dispatch: E + 1 bins, (T, k) ids
    (33, 200, (200,)),       # aux-loss counts
    (3 * 17, 96, (12, 8)),   # per-row counts: n_rows · (E + 1) bins
    (129, 1024, (1024,)),
    (7, 0, (0,)),            # no ids at all
])
def test_count_ids_equals_bincount(n, size, shape):
    rng = np.random.default_rng(n * 1000 + size)
    ids = rng.integers(0, n, size)
    if size:
        ids[rng.integers(0, size, max(1, size // 4))] = n - 1   # sentinel
    t = torch.from_numpy(ids).reshape(shape)
    got = count_ids(t, n)
    want = torch.bincount(t.reshape(-1), minlength=n)
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    assert torch.equal(count_ids(t.to(torch.int32), n), want)


# --------------------------------------------------------------------------
# 2. rope without a host→device copy
# --------------------------------------------------------------------------

def _rope_before(x, positions, theta):
    """``layers.rope`` as it was, with its per-call ``torch.tensor``."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
@pytest.mark.parametrize("hd", [64, 128])
def test_rope_bit_equal_to_before_and_close_to_reference(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((3, 5, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 5))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt = torch.from_numpy(pos)
    got = L.rope(xt, pt, theta)
    assert torch.equal(got, _rope_before(xt, pt, theta))
    want = np.asarray(jrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                            theta), np.float32)
    # sin/cos of another library: a bf16 rounding may flip (the dispatch
    # tests' tolerance).
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


# --------------------------------------------------------------------------
# 3. no host read in either decode step
# --------------------------------------------------------------------------

class HostRead(AssertionError):
    pass


def _bool_index(idx):
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Make every op that reads a tensor's values on the host (or copies
    host data to the device) raise: the CPU's stand-in for "capturable".
    Lifted inside the plain kernel versions (``kernels.ref``), which run
    only on the CPU."""
    on = [True]

    def refuse(name, orig, when=lambda *a, **k: True):
        def guarded(*a, **k):
            if on[0] and when(*a, **k):
                raise HostRead(f"host read in the decode step: {name}")
            return orig(*a, **k)
        return guarded

    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__", "nonzero", "bincount",
                 "masked_select", "unique"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(f"Tensor.{name}", getattr(torch.Tensor,
                                                             name)))
    for name in ("bincount", "nonzero", "masked_select", "unique", "tensor",
                 "as_tensor"):
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}",
                                                getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__getitem__", refuse(
        "bool-mask index", torch.Tensor.__getitem__,
        lambda self, idx: _bool_index(idx)))
    monkeypatch.setattr(torch.Tensor, "__setitem__", refuse(
        "bool-mask index", torch.Tensor.__setitem__,
        lambda self, idx, v: _bool_index(idx)))

    def lifted(fn):
        def call(*a, **k):
            prev, on[0] = on[0], False
            try:
                return fn(*a, **k)
            finally:
                on[0] = prev
        return call

    for name in dir(ref):
        fn = getattr(ref, name)
        if callable(fn) and getattr(fn, "__module__", None) == ref.__name__:
            monkeypatch.setattr(ref, name, lifted(fn))
    try:
        yield
    finally:
        on[0] = False


def test_guard_catches_each_host_read(monkeypatch):
    t = torch.arange(6)
    reads = [lambda: t.sum().item(), lambda: t.tolist(), lambda: t.numpy(),
             lambda: bool(t[0]), lambda: int(t[1]), lambda: float(t[1]),
             lambda: torch.bincount(t), lambda: torch.nonzero(t),
             lambda: t[t > 2], lambda: t.__setitem__(t > 2, 0),
             lambda: torch.tensor(1.0), lambda: t.cpu()]
    with no_host_reads(monkeypatch):
        for read in reads:
            with pytest.raises(HostRead):
                read()
        t[torch.arange(2)] = 0           # integer indices stay allowed


def _bank(experts, n_hi, gen):
    """A bank with ``n_hi // 2`` published hi experts per layer (none with
    n_hi = 0: the static backend's all-lo bank)."""
    bank = build_bank(experts, n_hi=n_hi, lo_bits=4, group_size=64)
    Ln, E = experts["w_gate"].shape[:2]
    for l in range(Ln):
        owners = torch.randperm(E, generator=gen)[:n_hi // 2]
        for s, e in enumerate(owners.tolist()):
            for n in bank.hi:
                bank.hi[n][l, s] = experts[n][l, e]
            bank.slot_owner[l, s] = e
            bank.slot_map[l, e] = s
    return bank


@pytest.mark.parametrize("bank_kind", ["static", "dynaexq", "fp16"])
@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_steps_read_nothing_on_the_host(monkeypatch, paged, dispatch,
                                               bank_kind):
    """``fp16``: no bank; the dense experts stay in ``params`` (the fp16
    and offload backends' forward)."""
    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(3)
    params = init_params(cfg, device="cpu", generator=gen)
    if bank_kind == "fp16":
        bank = None
    else:
        experts = params["blocks"]["0"]["moe"].pop("experts")
        n_hi = 0 if bank_kind == "static" else 4
        bank = {"0": _bank(experts, n_hi, gen)}
        if n_hi:
            assert bool((bank["0"].slot_owner >= 0).any())
    B, bt, nb = 3, 16, 4
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen)
    pos = torch.tensor([5, 17, 0])
    row_valid = torch.tensor([True, True, False])
    kw = dict(bank=bank, row_valid=row_valid, per_row_counts=True,
              moe_dispatch=dispatch)
    if paged:
        caches = init_paged_caches(cfg, 1 + B * nb, bt, device="cpu")
        table = torch.arange(1, 1 + B * nb, dtype=torch.int32).view(B, nb)
        table[2] = -1
        wblk = torch.tensor([int(table[0, 0]), int(table[1, 1]), 0])
        woff = torch.tensor([5, 1, 0])
        with no_host_reads(monkeypatch):
            logits, counts = decode_step_paged(params, cfg, tokens, pos,
                                               caches, table, wblk, woff,
                                               **kw)
    else:
        caches = init_caches(cfg, B, nb * bt, device="cpu")
        with no_host_reads(monkeypatch):
            logits, counts = decode_step(params, cfg, tokens, pos, caches,
                                         **kw)
    assert logits.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    c = counts["0"]
    assert c.shape == (cfg.n_superblocks(), B, cfg.moe.num_experts)
    assert int(c[:, 2].sum()) == 0                 # the vacant row
    assert bool((c[:, :2].sum(-1) == cfg.moe.top_k).all())


@pytest.mark.parametrize("paged,dispatch", [(True, "ragged"),
                                            (False, "padded")],
                         ids=["paged-ragged", "dense-padded"])
def test_flagship_decode_step_reads_nothing_on_the_host(monkeypatch, paged,
                                                        dispatch):
    """The reduced flagship (a shared expert in every MoE layer) on the
    bank of a default ``dynaexq`` backend: the global allocator's pool of
    2·n_hi slots per layer, with one layer holding more than n_hi."""
    cfg = get_config("qwen3-moe-80b-a3b").reduced(num_experts=16)
    params = init_params(cfg, seed=5, device="cpu")
    be = make_backend("dynaexq", lo_bits=2, hi_bits=4, device="cpu")
    bank = be.materialize_banks(cfg, params, kv_bytes=0)
    L, E, n_hi = cfg.n_superblocks(), cfg.moe.num_experts, 2
    hot = np.zeros((L, E), np.int64)
    hot[0, :2 * n_hi] = 50                 # layer 0 takes the slack
    hot[1, 5] = 1
    be.observe({"0": hot})
    be.force_update()
    be.flush()
    sets = be.hi_sets()["0"]
    assert bank["0"].slot_owner.shape == (L, 2 * n_hi)
    assert len(sets[0]) == 2 * n_hi > n_hi and len(sets[1]) == 0
    B, bt, nb = 3, 16, 4
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen)
    pos = torch.tensor([5, 17, 0])
    kw = dict(bank=bank, row_valid=torch.tensor([True, True, False]),
              per_row_counts=True, moe_dispatch=dispatch)
    if paged:
        caches = init_paged_caches(cfg, 1 + B * nb, bt, device="cpu")
        table = torch.arange(1, 1 + B * nb, dtype=torch.int32).view(B, nb)
        table[2] = -1
        wblk, woff = torch.tensor([1, 6, 0]), torch.tensor([5, 1, 0])
        with no_host_reads(monkeypatch):
            logits, counts = decode_step_paged(params, cfg, tokens, pos,
                                               caches, table, wblk, woff,
                                               **kw)
    else:
        caches = init_caches(cfg, B, nb * bt, device="cpu")
        with no_host_reads(monkeypatch):
            logits, counts = decode_step(params, cfg, tokens, pos, caches,
                                         **kw)
    assert logits.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert int(counts["0"][:, 2].sum()) == 0


# --------------------------------------------------------------------------
# 4. the engine's static-buffer step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("paged,dispatch", [(True, "ragged"),
                                            (False, "padded")],
                         ids=["paged-ragged", "dense-padded"])
def test_engine_static_step_matches_fresh_tensors(monkeypatch, paged,
                                                  dispatch):
    """Every decode step is shadowed by the model entry point on fresh
    copies of its inputs (the K/V it writes are the same values at the
    same slots): logits bit-equal, greedy tokens equal, and the static
    inputs the same memory in every step."""
    cfg = get_config(ARCH, reduced=True)
    eng = InferenceEngine(
        cfg, init_params(cfg, seed=1, device="cpu"),
        make_backend("static", device="cpu"),
        EngineConfig(max_slots=3, max_len=64, paged=paged,
                     moe_dispatch=dispatch), device="cpu")
    name = "decode_step_paged" if paged else "decode_step"
    entry = getattr(tengine, name)
    steps = []

    def shadowed(params, cfg_, *args, **kw):
        fresh = [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args]
        want, _ = entry(params, cfg_, *fresh,
                        **dict(kw, row_valid=kw["row_valid"].clone()))
        out = entry(params, cfg_, *args, **kw)
        ins = [a for a in args if isinstance(a, torch.Tensor)] + \
            [kw["row_valid"]]
        steps.append((want, out[0], [t.data_ptr() for t in ins]))
        return out

    monkeypatch.setattr(tengine, name, shadowed)
    handles = [eng.submit(Request(tokens=p, max_new_tokens=6))
               for p in (make_prompts("text", cfg.vocab_size, 1, n,
                                      seed=n)[0] for n in (9, 20, 14, 5))]
    buf = eng.decode_graph.inputs.dev_buf
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    while eng.queue or any(h is not None for h in eng.slots):
        before = {h.id: len(h.tokens) for h in handles}
        n_steps = len(steps)
        eng.step()
        if len(steps) == n_steps:
            continue
        want, got, ptrs = steps[-1]
        assert torch.equal(got, want)
        assert ptrs == steps[0][2]
        assert all(lo <= p < hi for p in ptrs)
        greedy = want.argmax(-1)
        for h in handles:
            if 0 < before[h.id] < len(h.tokens):       # decoded this step
                assert h.tokens[-1] == int(greedy[h.slot])
    assert len(steps) >= 6
    assert all(len(h.tokens) == 6 for h in handles)
