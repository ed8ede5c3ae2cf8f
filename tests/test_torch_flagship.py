"""The paper's flagship model, Qwen3-Next-80B-A3B (512 experts top-10 and
one shared expert), in the port against the reference: the shared SwiGLU,
``moe_apply`` with the shared expert at 512 experts on both dispatches,
teacher-forced logits of the reduced model, and served tokens with the
``static`` int2 and default ``dynaexq`` (int2 lo, int4-priced hi)
backends."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.models import decode_step_paged as jdecode_step_paged
from repro.models import init_paged_caches as jinit_paged_caches
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import prefill_paged as jprefill_paged
from repro.models.mlp import swiglu as jswiglu
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.models import moe as tmoe
from repro_torch.models.mlp import swiglu
from repro_torch.models.model import (decode_step_paged, init_paged_caches,
                                      init_params, prefill_paged)
from test_torch_engine import (_check_served, _default_engines,
                               _serve_lockstep, _warm_and_freeze)

ARCH = "qwen3-moe-80b-a3b"
# Logit tolerance of the reduced models, as in test_torch_model: float32
# decode attention in the port against bf16 logits/probabilities in the
# reference leave hidden states a few bf16 ulps apart.
LOGIT_ATOL = 0.1


def _configs(**reduce):
    return (jget_config(ARCH).reduced(**reduce),
            get_config(ARCH).reduced(**reduce))


def _publish(experts, n_hi, owners):
    """A reference bank with ``owners`` published into the first hi slots
    of every layer."""
    bank = jbuild_bank(experts, n_hi=n_hi, lo_bits=2, hi_bits=4)
    L, E = experts["w_gate"].shape[:2]
    for n in bank.hi:
        for l in range(L):
            for s, e in enumerate(owners):
                bank.hi[n] = bank.hi[n].at[l, s].set(experts[n][l, e])
    own = np.full((L, n_hi), -1, np.int32)
    own[:, :len(owners)] = owners
    bank.slot_owner = jnp.asarray(own)
    sm = np.full((L, E), -1, np.int32)
    for s, e in enumerate(owners):
        sm[:, e] = s
    bank.slot_map = jnp.asarray(sm)
    return bank


def test_config_matches_reference():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    for f in ("name", "n_layers", "d_model", "vocab_size", "d_ff",
              "norm_eps", "tie_embeddings", "max_seq_len", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.attn) == dataclasses.asdict(jcfg.attn)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    small = cfg.reduced(num_experts=16)
    assert small.moe.n_shared_experts == 1 and small.moe.d_ff_shared == 256
    p = init_params(small, device="cpu")
    sh = p["blocks"]["0"]["moe"]["shared"]
    assert {k: tuple(v.shape) for k, v in sh.items()} == {
        "w_gate": (2, 256, 256), "w_up": (2, 256, 256),
        "w_down": (2, 256, 256)}
    jp = jinit_params(jax.random.PRNGKey(0), jget_config(ARCH).reduced(
        num_experts=16))
    jsh = jp["blocks"]["0"]["moe"]["shared"]
    for k, v in sh.items():
        # The reference's init_swiglu scales: normal · fan_in^-1/2.
        assert v.dtype == torch.bfloat16
        assert float(v.float().std()) == pytest.approx(
            float(np.asarray(jsh[k], np.float32).std()), rel=0.05)


@pytest.mark.parametrize("T,d,F", [(24, 64, 64), (5, 2048, 512),
                                   (3, 256, 256)])
def test_swiglu_matches_reference(T, d, F):
    """The shared expert's SwiGLU against the reference's op by op: the
    same casts, bf16 products rounded once (float32 on the CPU). Bit-equal
    up to K = 256; at the flagship's K = 2048 the float32 sums run in
    another order than XLA's and may flip one bf16 rounding."""
    rng = np.random.default_rng(T * d)
    x = jnp.asarray(rng.standard_normal((T, d)), jnp.bfloat16)
    p = {n: jnp.asarray(rng.standard_normal(s) * s[0] ** -0.5, jnp.bfloat16)
         for n, s in (("w_gate", (d, F)), ("w_up", (d, F)),
                      ("w_down", (F, d)))}
    want = np.asarray(jswiglu(p, x), np.float32)
    got = swiglu({n: to_torch(v) for n, v in p.items()}, to_torch(x))
    assert got.dtype == torch.bfloat16
    if d <= 256:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=2 ** -8 * 2 ** -14)


@pytest.fixture(scope="module")
def wide_moe():
    """One layer at 512 experts top-10, d = F = F_sh = 64 (the flagship's
    expert count, so the 512-expert sort and tile map run), 4 hi slots
    with 3 published."""
    jcfg = jget_config(ARCH).reduced(n_layers=1, d_model=64,
                                     num_experts=512)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, top_k=10, d_ff_expert=64, d_ff_shared=64))
    jp = jinit_params(jax.random.PRNGKey(4), jcfg)
    moe = jp["blocks"]["0"]["moe"]
    bank = _publish(moe["experts"], 4, (3, 100, 511))
    layer = jax.tree_util.tree_map(lambda a: a[0], {
        "router": moe["router"], "shared": moe["shared"]})
    return jcfg, layer, bank


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
def test_moe_apply_with_shared_expert_matches_reference(wide_moe, dispatch,
                                                        masked):
    jcfg, layer, bank = wide_moe
    cfg = dataclasses.replace(get_config(ARCH).reduced(
        n_layers=1, d_model=64, num_experts=512), moe=dataclasses.replace(
        jcfg.moe))
    T, capacity = 24, tmoe.moe_capacity(24, jcfg.moe)
    rng = np.random.default_rng(11 + masked)
    x = jnp.asarray(rng.standard_normal((T, jcfg.d_model)), jnp.bfloat16)
    valid = np.ones(T, bool)
    valid[[2, 17]] = not masked
    tv = jnp.asarray(valid) if masked else None
    # Op by op with the jnp GEMM: the reference's roundings where its
    # source puts them.
    jl = jax.tree_util.tree_map(lambda a: a[0], bank)
    yj, aj = jmoe.moe_apply(layer, jl, x, jcfg.moe, capacity,
                            token_valid=tv, n_rows=4, dispatch=dispatch,
                            gemm="jnp")
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, layer))
    yt, at = tmoe.moe_apply(
        params, bank_from_reference(bank).layer(0), to_torch(x), cfg.moe,
        capacity, token_valid=torch.from_numpy(valid) if masked else None,
        n_rows=4, dispatch=dispatch)
    np.testing.assert_array_equal(np.asarray(aj.counts), at.counts.numpy())
    np.testing.assert_array_equal(np.asarray(aj.row_counts),
                                  at.row_counts.numpy())
    assert int(aj.active_experts) == int(at.active_experts) > 3
    assert float(aj.dropped) == float(at.dropped)
    want = np.asarray(yj, np.float32)
    got = yt.float().numpy()
    # Not bit-equal: the routed part's float32 sums (the grouped GEMM's
    # group sum, the ragged FFN's tiles) run in another order, one bf16
    # ulp apart; the shared term adds no difference of its own.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    shared = swiglu(params["shared"], to_torch(x))
    if masked:
        # A masked row is routed nowhere and still gets the shared term.
        for r in (2, 17):
            assert torch.equal(yt[r], shared[r])
            np.testing.assert_array_equal(got[r], want[r])
    else:
        assert not torch.equal(yt, shared)


def _forward_pair(steps=6, B=3, bt=16, max_len=64, seed=0):
    """Prefill + teacher-forced decode of the reduced flagship (16 experts,
    a shared expert of width 256) through both packages' paged entry
    points, the reference jitted. Yields per forward (logits_ref,
    logits_port, counts_ref, counts_port)."""
    jcfg, cfg = _configs(num_experts=16)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    jbank = _publish(jp["blocks"]["0"]["moe"]["experts"], 4, (1, 6, 11))
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    tbank = {"0": bank_from_reference(jbank)}
    nb = max_len // bt
    N = 1 + B * nb
    rng = np.random.default_rng(seed)
    lengths = np.array([20, 13, 32])[:B]
    S = 32
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table = np.arange(1, N).reshape(B, nb).astype(np.int32)
    jc = jinit_paged_caches(jcfg, B, max_len, bt, N)
    jprefill = jax.jit(functools.partial(
        jprefill_paged, cfg=jcfg, per_row_counts=True, moe_dispatch="ragged"))
    jdecode = jax.jit(functools.partial(
        jdecode_step_paged, cfg=jcfg, per_row_counts=True,
        moe_dispatch="ragged"))
    tc = init_paged_caches(cfg, N, bt, device="cpu")
    lj, jc, cj = jprefill(
        jp, batch={"tokens": jnp.asarray(toks)}, caches=jc,
        block_table=jnp.asarray(table), start=jnp.zeros(B, jnp.int32),
        lengths=jnp.asarray(lengths, jnp.int32), bank={"0": jbank})
    lt, ct = prefill_paged(
        tp, cfg, torch.from_numpy(toks).long(), tc, torch.from_numpy(table),
        torch.zeros(B, dtype=torch.long), torch.from_numpy(lengths),
        bank=tbank, per_row_counts=True)
    yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), ct["0"].numpy()
    pos = lengths.copy()
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        wb, wo = table[np.arange(B), pos // bt], pos % bt
        lj, jc, cj = jdecode(
            jp, token=jnp.asarray(tok), pos_idx=jnp.asarray(pos, jnp.int32),
            caches=jc, block_table=jnp.asarray(table),
            write_blk=jnp.asarray(wb, jnp.int32),
            write_off=jnp.asarray(wo, jnp.int32), bank={"0": jbank})
        lt, ct = decode_step_paged(
            tp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(pos), tc,
            torch.from_numpy(table), torch.from_numpy(wb).long(),
            torch.from_numpy(wo).long(), bank=tbank, per_row_counts=True)
        yield np.asarray(lj), lt.numpy(), np.asarray(cj["0"]), \
            ct["0"].numpy()
        pos += 1


def test_teacher_forced_logits_match_reference():
    """Each row is compared until the first forward whose routing differs
    (a near tie in the top-2 of 16 that ulp-level differences tip)."""
    diverged, compared = set(), 0
    for lj, lt, cj, ct in _forward_pair():
        assert np.isfinite(lt).all()
        for r in range(lj.shape[0]):
            if r in diverged:
                continue
            if not np.array_equal(cj[:, r], ct[:, r]):
                diverged.add(r)
                continue
            np.testing.assert_allclose(lt[r], lj[r], rtol=0,
                                       atol=LOGIT_ATOL)
            compared += 1
    assert len(diverged) <= 1, f"rows {sorted(diverged)} diverged"
    assert compared >= 2 * 7


@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_engine_tokens_match_reference(name, monkeypatch):
    """The reduced flagship (the packages' smoke reduction, as the other
    engine tests: 4 experts top-2 and the shared expert) served by both
    engines in lockstep: ``static`` int2, and ``dynaexq`` at its defaults
    (the global allocator) with int2 lo and int4-priced hi, as the paper
    serves the 80B."""
    jcfg, cfg = _configs()
    kw = dict(lo_bits=2) if name == "static" else dict(lo_bits=2, hi_bits=4)
    cfg, je, te = _default_engines(jcfg, cfg, name, **kw)
    if name == "dynaexq":
        _warm_and_freeze(cfg, je, te)
        assert te.backend.device_bytes() == je.backend.device_bytes()
    # The teacher-forced tolerance: the jitted reference's logits of this
    # family (qk-norm, magnitude ~3-4) sit up to ~0.06 from the port's, as
    # the 30B's do in test_torch_model.
    _check_served(name, te, _serve_lockstep(cfg, je, te, monkeypatch,
                                            tol=LOGIT_ATOL), tol=LOGIT_ATOL)
