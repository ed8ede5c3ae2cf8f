"""Self-speculative decoding of the port (``serving.spec``,
``models.spec_draft``/``spec_verify``) on the CPU, against the reference's
``serving/spec.py`` and within the port.

Mirrors the reference's ``tests/test_spec_decode.py`` for the family the
port serves (full-attention MoE; no sliding-window ring, no mamba state):
greedy token identity with spec off on the paged and the dense path,
adaptive and fixed depth, the KV pool after rewinds, an EOS mid-burst, the
sequence cap and the headroom fallback, sampled determinism, and the
acceptance rule. Against the reference: ``accept_burst`` exactly, the
draft and verify entry points (drafts and per-row counts exact, logits
within ``LOGIT_ATOL``), and the served spec engine (tokens and spec
counters).

The engines run drop-free (capacity_factor = E / k) on the reduced
granite-moe; a ``dynaexq`` target is warmed and then frozen (as the
reference's tests do), so the lo-tier drafts genuinely disagree with it
and rejections happen against a target that does not change over time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.core.ver import build_bank as jbuild_bank
from repro.models import init_caches as jinit_caches
from repro.models import init_paged_caches as jinit_paged_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import prefill_paged as jprefill_paged
from repro.models import spec_draft as jspec_draft
from repro.models import spec_verify as jspec_verify
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro.serving.requests import make_prompts
from repro.serving.sampler import RequestSampler as JRequestSampler
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro.serving.spec import accept_burst as jaccept_burst
from repro.serving.spec import all_lo_banks as jall_lo_banks
from repro_torch.configs import get_config
from repro_torch.convert import bank_from_reference, params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.models.model import (init_caches, init_paged_caches,
                                      prefill, prefill_paged, spec_draft,
                                      spec_verify)
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import (EngineConfig, InferenceEngine,
                                        RequestState)
from repro_torch.serving.lobanks import all_lo_banks
from repro_torch.serving.requests import Request
from repro_torch.serving.sampler import RequestSampler, SamplingParams
from repro_torch.serving.spec import accept_burst
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
# The two packages' logits differ by a few hundredths (test_torch_model).
LOGIT_ATOL = 0.1


@pytest.fixture(scope="module")
def ref_model():
    jcfg = jget_config(ARCH, reduced=True)
    return jcfg, jinit_params(jax.random.PRNGKey(0), jcfg)


def _port_params(jp):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, jp))


def _drop_free(cfg):
    return cfg.moe.num_experts / cfg.moe.top_k


# --------------------------------------------------------------------------
# accept_burst
# --------------------------------------------------------------------------

def test_accept_burst_matches_reference():
    """Seeded logits and drafts (drafts partly the target's argmax, so
    every acceptance length occurs), greedy and sampled rows over several
    rounds: the same ``(n_accepted, emitted)`` as the reference's; plus
    the reference's own rejection-math cases."""
    rng = np.random.default_rng(0)
    V = 12
    seen = set()
    for case in range(60):
        d = int(rng.integers(0, 5))
        logits = (rng.standard_normal((d + 1, V)) *
                  rng.choice([0.5, 2.0, 8.0])).astype(np.float32)
        drafts = np.argmax(logits[:d], -1).astype(np.int32)
        flip = rng.random(d) < 0.3
        drafts[flip] = rng.integers(0, V, int(flip.sum()))
        kw = [dict(), dict(temperature=0.9, seed=case),
              dict(temperature=0.7, top_k=5, top_p=0.9, seed=case + 100)]
        for sp in kw:
            js = JRequestSampler(JSamplingParams(**sp))
            ts = RequestSampler(SamplingParams(**sp))
            for rnd in range(2):
                want = jaccept_burst(js, drafts, logits)
                got = accept_burst(ts, drafts, logits)
                assert got == want, (case, sp, rnd)
                if not sp:                  # greedy: the argmax suffices
                    assert accept_burst(ts, drafts, None, target_top=np.argmax(
                        logits, -1)) == want
                seen.add(got[0] == d)
                js.end_round()
                ts.end_round()
    assert seen == {True, False}
    # The reference's cases: a one-hot target accepts its own token and
    # never emits a rejected draft; greedy is argmax agreement.
    sampler = RequestSampler(SamplingParams(temperature=1.0, seed=0))
    logits = np.zeros((3, 8), np.float32)
    logits[:, 0] = 10.0
    assert accept_burst(sampler, np.array([0, 0]), logits) == (2, [0, 0, 0])
    a, out = accept_burst(sampler, np.array([3, 3]), logits)
    assert a == 0 and len(out) == 1 and out[0] != 3
    g = RequestSampler(SamplingParams(temperature=0.0))
    logits = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    drafts = np.argmax(logits[:3], -1)
    assert accept_burst(g, drafts, logits) == \
        (3, [int(np.argmax(logits[j])) for j in range(4)])


# --------------------------------------------------------------------------
# spec_draft / spec_verify against the reference
# --------------------------------------------------------------------------

def _bank_with_hi(experts, owners=(1, 3)):
    """A reference bank with ``owners`` published in every layer."""
    bank = jbuild_bank(experts, n_hi=len(owners), lo_bits=4)
    L, E = experts["w_gate"].shape[:2]
    for n in bank.hi:
        for l in range(L):
            for s, e in enumerate(owners):
                bank.hi[n] = bank.hi[n].at[l, s].set(experts[n][l, e])
    bank.slot_owner = jnp.asarray([list(owners)] * L, jnp.int32)
    sm = np.full((L, E), -1, np.int32)
    for s, e in enumerate(owners):
        sm[:, e] = s
    bank.slot_map = jnp.asarray(sm)
    return bank


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_spec_draft_and_verify_match_reference(ref_model, paged):
    """A prefill of three rows, then a draft of 3 tokens on the all-lo
    view and a verify of 4 positions on the mixed bank, with one row past
    its depth after step 1 and one vacant row: drafted tokens and per-row
    per-step counts exact, the verify's logits of valid steps within
    ``LOGIT_ATOL`` (argmax equal unless the reference's top two are within
    2·LOGIT_ATOL), on the paged pool and on dense rows."""
    jcfg, jp = ref_model
    cfg = get_config(ARCH, reduced=True)
    jbank = {"0": _bank_with_hi(jp["blocks"]["0"]["moe"]["experts"])}
    tp = _port_params(jp)
    tbank = {"0": bank_from_reference(jbank["0"])}
    B, bt, max_len, S, k = 3, 16, 64, 32, 3
    cf = _drop_free(cfg)
    rng = np.random.default_rng(4)
    lengths = np.array([20, 13, 27])
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    step_valid = np.ones((k + 1, B), bool)
    step_valid[2:, 1] = False                      # row 1: depth 1
    step_valid[:, 2] = False                       # row 2: vacant
    if paged:
        nb = max_len // bt
        N = 1 + B * nb
        table = np.arange(1, N).reshape(B, nb).astype(np.int32)
        pos = lengths + np.arange(k + 1)[:, None]
        wblk = np.where(step_valid, table[np.arange(B), pos // bt], 0)
        woff = np.where(step_valid, pos % bt, 0)
        jc = jinit_paged_caches(jcfg, B, max_len, bt, N)
        tc = init_paged_caches(cfg, N, bt, device="cpu")
        jl, jc, _ = jprefill_paged(
            jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
            jnp.asarray(table), jnp.zeros(B, jnp.int32),
            jnp.asarray(lengths, jnp.int32), bank=jbank,
            moe_dispatch="ragged", capacity_factor=cf)
        prefill_paged(tp, cfg, torch.from_numpy(toks).long(), tc,
                      torch.from_numpy(table), torch.zeros(B).long(),
                      torch.from_numpy(lengths), bank=tbank,
                      moe_dispatch="ragged", capacity_factor=cf)
        jpg = lambda s: {"table": jnp.asarray(table),
                         "write_blk": jnp.asarray(wblk[s], jnp.int32),
                         "write_off": jnp.asarray(woff[s], jnp.int32)}
        tpg = lambda s: {"table": torch.from_numpy(table),
                         "write_blk": torch.from_numpy(wblk[s]).long(),
                         "write_off": torch.from_numpy(woff[s]).long()}
    else:
        jc = jinit_caches(jcfg, B, max_len)
        tc = init_caches(cfg, B, max_len, device="cpu")
        jl, jc, _ = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                             bank=jbank, lengths=jnp.asarray(lengths),
                             moe_dispatch="ragged", capacity_factor=cf)
        prefill(tp, cfg, torch.from_numpy(toks).long(), tc,
                torch.from_numpy(lengths), bank=tbank,
                moe_dispatch="ragged", capacity_factor=cf)
        jpg = tpg = lambda s: None
    tok0 = np.array(jnp.argmax(jl, -1), np.int32)
    kw = dict(capacity_factor=cf, moe_dispatch="ragged")
    jd, jc = jspec_draft(jp, jcfg, jnp.asarray(tok0),
                         jnp.asarray(lengths, jnp.int32), jc,
                         jnp.asarray(step_valid[1:]),
                         bank=jall_lo_banks(jbank, {}), paged=jpg(slice(0, k)),
                         **kw)
    td = spec_draft(tp, cfg, torch.from_numpy(tok0).long(),
                    torch.from_numpy(lengths), tc,
                    torch.from_numpy(step_valid[1:]),
                    bank=all_lo_banks(tbank, {}), paged=tpg(slice(0, k)),
                    **kw)
    jd = np.array(jd)
    valid = step_valid[1:]
    np.testing.assert_array_equal(td.numpy()[valid], jd[valid])
    vt = np.concatenate([tok0[None], jd], 0)
    jlog, _, jcnt, _ = jspec_verify(jp, jcfg, jnp.asarray(vt),
                                    jnp.asarray(lengths, jnp.int32), jc,
                                    jnp.asarray(step_valid), bank=jbank,
                                    paged=jpg(slice(None)), **kw)
    tlog, tcnt, tssm = spec_verify(tp, cfg, torch.from_numpy(vt).long(),
                                   torch.from_numpy(lengths), tc,
                                   torch.from_numpy(step_valid), bank=tbank,
                                   paged=tpg(slice(None)), **kw)
    assert tssm == {}                      # no Mamba position
    jlog = np.asarray(jlog)
    assert tlog.shape == (k + 1, B, cfg.vocab_size)
    assert tcnt["0"].shape == (k + 1, cfg.n_superblocks(), B,
                               cfg.moe.num_experts)
    np.testing.assert_array_equal(tcnt["0"].numpy(), np.asarray(jcnt["0"]))
    for j, r in zip(*np.nonzero(step_valid)):
        np.testing.assert_allclose(tlog[j, r].numpy(), jlog[j, r], rtol=0,
                                   atol=LOGIT_ATOL)
        top2 = np.sort(jlog[j, r])[-2:]
        assert int(tlog[j, r].argmax()) == int(jlog[j, r].argmax()) or \
            top2[1] - top2[0] < 2 * LOGIT_ATOL


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

def _frozen(eng, vocab, warm=True):
    """Warm a dynaexq engine's hi tier, publish it, and freeze its policy:
    a time-invariant mixed-precision target."""
    if warm:
        eng.generate({"tokens": make_prompts(
            "text", vocab, min(2, eng.ecfg.max_slots), 16, seed=99)}, 4)
    eng.backend.force_update()
    eng.backend.flush()
    for ctl in eng.backend.controllers.values():
        ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    return eng


def _engine(ref_model, spec_k=0, backend="dynaexq", max_slots=2,
            max_len=96, **ecfg):
    _, jp = ref_model
    cfg = get_config(ARCH, reduced=True)
    if backend == "dynaexq":
        be = make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                          global_alloc=False, device="cpu",
                          controller=ControllerConfig(update_interval_s=0.0))
    else:
        be = make_backend(backend, device="cpu")
    eng = InferenceEngine(cfg, _port_params(jp), be, EngineConfig(
        max_slots=max_slots, max_len=max_len, capacity_factor=_drop_free(cfg),
        spec_k=spec_k, **ecfg), device="cpu")
    if backend == "dynaexq":
        _frozen(eng, cfg.vocab_size)
    return cfg, eng


def _serve(cfg, eng, lengths=(24, 17, 21), new=10, seed=7, **req_kw):
    """Three requests over two slots (the third refills a freed slot
    mid-stream)."""
    hs = [eng.submit(Request(
        tokens=make_prompts("text", cfg.vocab_size, 1, L, seed=seed + s)[0],
        max_new_tokens=new, **req_kw)) for s, L in enumerate(lengths)]
    eng.drain()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_spec_token_identity_greedy(ref_model, paged, adaptive):
    """Drafts on the all-lo view, verify on the frozen mixed banks:
    rejections happen, and the emitted tokens equal spec off's, on the
    paged/ragged path and on the dense/padded path."""
    kw = dict(paged=paged, moe_dispatch="ragged" if paged else "padded")
    cfg, off = _engine(ref_model, **kw)
    want = _serve(cfg, off)
    cfg, on = _engine(ref_model, spec_k=4, spec_adaptive=adaptive, **kw)
    assert _serve(cfg, on) == want
    st = on.stats()
    assert st["spec_rounds"] > 0 and st["draft_tokens"] > 0
    assert st["verified_tokens"] > st["spec_rounds"]    # > 1 token/round
    assert 0.0 < st["accept_rate"] < 1.0
    if paged:
        on.pool.check_invariants()
        assert on.pool.blocks_in_use == off.pool.blocks_in_use


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_spec_engine_matches_reference(ref_model, paged):
    """The port's spec engine against the reference's on the same weights
    and the same frozen hi sets: the same tokens for every request and the
    same ``spec_rounds``, ``draft_tokens``, ``verified_tokens`` and
    ``accept_rate``."""
    jcfg, jp = ref_model
    kw = dict(max_slots=2, max_len=96, spec_k=4, paged=paged,
              moe_dispatch="ragged" if paged else "padded")
    cfg, te = _engine(ref_model, **kw)
    jbe = jmake_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                        global_alloc=False, controller=JControllerConfig(
                            update_interval_s=0.0))
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp), jbe,
                          JEngineConfig(capacity_factor=_drop_free(cfg),
                                        **kw))
    _frozen(je, cfg.vocab_size)
    assert je.backend.hi_sets() == te.backend.hi_sets()
    out = []
    for eng, R in ((je, JRequest), (te, Request)):
        hs = [eng.submit(R(tokens=make_prompts("text", cfg.vocab_size, 1, L,
                                               seed=7 + s)[0],
                           max_new_tokens=10))
              for s, L in enumerate((24, 17, 21))]
        eng.drain()
        st = eng.stats()
        out.append(([list(h.tokens) for h in hs],
                    {k: st[k] for k in ("spec_rounds", "draft_tokens",
                                        "verified_tokens", "accept_rate",
                                        "steps")}))
    assert out[1] == out[0]
    assert 0.0 < out[1][1]["accept_rate"] < 1.0


def test_kvpool_invariant_after_spec_rewind(ref_model):
    """Every lease closed: spec on holds exactly the blocks spec off does
    (the trie's), refcounts unwound, quota returned; with 4-token blocks a
    burst crosses block boundaries and rejected tail blocks are unwound
    (the pool's invariants hold after every step)."""
    cfg, off = _engine(ref_model, backend="static")
    _serve(cfg, off, new=12)
    cfg, on = _engine(ref_model, spec_k=4, backend="static")
    _serve(cfg, on, new=12)
    on.pool.check_invariants()
    assert on.pool.blocks_in_use == off.pool.blocks_in_use
    assert on.pool.quota_blocks == 0
    np.testing.assert_array_equal(np.sort(on.pool.refcount),
                                  np.sort(off.pool.refcount))
    cfg, eng = _engine(ref_model, spec_k=4, block_tokens=4, max_slots=1)
    h = eng.submit(Request(tokens=make_prompts(
        "text", cfg.vocab_size, 1, 18, seed=3)[0], max_new_tokens=16))
    import repro_torch.serving.kvpool as kvpool
    lease_unwind, calls = kvpool.KVLease.unwind, []

    def counted(lease, j):
        calls.append(j)
        return lease_unwind(lease, j)

    kvpool.KVLease.unwind = counted
    try:
        while h.state is not RequestState.FINISHED:
            eng.step()
            eng.pool.check_invariants()
    finally:
        kvpool.KVLease.unwind = lease_unwind
    assert len(h.tokens) == 16
    assert calls                                  # rejected tails unwound
    assert eng.stats()["accept_rate"] < 1.0


def test_eos_mid_burst_truncates_at_first_occurrence(ref_model):
    cfg, eng = _engine(ref_model, backend="static")
    base = _serve(cfg, eng, lengths=(20,), new=12)[0]
    eos = base[len(base) // 2]
    want = base[:base.index(eos) + 1]
    cfg, off = _engine(ref_model, backend="static")
    assert _serve(cfg, off, lengths=(20,), new=12, eos_token_id=eos)[0] \
        == want
    cfg, on = _engine(ref_model, spec_k=4, backend="static")
    h = on.submit(Request(tokens=make_prompts("text", cfg.vocab_size, 1, 20,
                                              seed=7)[0],
                          max_new_tokens=12, eos_token_id=eos))
    on.drain()
    assert h.tokens == want
    assert h.tokens[-1] == eos and eos not in h.tokens[:-1]
    # No discarded post-EOS token in the per-token accounting.
    assert len(h.step_times) == len(h.tokens) - 1
    assert on.stats()["verified_tokens"] <= len(h.tokens) - 1


def test_spec_identity_near_sequence_cap_dense(ref_model):
    """Rows near the sequence cap ride a deeper row's burst past their own
    depth; on dense rows those lanes wrap onto live low slots and are
    restored."""
    kw = dict(paged=False, moe_dispatch="padded", max_slots=3, max_len=48)
    cfg, off = _engine(ref_model, **kw)
    want = _serve(cfg, off, lengths=(40, 8, 36), new=12)
    cfg, on = _engine(ref_model, spec_k=4, **kw)
    assert _serve(cfg, on, lengths=(40, 8, 36), new=12) == want


def test_spec_round_touches_only_accepted_slots_dense(ref_model):
    """A round changes a live dense row only at the slots of the tokens it
    accepted ([pos before, pos after) mod C): rejected lanes, lanes past a
    row's depth and their wrap near the cap are all restored."""
    cfg, eng = _engine(ref_model, spec_k=4, backend="static", paged=False,
                       moe_dispatch="padded", max_slots=2, max_len=24)
    hs = [eng.submit(Request(tokens=make_prompts(
        "text", cfg.vocab_size, 1, L, seed=31 + L)[0], max_new_tokens=12))
        for L in (18, 6)]
    C, checked = eng.ecfg.max_len, 0
    while not all(h.state is RequestState.FINISHED for h in hs):
        live = [i for i, h in enumerate(eng.slots) if h is not None]
        pos0 = eng.pos.copy()
        before = {p: (c.k.clone(), c.v.clone()) for p, c in
                  eng.caches.items()}
        rounds = eng._spec.rounds
        eng.step()
        if eng._spec.rounds == rounds:
            continue
        checked += 1
        for i in live:
            allowed = {p % C for p in range(int(pos0[i]), int(eng.pos[i]))}
            keep = torch.tensor([s not in allowed for s in range(C)])
            for p, c in eng.caches.items():
                for a, b in ((c.k, before[p][0]), (c.v, before[p][1])):
                    assert torch.equal(a[:, i][:, :, keep],
                                       b[:, i][:, :, keep]), (i, allowed)
    assert checked > 0


def test_spec_headroom_fallback_single_token(ref_model):
    """One new token leaves no draft headroom: the plain step runs."""
    cfg, eng = _engine(ref_model, spec_k=4, backend="static")
    assert all(len(t) == 1 for t in _serve(cfg, eng, lengths=(12, 9),
                                           new=1))
    assert eng.stats()["spec_rounds"] == 0.0
    cfg, eng = _engine(ref_model, spec_k=4, backend="static", max_len=32)
    toks = _serve(cfg, eng, lengths=(28,), new=12)
    assert len(toks[0]) == 32 - 28 + 1        # stopped by the sequence cap


def test_spec_sampled_deterministic_and_batch_independent(ref_model):
    """temperature > 0: a rebuild reproduces the tokens, and one request
    emits the same tokens alone as beside two others (its depth follows
    its own acceptance EMA, so it consumes the same draws)."""
    sp = SamplingParams(temperature=0.8, seed=777)

    def run(crowded):
        cfg, eng = _engine(ref_model, spec_k=4, max_slots=3)
        target = Request(tokens=make_prompts("text", cfg.vocab_size, 1, 18,
                                             seed=5)[0],
                         max_new_tokens=10, sampling=sp)
        others = [Request(tokens=make_prompts("math", cfg.vocab_size, 1, n,
                                              seed=n)[0], max_new_tokens=10,
                          sampling=SamplingParams(temperature=0.8, seed=n))
                  for n in (11, 23)] if crowded else []
        hs = [eng.submit(r) for r in others[:1] + [target] + others[1:]]
        eng.drain()
        return hs[1 if crowded else 0].tokens, eng.stats()

    alone, st = run(False)
    assert run(False)[0] == alone
    assert run(True)[0] == alone
    assert len(alone) == 10 and st["spec_rounds"] > 0


def test_backend_observes_only_accepted_steps(ref_model):
    """The counts a spec engine hands ``backend.observe`` are the verify
    counts of accepted steps: recomputed from each round's per-step counts
    and accept mask, and in total the counts spec off observes for the
    same tokens (the draft's traffic and rejected steps never count)."""
    cfg, off = _engine(ref_model)
    before_off = {k: v.copy() for k, v in off.backend.router_counts().items()}
    want = _serve(cfg, off)
    cfg, on = _engine(ref_model, spec_k=4)
    before_on = {k: v.copy() for k, v in on.backend.router_counts().items()}
    observed, rounds = [], []
    observe, spec_round = on.backend.observe, on._spec.round

    def watched(counts, *a, **k):
        observed.append({p: v.copy() for p, v in counts.items()})
        return observe(counts, *a, **k)

    def round_(rows, finished):
        n = len(observed)
        ran = spec_round(rows, finished)
        if ran:
            rounds.append((n, dict(on._spec.last)))
        return ran

    on.backend.observe = watched
    on._spec.round = round_
    assert _serve(cfg, on) == want
    assert rounds and on.stats()["accept_rate"] < 1.0
    for n, last in rounds:
        mask = last["accept_mask"]                      # (W, B)
        for p, v in last["counts"].items():             # (W, nsb, B, E)
            np.testing.assert_array_equal(
                observed[n][p], (v * mask[:, None, :, None]).sum(axis=0))
    for p in before_off:
        np.testing.assert_array_equal(
            on.backend.router_counts()[p] - before_on[p],
            off.backend.router_counts()[p] - before_off[p])


def test_spec_stats_schema(ref_model):
    cfg, eng = _engine(ref_model, spec_k=3, backend="static")
    _serve(cfg, eng)
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["draft_tokens"] > 0
    assert st["spec_row_rounds"] >= st["spec_rounds"]
    assert st["verified_tokens"] >= st["spec_rounds"]
    assert eng._spec.ladder == [1, 2, 3]
    cfg, eng0 = _engine(ref_model, backend="static")
    _serve(cfg, eng0)
    assert eng0.stats()["spec_row_rounds"] == 0.0
    assert eng0.stats()["spec_rounds"] == 0.0
