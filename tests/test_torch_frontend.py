"""The port's request front against the reference engine's, on the
paged/ragged main path at reduced width, drop-free (capacity_factor =
E/k): prefix sharing on and off, chunked prefill, preemption and resume,
SLO tiers (the batch tier decoding on the all-lo view), shedding,
``replay`` on the virtual clock and the ``generate`` shim.

Scheduling is compared exactly: the same counters (prefill tokens, trie
hits, chunks, preemptions, resumes, steps) and the same virtual-clock
TTFTs. Tokens are compared under the margin rule of
``test_torch_engine``: the two packages' logits differ by a few
hundredths (LOGIT_TOL), so a request's tokens must agree up to its first
difference, and that difference must come at a near tie of the
reference's own logits for that position (greedy: top-2 gap below
4·LOGIT_TOL; sampled: the draw within EDGE_TOL of its token bin's edge).
Within the port, the features are held to the plain engine exactly."""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro.serving.engine import ENGINE_STAT_KEYS as J_ENGINE_STAT_KEYS
from repro.serving.engine import LOAD_SNAPSHOT_KEYS as J_LOAD_KEYS
from repro.serving.requests import make_prompts
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro.serving.sampler import sampling_probs as jsampling_probs
from repro.serving.sampler import STREAM_TOKEN, counter_uniform
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.models import moe as tmoe
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import (ENGINE_STAT_KEYS, LOAD_SNAPSHOT_KEYS,
                                        EngineConfig, EngineStallError,
                                        InferenceEngine, RequestState)
from repro_torch.serving.requests import Request
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import SchedulerConfig
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
LOGIT_TOL = 0.05
EDGE_TOL = 0.02
COUNTERS = ("steps", "prefills", "admitted", "finished", "prefill_tokens",
            "prefix_hit_tokens", "kv_cow_copies", "preemptions", "resumes",
            "shed_requests", "downgraded", "chunk_prefills",
            "prefill_compiles", "prefix_trie_nodes")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, _MarginOracle(jcfg, jp)


def _engines(setup, backend="static", sched=None, **ecfg):
    """A reference and a port engine on the same weights and config
    (``sched``: SchedulerConfig keywords)."""
    jcfg, cfg, jp, _ = setup
    kw = dict(max_slots=2, max_len=128, moe_dispatch="ragged",
              capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    kw.update(ecfg)
    if backend == "dynaexq":
        jbe = jmake_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                            global_alloc=False, controller=JControllerConfig(
                                update_interval_s=0.0))
        tbe = make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                           global_alloc=False, device="cpu",
                           controller=ControllerConfig(update_interval_s=0.0))
    else:
        jbe = jmake_backend("static", lo_bits=4)
        tbe = make_backend("static", lo_bits=4, device="cpu")
    sched = sched or {}
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp), jbe,
                          JEngineConfig(scheduler=JSchedulerConfig(**sched),
                                        **kw))
    te = InferenceEngine(cfg, params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)), tbe,
        EngineConfig(scheduler=SchedulerConfig(**sched), **kw), device="cpu")
    return je, te


def _stream(vocab, specs, step_s=2e-3):
    """Twin request lists from ``specs`` [(tokens, qos, sampling seed or
    None, arrival step)]: the reference's and the port's."""
    out = ([], [])
    for toks, qos, seed, step in specs:
        for reqs, R, SP in ((out[0], JRequest, JSamplingParams),
                            (out[1], Request, SamplingParams)):
            reqs.append(R(tokens=toks, max_new_tokens=8, qos=qos,
                          arrival_s=(step - 0.5) * step_s if step else 0.0,
                          sampling=None if seed is None else SP(
                              temperature=0.8, top_k=20, top_p=0.9,
                              seed=seed)))
    return out


def _prompts(vocab, n, length, workload="text", seed=0):
    return [make_prompts(workload, vocab, 1, length + 3 * i, seed=seed + i)[0]
            for i in range(n)]


def _shared_specs(vocab):
    """Six requests sharing a 40-token system prefix (two sample), one per
    virtual step, mixed with two of their own."""
    system = make_prompts("text", vocab, 1, 40, seed=5)[0]
    own = _prompts(vocab, 8, 5, "code", seed=20)
    specs = [(np.concatenate([system, own[i]]), None,
              7 + i if i in (1, 4) else None, i) for i in range(6)]
    specs += [(p, None, None, 6 + i)
              for i, p in enumerate(_prompts(vocab, 2, 17, "math", seed=40))]
    return specs


class _MarginOracle:
    """The reference's own logits for the token a request emits at index
    ``t``: one prefill of prompt + its first t tokens on a reference
    engine of the test's weights (static int4 lo, as the served banks)."""

    def __init__(self, jcfg, jp):
        self.eng = JInferenceEngine(
            jcfg, jax.tree_util.tree_map(lambda x: x, jp),
            jmake_backend("static", lo_bits=4),
            JEngineConfig(max_slots=1, max_len=256, moe_dispatch="ragged",
                          prefix_sharing=False))
        self.logits = None
        call = self.eng._jit_prefill_paged

        def captured(*a, **k):
            out = call(*a, **k)
            self.logits = np.asarray(out[0])[0]
            return out

        self.eng._jit_prefill_paged = captured

    def tie(self, handle, t) -> float:
        """Greedy: the top-2 gap; sampled: the draw's distance from its
        bin's edges."""
        request = handle.request
        seq = np.concatenate([np.asarray(request.tokens),
                              np.asarray(handle.tokens[:t], np.int32)])
        self.eng.submit(JRequest(tokens=seq, max_new_tokens=1))
        self.eng.drain()
        x = self.logits
        sp = request.sampling
        if sp is None:
            return _gap(x)
        p = jsampling_probs(x, sp)
        csum = np.cumsum(p)
        u = counter_uniform(sp.seed, STREAM_TOKEN, t) * csum[-1]
        k = int(np.searchsorted(csum, u, side="right"))
        lo = csum[k - 1] if k else 0.0
        return float(min(u - lo, csum[k] - u))


def _check_tokens(oracle, jh, th, held=0.5):
    """The margin rule over twin handle lists; at least ``held`` of all
    tokens compared identical."""
    same, total = 0, 0
    for a, b in zip(jh, th):
        assert b.state is RequestState.FINISHED and len(b.tokens) == \
            len(a.tokens)
        total += len(a.tokens)
        t = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if t is None:
            same += len(a.tokens)
            continue
        same += t
        tol = 4 * LOGIT_TOL if a.request.sampling is None else EDGE_TOL
        m = oracle.tie(a, t)
        assert m < tol, (a.id, t, m, a.tokens, b.tokens)
    assert same >= held * total, (same, total)


def _check_counters(je, te):
    js, ts = je.stats(), te.stats()
    assert {k: js[k] for k in COUNTERS} == {k: ts[k] for k in COUNTERS}
    te.pool.check_invariants()
    je.pool.check_invariants()


def test_schemas_equal_reference():
    assert ENGINE_STAT_KEYS == J_ENGINE_STAT_KEYS
    assert LOAD_SNAPSHOT_KEYS == J_LOAD_KEYS
    ref = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert set(ref) == set(ours)
    assert all(ref[k] == v for k, v in ours.items())


@pytest.mark.parametrize("sharing", [True, False], ids=["shared", "private"])
def test_prefix_sharing_matches_reference(setup, sharing):
    je, te = _engines(setup, prefix_sharing=sharing)
    jr, tr = _stream(setup[1].vocab_size, _shared_specs(setup[1].vocab_size))
    jh = je.replay(jr, realtime=False)
    th = te.replay(tr, realtime=False)
    _check_counters(je, te)
    _check_tokens(setup[3], jh, th)
    st = te.stats()
    if sharing:
        assert st["prefix_hit_tokens"] == 5 * 32      # 2 blocks x 5 hits
        assert st["prefix_trie_nodes"] > 0
        # Within the port, a hit's suffix prefill over the cached blocks
        # emits exactly the tokens of the whole prefill.
        _, plain = _engines(setup, prefix_sharing=False)
        ph = plain.replay(_stream(setup[1].vocab_size, _shared_specs(
            setup[1].vocab_size))[1], realtime=False)
        assert [h.tokens for h in th] == [h.tokens for h in ph]
    else:
        assert st["prefix_hit_tokens"] == 0 and te.trie is None
    assert [h.ttft_s for h in th] == [h.ttft_s for h in jh]


def test_chunked_prefill_matches_reference(setup):
    vocab = setup[1].vocab_size
    specs = [(p, None, 3 if i == 1 else None, 2 * i) for i, p in
             enumerate(_prompts(vocab, 3, 70, "text", seed=60))]
    specs += [(p, None, None, 1 + 2 * i) for i, p in
              enumerate(_prompts(vocab, 2, 12, "code", seed=70))]
    je, te = _engines(setup, sched=dict(prefill_chunk=32))
    jr, tr = _stream(vocab, specs)
    jh = je.replay(jr, realtime=False)
    th = te.replay(tr, realtime=False)
    _check_counters(je, te)
    _check_tokens(setup[3], jh, th)
    assert te.stats()["chunk_prefills"] >= 6
    # Within the port: the same tokens as whole prefills.
    _, plain = _engines(setup)
    ph = plain.replay(_stream(vocab, specs)[1], realtime=False)
    assert [h.tokens for h in th] == [h.tokens for h in ph]


def _qos_specs(vocab):
    """Batch work holding both slots when standard and premium requests
    arrive: the higher classes preempt it."""
    specs = [(p, "batch", 11 if i == 1 else None, 0) for i, p in
             enumerate(_prompts(vocab, 2, 20, "math", seed=80))]
    specs += [(p, q, None, 3 + i) for i, (p, q) in enumerate(zip(
        _prompts(vocab, 3, 9, "code", seed=90),
        ("standard", "premium", "standard")))]
    return specs


def test_preemption_and_resume_match_reference(setup):
    vocab = setup[1].vocab_size
    je, te = _engines(setup)
    jr, tr = _stream(vocab, _qos_specs(vocab))
    jh = je.replay(jr, realtime=False)
    th = te.replay(tr, realtime=False)
    _check_counters(je, te)
    st = te.stats()
    assert st["preemptions"] == st["resumes"] >= 2
    _check_tokens(setup[3], jh, th)
    assert [h.ttft_s for h in th] == [h.ttft_s for h in jh]
    # Resume is bit-exact: the same tokens as without preemption.
    _, plain = _engines(setup, sched=dict(preemption=False))
    ph = plain.replay(_stream(vocab, _qos_specs(vocab))[1], realtime=False)
    assert plain.stats()["preemptions"] == 0
    assert [h.tokens for h in th] == [h.tokens for h in ph]


@pytest.mark.parametrize("sharing", [True, False])
def test_explicit_preempt_resumes_bit_exact(setup, sharing):
    cfg = setup[1]
    prompt = make_prompts("text", cfg.vocab_size, 1, 20, seed=3)[0]

    def run(at):
        _, eng = _engines(setup, prefix_sharing=sharing)
        h = eng.submit(Request(tokens=prompt, max_new_tokens=12))
        steps = 0
        while h.state is not RequestState.FINISHED:
            eng.step()
            steps += 1
            if steps == at and h.state is RequestState.RUNNING:
                eng.preempt(h)
        eng.pool.check_invariants()
        assert eng.pool.blocks_in_use == (eng.trie.n_nodes if sharing
                                          else 0)
        return h, eng

    base, _ = run(None)
    for at in (2, 6):
        pre, eng = run(at)
        assert pre.tokens == base.tokens
        assert eng.counters["preemptions"] == eng.counters["resumes"] == 1
    with pytest.raises(ValueError, match="preempt of a finished"):
        eng.preempt(pre)


def test_replay_virtual_clock_deterministic(setup):
    vocab = setup[1].vocab_size
    out = []
    for _ in range(2):
        _, te = _engines(setup, sched=dict(prefill_chunk=32))
        th = te.replay(_stream(vocab, _shared_specs(vocab) +
                               _qos_specs(vocab))[1], realtime=False)
        out.append([(h.tokens, h.ttft_s, h.finish_s, h.qos) for h in th])
        assert te._clock is None
    assert out[0] == out[1]


def test_generate_shim_matches_reference(setup):
    cfg = setup[1]
    toks = make_prompts("text", cfg.vocab_size, 2, 10, seed=3)
    je, te = _engines(setup)
    jout, _, jsteps = je.generate({"tokens": toks}, 6)
    tout, ttft, tsteps = te.generate({"tokens": toks}, 6)
    assert tout.shape == (2, 6) and tout.dtype == np.int32
    assert ttft > 0 and len(tsteps) == len(jsteps)
    jh = [_finished(JRequest(tokens=toks[i], max_new_tokens=6),
                    np.asarray(jout)[i]) for i in range(2)]
    th = [_finished(Request(tokens=toks[i]), tout[i]) for i in range(2)]
    _check_tokens(setup[3], jh, th)
    sp = SamplingParams(temperature=0.9, seed=7)
    assert te.generate({"tokens": toks}, 4, sampling=sp)[0].shape == (2, 4)
    with pytest.raises(ValueError):
        te.generate({"tokens": np.zeros((3, 4), np.int32)}, 2)
    with pytest.raises(NotImplementedError):
        te.generate({"tokens": toks, "image_embeds": None}, 2)


def _finished(request, tokens):
    """A finished handle's stand-in for ``_check_tokens``."""
    return types.SimpleNamespace(id=0, request=request,
                                 tokens=[int(t) for t in tokens],
                                 state=RequestState.FINISHED)


def test_stall_error_on_a_never_satisfiable_head(setup):
    _, te = _engines(setup, hbm_budget_bytes=1 << 26)
    # Out-of-band pressure on the envelope: the submit-time guard passes,
    # but no KV block can ever be reserved and nothing can free bytes.
    assert te.budget.try_reserve(te.budget.cap - te.budget.used - 1)
    te.submit(Request(tokens=np.arange(8), max_new_tokens=2))
    with pytest.raises(EngineStallError) as ei:
        te.drain()
    snap = ei.value.snapshot
    assert snap["queued_total"] == 1 and snap["budget_cap"] == 1 << 26
    assert snap["budget_headroom_frac"] < 0.01
    assert "queue depths" in str(ei.value)


def test_batch_tier_decodes_on_the_all_lo_view(setup, monkeypatch):
    """dynaexq with hi experts published and frozen: batch-tier rows
    decode through the all-lo view (every tile of those forwards on lo),
    standard rows through the served banks (some tiles hi); tokens as the
    reference's under the margin rule."""
    je, te = _engines(setup, backend="dynaexq")
    vocab = setup[1].vocab_size
    for eng, R in ((je, JRequest), (te, Request)):
        for p in _prompts(vocab, 2, 16, "text", seed=99):
            eng.submit(R(tokens=p, max_new_tokens=4))
        eng.drain()
        eng.backend.force_update()
        eng.backend.flush()
        for ctl in eng.backend.controllers.values():
            ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    assert je.backend.hi_sets() == te.backend.hi_sets()
    seen, mode = {"lo": [], "mixed": []}, [None]
    decode_fn, tile_slots = te._decode_fn, tmoe._tile_slots

    def decode(lo):
        mode[0] = "lo" if lo else "mixed"
        try:
            return decode_fn(lo)
        finally:
            mode[0] = None

    def slots(bank, tile_eid, e_local):
        out = tile_slots(bank, tile_eid, e_local)
        if mode[0] is not None:
            seen[mode[0]].append(int((out >= 0).sum()))
        return out

    monkeypatch.setattr(te, "_decode_fn", decode)
    monkeypatch.setattr(tmoe, "_tile_slots", slots)
    specs = [(p, q, None, i) for i, (p, q) in enumerate(zip(
        _prompts(vocab, 2, 14, "code", seed=5), ("batch", "standard")))]
    jr, tr = _stream(vocab, specs)
    ties = _ReferenceTies(je)
    jh = je.replay(jr, realtime=False)
    th = te.replay(tr, realtime=False)
    assert seen["lo"] and not any(seen["lo"])
    assert any(seen["mixed"])
    assert all(int((b.slot_owner >= 0).sum()) == 0
               for b in te.lo_banks.values())
    assert any(int((b.slot_owner >= 0).sum()) > 0
               for b in te.banks.values())
    _check_counters(je, te)
    _check_tokens(ties, jh, th)


class _ReferenceTies:
    """The top-2 gap of the reference engine's own logits at every greedy
    emission, recorded while it serves (its prefills and its decode steps
    on either tier's banks)."""

    def __init__(self, je):
        self.gaps = {}
        post, decode = je._post_prefill, je._jit_decode_paged

        def post_prefill(group, slots_arr, lengths, counts, dt, logits, *a):
            lg = np.asarray(logits)
            for r, h in enumerate(group):
                self.gaps[(h.id, 0)] = _gap(lg[r])
            return post(group, slots_arr, lengths, counts, dt, logits, *a)

        def decoded(*a, **k):
            out = decode(*a, **k)
            lg = np.asarray(out[0])
            for i in np.flatnonzero(np.asarray(a[5])):     # row_valid
                h = je.slots[i]
                self.gaps[(h.id, len(h.tokens))] = _gap(lg[i])
            return out

        je._post_prefill, je._jit_decode_paged = post_prefill, decoded

    def tie(self, handle, t) -> float:
        assert handle.request.sampling is None
        return self.gaps[(handle.id, t)]


def _gap(row) -> float:
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def test_shedding_and_downgrade_match_reference(setup):
    vocab = setup[1].vocab_size
    sched = dict(shed_policy="reject", shed_queue_depth=2)
    je, te = _engines(setup, sched=sched)
    out = []
    for eng, R in ((je, JRequest), (te, Request)):
        hs = [eng.submit(R(tokens=p, max_new_tokens=2, qos=q))
              for p, q in zip(_prompts(vocab, 7, 6, seed=3),
                              ["standard"] * 3 + ["batch", "standard",
                                                  "premium", "batch"])]
        out.append([(h.state.value, h.exec_qos) for h in hs])
        assert eng.load_snapshot().keys() == set(LOAD_SNAPSHOT_KEYS)
        eng.drain()
    assert out[0] == out[1]
    assert ("shed", "batch") in out[1]
    assert te.counters["shed_requests"] == je.counters["shed_requests"] >= 1
    assert te.counters["downgraded"] == je.counters["downgraded"] >= 1
    # Expired batch work is dropped from the queue.
    je, te = _engines(setup)
    for eng, R in ((je, JRequest), (te, Request)):
        eng._clock = 0.0
        h = eng.submit(R(tokens=np.arange(6), qos="batch", deadline_ms=1.0))
        eng._clock = 1.0
        eng.step()
        assert h.state.value == "shed"
    assert te.counters["shed_requests"] == je.counters["shed_requests"] == 1


def test_default_config_serves_as_the_reference_default(setup):
    """``EngineConfig()`` with ``SchedulerConfig()`` (prefix sharing on)
    against the reference's defaults on default-class traffic."""
    jcfg, cfg, jp, oracle = setup
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp),
                          jmake_backend("static"),
                          JEngineConfig(moe_dispatch="ragged"))
    te = InferenceEngine(cfg, params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)),
        make_backend("static", device="cpu"), device="cpu")
    jr, tr = _stream(cfg.vocab_size, _shared_specs(cfg.vocab_size))
    jh = je.replay(jr, realtime=False)
    th = te.replay(tr, realtime=False)
    _check_counters(je, te)
    assert te.stats()["prefix_hit_tokens"] > 0
    _check_tokens(oracle, jh, th)


@pytest.mark.parametrize("option", [dict(spec_k=2), dict(promo_deadline_s=1.0),
                                    dict(watchdog_no_progress_s=1.0),
                                    dict(row_capacity_norm=True)],
                         ids=lambda o: next(iter(o)))
def test_unported_options_raise(setup, option):
    """Each of these options (once refused by the port) builds an engine
    on both paths and, drop-free with nothing for a watchdog to do, serves
    the same tokens as without it (tests/test_torch_spec.py and
    tests/test_torch_watchdog.py hold each feature against the
    reference)."""
    vocab = setup[1].vocab_size
    specs = [(p, None, None, 0) for p in _prompts(vocab, 2, 12, "code",
                                                  seed=8)]
    for paged in (True, False):
        kw = dict(paged=paged, moe_dispatch="ragged" if paged else "padded")
        out = []
        for opt in ({}, option):
            _, te = _engines(setup, **kw, **opt)
            out.append([h.tokens for h in te.replay(_stream(vocab, specs)[1],
                                                    realtime=False)])
        assert out[1] == out[0]
        assert all(len(t) == 8 for t in out[1])


def test_dense_path_preemption_is_not_ported(setup):
    """Preemption on the dense path (which the port once refused): an
    explicit ``preempt`` requeues the request and its resume continues
    bit-exact; the reference does the same."""
    out = []
    for at in (None, 2):
        je, te = _engines(setup, paged=False, moe_dispatch="padded")
        for eng, R in ((je, JRequest), (te, Request)):
            h = eng.submit(R(tokens=np.arange(9), max_new_tokens=6))
            steps = 0
            while h.state.value != "finished":
                eng.step()
                steps += 1
                if steps == at:
                    eng.preempt(h)
                    assert h.state.value == "queued"
            assert eng.counters["resumes"] == (0 if at is None else 1)
            out.append(list(h.tokens))
    assert out[0] == out[2] and out[1] == out[3]
