"""The port's fault plane on the CPU, against the reference's.

* ``fault.inject``: the same plans give the same fire sequences (kind,
  arrival, rule, stall) and counters in both packages (the cases of the
  reference's ``tests/test_faults.py`` and a mixed-site plan).
* ``fault.retry``: ``RetryPolicy.delay_s`` and ``retry_call``'s outcomes
  (result, retries, modeled backoff, exhaustion, deadline) equal.
* The ``promo_copy`` fault path of ``TransitionManager``, side by side
  with the reference's over the same weights: a failed copy aborts and
  refunds once, a transient failure is absorbed by the retry, a stall
  holds publication until the watchdog cancels it, a corrupt copy is never
  published.
* The streaming cold start under shard faults (the reference's
  ``test_shard_fault_retry_token_parity`` and
  ``test_quarantine_heal_and_degraded_marking``), and a seeded soak under
  random promotion and host faults: every request finishes, the refunds
  balance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JControllerConfig
from repro.core import DynaExqController as JDynaExqController
from repro.core import build_bank as jbuild_bank
from repro.core import expert_hi_nbytes as jexpert_hi_nbytes
from repro.fault import FaultPlan as JFaultPlan
from repro.fault import FaultRule as JFaultRule
from repro.fault import RetryExhausted as JRetryExhausted
from repro.fault import RetryPolicy as JRetryPolicy
from repro.fault import TransferFault as JTransferFault
from repro.fault import retry_call as jretry_call
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import load_streaming_params as jload_streaming_params
from repro.serving import make_backend as jmake_backend
from repro.serving import save_expert_shards as jsave_expert_shards
from repro.serving.requests import make_prompts
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.core.controller import ControllerConfig, DynaExqController
from repro_torch.core.ver import Residency, build_bank, expert_hi_nbytes
from repro_torch.fault import (FaultPlan, FaultRule, RetryExhausted,
                               RetryPolicy, TransferFault, retry_call)
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import (EngineConfig, InferenceEngine,
                                        RequestState)
from repro_torch.serving.requests import Request
from repro_torch.serving.streaming import load_streaming_params
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
FROZEN = dict(update_interval_s=1e9)


def _plans(*rules, seed=7):
    """The same plan in both packages."""
    return (JFaultPlan(seed=seed, rules=tuple(JFaultRule(**r)
                                              for r in rules)),
            FaultPlan(seed=seed, rules=tuple(FaultRule(**r)
                                             for r in rules)))


# --------------------------------------------------------------------------
# fault plans, the injector and the retry policy
# --------------------------------------------------------------------------

def test_fault_plan_parse_roundtrip_matches_reference(tmp_path):
    text = ('{"seed": 7, "rules": [{"site": "host_lo", "prob": 0.1},'
            ' {"site": "promo_copy", "kind": "stall", "every": 3,'
            ' "stall_s": 0.5}]}')
    jplan, plan = JFaultPlan.parse(text), FaultPlan.parse(text)
    assert plan.to_json() == jplan.to_json()
    f = tmp_path / "plan.json"
    f.write_text(jplan.to_json())
    again = FaultPlan.parse(str(f), seed=11)
    assert again.seed == 11 and again.rules == plan.rules
    assert FaultPlan.parse(plan.to_json()) == plan


@pytest.mark.parametrize("bad", [dict(kind="explode"), dict(prob=1.5),
                                 dict(prob=-0.1)])
def test_fault_rule_validation_matches_reference(bad):
    msgs = []
    for cls in (JFaultRule, FaultRule):
        with pytest.raises(ValueError) as ei:
            cls(site="host_lo", **bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


PLANS = {
    "prob": [dict(site="host_lo", prob=0.3)],
    "cadence": [dict(site="promo_copy", every=3, start=1, max_fires=2)],
    "first_match": [dict(site="host_lo", every=1, max_fires=1),
                    dict(site="host_lo", kind="stall", every=1,
                         stall_s=9.0)],
    "mixed": [dict(site="promo_copy", prob=0.4),
              dict(site="promo_copy", kind="corrupt", prob=0.2),
              dict(site="host_hi", kind="stall", prob=0.3, stall_s=0.25),
              dict(site="stage_lo", every=5, start=2),
              dict(site="shard_lo", prob=0.5, max_fires=7),
              dict(site="host_fetch", kind="stall", every=4,
                   stall_s=0.01)],
}


@pytest.mark.parametrize("seed", [7, 12345])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_injector_fire_sequences_match_reference(name, seed):
    jplan, plan = _plans(*PLANS[name], seed=seed)
    jinj, inj = jplan.injector(), plan.injector()
    sites = ("promo_copy", "host_hi", "host_lo", "stage_lo", "shard_lo",
             "shard_hi", "host_fetch")
    order = np.random.default_rng(seed).integers(0, len(sites), 400)
    fired = 0
    for i in order:
        a, b = jinj.fire(sites[i]), inj.fire(sites[i])
        assert (a is None) == (b is None), (sites[i], a, b)
        if a is not None:
            fired += 1
            assert (b.site, b.kind, b.seq, b.stall_s, b.rule) == \
                (a.site, a.kind, a.seq, a.stall_s, a.rule)
    assert fired > 0
    assert inj.stats == jinj.stats
    assert [inj.arrivals(s) for s in sites] == \
        [jinj.arrivals(s) for s in sites]


def test_injector_cadence_and_first_match():
    """The reference's own expectations, on the port's injector."""
    _, plan = _plans(*PLANS["cadence"])
    inj = plan.injector()
    assert [k for k in range(12) if inj.fire("promo_copy")] == [1, 4]
    _, plan = _plans(*PLANS["first_match"])
    inj = plan.injector()
    f0, f1 = inj.fire("host_lo"), inj.fire("host_lo")
    assert f0.kind == "fail" and f0.rule == 0
    assert f1.kind == "stall" and f1.rule == 1 and f1.stall_s == 9.0


@pytest.mark.parametrize("policy", [dict(), dict(max_attempts=5, base_s=0.01,
                                                 cap_s=0.02)])
def test_retry_delay_matches_reference(policy):
    jpol, pol = JRetryPolicy(**policy), RetryPolicy(**policy)
    for attempt in range(1, 7):
        for seed, site, key in ((0, "", 0), (3, "host_lo", 42),
                                (7, "promo_copy", (3 << 16) | 5)):
            d = pol.delay_s(attempt, seed=seed, site=site, key=key)
            assert d == jpol.delay_s(attempt, seed=seed, site=site, key=key)
            assert 0.5 * min(pol.cap_s, pol.base_s) <= d < 1.5 * pol.cap_s


def _flaky(n_fail, fault):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= n_fail:
            raise fault("host_lo")
        return "ok"
    return fn


@pytest.mark.parametrize("n_fail,attempts,timeout", [
    (0, 3, None), (2, 4, None), (2, 3, None), (5, 100, 0.08), (3, 3, None)])
def test_retry_call_outcomes_match_reference(n_fail, attempts, timeout):
    kw = dict(max_attempts=attempts, base_s=0.05, cap_s=0.05,
              timeout_s=timeout)
    got = []
    for call, pol, fault, exhausted in (
            (jretry_call, JRetryPolicy(**kw), JTransferFault,
             JRetryExhausted),
            (retry_call, RetryPolicy(**kw), TransferFault, RetryExhausted)):
        try:
            got.append(call(_flaky(n_fail, fault), pol, seed=3,
                            site="host_lo", key=9))
        except exhausted as e:
            assert isinstance(e.__cause__, fault)
            got.append(("exhausted", e.attempts, e.waited_s))
    assert got[0] == got[1]


def test_retry_call_leaves_other_errors_alone():
    def broken():
        raise ValueError("not a transfer fault")
    with pytest.raises(ValueError):
        retry_call(broken, RetryPolicy(), site="host_lo")


# --------------------------------------------------------------------------
# the promotion copy under faults, side by side with the reference
# --------------------------------------------------------------------------

def _managers(rules, n_hi=2, seed=7):
    """The reference's and the port's controller over the same weights,
    each with the same fault plan; returns their transition managers."""
    w = jax.random.normal(jax.random.PRNGKey(0), (1, 8, 64, 32),
                          jnp.float32).astype(jnp.bfloat16)
    hib = jexpert_hi_nbytes({"w": w.shape})
    jctl = JDynaExqController(
        jbuild_bank({"w": w}, n_hi=n_hi, lo_bits=4), {"w": np.asarray(w)},
        n_hi_per_layer=n_hi, hi_bytes_per_expert=hib,
        cfg=JControllerConfig(**FROZEN))
    tw = to_torch(w)
    tctl = DynaExqController(
        build_bank({"w": tw}, n_hi=n_hi, lo_bits=4), {"w": tw},
        n_hi_per_layer=n_hi,
        hi_bytes_per_expert=expert_hi_nbytes({"w": tuple(tw.shape)}),
        cfg=ControllerConfig(**FROZEN))
    jplan, plan = _plans(*rules, seed=seed)
    jctl.tm.injector, tctl.tm.injector = jplan.injector(), plan.injector()
    return (jctl, tctl), hib


def _same(jtm, ttm):
    assert ttm.stats == jtm.stats
    assert np.array_equal(ttm.state, jtm.state)
    assert ttm.hi_set(0) == jtm.hi_set(0)
    assert ttm.tracker.used == jtm.tracker.used
    assert ttm.inflight_bytes == jtm.inflight_bytes
    assert len(ttm._pending) == len(jtm._pending)
    jtm.check_invariants()
    ttm.check_invariants()


def test_promo_fail_aborts_and_refunds_once():
    ctls, _ = _managers([dict(site="promo_copy", every=1)])
    for ctl in ctls:
        ctl.tm.request_promotion(0, 3)
        ctl.tm.drain()
    (jctl, tctl) = ctls
    _same(jctl.tm, tctl.tm)
    tm = tctl.tm
    assert tm.hi_set(0) == set() and not tm._pending
    assert tm.state[0, 3] == Residency.RESIDENT_LO.value
    assert tm.tracker.used == 0 and tm.inflight_bytes == 0
    assert tm.stats["fault_cancels"] == 1
    assert np.array_equal(tctl._fail_penalty, jctl._fail_penalty)
    assert tctl._fail_penalty[0, 3] < 1.0
    # The decay ranks the failed expert down, then recovers toward 1.
    for ctl in ctls:
        ctl.hotness.observe(np.ones((1, 8)))
    np.testing.assert_array_equal(tctl.folded_scores(),
                                  jctl.folded_scores())
    np.testing.assert_array_equal(tctl._fail_penalty, jctl._fail_penalty)


def test_promo_retry_then_succeed_is_transparent():
    ctls, hib = _managers([dict(site="promo_copy", every=2)])
    for ctl in ctls:
        ctl.tm.request_promotion(0, 3)
        ctl.tm.drain()
        assert ctl.tm.publish_ready(wait=True) == 1
    _same(ctls[0].tm, ctls[1].tm)
    tm = ctls[1].tm
    assert tm.hi_set(0) == {3} and tm.tracker.used == hib
    assert tm.stats["retries"] >= 1 and tm.stats["fault_cancels"] == 0
    assert torch.equal(tm.bank.hi["w"][0, int(tm.slot_map_h[0, 3])],
                       tm.host_hi["w"][0, 3])


def test_promo_stall_holds_publication_until_the_watchdog_cancels():
    ctls, hib = _managers([dict(site="promo_copy", kind="stall", every=1,
                                stall_s=100.0)])
    t = [0.0]
    for ctl in ctls:
        ctl.tm.clock = lambda: t[0]
        ctl.tm.request_promotion(0, 1)
        ctl.tm.drain()
        assert ctl.tm.inflight_bytes == hib
        assert ctl.tm.publish_ready() == 0 and len(ctl.tm._pending) == 1
        assert ctl.tm.cancel_stuck(now=t[0], deadline_s=5.0) == 0
    _same(ctls[0].tm, ctls[1].tm)
    assert ctls[1].tm.pending_ages(2.5) == ctls[0].tm.pending_ages(2.5) == \
        [(0, 1, 2.5)]
    t[0] = 10.0
    for ctl in ctls:
        assert ctl.tm.cancel_stuck(now=t[0], deadline_s=5.0) == 1
        assert ctl.tm.cancel_stuck(now=t[0], deadline_s=5.0) == 0
    _same(ctls[0].tm, ctls[1].tm)
    tm = ctls[1].tm
    assert not tm._pending and tm.tracker.used == 0
    assert tm.state[0, 1] == Residency.RESIDENT_LO.value
    assert tm.stats["fault_cancels"] == 1


def test_promo_stall_publishes_once_the_clock_passes_it():
    ctls, _ = _managers([dict(site="promo_copy", kind="stall", every=1,
                              stall_s=3.0)])
    t = [1.0]
    for ctl in ctls:
        ctl.tm.clock = lambda: t[0]
        ctl.tm.request_promotion(0, 6)
        ctl.tm.drain()
    t[0] = 3.9
    assert [c.tm.publish_ready() for c in ctls] == [0, 0]
    # The reference's copy is an asynchronous dispatch that a loaded host
    # may not have finished yet: wait for it, so the clock alone decides.
    for p in ctls[0].tm._pending:
        jax.block_until_ready(p.arrays)
    t[0] = 4.1
    assert [c.tm.publish_ready() for c in ctls] == [1, 1]
    _same(ctls[0].tm, ctls[1].tm)
    assert ctls[1].tm.hi_set(0) == {6}


def test_promo_corrupt_copy_is_never_published():
    ctls, _ = _managers([dict(site="promo_copy", kind="corrupt", every=1)])
    for ctl in ctls:
        ctl.tm.request_promotion(0, 2)
        ctl.tm.drain()
        assert ctl.tm.publish_ready(wait=True) == 0
    _same(ctls[0].tm, ctls[1].tm)
    tm = ctls[1].tm
    assert tm.hi_set(0) == set() and (tm.slot_map_h < 0).all()
    assert (tm.bank.slot_map.numpy() < 0).all()
    assert tm.state[0, 2] == Residency.RESIDENT_LO.value
    assert tm.tracker.used == 0 and tm.stats["fault_cancels"] == 1


def test_cancel_refunds_exactly_once():
    ctls, _ = _managers([dict(site="promo_copy", kind="stall", every=1,
                              stall_s=100.0)])
    tm = ctls[1].tm
    tm.clock = lambda: 0.0
    tm.request_promotion(0, 0)
    tm.drain()
    p = tm._pending[0]
    tm._cancel_pending(p)
    tm._cancel_pending(p)                    # a racing second cancel
    assert tm.tracker.used == 0 and tm.inflight_bytes == 0
    assert tm.stats["fault_cancels"] == 1
    tm._pending = [q for q in tm._pending if not q.cancelled]
    tm.check_invariants()


# --------------------------------------------------------------------------
# the streaming cold start under shard faults
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory, serving_setup):
    """The reduced granite, its port params and a shard directory the
    reference wrote."""
    jcfg, jp = serving_setup
    d = tmp_path_factory.mktemp("torch_fault_shards")
    jsave_expert_shards(str(d), jax.tree_util.tree_map(lambda x: x, jp),
                        [0], lo_bits=4)
    cfg = get_config(ARCH, reduced=True)
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, params, str(d)


def _clone(p):
    return {k: _clone(v) for k, v in p.items()} if isinstance(p, dict) \
        else p


def _engine(cfg, params, **kw):
    kw.setdefault("lo_bits", 4)
    kw.setdefault("n_hi_per_layer", 2)
    kw.setdefault("controller", ControllerConfig(**FROZEN))
    ecfg = dict(max_slots=2, max_len=48)
    ecfg.update(kw.pop("ecfg", {}))
    return InferenceEngine(cfg, params, make_backend("dynaexq", device="cpu",
                                                     **kw),
                           EngineConfig(**ecfg), device="cpu")


def _generate(eng, prompts, n=6):
    hs = [eng.submit(Request(tokens=p, max_new_tokens=n)) for p in prompts]
    eng.drain()
    return [list(h.tokens) for h in hs], hs


def test_shard_fault_retry_token_parity(setup):
    """Shard reads that fail once and succeed on their retry are
    invisible: the streamed engine emits the materialized engine's
    tokens, and nothing quarantines."""
    cfg, params, d = setup
    prompts = make_prompts("text", cfg.vocab_size, 2, 16)
    want, _ = _generate(_engine(cfg, _clone(params)), prompts)
    _, plan = _plans(dict(site="shard_lo", every=2))
    eng = _engine(cfg, load_streaming_params(d, device="cpu"), stream=d,
                  stream_experts_per_tick=3, fault=plan)
    got, hs = _generate(eng, prompts)
    assert got == want
    assert not any(h.degraded for h in hs)
    st = eng.backend.stats()
    assert st["retries"] >= 1
    assert st["quarantined"] == 0 and st["fault_cancels"] == 0
    for store in eng.backend.stores.values():
        store.check_invariants()


def _ref_engine(serving_setup, d, **kw):
    jcfg, _ = serving_setup
    kw.setdefault("lo_bits", 4)
    kw.setdefault("n_hi_per_layer", 2)
    kw.setdefault("controller", JControllerConfig(**FROZEN))
    return JInferenceEngine(jcfg, jload_streaming_params(d),
                            jmake_backend("dynaexq", stream=d, **kw),
                            JEngineConfig(max_slots=2, max_len=48))


def _ladder_state(be):
    store = be.stores["0"]
    return (store.quarantined.copy(), store.lo_valid.copy(),
            store.lo_resident.copy(), dict(store.stats),
            dict(be.stream.stats), be.ready_frac())


def _same_ladder(a, b):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3:] == b[3:]


def test_quarantine_heal_and_degraded_marking(setup, serving_setup):
    """Exhausted shard reads quarantine their experts instead of holding
    ``serving_ready()`` back: serving opens with them host-served, the
    requests routed there are flagged degraded, and later re-stages heal
    every cell. The reference under the same plan takes the same steps:
    the same quarantine masks, store and shard-read counters after every
    step, and the same degraded flag."""
    cfg, _, d = setup
    jplan, plan = _plans(dict(site="shard_lo", every=1, max_fires=12))
    eng = _engine(cfg, load_streaming_params(d, device="cpu"), stream=d,
                  stream_experts_per_tick=4, fault=plan)
    je = _ref_engine(serving_setup, d, stream_experts_per_tick=4,
                     fault=jplan)
    be = eng.backend
    steps = 0
    while not be.serving_ready():
        assert not je.backend.serving_ready()
        eng.step()
        je.step()
        steps += 1
        assert steps < 200
    # The pump ends on a blocking publish: both ladders are settled here.
    assert je.backend.serving_ready()
    _same_ladder(_ladder_state(be), _ladder_state(je.backend))
    store = be.stores["0"]
    assert store.stats["quarantines"] >= 1
    assert int(store.quarantined.sum()) > 0
    assert be.degraded_cells()["0"] is store.quarantined
    store.check_invariants()
    prompts = make_prompts("text", cfg.vocab_size, 1, 8)
    h = eng.submit(Request(tokens=prompts[0], max_new_tokens=2))
    jh = je.submit(JRequest(tokens=prompts[0], max_new_tokens=2))
    while h.state is not RequestState.FINISHED:
        eng.step()
    while jh.state.value != "finished":
        je.step()
    assert h.degraded and jh.degraded
    assert be.stats()["host_fetches"] > 0
    # Healing: when a heal publishes depends on when the reference's
    # asynchronous copy reports ready, so the two are compared healed.
    for e in (eng, je):
        for _ in range(200):
            if int(e.backend.stores["0"].quarantined.sum()) == 0:
                break
            e.step()
        e.backend.flush()
    assert int(store.quarantined.sum()) == 0
    assert bool(store.lo_valid.all()) and be.degraded_cells() == {}
    store.check_invariants()
    jstore = je.backend.stores["0"]
    np.testing.assert_array_equal(store.lo_resident, jstore.lo_resident)
    np.testing.assert_array_equal(store.lo_valid, jstore.lo_valid)
    assert store.stats["quarantines"] == jstore.stats["quarantines"]
    st = be.stats()
    assert st["quarantined"] == 0 and st["retries"] >= 1
    # Healed: the bank holds the materialized engine's rows.
    ref = _engine(cfg, _clone(setup[1])).backend.banks["0"]
    for n, q in be.banks["0"].lo.items():
        assert torch.equal(q.packed, ref.lo[n].packed)
        assert torch.equal(q.scales, ref.lo[n].scales)


def test_spec_rounds_flag_degraded_requests(setup, tmp_path):
    """Speculative rounds flag a request degraded when its accepted verify
    steps routed through a quarantined cell, as a plain decode step does
    (the reference's spec rounds leave the flag as it was). Layer 1's lo
    shard is unreadable, so its cells stay quarantined and every forward
    routes through them; the flag the prefill set is cleared, and the
    rounds alone must set it again. With the shard restored and the
    cells healed, a request finishes undegraded."""
    import shutil
    cfg, _, d = setup
    root = str(tmp_path / "shards")
    shutil.copytree(d, root)
    bad = tmp_path / "shards" / "lo" / "p0_l1.npz"
    kept = bad.read_bytes()
    bad.write_bytes(b"not a shard")
    eng = _engine(cfg, load_streaming_params(root, device="cpu"),
                  stream=root, stream_experts_per_tick=4,
                  ecfg=dict(spec_k=2, prefix_sharing=False))
    be = eng.backend
    steps = 0
    while not be.serving_ready():
        eng.step()
        steps += 1
        assert steps < 200
    store = be.stores["0"]
    assert store.quarantined[1].all() and not store.quarantined[0].any()
    prompt = make_prompts("text", cfg.vocab_size, 1, 8)[0]
    h = eng.submit(Request(tokens=prompt, max_new_tokens=6))
    while not h.tokens:
        eng.step()
    assert h.degraded
    h.degraded = False
    rounds = eng._spec.rounds
    while h.state is not RequestState.FINISHED:
        eng.step()
    assert eng._spec.rounds > rounds
    assert h.degraded
    bad.write_bytes(kept)
    for _ in range(200):
        if not store.quarantined.any():
            break
        eng.step()
    be.flush()
    assert not store.quarantined.any() and be.degraded_cells() == {}
    h = eng.submit(Request(tokens=prompt, max_new_tokens=6))
    eng.drain()
    assert h.state is RequestState.FINISHED and not h.degraded
    store.check_invariants()


@pytest.mark.parametrize("seed", [3, 4242])
def test_chaos_soak_zero_failures_and_invariants(setup, seed):
    """Random promotion and host faults under a live controller and mixed
    QoS traffic (the reference's soak plan): every request finishes, the
    refunds balance, hi residents are RESIDENT_HI."""
    cfg, params, _ = setup
    _, plan = _plans(dict(site="promo_copy", prob=0.4),
                     dict(site="promo_copy", kind="corrupt", prob=0.2),
                     dict(site="host_hi", prob=0.3),
                     dict(site="host_lo", prob=0.2), seed=seed)
    eng = _engine(cfg, _clone(params), fault=plan,
                  controller=ControllerConfig(update_interval_s=0.0),
                  ecfg=dict(max_slots=3, promo_deadline_s=30.0))
    prompts = make_prompts("text", cfg.vocab_size, 3, 12)
    hs = [eng.submit(Request(tokens=prompts[i], max_new_tokens=5, qos=q))
          for i, q in enumerate(("premium", "standard", "batch"))]
    eng.drain()
    eng.flush()
    assert all(h.state is RequestState.FINISHED and len(h.tokens) == 5
               for h in hs)
    be = eng.backend
    for ctl in be.controllers.values():
        ctl.tm.check_invariants()
        for l in range(ctl.tm.state.shape[0]):
            for e in ctl.tm.hi_set(l):
                assert ctl.tm.state[l, e] == Residency.RESIDENT_HI.value
    st = eng.stats()
    assert st["fault_cancels"] + st["retries"] > 0
