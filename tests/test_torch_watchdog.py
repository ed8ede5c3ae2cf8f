"""The watchdogs, dense-path preemption and per-row MoE capacity of the
port, on the CPU, against the reference.

* ``TransitionManager.cancel_stuck`` (a promotion whose copy has not
  completed past the deadline) against the reference's under its injected
  DMA stall: the same cancels, exactly one refund, the expert left lo, the
  same ages; and the engine's ``promo_deadline_s`` on a virtual clock.
* ``watchdog_no_progress_s``: a wedged request is requeued and resumes
  bit-exact (the reference's ``test_faults.py::
  test_watchdog_requeues_no_progress_request``).
* ``preempt`` on the dense path: the reference's tokens and the
  unpreempted run's.
* ``row_capacity_norm``: the padded layout's per-row drop rule against the
  reference's, and served tokens equal to the reference's with drops on
  both dispatches.

On the CPU a copy completes at once, so a stuck copy is a stand-in event
that never completes (on the card, ``chip_smoke.py``'s spec phase holds a
real copy behind a spin on the side stream).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.core import DynaExqController as JDynaExqController
from repro.core import build_bank as jbuild_bank
from repro.core import expert_hi_nbytes as jexpert_hi_nbytes
from repro.core.ver import Residency as JResidency
from repro.fault import FaultPlan, FaultRule
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro.serving.requests import make_prompts
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.core.controller import ControllerConfig, DynaExqController
from repro_torch.core.ver import Residency, build_bank, expert_hi_nbytes
from repro_torch.models import moe as tmoe
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import (EngineConfig, InferenceEngine,
                                        RequestState)
from repro_torch.serving.requests import Request
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def ref_model():
    jcfg = jget_config(ARCH, reduced=True)
    return jcfg, jinit_params(jax.random.PRNGKey(0), jcfg)


class _Stuck:
    """A copy's completion event that never completes."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        raise AssertionError("waited on a stuck copy")


# --------------------------------------------------------------------------
# promotions: cancel_stuck
# --------------------------------------------------------------------------

def _controllers(n_hi=2):
    """The reference's controller under a promotion-copy stall of 100 s
    (its fault plane) and the port's over the same weights."""
    w = jax.random.normal(jax.random.PRNGKey(0), (1, 8, 64, 32),
                          jnp.float32).astype(jnp.bfloat16)
    hib = jexpert_hi_nbytes({"w": w.shape})
    jctl = JDynaExqController(
        jbuild_bank({"w": w}, n_hi=n_hi, lo_bits=4), {"w": np.asarray(w)},
        n_hi_per_layer=n_hi, hi_bytes_per_expert=hib,
        cfg=JControllerConfig(update_interval_s=1e9))
    jctl.tm.injector = FaultPlan(seed=7, rules=(FaultRule(
        site="promo_copy", kind="stall", every=1, stall_s=100.0),)) \
        .injector()
    tw = to_torch(w)
    tctl = DynaExqController(
        build_bank({"w": tw}, n_hi=n_hi, lo_bits=4), {"w": tw},
        n_hi_per_layer=n_hi, hi_bytes_per_expert=expert_hi_nbytes(
            {"w": tuple(tw.shape)}),
        cfg=ControllerConfig(update_interval_s=1e9))
    assert expert_hi_nbytes({"w": tuple(tw.shape)}) == hib
    return jctl.tm, tctl.tm, hib


def test_cancel_stuck_refunds_once_and_leaves_the_expert_lo():
    jtm, ttm, hib = _controllers()
    t = [1.0]
    jtm.clock = ttm.clock = lambda: t[0]
    for tm in (jtm, ttm):
        tm.request_promotion(0, 1)
        tm.request_promotion(0, 5)
        tm.drain()
    for p in ttm._pending:
        p.event = _Stuck()
    t[0] = 3.5
    assert ttm.pending_ages(t[0]) == jtm.pending_ages(t[0]) == \
        [(0, 1, 2.5), (0, 5, 2.5)]
    # In flight, not yet past the deadline: nothing published or cancelled.
    for tm in (jtm, ttm):
        assert tm.publish_ready() == 0 and len(tm._pending) == 2
        assert tm.cancel_stuck(now=t[0], deadline_s=5.0) == 0
        tm.check_invariants()
    t[0] = 10.0
    for tm, R in ((jtm, JResidency), (ttm, Residency)):
        p = tm._pending[0]
        assert tm.cancel_stuck(now=t[0], deadline_s=5.0) == 2
        assert not tm._pending and tm.inflight_bytes == 0
        assert tm.tracker.used == 0
        assert tm.state[0, 1] == tm.state[0, 5] == R.RESIDENT_LO.value
        assert tm.hi_set(0) == set()
        assert tm.stats["fault_cancels"] == 2
        assert tm.cancel_stuck(now=t[0], deadline_s=5.0) == 0
        # A racing second cancel (the reference's takes a reason).
        if tm is jtm:
            tm._cancel_pending(p, "timeout")
        else:
            tm._cancel_pending(p)
        assert tm.tracker.used == 0 and tm.inflight_bytes == 0
        assert tm.stats["fault_cancels"] == 2
        tm.check_invariants()
        # The freed slots promote again.
        tm.request_promotion(0, 1)
        tm.drain()
        assert tm.tracker.used == hib


def test_engine_promo_deadline_cancels_on_the_virtual_clock(ref_model):
    """``promo_deadline_s``: promotions whose copy is held in flight are
    cancelled by the step after the deadline on the engine's clock (the
    expert keeps serving lo, the refund happens once, the request
    finishes); a copy that completes is published, never cancelled."""
    _, jp = ref_model
    cfg = get_config(ARCH, reduced=True)
    be = make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                      global_alloc=False, device="cpu",
                      controller=ControllerConfig(update_interval_s=0.0))
    eng = InferenceEngine(cfg, params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)), be,
        EngineConfig(max_slots=2, max_len=64, promo_deadline_s=1.0),
        device="cpu")
    tms = [c.tm for c in be.controllers.values()]
    held = []
    issue = type(tms[0])._issue_copy

    def stuck_copy(tm, layer, expert, slot):
        issue(tm, layer, expert, slot)
        tm._pending[-1].event = _Stuck()
        held.append((layer, expert))

    eng._clock = 0.0
    for tm in tms:
        tm._issue_copy = stuck_copy.__get__(tm)
    h = eng.submit(Request(tokens=make_prompts("text", cfg.vocab_size, 1,
                                               12, seed=2)[0],
                           max_new_tokens=4))
    eng.step()                       # prefill; its counts queue promotions
    assert held and all(tm._pending for tm in tms)
    eng._clock = 0.5
    eng.step()
    assert eng._watchdog.stats["promo_timeouts"] == 0
    pending = sum(isinstance(p.event, _Stuck) for tm in tms
                  for p in tm._pending)
    for tm in tms:
        del tm._issue_copy          # later copies complete
    eng._clock = 2.0
    eng.step()
    assert eng._watchdog.stats["promo_timeouts"] == pending
    assert eng.stats()["fault_cancels"] == pending
    for tm in tms:
        assert not any(isinstance(p.event, _Stuck) for p in tm._pending)
        tm.check_invariants()
    eng.drain()
    eng.flush()
    assert h.state is RequestState.FINISHED and len(h.tokens) == 4
    assert eng.stats()["promotions"] >= 1
    for tm in tms:
        tm.check_invariants()


# --------------------------------------------------------------------------
# requests: the no-progress watchdog, dense preemption
# --------------------------------------------------------------------------

def _pair(ref_model, **ecfg):
    """A reference and a port engine (static int4 lo) on the same
    weights."""
    jcfg, jp = ref_model
    cfg = get_config(ARCH, reduced=True)
    kw = dict(max_slots=2, max_len=48)
    kw.update(ecfg)
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp),
                          jmake_backend("static", lo_bits=4),
                          JEngineConfig(**kw))
    te = InferenceEngine(cfg, params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)),
        make_backend("static", lo_bits=4, device="cpu"), EngineConfig(**kw),
        device="cpu")
    return cfg, je, te


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_watchdog_requeues_no_progress_request(ref_model, paged):
    """A RUNNING request with no token for longer than the deadline is
    preempted and requeued (``watchdog_cancels``), then finishes with
    exactly the undisturbed run's tokens, which are the reference's under
    the same watchdog."""
    kw = dict(paged=paged, moe_dispatch="ragged" if paged else "padded",
              watchdog_no_progress_s=30.0)
    cfg, je, te = _pair(ref_model, **kw)
    prompt = make_prompts("text", cfg.vocab_size, 1, 8)[0]
    _, _, plain = _pair(ref_model, **dict(kw, watchdog_no_progress_s=None))
    want = plain.generate({"tokens": prompt[None]}, 6)[0][0].tolist()
    out = []
    for eng, R in ((je, JRequest), (te, Request)):
        h = eng.submit(R(tokens=prompt, max_new_tokens=6))
        while len(h.tokens) < 2:
            eng.step()
        h.last_progress_s -= 1000.0          # a wedged slot
        eng.step()
        assert eng.counters["watchdog_cancels"] == 1
        assert eng.counters["preemptions"] == 1
        assert h.state.value in ("queued", "running")
        eng.drain()
        assert eng.counters["resumes"] == 1
        out.append(list(h.tokens))
    assert out[1] == want
    assert out[0] == out[1]


def test_dense_preemption_matches_reference_and_unpreempted(ref_model):
    """``preempt`` on dense rows: the whole row goes to the host and comes
    back into any free slot (here slot 0, freed by a finished request,
    not the slot 2 it left); the tokens are the unpreempted run's, and the
    reference's under the same preemption are its own unpreempted ones.
    The two packages' tokens agree up to a near tie of the reference's
    logits (``_check_margin``)."""
    kw = dict(paged=False, moe_dispatch="padded", max_slots=3)
    prompts = [make_prompts("text", 512, 1, n, seed=n)[0]
               for n in (9, 14, 11)]

    def run(eng, R, preempt):
        hs = [eng.submit(R(tokens=p, max_new_tokens=n))
              for p, n in zip(prompts, (3, 10, 10))]
        while hs[0].state.value != "finished":
            eng.step()
        if preempt:
            assert hs[2].slot == 2
            eng.preempt(hs[2])
            assert hs[2].state.value == "queued" and hs[2].slot is None
            eng.step()
            assert hs[2].slot == 0
        eng.drain()
        return [list(h.tokens) for h in hs]

    _, jplain, plain = _pair(ref_model, **kw)
    want = run(plain, Request, False)
    jwant = run(jplain, JRequest, False)
    _, je, te = _pair(ref_model, **kw)
    assert run(te, Request, True) == want
    assert te.counters["preemptions"] == te.counters["resumes"] == 1
    assert run(je, JRequest, True) == jwant
    _check_margin(ref_model, prompts, jwant, want)


def _check_margin(ref_model, prompts, ref_tokens, port_tokens, tol=0.2):
    """Each request's tokens equal the reference's up to their first
    difference, which must come where the reference's own top-2 logits
    (one prefill of prompt + the tokens before it, static int4) are within
    ``tol`` (4 × the packages' logit tolerance, as test_torch_frontend)."""
    jcfg, jp = ref_model
    for p, a, b in zip(prompts, ref_tokens, port_tokens):
        assert len(a) == len(b)
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        eng = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp),
                               jmake_backend("static", lo_bits=4),
                               JEngineConfig(max_slots=1, max_len=64,
                                             prefix_sharing=False))
        seen = []
        call = eng._jit_prefill_paged
        eng._jit_prefill_paged = lambda *x, **k: seen.append(
            call(*x, **k)) or seen[-1]
        eng.submit(JRequest(tokens=np.concatenate([p, a[:t]]),
                            max_new_tokens=1))
        eng.drain()
        top = np.sort(np.asarray(seen[-1][0])[0])[-2:]
        assert top[1] - top[0] < tol, (t, a, b)


# --------------------------------------------------------------------------
# per-row MoE capacity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("row_capacity", [1, 2, 3])
def test_padded_row_capacity_matches_reference(row_capacity):
    """The padded layout's per-row rule (physical capacity n_rows ·
    row_capacity, kept assignments packed in order) against the
    reference's ``dispatch_compute``: counts, drop fraction and outputs;
    and against the port's ragged layout, which keeps the same
    assignments (bit-equal per token)."""
    jcfg = jget_config("qwen3-moe-30b-a3b", reduced=True)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jbank = jbuild_bank(jp["blocks"]["0"]["moe"]["experts"], n_hi=0,
                        lo_bits=4)
    E, k, d = jcfg.moe.num_experts, jcfg.moe.top_k, jcfg.d_model
    T, n_rows = 24, 4
    rng = np.random.default_rng(row_capacity)
    x = jnp.asarray(rng.standard_normal((T, d)), jnp.bfloat16)
    # Expert 0 in every token's top-k: each row of 6 tokens overflows it.
    idx = np.stack([np.concatenate([[0], 1 + rng.permutation(E - 1)[:k - 1]])
                    for _ in range(T)]).astype(np.int32)
    idx[3, :] = E                          # one masked token
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    gates[idx == E] = 0.0
    cap = n_rows * row_capacity
    jl = jax.tree_util.tree_map(lambda a: a[0], jbank)
    yj, cj, dj = jmoe.dispatch_compute(
        jl, x, jnp.asarray(idx), jnp.asarray(gates), E, cap,
        row_capacity=row_capacity, n_rows=n_rows, gemm="jnp")
    tl = bank_from_reference(jbank).layer(0)
    args = (tl, to_torch(x), torch.from_numpy(idx).long(),
            torch.from_numpy(gates), E, cap)
    yt, ct, dt = tmoe.dispatch_compute(*args, row_capacity=row_capacity,
                                       n_rows=n_rows)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert float(dj) == float(dt) > 0.0
    # Another summation order than XLA's: a bf16 rounding of an output may
    # flip (test_torch_padded's tolerance).
    want = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())
    yr, cr, dr, _ = tmoe._dispatch_ragged(*args, row_capacity=row_capacity,
                                          n_rows=n_rows)
    assert torch.equal(cr, ct) and float(dr) == float(dt)
    np.testing.assert_allclose(yr.float().numpy(), yt.float().numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("paged,dispatch", [(True, "ragged"),
                                            (True, "padded"),
                                            (False, "padded")],
                         ids=["paged-ragged", "paged-padded",
                              "dense-padded"])
def test_row_capacity_norm_tokens_match_reference(ref_model, paged,
                                                  dispatch):
    """``row_capacity_norm`` under a capacity factor that drops: the same
    tokens as the reference's engine, on both dispatches; and a request's
    tokens do not depend on the rows beside it (alone = together)."""
    # Prompts of 20-28 tokens in the 32-token bucket: ~12 assignments per
    # expert and row against a prefill row capacity of 8.
    kw = dict(paged=paged, moe_dispatch=dispatch, capacity_factor=0.25,
              row_capacity_norm=True, max_slots=3)
    prompts = [make_prompts("text", 512, 1, n, seed=n)[0] for n in (20, 28,
                                                                   25)]
    _, je, te = _pair(ref_model, **kw)
    assert te._row_cap_decode == je._row_cap_decode == 8
    assert te._row_cap_prefill(32) == je._row_cap_prefill(32) == 8
    out = []
    for eng, R in ((je, JRequest), (te, Request)):
        hs = [eng.submit(R(tokens=p, max_new_tokens=8)) for p in prompts]
        eng.drain()
        out.append([list(h.tokens) for h in hs])
    assert out[0] == out[1]
    _, _, alone = _pair(ref_model, **kw)
    h = alone.submit(Request(tokens=prompts[1], max_new_tokens=8))
    alone.drain()
    assert h.tokens == out[1][1]
