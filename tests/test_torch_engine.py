"""The port's serving engine against the reference engine: the same
requests, the same weights, greedy tokens compared step by step."""
import dataclasses

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
from repro.serving.requests import make_prompts
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.serving.backends import STAT_KEYS, make_backend
from repro_torch.serving.engine import (ENGINE_STAT_KEYS, EngineConfig,
                                        InferenceEngine)
from repro_torch.serving.requests import Request

ARCH = "granite-moe-1b-a400m"
# Engine logits of the two packages differ by at most a few hundredths on
# this model (see test_torch_model: float32 decode attention in the port,
# bf16 logits/probs in the reference; logits are of magnitude ~1). Greedy
# tokens must stay identical; they may first differ only at a step whose
# reference top-1/top-2 margin is below 4x that tolerance.
LOGIT_TOL = 0.05
PROMPT_LENS = (20, 13, 37)
NEW_TOKENS = 8


def _engines(name, paged=True):
    """Both engines on one set of weights: the paged pool with ragged
    dispatch, or (``paged=False``) dense rows with padded dispatch."""
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    ecfg = dict(max_slots=2, max_len=96)
    if name == "dynaexq":
        jbe = jmake_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                            global_alloc=False,
                            controller=JControllerConfig(
                                update_interval_s=0.0))
        tbe = make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                           controller=ControllerConfig(update_interval_s=0.0),
                           device="cpu")
    else:
        jbe = jmake_backend("static", lo_bits=4)
        tbe = make_backend("static", lo_bits=4, device="cpu")
    dispatch = "ragged" if paged else "padded"
    je = JInferenceEngine(jcfg, jp, jbe, JEngineConfig(
        paged=paged, moe_dispatch=dispatch, prefix_sharing=False, **ecfg))
    te = InferenceEngine(cfg, tp, tbe, EngineConfig(
        paged=paged, moe_dispatch=dispatch, **ecfg), device="cpu")
    return cfg, je, te


def _default_engines(jcfg, cfg, name, paged=True, **kw):
    """Both engines on one set of weights, on the paged/ragged path (or,
    ``paged=False``, dense rows with padded dispatch), each with
    ``make_backend(name, **kw)`` at otherwise default arguments
    (``dynaexq``: the global allocator in both), but a policy window every
    step, so the published sets depend on the tokens alone."""
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    if name == "dynaexq":
        jkw = dict(kw, controller=JControllerConfig(update_interval_s=0.0))
        kw = dict(kw, controller=ControllerConfig(update_interval_s=0.0))
    else:
        jkw = kw
    ecfg = dict(max_slots=2, max_len=96)
    if not paged:
        ecfg.update(paged=False, moe_dispatch="padded")
    je = JInferenceEngine(jcfg, jp, jmake_backend(name, **jkw),
                          JEngineConfig(prefix_sharing=False, **ecfg))
    te = InferenceEngine(cfg, tp, make_backend(name, device="cpu", **kw),
                         EngineConfig(**ecfg), device="cpu")
    return cfg, je, te


def _warm_and_freeze(cfg, je, te):
    """The reference suite's pattern: warm both engines on the same
    prompts, force a policy window, flush, then freeze the controllers, so
    both serve with the same published hi sets whatever the copy timing."""
    warm = make_prompts("text", cfg.vocab_size, 2, 16, seed=99)
    for eng, req in ((je, JRequest), (te, Request)):
        for row in warm:
            eng.submit(req(tokens=row, max_new_tokens=4))
        eng.drain()
        eng.backend.force_update()
        eng.backend.flush()
        for ctl in eng.backend.controllers.values():
            ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    assert je.backend.hi_sets() == te.backend.hi_sets()
    assert any(len(s) for sets in te.backend.hi_sets().values()
               for s in sets)


def _margin(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


def _serve_lockstep(cfg, je, te, monkeypatch, paged=True, tol=LOGIT_TOL):
    """Serve the same requests through both engines one step at a time and
    compare every emitted token and its logits row (to ``tol``, the margin
    rule at ``4 * tol``). A request is compared
    until its tokens first differ (which must be at a small-margin step) or
    its router counts first differ (a top-k near tie, after which its
    hidden states legitimately diverge). Returns per request: (reference
    tokens, port tokens, (first uncompared token, reason) or None,
    small-margin steps seen)."""
    margins, port_logits = {}, {}

    post = je._post_prefill

    def post_prefill(group, slots_arr, lengths, counts, dt, logits, *a):
        lg = np.asarray(logits)
        for r, h in enumerate(group):
            margins[h.id] = [_margin(lg[r])]
        return post(group, slots_arr, lengths, counts, dt, logits, *a)

    je._post_prefill = post_prefill
    last = {}
    jdecode = "_jit_decode_paged" if paged else "_jit_decode"
    decode = getattr(je, jdecode)

    def decode_capture(*a, **kw):
        out = decode(*a, **kw)
        last["logits"] = np.asarray(out[0])
        return out

    setattr(je, jdecode, decode_capture)

    import repro_torch.serving.engine as tengine

    def capture(fn, key):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            port_logits[key] = out[0].float().numpy()
            return out
        return wrapped

    suffix = "_paged" if paged else ""
    for fn, key in (("prefill", "prefill"), ("decode_step", "decode")):
        monkeypatch.setattr(tengine, fn + suffix,
                            capture(getattr(tengine, fn + suffix), key))
    prompts = [make_prompts("code", cfg.vocab_size, 1, n, seed=7 + i)[0]
               for i, n in enumerate(PROMPT_LENS)]
    jh = [je.submit(JRequest(tokens=p, max_new_tokens=NEW_TOKENS))
          for p in prompts]
    th = [te.submit(Request(tokens=p, max_new_tokens=NEW_TOKENS))
          for p in prompts]
    stop = {i: None for i in range(len(prompts))}
    small = {i: 0 for i in range(len(prompts))}
    while je.queue or any(je.slots) or te.queue or any(te.slots):
        before = [len(h.tokens) for h in jh]
        port_logits.clear()
        je.step()
        te.step()
        for i, (a, b) in enumerate(zip(jh, th)):
            n = len(a.tokens)
            if n == before[i] or stop[i] is not None:
                continue
            assert len(b.tokens) == n
            if before[i] > 0:                      # a decode step
                ref_row = last["logits"][a.slot]
                port_row = port_logits["decode"][b.slot]
                margins[a.id].append(_margin(ref_row))
            else:                                  # its prefill
                port_row = None
            small[i] += margins[a.id][-1] < 4 * tol
            if any(not np.array_equal(a.expert_counts[k],
                                      b.expert_counts[k])
                   for k in b.expert_counts):
                stop[i] = (n - 1, "router near-tie")
                continue
            if port_row is not None:
                np.testing.assert_allclose(port_row, ref_row, rtol=0,
                                           atol=tol)
            if a.tokens[-1] != b.tokens[-1]:
                assert margins[a.id][-1] < 4 * tol, (i, n, margins[a.id])
                stop[i] = (n - 1, "tokens differ at a small margin")
    return [(a.tokens, b.tokens, stop[i], small[i])
            for i, (a, b) in enumerate(zip(jh, th))]


def _check_served(name, te, results, tol=LOGIT_TOL):
    held = 0
    for i, (ref_toks, port_toks, stop, small) in enumerate(results):
        assert len(port_toks) == NEW_TOKENS
        upto = NEW_TOKENS if stop is None else stop[0]
        print(f"request {i}: {upto} tokens identical, {small} at a "
              f"reference margin below {4 * tol}"
              + ("" if stop is None else f"; then {stop[1]}"))
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= NEW_TOKENS * len(PROMPT_LENS) // 2, results
    st = te.stats()
    assert set(st) == set(STAT_KEYS + type(te.backend).STAT_EXTRAS +
                          ENGINE_STAT_KEYS)
    assert st["finished"] == len(PROMPT_LENS) + (2 if name == "dynaexq"
                                                  else 0)
    assert st["active_experts"] > 0
    if name == "dynaexq":
        te.flush()
        for ctl in te.backend.controllers.values():
            ctl.tm.check_invariants()
        assert st["promotions"] > 0
        assert te.backend.hi_routed > 0


@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_engine_tokens_match_reference(name, monkeypatch):
    cfg, je, te = _engines(name)
    if name == "dynaexq":
        _warm_and_freeze(cfg, je, te)
    _check_served(name, te, _serve_lockstep(cfg, je, te, monkeypatch))


@pytest.mark.parametrize("name", ["static", "dynaexq"])
def test_dense_padded_engine_tokens_match_reference(name, monkeypatch):
    """The reference engine's ``paged=False, moe_dispatch="padded"`` path
    against the port's, under the same margin rule."""
    cfg, je, te = _engines(name, paged=False)
    if name == "dynaexq":
        _warm_and_freeze(cfg, je, te)
    _check_served(name, te, _serve_lockstep(cfg, je, te, monkeypatch,
                                            paged=False))
    assert te.pool is None


def test_engine_default_dynaexq_tokens_match_reference(monkeypatch):
    """``make_backend("dynaexq")`` at the defaults of both packages (the
    global cross-layer allocator) publishes the same hi sets and serves
    the same tokens under the margin rule."""
    cfg, je, te = _default_engines(jget_config(ARCH, reduced=True),
                                   get_config(ARCH, reduced=True), "dynaexq")
    assert je.backend.allocator is not None
    assert te.backend.allocator is not None
    _warm_and_freeze(cfg, je, te)
    _check_served("dynaexq", te, _serve_lockstep(cfg, je, te, monkeypatch))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_per_layer_dynaexq_tokens_match_reference(paged, monkeypatch):
    """``global_alloc=False`` in both packages, the paper's per-layer top-n
    rule (the pinned tests above hold the port's global default against
    the reference's per-layer rule): equal hi sets and ``device_bytes()``,
    and the same tokens under the margin rule, on both paths."""
    cfg, je, te = _default_engines(
        jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True),
        "dynaexq", paged=paged, lo_bits=4, n_hi_per_layer=2,
        global_alloc=False)
    assert je.backend.allocator is None and te.backend.allocator is None
    for pos, bank in te.backend.banks.items():
        assert tuple(bank.slot_owner.shape) == \
            tuple(je.backend.banks[pos].slot_owner.shape)
    _warm_and_freeze(cfg, je, te)
    assert te.backend.device_bytes() == je.backend.device_bytes()
    _check_served("dynaexq", te, _serve_lockstep(cfg, je, te, monkeypatch,
                                                 paged=paged))
    assert (te.pool is None) == (not paged)
