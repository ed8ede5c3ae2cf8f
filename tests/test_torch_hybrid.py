"""The hybrid Mamba/attention MoE family (Jamba-v0.1, reduced: one
super-block of 8 layers, d 256, 4 experts top-2, window 64) through the
port's model and engine, against the reference's, on weights built by
``repro.models.init_params`` and carried over by ``convert``: tokens at
temperature 0 under the engine suite's margin rule (drop-free: at 4
experts top-2 the capacity covers every token; dynaexq's policy frozen),
on the paged pool with ragged dispatch and on dense rows with padded
dispatch, with all four backends; preemption; conversion of the tree."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import OffloadConfig as JOffloadConfig
from repro.serving import make_backend as jmake_backend
from repro.serving.requests import make_prompts
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.models import model as tmodel
from repro_torch.serving.backends import OffloadConfig, make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request

from test_torch_engine import _check_served, _serve_lockstep
from torch_threads import _one_thread  # noqa: F401

ARCH = "jamba-v0_1-52b"
#: Decode logits of the two engines on this 8-layer stack (seven of them
#: bf16 SSD layers) agree to this. Each layer alone agrees to about one
#: bf16 ulp (tests/test_torch_ssm.py), and the stack amplifies such ulps:
#: the reference against itself, with 1-ulp changes in 0.02% of its bf16
#: weights, moves its decode logits (magnitude ~1–4) by ~0.08, where the
#: two-layer granite stack of test_torch_engine moves by a few hundredths.
#: Tokens may first differ only at a reference top-1/top-2 margin below
#: 4x this (the engine suite's rule).
LOGIT_TOL = 0.25


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_config(ARCH, reduced=True), \
        jax.tree_util.tree_map(np.asarray, jp)


def _backends(name):
    if name == "dynaexq":
        return (jmake_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                              global_alloc=False,
                              controller=JControllerConfig(
                                  update_interval_s=0.0)),
                make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                             global_alloc=False,
                             controller=ControllerConfig(
                                 update_interval_s=0.0), device="cpu"))
    if name == "offload":
        return (jmake_backend("offload", ocfg=JOffloadConfig(
                    cache_experts_per_layer=2, pcie_gbps=16.0)),
                make_backend("offload", ocfg=OffloadConfig(
                    cache_experts_per_layer=2, pcie_gbps=16.0),
                    device="cpu"))
    if name == "static":
        return (jmake_backend("static", lo_bits=4),
                make_backend("static", lo_bits=4, device="cpu"))
    return jmake_backend(name), make_backend(name, device="cpu")


def _engines(weights, name, paged=True, **ekw):
    jcfg, cfg, jp_np = weights
    jp = jax.tree_util.tree_map(jax.numpy.asarray, jp_np)
    tp = params_from_reference(jp_np)
    jbe, tbe = _backends(name)
    ecfg = dict(max_slots=2, max_len=96, paged=paged,
                moe_dispatch="ragged" if paged else "padded", **ekw)
    je = JInferenceEngine(jcfg, jp, jbe, JEngineConfig(prefix_sharing=False,
                                                       **ecfg))
    te = InferenceEngine(cfg, tp, tbe, EngineConfig(**ecfg), device="cpu")
    return cfg, je, te


def test_convert_carries_every_leaf(weights):
    """The reference's Jamba tree (Mamba leaves with float32 A_log /
    dt_bias / D, dense ``mlp`` leaves, MoE leaves) → the port's, every
    leaf's dtype, shape and bits; the port's own ``init_params`` builds
    the same tree."""
    jcfg, cfg, jp = weights
    tp = params_from_reference(jp)
    own = tmodel.init_params(cfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    ol = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert set(tl) == set(ol) == {k for k, _ in jl}
    names = {jax.tree_util.keystr(k) for k, _ in jl}
    assert "['blocks']['0']['mamba']['A_log']" in names
    assert "['blocks']['2']['mlp']['w_down']" in names
    assert "['blocks']['7']['moe']['experts']['w_up']" in names
    for k, a in jl:
        t = tl[k]
        assert tuple(t.shape) == a.shape == tuple(ol[k].shape), k
        assert str(t.dtype).split(".")[-1] == a.dtype.name == \
            str(ol[k].dtype).split(".")[-1], k
        back = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(back, raw), k


def _spec_engine(cfg, jp, paged, spec_k):
    """The port's engine on the reduced Jamba with dynaexq (int4 lo, two
    hi experts per layer published from given counts, the policy frozen):
    drafts on the all-lo view then differ from the served banks often
    enough that rounds both accept and reject."""
    be = make_backend("dynaexq", lo_bits=4, n_hi_per_layer=2,
                      global_alloc=False,
                      controller=ControllerConfig(update_interval_s=1e9),
                      device="cpu")
    eng = InferenceEngine(cfg, params_from_reference(jp), be, EngineConfig(
        max_slots=2, max_len=96, paged=paged, spec_k=spec_k,
        moe_dispatch="ragged" if paged else "padded"), device="cpu")
    rng = np.random.default_rng(3)
    be.observe({str(p): rng.integers(0, 6, (cfg.n_superblocks(),
                                            cfg.moe.num_experts))
                for p in cfg.moe_positions}, 0.0)
    be.force_update()
    be.flush()
    return eng


def test_check_family_and_spec_on_mamba_stacks(weights):
    """``_check_family`` takes the hybrid stack and a pure SSM stack of its
    Mamba positions; a stack labelled with the ``audio`` or ``vlm``
    family (the encoder-decoder and VLM ones) builds as well.
    Speculative decoding on the reduced Jamba (the reference suite's
    ``test_spec_token_identity_jamba_mixed_stack``, with few steps): at
    ``spec_k`` 3 the engine emits the tokens of ``spec_k`` 0 on both
    layouts, over rounds that accept some drafts and reject others (each
    row's Mamba state rolls back to its last accepted step; the second
    request decodes past the wrap of the 64-slot window ring, whose lanes
    the draft overwrites and the round restores); and a round leaves the
    Mamba rows of an occupied row outside it bit for bit."""
    jcfg, cfg, jp = weights
    tmodel.init_params(dataclasses.replace(
        cfg, family="ssm", superblock=("mamba",), moe=None, moe_positions=(),
        attn=None, d_ff=0), device="cpu")
    for fam in ("audio", "vlm"):
        p = tmodel.init_params(dataclasses.replace(cfg, family=fam),
                               device="cpu")
        assert set(p["blocks"]) == {str(i) for i in range(8)}
    prompts = [make_prompts("text", cfg.vocab_size, 1, n, seed=n)[0]
               for n in (5, 60)]
    for paged in (True, False):
        runs = []
        for k in (0, 3):
            eng = _spec_engine(cfg, jp, paged, k)
            hs = [eng.submit(Request(tokens=p, max_new_tokens=n))
                  for p, n in zip(prompts, (16, 14))]
            eng.drain()
            runs.append(([h.tokens for h in hs], eng.stats()))
        (plain, _), (spec, st) = runs
        assert spec == plain
        assert st["spec_rounds"] > 0 and 0.0 < st["accept_rate"] < 1.0
    # Rounds over row 1 alone once it decodes past the ring's wrap, until
    # one rejects a draft: each leaves row 0's Mamba rows unchanged, and of
    # row 1's ring only the slots of the positions it accepted change (the
    # lanes the draft and the rejected verify steps wrote are restored).
    eng = _spec_engine(cfg, jp, True, 3)
    hs = [eng.submit(Request(tokens=p, max_new_tokens=24)) for p in prompts]
    h0, h1 = hs
    eng.step()
    while eng.pos[h1.slot] < 64:
        eng.step()
    ring = eng.caches[eng._attn_pos[0]]
    bt, C = eng._bt, eng._C_pad
    spec, rejected = eng._spec, False
    while not rejected:
        before = {p: [t.clone() for t in eng.caches[p]]
                  for p in eng._mamba_pos}
        blocks = torch.as_tensor(h1.lease.table).long()
        kv0 = [t[:, blocks].clone() for t in ring]
        p0, n0 = int(eng.pos[h1.slot]), spec.draft_total - spec.accepted_total
        assert spec.round([(h1.slot, h1)], [])
        p1 = int(eng.pos[h1.slot])
        rejected = spec.draft_total - spec.accepted_total > n0
        for p in eng._mamba_pos:
            for t, b in zip(eng.caches[p], before[p]):
                assert torch.equal(t[:, h0.slot], b[:, h0.slot])
                assert not torch.equal(t[:, h1.slot], b[:, h1.slot])
        kept = torch.ones((len(blocks), bt), dtype=torch.bool)
        for q in range(p0, p1):
            kept[(q % C) // bt, (q % C) % bt] = False
        for t, b in zip(ring, kv0):
            assert torch.equal(t[:, blocks].transpose(2, 3)[:, kept],
                               b.transpose(2, 3)[:, kept])


def test_rollback_select_matches_reference():
    """``serving.spec.select_rows`` against the reference's
    ``_select_ssm`` on the same stacked rows (S, nsb, B, ...): each row's
    state after its accepted step, bit for bit."""
    from repro.serving.spec import _select_ssm
    from repro_torch.models.ssm import MambaCache
    from repro_torch.serving.spec import select_rows
    rng = np.random.default_rng(5)
    S, nsb, B = 4, 2, 3
    conv = rng.standard_normal((S, nsb, B, 4, 24)).astype(np.float32)
    state = rng.standard_normal((S, nsb, B, 3, 8, 16)).astype(np.float32)
    sel = np.array([2, 0, 3])
    want = _select_ssm({"1": {"conv": jax.numpy.asarray(
        conv, jax.numpy.bfloat16), "state": jax.numpy.asarray(state)}},
        jax.numpy.asarray(sel))["1"]
    got = select_rows({"1": MambaCache(torch.from_numpy(conv).to(
        torch.bfloat16), torch.from_numpy(state))},
        torch.from_numpy(sel))["1"]
    assert tuple(got.conv.shape) == (nsb, B, 4, 24)
    np.testing.assert_array_equal(got.conv.float().numpy(),
                                  np.asarray(want["conv"], np.float32))
    np.testing.assert_array_equal(got.state.numpy(),
                                  np.asarray(want["state"]))


@pytest.mark.parametrize("name", ["static", "dynaexq", "fp16", "offload"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_hybrid_engine_tokens_match_reference(weights, name, paged,
                                              monkeypatch):
    """The reference suite's engine parity (``test_paged_engine`` and
    ``test_ragged_dispatch`` on Jamba): both engines serve the same
    prompts step by step; tokens and decode logits agree under the margin
    rule. The engine runs the pool over the attention position only, no
    trie, SSD-chunk buckets; the reference's own KV and device bytes."""
    cfg, je, te = _engines(weights, name, paged=paged)
    assert te.buckets == tuple(je.buckets) == (32, 64, 96)
    assert te.trie is None
    assert te.backend.device_bytes() == je.backend.device_bytes()
    if paged:
        assert te.pool.block_bytes == je.pool.block_bytes
        assert set(te.caches) == set(je.caches.blocks)
    if name == "dynaexq":
        _freeze_same(cfg, je, te)
    results = _serve_lockstep(cfg, je, te, monkeypatch, paged=paged,
                              tol=LOGIT_TOL, past_routing=True)
    if name == "static":
        _check_served(name, te, results, tol=LOGIT_TOL)
        return
    held = 0
    for ref_toks, port_toks, stop, _ in results:
        upto = len(port_toks) if stop is None else stop[0]
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= 12
    st = te.stats()
    if name == "dynaexq":
        assert te.backend.hi_sets() == je.backend.hi_sets()
        assert st["promotions"] > 0 and te.backend.hi_routed > 0
    if name == "offload":
        # Its LRU accounting follows the routing (held to the reference's
        # on the same counts in test_torch_baselines).
        assert st["misses"] > 0


def _freeze_same(cfg, je, te):
    """The same published hi sets in both engines whatever their routing
    (near ties of the 8-layer stack tip either way): both controllers fed
    the same router counts, one forced policy window, flushed, then frozen
    (the reference suite's warm-and-freeze, on given counts)."""
    rng = np.random.default_rng(3)
    counts = {str(p): rng.integers(0, 6, (cfg.n_superblocks(),
                                          cfg.moe.num_experts))
              for p in cfg.moe_positions}
    for eng in (je, te):
        eng.backend.observe({k: v.copy() for k, v in counts.items()}, 0.0)
        eng.backend.force_update()
        eng.backend.flush()
        for ctl in eng.backend.controllers.values():
            ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    assert je.backend.hi_sets() == te.backend.hi_sets()
    assert any(len(s) for sets in te.backend.hi_sets().values()
               for s in sets)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_hybrid_preemption_resumes_the_uninterrupted_run(weights, paged):
    """After ``test_preemption.py``: a request preempted mid-decode (its
    KV lanes or rows and its Mamba rows to the host) and resumed into
    another slot emits what it would have without the preemption, and the
    other request's state is untouched."""
    jcfg, cfg, jp = weights
    prompts = [make_prompts("code", cfg.vocab_size, 1, n, seed=11 + i)[0]
               for i, n in enumerate((23, 40))]

    def serve(preempt_at):
        eng = InferenceEngine(cfg, params_from_reference(jp),
                              make_backend("static", lo_bits=4,
                                           device="cpu"),
                              EngineConfig(max_slots=2, max_len=96,
                                           paged=paged,
                                           moe_dispatch="ragged" if paged
                                           else "padded"), device="cpu")
        hs = [eng.submit(Request(tokens=p, max_new_tokens=10))
              for p in prompts]
        steps = 0
        while eng.queue or any(eng.slots):
            eng.step()
            steps += 1
            if steps == preempt_at:
                snap_slot = hs[0].slot
                eng.preempt(hs[0])
                assert hs[0]._snapshot.mamba_rows is not None
                # The vacated slot is reused by the resume: scribble on
                # its rows first, so the resume must restore them.
                for p in eng._mamba_pos:
                    for t in eng.caches[p]:
                        t[:, snap_slot] = 1
        return [h.token_array().tolist() for h in hs], eng

    base, _ = serve(preempt_at=None)
    got, eng = serve(preempt_at=4)
    assert eng.counters["preemptions"] == 1 and eng.counters["resumes"] == 1
    assert got == base
