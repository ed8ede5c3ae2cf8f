"""Every decoder-only family the reference serves beyond the MoE and
hybrid stacks, through the port's model and engine against the
reference's, on weights built by ``repro.models.init_params`` and carried
over by ``convert``: the dense attention stacks (Llama-3.2-3B,
DeepSeek-7B's MHA, Phi-4-mini, H2O-Danube3-4B's 64-slot window ring in the
reduced configuration, decoded past its wrap) and the pure SSM stack
Mamba2-130m (no attention, no FFN, tied embeddings). Greedy tokens at
temperature 0 equal the reference engine's on both KV layouts; the
backends behave as the reference's do on a stack without MoE (the
offload baseline raises the reference's kind of error); speculative
decoding on Mamba2 emits the plain tokens; the launcher serves a dense
family and Mamba2; an observed dense engine traces as the reference's.

Tokens are compared step by step under the engine suite's margin rule
(``test_torch_engine._serve_lockstep``): every decode step's logits agree
to ``LOGIT_TOL``, and a request's tokens may first differ only at a step
whose reference top-1/top-2 margin is below 4x that."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.obs import ObsConfig as JObsConfig
from repro.obs import Observability as JObservability
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro.serving.requests import make_prompts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.launch.roofline import predict_moe_bytes_per_token
from repro_torch.models import model as tmodel
from repro_torch.obs import ObsConfig, Observability, costmodel
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request
from test_torch_engine import _serve_lockstep
from torch_threads import _one_thread  # noqa: F401

FAMILIES = ("llama3_2-3b", "deepseek-7b", "phi4-mini-3.8b",
            "h2o-danube-3-4b", "mamba2-130m")
#: Prompt lengths: the third Danube prompt and its new tokens run past the
#: reduced window's 64-slot ring.
PROMPTS = {"h2o-danube-3-4b": (5, 19, 60)}
NEW_TOKENS = 10
#: Decode logits of the two engines on these two-layer dense stacks agree
#: to this (bf16 projections and logits rounded in each library's order;
#: the same bound as the granite engine suite).
LOGIT_TOL = 0.05
_WEIGHTS = {}


def _weights(arch):
    """(reference config, port config, reference params as numpy), built
    once per module and family."""
    if arch not in _WEIGHTS:
        jcfg = jget_config(arch, reduced=True)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS[arch] = (jcfg, get_config(arch, reduced=True),
                          jax.tree_util.tree_map(np.asarray, jp))
    return _WEIGHTS[arch]


def _prompts(arch, vocab):
    return [make_prompts("text", vocab, 1, n, seed=n)[0]
            for n in PROMPTS.get(arch, (5, 19, 40))]


def _ecfg(paged, **kw):
    return dict(max_slots=2, max_len=96, paged=paged, **kw)


def _serve(eng, req, prompts):
    hs = [eng.submit(req(tokens=p, max_new_tokens=NEW_TOKENS))
          for p in prompts]
    eng.drain()
    return [list(map(int, h.tokens)) for h in hs]


def _reference(arch, paged, backend="fp16"):
    jcfg, cfg, jp = _weights(arch)
    return JInferenceEngine(jcfg, jax.tree_util.tree_map(jax.numpy.asarray,
                                                         jp),
                            jmake_backend(backend),
                            JEngineConfig(prefix_sharing=False,
                                          **_ecfg(paged)))


def _port(arch, paged, backend="fp16", **ekw):
    _, cfg, jp = _weights(arch)
    return InferenceEngine(cfg, params_from_reference(jp),
                           make_backend(backend, device="cpu"),
                           EngineConfig(**_ecfg(paged, **ekw)),
                           device="cpu")


def _lockstep(arch, paged, backend, monkeypatch):
    """Both engines over the family's prompts, step by step: returns the
    engines after asserting the margin rule, with most tokens held."""
    je, te = _reference(arch, paged, backend), _port(arch, paged, backend)
    results = _serve_lockstep(te.cfg, je, te, monkeypatch, paged=te.pool
                              is not None, tol=LOGIT_TOL,
                              prompts=_prompts(arch, te.cfg.vocab_size),
                              new_tokens=NEW_TOKENS)
    held = 0
    for ref_toks, port_toks, stop, _ in results:
        assert len(port_toks) == NEW_TOKENS
        upto = NEW_TOKENS if stop is None else stop[0]
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= 2 * NEW_TOKENS, results
    return je, te


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_carries_every_leaf(arch):
    """The reference's tree of each family (no ``moe``; no ``lm_head``
    under tied embeddings; no ``attn`` and no ``mlp`` on Mamba2) → the
    port's, every leaf's dtype, shape and bits; the port's own
    ``init_params`` builds the same tree."""
    jcfg, cfg, jp = _weights(arch)
    tp = params_from_reference(jp)
    own = tmodel.init_params(cfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    ol = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert set(tl) == set(ol) == {k for k, _ in jl}
    names = {jax.tree_util.keystr(k) for k, _ in jl}
    assert not any("['moe']" in n for n in names)
    assert ("['lm_head']" in names) == (not cfg.tie_embeddings)
    if arch == "mamba2-130m":
        assert not any("['mlp']" in n or "['attn']" in n for n in names)
    else:
        assert "['blocks']['0']['mlp']['w_gate']" in names
    for k, a in jl:
        t = tl[k]
        assert tuple(t.shape) == a.shape == tuple(ol[k].shape), k
        assert str(t.dtype).split(".")[-1] == a.dtype.name == \
            str(ol[k].dtype).split(".")[-1], k
        back = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(back, raw), k


def test_registry_and_family_check():
    """The registry holds all eleven configurations of the reference's
    (the encoder-decoder and VLM ones too), with the reference's fields
    and aliases; ``_check_family`` takes ``dense`` and ``ssm``, and the
    ``audio`` and ``vlm`` families now build."""
    assert set(ARCH_IDS) == set(FAMILIES) | {
        "qwen3-moe-30b-a3b", "qwen3-moe-80b-a3b", "granite-moe-1b-a400m",
        "jamba-v0_1-52b", "whisper-tiny", "llava-next-34b"}
    assert set(ARCH_IDS) == set(JARCH_IDS)
    for name in ARCH_IDS + ("llama3.2-3b", "phi4-mini-3_8b",
                            "jamba-v0.1-52b"):
        for reduced in (False, True):
            want = jget_config(name, reduced=reduced)
            got = get_config(name, reduced=reduced)
            for f in dataclasses.fields(got):
                w = getattr(want, f.name)
                g = getattr(got, f.name)
                assert (dataclasses.asdict(g) if dataclasses.is_dataclass(g)
                        else g) == (dataclasses.asdict(w)
                                    if dataclasses.is_dataclass(w) else w), \
                    (name, reduced, f.name)
            assert got.param_count() == want.param_count(), name
    for arch in FAMILIES:
        tmodel._check_family(get_config(arch))
    cfg = get_config("llama3_2-3b", reduced=True)
    for fam, arch in (("audio", "whisper-tiny"), ("vlm", "llava-next-34b")):
        tmodel._check_family(get_config(arch))
        p = tmodel.init_params(get_config(arch, reduced=True), device="cpu")
        assert ("encoder" in p) == (fam == "audio")
        tmodel.init_params(dataclasses.replace(cfg, family=fam),
                           device="cpu")


@pytest.mark.parametrize("arch,paged", [
    ("llama3_2-3b", True), ("llama3_2-3b", False),
    ("h2o-danube-3-4b", True), ("h2o-danube-3-4b", False),
    ("mamba2-130m", False), ("mamba2-130m", True),
    ("deepseek-7b", True), ("phi4-mini-3.8b", True)],
    ids=lambda v: {True: "paged", False: "dense"}.get(v, v))
def test_family_engine_tokens_match_reference(arch, paged, monkeypatch):
    """fp16 through both engines, three prompts over two slots: the same
    greedy tokens under the margin rule. Mamba2 under ``paged=True``
    builds no pool (nothing to page) in either engine and serves on dense
    rows; KV bytes follow the attention positions only."""
    je, te = _lockstep(arch, paged, "fp16", monkeypatch)
    assert (te.pool is None) == (je.pool is None) == \
        (not paged or arch == "mamba2-130m")
    if te.pool is not None:
        assert te.pool.block_bytes == je.pool.block_bytes
        assert te.pool.capacity_bytes == je.pool.capacity_bytes
    assert te.backend.device_bytes() == je.backend.device_bytes() == 0
    st = te.stats()
    assert st["finished"] == 3 and st["active_experts"] == 0.0


@pytest.mark.parametrize("backend", ["static", "dynaexq", "offload"])
def test_backends_on_a_dense_stack(backend, monkeypatch):
    """``static`` and ``dynaexq`` on a stack without MoE position serve as
    the reference's do (the same tokens under the margin rule, 0 resident
    expert bytes, every expert counter 0); ``offload`` raises where the
    reference's raises, the same kind of error."""
    arch = "llama3_2-3b"
    if backend == "offload":
        jcfg, cfg, jp = _weights(arch)
        with pytest.raises(AttributeError):
            JInferenceEngine(jcfg, jax.tree_util.tree_map(
                jax.numpy.asarray, jp), jmake_backend("offload"),
                JEngineConfig(**_ecfg(False)))
        with pytest.raises(AttributeError):
            _port(arch, False, "offload")
        return
    je, te = _lockstep(arch, False, backend, monkeypatch)
    assert te.backend.device_bytes() == je.backend.device_bytes() == 0
    jst, st = je.stats(), te.stats()
    for k in ("promotions", "demotions", "bytes_moved", "active_experts",
              "dispatch_pad_ratio", "finished", "prefill_tokens"):
        assert st[k] == jst[k], k


def test_mamba2_spec_tokens_equal_plain():
    """Speculative decoding on the pure SSM stack (the port's counterpart
    of the reference's ``test_spec_token_identity_greedy[mamba2-130m]``):
    ``spec_k`` 4 on dense rows emits the tokens of ``spec_k`` 0, over
    rounds that ran."""
    arch = "mamba2-130m"
    _, cfg, _ = _weights(arch)
    runs = []
    for k in (0, 4):
        eng = _port(arch, False, spec_k=k)
        runs.append((_serve(eng, Request, _prompts(arch, cfg.vocab_size)),
                     eng.stats()))
    (plain, _), (spec, st) = runs
    assert spec == plain
    assert st["spec_rounds"] > 0 and st["draft_tokens"] > 0


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-130m"])
def test_launcher_serves_the_family(arch):
    """``python -m repro_torch.launch.serve --arch ...`` on the CPU: every
    request served, speculative decoding at its default depth, 0 active
    experts and 0 resident expert bytes on a stack without MoE, and the
    observability line over the trace."""
    out = serve.main(["--arch", arch, "--backend", "fp16", "--batch", "2",
                      "--prompt-len", "16", "--new-tokens", "4",
                      "--device", "cpu"])
    assert [len(t) for t in out["tokens"]] == [4, 4]
    assert out["device_bytes"] == 0
    lines = out["lines"]
    assert any("active_experts 0.0/0" in line for line in lines)
    assert any(line.startswith("[serve] spec: ") for line in lines)
    assert any(line.startswith("[serve] obs: ") for line in lines)


def test_observed_dense_engine_traces_as_the_reference():
    """With a flight recorder on, both engines trace a dense stack's
    forwards alike: one ``moe_forward`` event per forward with nothing
    routed, the same metadata (no experts), the same cost-model report, and
    a roofline model that predicts 0 expert bytes per token."""
    arch = "llama3_2-3b"
    jcfg, cfg, jp = _weights(arch)
    jobs, tobs = JObservability(JObsConfig()), Observability(ObsConfig())
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(jax.numpy.asarray,
                                                       jp),
                          jmake_backend("fp16"),
                          JEngineConfig(prefix_sharing=False,
                                        **_ecfg(True, moe_dispatch="ragged")),
                          obs=jobs)
    te = InferenceEngine(cfg, params_from_reference(jp),
                         make_backend("fp16", device="cpu"),
                         EngineConfig(**_ecfg(True, moe_dispatch="ragged")),
                         device="cpu", obs=tobs)
    prompts = _prompts(arch, cfg.vocab_size)
    assert _serve(te, Request, prompts) == _serve(je, JRequest, prompts)
    jev = [e.args for e in jobs.tracer.instants("moe_forward")]
    tev = [e.args for e in tobs.tracer.instants("moe_forward")]
    assert tev == jev and len(tev) > NEW_TOKENS
    assert all(a["routed"] == 0 and a["layers"] == 0 for a in tev)
    keys = costmodel.META_KEYS
    assert {k: tobs.tracer.meta[k] for k in keys} == \
        {k: jobs.tracer.meta[k] for k in keys}
    assert tobs.tracer.meta["num_experts"] == 0
    from repro.obs import costmodel as jcostmodel
    assert costmodel.report(tobs.tracer)["roofline"] == \
        jcostmodel.report(jobs.tracer)["roofline"]
    meta = tobs.tracer.meta
    assert predict_moe_bytes_per_token(
        8, 0, meta["num_experts"], meta["top_k"], meta["lo_bytes"],
        meta["hi_bytes"]) == 0.0
    jobs.close()
    tobs.close()
