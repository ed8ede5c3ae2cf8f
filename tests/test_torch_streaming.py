"""The streaming cold start of the port on the CPU, against the reference's
(the cases of the reference's ``tests/test_hierarchy.py`` on expert
shards, with the shard directory checked both ways):

* ``save_expert_shards`` of the port writes the reference's directory
  array for array (manifest, base leaves, prepacked lo rows, hi rows);
* a directory written by the reference serves in the port, and one
  written by the port serves in the reference, with the tokens of the
  materialized engine (frozen policy, greedy) and, warmed by the same
  traffic, the same hi sets;
* the cold-start gate (no forward before every lo cell is staged; the
  scheduler sheds meanwhile), the shard reads counted as the reference
  counts them, the hottest-first staging order under a restored prior;
* staging writes the bank in place: every bank tensor keeps its storage
  (the decode graph captured it).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JControllerConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import load_streaming_params as jload_streaming_params
from repro.serving import make_backend as jmake_backend
from repro.serving import save_expert_shards as jsave_expert_shards
from repro.serving.requests import make_prompts
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serving.streaming import ShardSource as JShardSource
from repro.serving.streaming import \
    hotness_stage_order as jhotness_stage_order
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.streaming import (ShardSource, hotness_stage_order,
                                           load_streaming_params,
                                           save_expert_shards)
from test_torch_engine import NEW_TOKENS, PROMPT_LENS, _serve_lockstep
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
FROZEN = dict(update_interval_s=1e9)
NEW = 6


def _clone(p):
    return {k: _clone(v) for k, v in p.items()} if isinstance(p, dict) \
        else p


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, serving_setup):
    """(reference cfg/params, port cfg/params, the directory the reference
    wrote, the directory the port wrote), from the same weights."""
    jcfg, jp = serving_setup
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    d_ref = str(tmp_path_factory.mktemp("shards_ref"))
    d_port = str(tmp_path_factory.mktemp("shards_port"))
    jsave_expert_shards(d_ref, jax.tree_util.tree_map(lambda x: x, jp), [0],
                        lo_bits=4)
    save_expert_shards(d_port, _clone(tp), [0], lo_bits=4)
    return jcfg, jp, get_config(ARCH, reduced=True), tp, d_ref, d_port


def _port(cfg, params, ecfg=None, **kw):
    kw.setdefault("lo_bits", 4)
    kw.setdefault("n_hi_per_layer", 2)
    kw.setdefault("controller", ControllerConfig(**FROZEN))
    return InferenceEngine(cfg, params, make_backend("dynaexq", device="cpu",
                                                     **kw),
                           EngineConfig(max_slots=2, max_len=48,
                                        **(ecfg or {})), device="cpu")


def _ref(jcfg, params, ecfg=None, **kw):
    kw.setdefault("lo_bits", 4)
    kw.setdefault("n_hi_per_layer", 2)
    kw.setdefault("controller", JControllerConfig(**FROZEN))
    return JInferenceEngine(jcfg, params, jmake_backend("dynaexq", **kw),
                            JEngineConfig(max_slots=2, max_len=48,
                                          **(ecfg or {})))


def _serve(eng, prompts, req=Request):
    hs = [eng.submit(req(tokens=p, max_new_tokens=NEW)) for p in prompts]
    eng.drain()
    return [list(h.tokens) for h in hs]


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_shard_directories_equal_array_for_array(dirs):
    _, _, _, _, d_ref, d_port = dirs
    assert _files(d_port) == _files(d_ref)
    for name in ("manifest.json",):
        with open(os.path.join(d_ref, name)) as a, \
                open(os.path.join(d_port, name)) as b:
            assert json.load(a) == json.load(b)
    n = 0
    for rel in _files(d_ref):
        pa, pb = os.path.join(d_ref, rel), os.path.join(d_port, rel)
        if rel.endswith(".npy"):
            a, b = np.load(pa), np.load(pb)
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
            n += 1
        elif rel.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, (rel, k)
                    np.testing.assert_array_equal(za[k], zb[k],
                                                  err_msg=f"{rel}:{k}")
            n += 1
    assert n == len(_files(d_ref)) - 1


@pytest.fixture(scope="module")
def served(dirs):
    """Greedy tokens, frozen policy: the port materialized, the port
    streamed from the reference's directory, the reference materialized
    and the reference streamed from the port's directory."""
    jcfg, jp, cfg, tp, d_ref, d_port = dirs
    prompts = make_prompts("text", cfg.vocab_size, 2, 16)
    out = {"port": _serve(_port(cfg, _clone(tp)), prompts)}
    eng = _port(cfg, load_streaming_params(d_ref, device="cpu"),
                stream=d_ref, stream_experts_per_tick=3)
    assert not eng.backend.serving_ready()
    out["port streamed"] = _serve(eng, prompts)
    assert eng.backend.serving_ready()
    out["port bank"] = eng.backend.banks["0"]
    out["port source"] = dict(eng.backend.stream.stats)
    out["ref"] = _serve(_ref(jcfg, jax.tree_util.tree_map(lambda x: x, jp)),
                        prompts, JRequest)
    je = _ref(jcfg, jload_streaming_params(d_port), stream=d_port,
              stream_experts_per_tick=3)
    assert not je.backend.serving_ready()
    out["ref streamed"] = _serve(je, prompts, JRequest)
    out["ref source"] = dict(je.backend.stream.stats)
    return out


def test_streaming_token_parity(served):
    """Streamed from the reference's shards, the port emits the tokens its
    materialized engine does (the staged rows are ``build_bank``'s)."""
    assert served["port streamed"] == served["port"]
    assert all(len(t) == NEW for t in served["port"])


def test_port_shards_serve_in_the_reference(served):
    """The reference streamed from the port's shards emits its own
    materialized engine's tokens."""
    assert served["ref streamed"] == served["ref"]


def _check_lockstep(results):
    """The reference's tokens, each request up to its first router near
    tie or small-margin flip (``test_torch_engine``'s rule), and at least
    half of all tokens compared."""
    held = 0
    for ref_toks, port_toks, stop, _ in results:
        assert len(port_toks) == NEW_TOKENS
        upto = NEW_TOKENS if stop is None else stop[0]
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= NEW_TOKENS * len(PROMPT_LENS) // 2, results


def _streamed_pair(dirs, warm=False):
    """The port streamed from the reference's shards and the reference
    streamed from the port's; ``warm``: both warmed by the same traffic,
    then frozen, with equal hi sets."""
    jcfg, _, cfg, _, d_ref, d_port = dirs
    te = _port(cfg, load_streaming_params(d_ref, device="cpu"),
               stream=d_ref, stream_experts_per_tick=3)
    je = _ref(jcfg, jload_streaming_params(d_port), stream=d_port,
              stream_experts_per_tick=3)
    if warm:
        counts = np.zeros((2, cfg.moe.num_experts))
        counts[0] = [40, 30, 20, 10]
        for be in (te.backend, je.backend):
            be.flush()
            be.controllers["0"].observe(counts)
            be.force_update()
            be.flush()
        assert te.backend.hi_sets() == je.backend.hi_sets()
    return cfg, je, te


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmed"])
def test_streamed_tokens_match_the_reference(dirs, warm, monkeypatch):
    """Both streamed, each from the other package's shards: the port's
    tokens are the reference's under the margin rule of the engine tests
    (the two packages' logits differ by a few hundredths)."""
    cfg, je, te = _streamed_pair(dirs, warm)
    _check_lockstep(_serve_lockstep(cfg, je, te, monkeypatch))
    assert te.backend.stream.stats == je.backend.stream.stats


def test_shard_reads_counted_as_the_reference(served):
    """The same cold start reads the same lo shards and bytes before
    serving opens, and no hi shard (frozen policy: no promotion)."""
    assert served["port source"] == served["ref source"]
    assert served["port source"]["hi_reads"] == 0
    assert served["port source"]["lo_reads"] == 2


def test_staged_rows_equal_build_bank(dirs, served):
    _, _, cfg, tp, _, _ = dirs
    want = _port(cfg, _clone(tp)).backend.banks["0"]
    for n, q in served["port bank"].lo.items():
        assert torch.equal(q.packed, want.lo[n].packed)
        assert torch.equal(q.scales, want.lo[n].scales)


def test_streaming_warmed_parity(dirs):
    """With the same traffic, the streamed and materialized engines of the
    port reach the reference's hi sets and the same tokens; the hi rows a
    promotion reads from the shards (float32 on disk) are the bf16
    masters exactly. (The reference's tokens: the lockstep test above.)"""
    jcfg, jp, cfg, tp, d_ref, d_port = dirs
    counts = np.zeros((2, cfg.moe.num_experts))
    counts[0] = [40, 30, 20, 10]
    prompts = make_prompts("text", cfg.vocab_size, 2, 16)
    outs, his = [], []
    engines = [
        (_port(cfg, _clone(tp)), Request),
        (_port(cfg, load_streaming_params(d_ref, device="cpu"),
               stream=d_ref), Request),
        (_ref(jcfg, jload_streaming_params(d_port), stream=d_port),
         JRequest)]
    for eng, req in engines:
        be = eng.backend
        be.flush()                       # finish the cold-start pump
        be.controllers["0"].observe(counts)
        be.force_update()
        be.flush()
        his.append(be.hi_sets())
        outs.append(_serve(eng, prompts, req))
    assert his[0] == his[1] == his[2]
    assert sum(len(s) for s in his[1]["0"]) == 4
    assert outs[0] == outs[1]
    streamed = engines[1][0].backend
    assert streamed.stats()["hi_loads"] == 4
    for name, host in streamed.stores["0"].items():
        # Host hi rows exist only for the experts a promotion loaded.
        assert len(host.rows) == 4
        for l, hs in enumerate(his[1]["0"]):
            for e in hs:
                assert torch.equal(host[l, e],
                                   tp["blocks"]["0"]["moe"]["experts"]
                                   [name][l, e])


def test_cold_start_gating(dirs):
    """While streaming, the engine queues but never runs a forward;
    readiness grows monotonically; queued work drains once the lo tier is
    complete; every bank tensor keeps its storage."""
    _, _, cfg, _, d_ref, _ = dirs
    eng = _port(cfg, load_streaming_params(d_ref, device="cpu"),
                stream=d_ref, stream_experts_per_tick=2)
    be = eng.backend
    bank = be.banks["0"]
    tensors = [q.packed for q in bank.lo.values()] + \
        [q.scales for q in bank.lo.values()] + list(bank.hi.values()) + \
        [bank.slot_owner, bank.slot_map]
    ptrs = [t.data_ptr() for t in tensors]
    lo_view = [q.packed.data_ptr() for q in eng.lo_banks["0"].lo.values()]
    assert eng.load_snapshot()["residency_ready_frac"] == 0.0
    h = eng.submit(Request(tokens=make_prompts("text", cfg.vocab_size, 1,
                                               8)[0], max_new_tokens=4))
    last, steps = 0.0, 0
    while not be.serving_ready():
        assert all(s is None for s in eng.slots)
        assert eng.step() == []
        assert eng.counters["prefills"] == 0
        frac = be.ready_frac()
        assert frac >= last
        last = frac
        steps += 1
        assert steps < 100
    assert steps == 4                     # 8 cells, 2 per window
    for store in be.stores.values():
        store.check_invariants()
        assert store.lo_complete
    assert eng.load_snapshot()["residency_ready_frac"] == 1.0
    eng.drain()
    assert len(h.tokens) == 4
    assert be.stats()["residency_ready_frac"] == 1.0
    be.force_update()
    be.flush()
    assert [t.data_ptr() for t in tensors] == ptrs
    assert [q.packed.data_ptr() for q in eng.lo_banks["0"].lo.values()] \
        == lo_view == ptrs[:len(lo_view)]


def test_scheduler_downgrades_during_cold_start(dirs):
    """With ``shed_min_ready_frac``, a request submitted during a cold
    start is downgraded to the batch tier in both packages."""
    jcfg, _, cfg, _, d_ref, _ = dirs
    prompt = make_prompts("text", cfg.vocab_size, 1, 8)[0]
    got = []
    for eng, req in (
            (_port(cfg, load_streaming_params(d_ref, device="cpu"),
                   ecfg=dict(scheduler=SchedulerConfig(
                       shed_policy="downgrade", shed_min_ready_frac=0.9)),
                   stream=d_ref), Request),
            (_ref(jcfg, jload_streaming_params(d_ref),
                  ecfg=dict(scheduler=JSchedulerConfig(
                      shed_policy="downgrade", shed_min_ready_frac=0.9)),
                  stream=d_ref), JRequest)):
        h = eng.submit(req(tokens=prompt, max_new_tokens=2))
        eng.drain()
        late = eng.submit(req(tokens=prompt, max_new_tokens=2))
        eng.drain()
        got.append((h.exec_qos, late.exec_qos, eng.counters["downgraded"],
                    list(h.tokens) == list(late.tokens)))
    assert got[0] == got[1] == ("batch", "standard", 1, True)


def test_stage_order_and_restored_prior(dirs, tmp_path):
    """``hotness_stage_order`` is the reference's; a cold start with a
    saved hotness prior stages hottest-first, in the reference's order."""
    rng = np.random.default_rng(0)
    for scores in (None, np.zeros((2, 4)), rng.random((2, 4)),
                   rng.integers(0, 3, (2, 4)).astype(float)):
        assert hotness_stage_order(scores, 2, 4) == \
            jhotness_stage_order(scores, 2, 4)
    jcfg, _, cfg, _, d_ref, _ = dirs
    prefix = str(tmp_path / "hot")
    warm = _port(cfg, load_streaming_params(d_ref, device="cpu"),
                 stream=d_ref, hotness_path=prefix)
    counts = np.zeros((2, 4))
    counts[1, 2], counts[0, 3] = 50, 7
    warm.backend.flush()
    warm.backend.controllers["0"].observe(counts)
    warm.backend.controllers["0"].hotness.fold()
    warm.backend.save_hotness()
    port = _port(cfg, load_streaming_params(d_ref, device="cpu"),
                 stream=d_ref, hotness_path=prefix).backend
    ref = _ref(jcfg, jload_streaming_params(d_ref), stream=d_ref,
               hotness_path=prefix).backend
    assert list(port._pump_queue) == list(ref._pump_queue)
    assert list(port._pump_queue)[:2] == [("0", 1, 2), ("0", 0, 3)]


def test_load_dense_experts(dirs):
    """The no-streaming baseline reads every hi shard: the bf16 experts
    exactly, and the reference's byte count."""
    _, _, _, tp, d_ref, d_port = dirs
    src, jsrc = ShardSource(d_port), JShardSource(d_ref)
    dense = src.load_dense_experts("0", device="cpu")
    jsrc.load_dense_experts("0")
    for n, t in dense.items():
        assert torch.equal(t, tp["blocks"]["0"]["moe"]["experts"][n])
    assert src.stats == jsrc.stats
    assert src.stats["hi_reads"] == 8
