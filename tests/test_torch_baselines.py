"""The paper's baselines in the port, against the reference: the ``fp16``
(dense bf16 experts on the device) and ``offload`` (an LRU expert cache in
front of host memory, its transfers priced as a modeled stall) backends,
served through ``InferenceEngine`` on both paths; the offload accounting
fed the same router counts; the engine's stall clock; and the ragged
dispatch's weight bytes per token on the reference's kernel benchmark
setup."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serving.engine as jengine
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import OffloadConfig as JOffloadConfig
from repro.serving import Request as JRequest
from repro.serving import make_backend as jmake_backend
from repro.serving.backends import LRUSet as JLRUSet
from repro.serving.requests import make_prompts
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, to_torch
from repro_torch.models.model import init_params
import repro_torch.serving.engine as tengine
from repro_torch.serving.backends import (BACKENDS, STAT_KEYS, LRUSet,
                                          OffloadConfig, make_backend)
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request

from test_torch_engine import _check_served, _serve_lockstep
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
#: The offload cache in the engine tests: 2 of the reduced model's 4
#: experts per layer, so decode steps both hit and miss.
CACHE = 2


def _backends(name, gbps=16.0, prefetch=True):
    """The same baseline in both packages (``offload``: ``CACHE`` experts
    per layer at ``gbps``)."""
    if name == "offload":
        return (jmake_backend("offload", ocfg=JOffloadConfig(
                    cache_experts_per_layer=CACHE, pcie_gbps=gbps,
                    prefetch=prefetch)),
                make_backend("offload", ocfg=OffloadConfig(
                    cache_experts_per_layer=CACHE, pcie_gbps=gbps,
                    prefetch=prefetch), device="cpu"))
    return jmake_backend(name), make_backend(name, device="cpu")


def _engines(name, paged=True, **kw):
    """Both engines on one set of weights, on the paged pool with ragged
    dispatch or (``paged=False``) dense rows with padded dispatch."""
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    jbe, tbe = _backends(name, **kw)
    ecfg = dict(max_slots=2, max_len=96, paged=paged,
                moe_dispatch="ragged" if paged else "padded")
    je = JInferenceEngine(jcfg, jp, jbe, JEngineConfig(prefix_sharing=False,
                                                       **ecfg))
    te = InferenceEngine(cfg, tp, tbe, EngineConfig(**ecfg), device="cpu")
    return cfg, je, te


@pytest.mark.parametrize("name", ["fp16", "offload"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_baseline_engine_tokens_match_reference(name, paged, monkeypatch):
    """The port's baselines serve the reference's greedy tokens (the
    engine suite's margin rule), with the reference's ``device_bytes()``,
    the backend's stats keys exactly ``STAT_KEYS + STAT_EXTRAS``, no
    quantized bank, and (offload) the same hits and misses."""
    cfg, je, te = _engines(name, paged=paged)
    assert te.banks is None and je.banks is None
    assert te.backend.device_bytes() == je.backend.device_bytes() > 0
    results = _serve_lockstep(cfg, je, te, monkeypatch, paged=paged)
    _check_served(name, te, results)
    extras = type(te.backend).STAT_EXTRAS
    assert extras == type(je.backend).STAT_EXTRAS
    assert set(te.backend.stats()) == set(STAT_KEYS + extras)
    if name == "offload":
        jst, tst = je.backend.stats(), te.backend.stats()
        assert tst["misses"] > 0 and tst["hits"] > 0
        if all(r[2] is None for r in results):   # routing identical
            for k in ("hits", "misses", "bytes_moved"):
                assert tst[k] == jst[k], k


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_every_backend_has_the_reference_stats_schema(name):
    from repro.serving.backends import BACKENDS as JBACKENDS
    assert sorted(BACKENDS) == sorted(JBACKENDS)
    jbe, tbe = jmake_backend(name), make_backend(name, device="cpu")
    assert type(tbe).STAT_EXTRAS == type(jbe).STAT_EXTRAS
    assert set(tbe.stats()) == set(jbe.stats())
    assert set(tbe.stats()) == set(STAT_KEYS + type(tbe).STAT_EXTRAS)


def _counts_sequence(rng, L, E, steps, R=None):
    """Router counts as the engine hands them over: (L, E), or
    row-resolved (L, R, E) with a row mask; a hot set that drifts, so the
    LRU both hits and evicts."""
    seq = []
    for s in range(steps):
        shape = (L, E) if R is None else (L, R, E)
        c = np.zeros(shape, np.int64)
        hot = (np.arange(4) + s // 3) % E
        for l in range(L):
            picks = np.concatenate([rng.choice(hot, 3),
                                    rng.integers(0, E, 2)])
            for e in picks:
                if R is None:
                    c[l, e] += int(rng.integers(1, 4))
                else:
                    c[l, int(rng.integers(0, R)), e] += 1
        valid = None if R is None else rng.random(R) < 0.7
        seq.append((c, float(rng.uniform(0.0, 2e-4)), valid))
    return seq


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch",
                                                         "no_prefetch"])
@pytest.mark.parametrize("rows", [None, 5], ids=["aggregate", "per_row"])
def test_offload_accounting_matches_reference(prefetch, rows):
    """The same router-count sequences and ``compute_s`` into both
    packages' ``OffloadBackend.observe``: every returned stall, the hits,
    misses, bytes moved, stall seconds and every layer's LRU order agree
    exactly."""
    jcfg = jget_config("qwen3-moe-30b-a3b").reduced(num_experts=16)
    cfg = get_config("qwen3-moe-30b-a3b").reduced(num_experts=16)
    ocfg = dict(cache_experts_per_layer=5, pcie_gbps=2.0, prefetch=prefetch)
    jbe = jmake_backend("offload", ocfg=JOffloadConfig(**ocfg))
    tbe = make_backend("offload", ocfg=OffloadConfig(**ocfg), device="cpu")
    assert jbe.materialize_banks(jcfg, {}, 0) is None
    assert tbe.materialize_banks(cfg, init_params(cfg, device="cpu"),
                                 0) is None
    assert tbe.device_bytes() == jbe.device_bytes()
    L, E = cfg.n_superblocks(), cfg.moe.num_experts
    rng = np.random.default_rng(17 + (rows or 0) + prefetch)
    stalls = 0
    for c, compute_s, valid in _counts_sequence(rng, L, E, 40, rows):
        for prefill in (False, True) if rows else (False,):
            js = jbe.observe({"0": c}, compute_s, prefill=prefill,
                             row_valid=valid)
            ts = tbe.observe({"0": c}, compute_s, prefill=prefill,
                             row_valid=valid)
            assert ts == js
            stalls += ts > 0
        for l in range(L):
            assert tbe.lru[l].order() == jbe.lru[l].order()
    jst, tst = jbe.stats(), tbe.stats()
    assert set(tst) == set(jst)
    for k in ("hits", "misses", "bytes_moved", "stall_s", "host_fetches",
              "ttft_s", "tpot_s"):
        assert tst[k] == jst[k], k
    assert tst["hits"] > 0 and tst["misses"] > 0 and stalls > 0
    for k in ("0",):
        np.testing.assert_array_equal(tbe.router_counts()[k],
                                      jbe.router_counts()[k])


def test_lru_set_matches_reference():
    rng = np.random.default_rng(4)
    a, b = JLRUSet(6, init=[3, 1, 3]), LRUSet(6, init=[3, 1, 3])
    for _ in range(500):
        e, op = int(rng.integers(0, 12)), int(rng.integers(0, 3))
        f = ("hit", "add", "touch")[op]
        assert getattr(a, f)(e) == getattr(b, f)(e)
        assert a.order() == b.order()
        assert len(a) == len(b) and (e in a) == (e in b)


class _FrozenTime:
    """The ``time`` module with a clock that never moves: measured
    compute is 0, so every latency is the modeled stall alone."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter():
        return 1000.0


def _record_stalls(backend):
    """Wrap ``backend.observe``: a list of (prefill, rows admitted, stall)
    per forward."""
    log, observe = [], backend.observe

    def recorded(counts, compute_s=0.0, prefill=False, row_valid=None):
        s = observe(counts, compute_s, prefill=prefill, row_valid=row_valid)
        log.append((prefill, int(np.sum(row_valid)), s))
        return s

    backend.observe = recorded
    return log


def _expected_latencies(log):
    """What the reference's accounting makes of a stall log when the clock
    stands still and every request was submitted before the first step:
    decode latencies = their stalls; a request's TTFT = the stall clock
    when its prefill observed (all stalls so far, its own included)."""
    clock, ttfts, decode = 0.0, [], []
    for prefill, rows, stall in log:
        clock += stall
        if prefill:
            ttfts += [clock] * rows
        else:
            decode.append(stall)
    return ttfts, decode


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_stall_clock_matches_reference(paged, monkeypatch):
    """A modeled stall (offload at 0.05 GB/s) enters the engine's latency
    as the reference's does. With the clock frozen every latency is stall
    alone, and both engines must show the same accounting of their own
    stalls: each decode step's latency (``decode_times``, each request's
    ``step_times``) is exactly its stall, TPOT their token-weighted mean,
    and each TTFT the stall clock's advance from submit to its prefill
    (the third request, admitted behind the first two, carries their
    stalls). Where both engines routed every step alike, their numbers
    are equal too."""
    monkeypatch.setattr(tengine, "time", _FrozenTime())
    monkeypatch.setattr(jengine, "time", _FrozenTime())
    cfg, je, te = _engines("offload", paged=paged, gbps=0.05)
    logs = [_record_stalls(je.backend), _record_stalls(te.backend)]
    prompts = [make_prompts("code", cfg.vocab_size, 1, n, seed=3 + i)[0]
               for i, n in enumerate((20, 13, 37))]
    jh = [je.submit(JRequest(tokens=p, max_new_tokens=6)) for p in prompts]
    th = [te.submit(Request(tokens=p, max_new_tokens=6)) for p in prompts]
    je.drain()
    te.drain()
    for eng, hs, log in ((je, jh, logs[0]), (te, th, logs[1])):
        ttfts, decode = _expected_latencies(log)
        assert len(log) > 4 and all(s > 0 for p, _, s in log if p)
        assert eng.decode_times == decode
        assert eng.ttfts == ttfts
        assert hs[2].ttft_s > hs[0].ttft_s > 0
        steps = [t for h in hs for t in h.step_times]
        assert all(len(h.step_times) == len(h.tokens) - 1 for h in hs)
        assert sorted(set(steps)) == sorted(set(decode))
        st = eng.stats()
        assert st["tpot_s"] == pytest.approx(np.mean(steps), rel=1e-12)
        assert st["ttft_s"] == pytest.approx(np.mean(ttfts), rel=1e-12)
        assert st["stall_s"] == pytest.approx(sum(s for _, _, s in log),
                                              rel=1e-12)
    same = all(np.array_equal(a.expert_counts[k], b.expert_counts[k])
               for a, b in zip(jh, th) for k in b.expert_counts)
    if same:
        assert te.decode_times == je.decode_times
        assert te.ttfts == je.ttfts


# ---------------------------------------------------------------------------
# Weight bytes per token of the ragged dispatch (the reference's
# benchmarks/kernels_bench.py setup and its recorded rows)
# ---------------------------------------------------------------------------

#: ``experiments/BENCH_kernels.json``'s ragged rows (3 smoke steps). They
#: were recorded with JAX's random bits of the time (before JAX 0.5 made
#: ``jax_threefry_partitionable`` the default): the setup and the inputs
#: are drawn under that setting again, which makes the reference itself
#: reproduce them (with today's default it reads 995,328 / 290,304 /
#: 105,856 B/token, and so does the port).
BENCH_RAGGED_BYTES = {1: 1_187_840, 8: 299_008, 32: 103_680}
BENCH_E, BENCH_K, BENCH_D, BENCH_F = 32, 2, 256, 512
BENCH_N_HI, BENCH_BITS, BENCH_GROUP, BENCH_STEPS = 4, 4, 64, 3


def _bytes_per_token(counts, slot_map, batch, lo_b, hi_b):
    """The ragged row of ``kernels_bench._bytes_per_token``: the weight
    bytes one decode step reads (each routed expert's resident tier: lo
    codes and scales, or its hi bf16 weights), per token."""
    is_hi = slot_map >= 0
    active = counts > 0
    total = int((active & ~is_hi).sum()) * lo_b + \
        int((active & is_hi).sum()) * hi_b
    return total / batch


@pytest.fixture(scope="module")
def bench_setup():
    """``kernels_bench._setup`` in the reference, converted: the router
    biased toward low expert ids, the 4 hottest experts published hi."""
    from repro.models.config import MoEConfig as JMoEConfig
    from repro.models.moe import init_moe
    from repro_torch.core.ver import (build_bank, expert_hi_nbytes,
                                      expert_lo_nbytes)
    from repro_torch.models.config import MoEConfig
    jcfg = JMoEConfig(num_experts=BENCH_E, top_k=BENCH_K,
                      d_ff_expert=BENCH_F, norm_topk_prob=True)
    with jax.threefry_partitionable(False):
        params = init_moe(jax.random.PRNGKey(0), BENCH_D, jcfg)
    bias = jnp.linspace(2.5, -2.5, BENCH_E)[None, :]
    params["router"] = params["router"] * 0.3 + bias
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    w = {n: a[None] for n, a in tp["experts"].items()}
    bank = build_bank(w, n_hi=BENCH_N_HI, lo_bits=BENCH_BITS,
                      group_size=BENCH_GROUP)
    for s in range(BENCH_N_HI):
        bank.slot_map[0, s] = s
        bank.slot_owner[0, s] = s
        for n in bank.hi:
            bank.hi[n][0, s] = w[n][0, s]
    shapes = {n: tuple(a.shape) for n, a in w.items()}
    cfg = MoEConfig(num_experts=BENCH_E, top_k=BENCH_K,
                    d_ff_expert=BENCH_F, norm_topk_prob=True)
    return (cfg, {"router": tp["router"]}, bank.layer(0),
            expert_lo_nbytes(shapes, BENCH_BITS, BENCH_GROUP),
            expert_hi_nbytes(shapes, hi_bits=16, group_size=BENCH_GROUP))


@pytest.mark.parametrize("batch", sorted(BENCH_RAGGED_BYTES))
def test_ragged_bytes_per_token_reproduce_the_benchmark(bench_setup, batch):
    """The port's ragged dispatch on the benchmark's setup and inputs (the
    smoke run's 3 steps of ``PRNGKey(7 + s)`` activations, made by JAX and
    converted through numpy) reads exactly the weight bytes per token that
    ``experiments/BENCH_kernels.json`` records."""
    from repro_torch.models.moe import moe_apply, moe_capacity
    cfg, router, bank, lo_b, hi_b = bench_setup
    cap = moe_capacity(batch, cfg, 2.0)
    slot_map = bank.slot_map.numpy()
    bpt = []
    for s in range(BENCH_STEPS):
        with jax.threefry_partitionable(False):
            x = jax.random.normal(jax.random.PRNGKey(7 + s),
                                  (batch, BENCH_D), jnp.bfloat16)
        _, aux = moe_apply(router, bank, to_torch(np.asarray(x)), cfg, cap,
                           dispatch="ragged")
        bpt.append(_bytes_per_token(aux.counts.numpy(), slot_map, batch,
                                    lo_b, hi_b))
    assert float(np.mean(bpt)) == BENCH_RAGGED_BYTES[batch]
