"""The port's observability (``repro_torch.obs``, the tracer and metrics
sites of its serving stack, ``launch.roofline``) against the reference's.

* The flight recorder and the metrics registry: one scripted sequence
  (instants, duration and async spans, a ring overflow, metadata; counters,
  gauges, histograms, JSONL rows) fed to the reference's objects and to the
  port's saves the same bytes, exposes the same Prometheus text, writes
  the same JSONL lines and snapshots equal.
* The cost model: the port's ``costmodel.report`` equals the reference's
  exactly on a trace a reference engine recorded; ``predict_moe_bytes_per_
  token`` (and the coupon-collector term under it) equals over a grid.
* The port's counterparts of the reference's ``tests/test_obs.py`` on the
  port's engine (CPU, plain versions), the stats-schema pins held to the
  reference's constants.
* Across packages: the reference engine and the port's on one set of
  weights, ``static``, metrics off, the same ``RequestStream`` under
  ``replay(realtime=False)``, write byte-identical Chrome traces (the
  margin rule of ``test_torch_frontend`` is the only allowed exception);
  ``dynaexq`` with its policy frozen between explicit windows records the
  same residency events and forwards in both (the reference publishes a
  tick later while windows run on their own, so settled windows are
  compared).
"""
import collections
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.launch import roofline as jroofline
from repro.models import init_params as jinit_params
from repro.obs import FlightRecorder as JFlightRecorder
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Observability as JObservability
from repro.obs import ObsConfig as JObsConfig
from repro.obs import costmodel as jcostmodel
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import Request as JRequest
from repro.serving import RequestStream as JRequestStream
from repro.serving import STAT_KEYS as J_STAT_KEYS
from repro.serving import make_backend as jmake_backend
from repro.serving.backends import BACKENDS as J_BACKENDS
from repro.serving.engine import ENGINE_STAT_KEYS as J_ENGINE_STAT_KEYS
from repro.serving.engine import LOAD_SNAPSHOT_KEYS as J_LOAD_KEYS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.launch import roofline
from repro_torch.models.model import init_params
from repro_torch.obs import (FlightRecorder, MetricsRegistry, ObsConfig,
                             Observability, costmodel, load_chrome_trace)
from repro_torch.serving.backends import (BACKENDS, STAT_KEYS,
                                          OffloadConfig, make_backend)
from repro_torch.serving.engine import (ENGINE_STAT_KEYS, LOAD_SNAPSHOT_KEYS,
                                        EngineConfig, InferenceEngine,
                                        RequestState)
from repro_torch.serving.requests import Request, RequestStream

ARCH = "granite-moe-1b-a400m"
#: The margin rule of ``test_torch_frontend``: a greedy token may differ
#: only where the reference's own top-2 logits lie within this gap.
TIE_GAP = 4 * 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The recorder and the registry, byte for byte against the reference's
# ---------------------------------------------------------------------------

def _script_recorder(tr):
    """One scripted sequence: instants, a duration span, async spans ended
    out of order and one left open, metadata, then more events than the
    ring holds."""
    tr.meta.update(moe_dispatch="ragged", num_experts=4, top_k=2,
                   lo_bytes=100, hi_bytes=400, backend="dynaexq")
    tr.instant("submit", cat="sched", rid=0, qos="standard", prompt=10)
    tr.begin("prefill", cat="engine", rows=2)
    tr.end("prefill", cat="engine")
    a, b = tr.next_id(), tr.next_id()
    tr.async_begin("promotion", a, cat="residency", layer=0, expert=3,
                   slot=1, bytes=400)
    tr.async_begin("promotion", b, cat="residency", layer=1, expert=2,
                   slot=0, bytes=400)
    tr.async_end("promotion", b, cat="residency", published=1)
    tr.async_end("promotion", a, cat="residency", published=0,
                 reason="timeout")
    tr.async_begin("promotion", tr.next_id(), cat="residency", layer=0)
    tr.instant("step", cat="engine", step=1, active_experts=1.5,
               headroom=round(1 / 3, 6))
    tr.instant("nocat")
    for i in range(12):
        tr.instant("moe_forward", cat="engine", routed=8 + i, layers=2,
                   active_hi=i % 3, active_lo=2, active_host=0,
                   published_hi=2, prefill=int(i == 0))


def _ticks():
    t = iter(np.arange(0.0, 100.0, 0.125))
    return lambda: float(next(t))


@pytest.mark.parametrize("capacity", [64, 8], ids=["fits", "overflows"])
def test_recorder_saves_the_reference_bytes(tmp_path, capacity):
    jtr = JFlightRecorder(capacity=capacity, clock=_ticks())
    ttr = FlightRecorder(capacity=capacity, clock=_ticks())
    for tr in (jtr, ttr):
        _script_recorder(tr)
    assert ttr.dropped == jtr.dropped == max(0, 22 - capacity)
    assert len(ttr) == len(jtr)
    assert ttr.to_chrome() == jtr.to_chrome()
    paths = [str(tmp_path / f"{k}.json") for k in ("ref", "port")]
    jtr.save(paths[0])
    ttr.save(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    pairs = lambda tr: [(x.ts, x.id, y.ts, y.args)
                        for x, y in tr.spans("promotion")]
    assert pairs(ttr) == pairs(jtr)
    assert [e.args for e in ttr.instants("moe_forward")] == \
        [e.args for e in jtr.instants("moe_forward")]
    assert load_chrome_trace(paths[1]) == json.load(open(paths[0]))


def _script_metrics(m):
    m.counter("reqs", "total requests").inc(3)
    m.counter("reqs").inc(0.5)
    m.gauge("depth").set(2)
    m.gauge("headroom", "envelope headroom").set(1 / 3)
    h = m.histogram("lat", "publish latency")
    for v in np.linspace(1e-5, 5.0, 37):
        h.observe(v)
    m.histogram("coarse", buckets=(0.5, 0.1, 2.0)).observe(0.3)
    m.sample(step=1, depth=2, pad_ratio=round(0.123456, 4))
    m.sample(step=2, depth=0, queued_batch=1)


def test_metrics_match_the_reference(tmp_path):
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("ref", "port")]
    jm, tm = JMetricsRegistry(paths[0]), MetricsRegistry(paths[1])
    for m in (jm, tm):
        _script_metrics(m)
        m.close()
    assert tm.to_prometheus() == jm.to_prometheus()
    assert tm.snapshot() == jm.snapshot()
    assert open(paths[0]).read() == open(paths[1]).read()
    with pytest.raises(TypeError):
        tm.gauge("reqs")


# ---------------------------------------------------------------------------
# The roofline model and the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
@pytest.mark.parametrize("tokens", [0, 1, 3.5, 8, 32, 512])
@pytest.mark.parametrize("E,k", [(4, 2), (32, 8), (128, 8), (512, 10)])
@pytest.mark.parametrize("published_hi", [0, 7, 64])
def test_predict_bytes_per_token_matches_reference(dispatch, tokens, E, k,
                                                   published_hi):
    args = (tokens, 6, E, k, 1_671_168, 6_291_456)
    kw = dict(published_hi=published_hi, dispatch=dispatch)
    assert roofline.predict_moe_bytes_per_token(*args, **kw) == \
        jroofline.predict_moe_bytes_per_token(*args, **kw)
    assert roofline.expected_active_experts(tokens, E, k) == \
        jroofline.expected_active_experts(tokens, E, k)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b", "qwen3-moe-80b-a3b"])
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_model_flops_matches_reference(arch, kind):
    for reduced in (False, True):
        assert roofline.model_flops(get_config(arch, reduced), kind, 77) == \
            jroofline.model_flops(jget_config(arch, reduced), kind, 77)
    # The card's peaks are the H100 SXM's, not the reference's TPU's.
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)


@pytest.fixture(scope="module")
def ref_setup():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_config(ARCH, reduced=True), jp


def _pair(ref_setup, backend="static", obs=(None, None), **bkw):
    """A reference and a port engine on one set of weights, drop-free on
    the paged/ragged path, 2 slots."""
    jcfg, cfg, jp = ref_setup
    kw = dict(max_slots=2, max_len=64, moe_dispatch="ragged",
              capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    if backend == "dynaexq":
        jbkw = dict(bkw, lo_bits=4, n_hi_per_layer=2,
                    controller=JControllerConfig(update_interval_s=1e9))
        tbkw = dict(bkw, lo_bits=4, n_hi_per_layer=2,
                    controller=ControllerConfig(update_interval_s=1e9))
    else:
        jbkw = tbkw = dict(bkw, lo_bits=4)
    je = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp),
                          jmake_backend(backend, **jbkw),
                          JEngineConfig(**kw), obs=obs[0])
    te = InferenceEngine(cfg, params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp)),
        make_backend(backend, device="cpu", **tbkw), EngineConfig(**kw),
        device="cpu", obs=obs[1])
    return je, te


def _stream(cls, vocab, phases=(("text", 4), ("code", 4)), seed=11):
    return cls(vocab, phases=list(phases), prompt_len=10,
               prompt_len_jitter=3, max_new_tokens=6,
               arrival_rate_rps=200.0, seed=seed)


def _settled_windows(ref_setup, global_alloc):
    """Both packages' ``dynaexq`` over three streams, the policy frozen
    except for one explicit window (and a flush) after each."""
    jo = JObservability(JObsConfig())
    to = Observability(ObsConfig())
    je, te = _pair(ref_setup, "dynaexq", (jo, to),
                   global_alloc=global_alloc)
    vocab = ref_setup[1].vocab_size
    for ph, seed in (("text", 11), ("code", 12), ("math", 13)):
        for eng, cls in ((je, JRequestStream), (te, RequestStream)):
            eng.replay(_stream(cls, vocab, ((ph, 4),), seed),
                       realtime=False)
            eng.backend.force_update()
            eng.flush()
    return (je, jo), (te, to)


def test_costmodel_matches_reference_on_a_reference_trace(ref_setup,
                                                          tmp_path):
    (je, jo), _ = _settled_windows(ref_setup, global_alloc=False)
    path = str(tmp_path / "ref.trace.json")
    jo.save_trace(path)
    want = jcostmodel.report(path)
    assert want["roofline"]["n_steps"] > 0
    assert want["promotions"]["n_published"] > 0
    assert costmodel.report(path) == want
    assert costmodel.report(load_chrome_trace(path)) == want
    assert costmodel.fold_steps(path, decode_only=False) == \
        jcostmodel.fold_steps(path, decode_only=False)
    assert costmodel.META_KEYS == jcostmodel.META_KEYS
    # The same events in the port's own recorder fold the same.
    tr = FlightRecorder()
    obj = load_chrome_trace(path)
    tr.meta.update(obj["otherData"])
    for ev in obj["traceEvents"]:
        if ev["ph"] == "i":
            tr.clock = lambda ts=ev["ts"]: ts / 1e6
            tr.instant(ev["name"], ev["cat"], **ev.get("args", {}))
    assert costmodel.residual_report(tr) == want["roofline"]


# ---------------------------------------------------------------------------
# The reference's tests/test_obs.py on the port
# ---------------------------------------------------------------------------

def test_ring_buffer_bounds_and_drop_count():
    tr = FlightRecorder(capacity=4, clock=lambda: 0.0)
    for i in range(10):
        tr.instant("e", cat="t", i=i)
    assert len(tr) == 4
    assert tr.dropped == 6
    assert [e.args["i"] for e in tr.events()] == [6, 7, 8, 9]
    assert tr.to_chrome()["otherData"]["dropped_events"] == 6
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_async_span_pairing():
    t = iter(np.arange(0.0, 10.0, 0.5))
    tr = FlightRecorder(clock=lambda: float(next(t)))
    a, b = tr.next_id(), tr.next_id()
    assert a != b
    tr.async_begin("promotion", a, cat="residency", layer=0)
    tr.async_begin("promotion", b, cat="residency", layer=1)
    tr.async_end("promotion", b, published=1)
    tr.async_end("promotion", a, published=0)
    tr.async_begin("promotion", tr.next_id())
    spans = tr.spans("promotion")
    assert len(spans) == 2
    for bg, en in spans:
        assert bg.id == en.id and bg.ts < en.ts
    assert spans[0][1].args["published"] == 1
    assert spans[1][1].args["published"] == 0


def test_chrome_export_round_trip(tmp_path):
    tr = FlightRecorder(clock=lambda: 1.0)
    tr.meta.update(num_experts=4, top_k=2)
    tr.instant("moe_forward", cat="engine", routed=8)
    path = str(tmp_path / "t.trace.json")
    tr.save(path)
    obj = load_chrome_trace(path)
    (ev,) = obj["traceEvents"]
    assert ev["name"] == "moe_forward" and ev["ph"] == "i"
    assert ev["ts"] == 1e6 and ev["tid"] == "engine"
    assert ev["args"] == {"routed": 8}
    assert obj["otherData"]["num_experts"] == 4
    path2 = str(tmp_path / "t2.trace.json")
    tr.save(path2)
    assert open(path, "rb").read() == open(path2, "rb").read()


def test_metrics_registry_kinds_and_values():
    m = MetricsRegistry()
    m.counter("c").inc()
    m.counter("c").inc(2.5)
    assert m.counter("c").value == 3.5
    with pytest.raises(ValueError):
        m.counter("c").inc(-1)
    m.gauge("g").set(7)
    m.gauge("g").set(4)
    with pytest.raises(TypeError):
        m.gauge("c")
    h = m.histogram("h")
    for v in np.linspace(0.001, 0.1, 100):
        h.observe(v)
    snap = m.snapshot()
    assert snap["c"] == 3.5 and snap["g"] == 4.0
    assert snap["h_count"] == 100
    assert snap["h_p50"] == pytest.approx(np.percentile(
        np.linspace(0.001, 0.1, 100), 50))
    assert snap["h_p50"] <= snap["h_p95"]


def test_prometheus_exposition_and_jsonl_sink(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = MetricsRegistry(jsonl_path=path)
    m.counter("reqs", "total requests").inc(3)
    m.gauge("depth").set(2)
    m.histogram("lat").observe(0.002)
    m.sample(step=1, depth=2)
    m.sample(step=2, depth=0)
    m.close()
    text = m.to_prometheus()
    assert "# HELP reqs total requests" in text
    assert "# TYPE reqs counter" in text
    assert "reqs 3" in text
    assert "# TYPE lat histogram" in text
    assert 'lat_bucket{le="+Inf"} 1' in text
    assert "lat_count 1" in text
    rows = [json.loads(ln) for ln in open(path)]
    assert rows == [{"step": 1, "depth": 2}, {"step": 2, "depth": 0}]
    m.close()


def _synthetic_trace():
    """A hand-built trace whose measured traffic equals the roofline
    prediction for one token per forward: residuals 0."""
    t = iter(np.arange(0.0, 100.0, 0.25))
    tr = FlightRecorder(clock=lambda: float(next(t)))
    tr.meta.update(moe_dispatch="padded", num_experts=8, top_k=2,
                   lo_bytes=100, hi_bytes=400)
    for _ in range(5):
        tr.instant("moe_forward", cat="engine", routed=1 * 4 * 2, layers=4,
                   active_hi=4, active_lo=4, active_host=0,
                   published_hi=2 * 4, prefill=0)
    tr.instant("moe_forward", cat="engine", routed=64, layers=4,
               active_hi=0, active_lo=0, active_host=0, published_hi=0,
               prefill=1)
    sid = tr.next_id()
    tr.async_begin("promotion", sid, cat="residency", layer=0, expert=3)
    tr.async_end("promotion", sid, cat="residency", published=1)
    sid = tr.next_id()
    tr.async_begin("promotion", sid, cat="residency", layer=1, expert=5)
    tr.async_end("promotion", sid, cat="residency", published=0)
    return tr


def test_costmodel_fold_and_residuals(tmp_path):
    tr = _synthetic_trace()
    samples = costmodel.fold_steps(tr)
    assert len(samples) == 5
    assert all(s["tokens"] == 1.0 for s in samples)
    assert samples[0]["measured_bpt"] == 4 * 8 * 100 + 8 * 400
    rep = costmodel.residual_report(tr)
    assert rep["n_steps"] == 5
    assert rep["max_abs_rel_residual"] == 0.0
    prom = costmodel.promotion_report(tr)
    assert prom["n_published"] == 1 and prom["n_cancelled"] == 1
    assert prom["publish_latency_p50_s"] == pytest.approx(0.25)
    path = str(tmp_path / "t.trace.json")
    tr.save(path)
    assert costmodel.report(path) == costmodel.report(tr)


def test_costmodel_requires_meta():
    tr = FlightRecorder(clock=lambda: 0.0)
    tr.instant("moe_forward", cat="engine", routed=8, layers=4)
    with pytest.raises(ValueError, match="metadata missing"):
        costmodel.fold_steps(tr)


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_stat_extras_pinned(kind):
    """The schema is the reference's: the same uniform keys, the same
    per-class extras, the same engine keys and overlap."""
    assert BACKENDS[kind].STAT_EXTRAS == J_BACKENDS[kind].STAT_EXTRAS
    assert STAT_KEYS == J_STAT_KEYS
    assert ENGINE_STAT_KEYS == J_ENGINE_STAT_KEYS
    assert LOAD_SNAPSHOT_KEYS == J_LOAD_KEYS
    assert {"retries", "fault_cancels"} <= set(STAT_KEYS)
    assert "watchdog_cancels" in ENGINE_STAT_KEYS
    assert set(STAT_KEYS) & set(ENGINE_STAT_KEYS) == {
        "preemptions", "resumes", "shed_requests", "downgraded"}


@pytest.fixture(scope="module")
def port_params():
    cfg = get_config(ARCH, reduced=True)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(port_params, name, obs=None, max_slots=4, max_len=64, **kw):
    """The reference's canonical test engine on the port: int4 lo, n_hi 2,
    a policy window every tick."""
    cfg, params = port_params
    if name in ("static", "dynaexq"):
        kw.setdefault("lo_bits", 4)
    if name == "dynaexq":
        kw.setdefault("n_hi_per_layer", 2)
        kw.setdefault("controller", ControllerConfig(update_interval_s=0.0))
    clone = jax.tree_util.tree_map(lambda x: x, params)
    return InferenceEngine(cfg, clone, make_backend(name, device="cpu", **kw),
                           EngineConfig(max_slots=max_slots,
                                        max_len=max_len),
                           device="cpu", obs=obs)


def _run(port_params, kind, obs, n=4, new=6, **kw):
    cfg = port_params[0]
    eng = _engine(port_params, kind, obs=obs, **kw)
    rng = np.random.default_rng(7)
    handles = [eng.submit(Request(
        tokens=rng.integers(0, cfg.vocab_size, size=12), max_new_tokens=new))
        for _ in range(n)]
    eng.drain()
    eng.flush()
    return eng, handles


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_stats_schema_exact(port_params, kind):
    kw = {"ocfg": OffloadConfig(cache_experts_per_layer=1)} \
        if kind == "offload" else {}
    eng, _ = _run(port_params, kind, Observability(), n=3, new=4, **kw)
    st = eng.stats()
    expect = set(STAT_KEYS) | set(BACKENDS[kind].STAT_EXTRAS) | \
        set(ENGINE_STAT_KEYS)
    assert set(st) == expect, (sorted(set(st) - expect),
                               sorted(expect - set(st)))
    assert all(isinstance(v, float) for v in st.values())


def test_load_snapshot_schema(port_params):
    eng = _engine(port_params, "static")
    assert set(eng.load_snapshot()) == set(LOAD_SNAPSHOT_KEYS)


def test_engine_emits_lifecycle_and_forward_events(port_params):
    obs = Observability(ObsConfig())
    eng, handles = _run(port_params, "dynaexq", obs)
    tr = obs.tracer
    names = {e.name for e in tr.events()}
    assert {"submit", "admit", "finish", "step", "moe_forward"} <= names
    assert len(tr.instants("submit")) == len(handles)
    assert len(tr.instants("finish")) == len(handles)
    assert all(k in tr.meta for k in costmodel.META_KEYS)
    assert tr.meta["backend"] == "dynaexq"
    assert tr.meta["lo_bytes"] > 0 and tr.meta["hi_bytes"] > 0
    rep = costmodel.report(tr)
    assert rep["roofline"]["n_steps"] > 0
    snap = obs.metrics.snapshot()
    assert "engine_active_experts" in snap
    assert snap["residency_hi_cells"] > 0


def test_promotion_lifecycle_spans(port_params):
    """Every completed promotion span ends with ``published`` ∈ {0, 1}; a
    published end comes only after its copy completed (on the CPU at
    once); the histogram and the backend's count agree with the spans."""
    obs = Observability(ObsConfig())
    eng, _ = _run(port_params, "dynaexq", obs)
    spans = obs.tracer.spans("promotion")
    assert spans, "dynaexq run produced no promotion lifecycle spans"
    assert any(e.args["published"] == 1 for _, e in spans)
    for b, e in spans:
        assert e.args["published"] in (0, 1)
        assert e.ts >= b.ts
        assert b.args["layer"] >= 0 and b.args["bytes"] > 0
    n_pub = sum(e.args["published"] for _, e in spans)
    assert n_pub == eng.stats()["promotions"]
    snap = obs.metrics.snapshot()
    assert snap["promotion_publish_latency_seconds_count"] == n_pub
    assert len(obs.tracer.instants("promo_request")) == len(spans)


def test_stall_exposure_attribution(port_params):
    eng, handles = _run(port_params, "offload", None,
                        ocfg=OffloadConfig(cache_experts_per_layer=1))
    st = eng.stats()
    assert st["stall_s"] > 0
    exposed = [h.stall_exposure_s for h in handles]
    assert max(exposed) > 0
    assert max(exposed) <= st["stall_s"] + 1e-9
    eng2, handles2 = _run(port_params, "static", None)
    assert all(h.stall_exposure_s == 0.0 for h in handles2)


def test_disabled_tracer_records_nothing(port_params, tmp_path):
    obs = Observability(ObsConfig(trace=False, metrics=True))
    assert obs.tracer is None
    eng, _ = _run(port_params, "dynaexq", obs)
    assert eng.tracer is None and eng.backend.tracer is None
    assert "engine_active_experts" in obs.metrics.snapshot()
    with pytest.raises(ValueError):
        obs.save_trace(str(tmp_path / "never.json"))


def test_obs_none_leaves_engine_bare(port_params):
    eng, _ = _run(port_params, "dynaexq", None)
    assert eng.obs is None and eng.tracer is None and eng.metrics is None
    assert eng.backend.tracer is None and eng.backend.metrics is None
    for ctl in eng.backend.controllers.values():
        assert ctl.tm.tracer is None and ctl.tm.publish_hist is None
    for store in eng.backend.stores.values():
        assert store.tracer is None


def test_virtual_clock_replay_traces_byte_identical(port_params, tmp_path):
    cfg = port_params[0]

    def one(tag):
        obs = Observability(ObsConfig(metrics=False))
        eng = _engine(port_params, "static", obs=obs)
        stream = RequestStream(cfg.vocab_size, phases=[("text", 5)],
                               prompt_len=10, prompt_len_jitter=3,
                               max_new_tokens=5, arrival_rate_rps=200.0,
                               seed=11)
        handles = eng.replay(stream, realtime=False)
        assert all(h.tokens for h in handles)
        path = str(tmp_path / f"{tag}.trace.json")
        obs.save_trace(path)
        return open(path, "rb").read()

    a, b = one("a"), one("b")
    assert len(a) > 200
    assert a == b
    first = json.loads(a)["traceEvents"][0]
    assert first["ts"] < 60e6


def test_metrics_rows_follow_the_sampling_cadence(port_params, tmp_path):
    """One JSONL row per ``sample_every`` engine steps, each with the step
    event's gauges; the metrics sampled and the trace share the step."""
    path = str(tmp_path / "m.jsonl")
    obs = Observability(ObsConfig(metrics_jsonl=path, sample_every=2))
    _run(port_params, "static", obs)
    obs.close()
    rows = [json.loads(ln) for ln in open(path)]
    steps = [e.args for e in obs.tracer.instants("step")]
    want = [s for s in steps if s["step"] % 2 == 0]
    assert rows and len(rows) == len(want)
    for r, s in zip(rows, want):
        assert r["step"] == s["step"]
        for k in ("active_experts", "pad_ratio", "hi", "lo", "host",
                  "headroom"):
            assert r[k] == s[k]
        assert r["queued_standard"] + r["queued_batch"] + \
            r["queued_premium"] == s["queued"]


# ---------------------------------------------------------------------------
# Across packages: the reference engine's trace and the port's
# ---------------------------------------------------------------------------

def _top2_gap(jcfg, jp, request, tokens) -> float:
    """The reference's own top-2 logit gap for the token after
    ``tokens`` (a one-row prefill on a fresh reference engine)."""
    eng = JInferenceEngine(jcfg, jax.tree_util.tree_map(lambda x: x, jp),
                           jmake_backend("static", lo_bits=4),
                           JEngineConfig(max_slots=1, max_len=128,
                                         moe_dispatch="ragged",
                                         prefix_sharing=False))
    seen = []
    call = eng._jit_prefill_paged

    def captured(*a, **k):
        out = call(*a, **k)
        seen.append(np.asarray(out[0])[0])
        return out

    eng._jit_prefill_paged = captured
    seq = np.concatenate([np.asarray(request.tokens),
                          np.asarray(tokens, np.int32)])
    eng.submit(JRequest(tokens=seq, max_new_tokens=1))
    eng.drain()
    top = np.sort(seen[-1])[-2:]
    return float(top[1] - top[0])


def test_static_traces_byte_identical_across_packages(ref_setup, tmp_path):
    jo = JObservability(JObsConfig(metrics=False))
    to = Observability(ObsConfig(metrics=False))
    je, te = _pair(ref_setup, "static", (jo, to))
    vocab = ref_setup[1].vocab_size
    jh = je.replay(_stream(JRequestStream, vocab), realtime=False)
    th = te.replay(_stream(RequestStream, vocab), realtime=False)
    paths = [str(tmp_path / f"{k}.json") for k in ("ref", "port")]
    jo.save_trace(paths[0])
    to.save_trace(paths[1])
    a, b = (open(p, "rb").read() for p in paths)
    assert len(jo.tracer.instants("submit")) == 8 and jo.tracer.dropped == 0
    assert all(h.state is RequestState.FINISHED for h in th)
    if a == b:
        assert [h.tokens for h in jh] == [h.tokens for h in th]
        return
    # The margin rule: tokens agree up to a near tie of the reference's
    # logits, and the events agree up to the first forward whose router
    # counts differ.
    ja, tb = (json.loads(x)["traceEvents"] for x in (a, b))
    first = next(i for i, (x, y) in enumerate(zip(ja, tb)) if x != y)
    fwd = next(i for i, (x, y) in enumerate(zip(ja, tb))
               if x["name"] == "moe_forward" and x != y)
    assert first == fwd, (ja[first], tb[first])
    diverged = [(x, y) for x, y in zip(jh, th) if x.tokens != y.tokens]
    assert diverged
    for x, y in diverged:
        t = next(i for i, (p, q) in enumerate(zip(x.tokens, y.tokens))
                 if p != q)
        assert _top2_gap(ref_setup[0], ref_setup[2], x.request,
                         x.tokens[:t]) < TIE_GAP


@pytest.mark.parametrize("global_alloc", [False, True],
                         ids=["per-layer", "global"])
def test_dynaexq_settled_events_match_reference(ref_setup, global_alloc):
    (je, jo), (te, to) = _settled_windows(ref_setup, global_alloc)
    res = lambda tr: [(e.name, e.ph, e.args)
                      for e in tr.events() if e.cat == "residency"]
    jtr, ttr = jo.tracer, to.tracer
    assert res(ttr) == res(jtr)
    count = lambda tr: collections.Counter(e.name for e in tr.events())
    assert count(ttr) == count(jtr)
    published = lambda tr: sum(e.args["published"]
                               for _, e in tr.spans("promotion"))
    assert published(ttr) == published(jtr) == \
        te.stats()["promotions"] > 0
    assert to.metrics.snapshot()[
        "promotion_publish_latency_seconds_count"] == published(ttr)
    assert len(ttr.instants("moe_forward")) == \
        len(jtr.instants("moe_forward"))
    assert te.backend.hi_sets() == je.backend.hi_sets()
    assert ttr.meta == jtr.meta
