"""The residency ladder's options on the hybrid family (Jamba-v0.1,
reduced: one super-block of 8 layers, MoE at positions 1, 3, 5 and 7,
4 experts top-2): the streaming cold start from expert shards, the host
tier (``lo_resident_total``) and a fault plan, served by the port's
engine against the reference's on the same options. The shards are the
port's (``save_expert_shards``); the reference reads them as its own.

Held to the reference: the shard reads and bytes before serving opens,
the hi sets and lo residency a forced window publishes from the same
counts, the ladder's stats (retries, fault cancels, quarantines, hi
loads), the tokens under the hybrid stack's margin rule
(``test_torch_hybrid``: routing near ties of its 8-layer stack tip
either way, so requests are compared past them), and the host fetches
the served ladder charges for the same counts (the served totals part
only where routing tipped)."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import ControllerConfig as JControllerConfig
from repro.fault import FaultPlan as JFaultPlan
from repro.fault import FaultRule as JFaultRule
from repro.models import init_params as jinit_params
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import InferenceEngine as JInferenceEngine
from repro.serving import make_backend as jmake_backend
from repro.serving.hoststore import FetchModel as JFetchModel
from repro.serving.streaming import \
    load_streaming_params as jload_streaming_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.controller import ControllerConfig
from repro_torch.fault import FaultPlan, FaultRule
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.hoststore import FetchModel
from repro_torch.serving.streaming import (load_streaming_params,
                                           save_expert_shards)

from test_torch_engine import NEW_TOKENS, PROMPT_LENS, _serve_lockstep
from test_torch_hybrid import LOGIT_TOL
from torch_threads import _one_thread  # noqa: F401

ARCH = "jamba-v0_1-52b"
MOE_POSITIONS = (1, 3, 5, 7)
#: Of the 4 positions × 1 layer × 4 experts = 16 cells, 10 lo-resident.
LO_RESIDENT = 10
#: Staging and host-row faults of the cold start, and promotion copies
#: that fail (retried, quarantined or cancelled).
RULES = (dict(site="stage_lo", prob=0.3),
         dict(site="host_hi", kind="stall", prob=0.5, stall_s=0.01),
         dict(site="promo_copy", prob=0.8))
#: Counts of the forced window: one hot expert per MoE position.
WARM = {str(p): np.array([[40.0, 5.0, 30.0, 10.0]]) for p in MOE_POSITIONS}
#: The ladder's stats that routing does not move.
STAT_NAMES = ("retries", "fault_cancels", "quarantined", "promotions",
              "hi_loads", "lo_resident_frac")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jget_config(ARCH, reduced=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit_params(jax.random.PRNGKey(0), jcfg))
    d = str(tmp_path_factory.mktemp("jamba_shards"))
    save_expert_shards(d, params_from_reference(jp), list(MOE_POSITIONS),
                       lo_bits=4)
    return jcfg, get_config(ARCH, reduced=True), d


def _engines(setup):
    jcfg, cfg, d = setup
    opts = dict(lo_bits=4, n_hi_per_layer=1, lo_resident_total=LO_RESIDENT,
                stream=d, stream_experts_per_tick=3)
    je = JInferenceEngine(
        jcfg, jload_streaming_params(d),
        jmake_backend("dynaexq", fetch=JFetchModel(gbps=1.0),
                      fault=JFaultPlan(seed=5, rules=tuple(
                          JFaultRule(**r) for r in RULES)),
                      controller=JControllerConfig(update_interval_s=1e9),
                      **opts),
        JEngineConfig(max_slots=2, max_len=96, prefix_sharing=False))
    te = InferenceEngine(
        cfg, load_streaming_params(d, device="cpu"),
        make_backend("dynaexq", fetch=FetchModel(gbps=1.0),
                     fault=FaultPlan(seed=5, rules=tuple(
                         FaultRule(**r) for r in RULES)),
                     controller=ControllerConfig(update_interval_s=1e9),
                     device="cpu", **opts),
        EngineConfig(max_slots=2, max_len=96), device="cpu")
    return cfg, je, te


@pytest.fixture(scope="module")
def cold(setup):
    """Both engines through the cold start and a forced window on the same
    counts: the shard reads before serving opened, then the engines."""
    cfg, je, te = _engines(setup)
    read = {}
    for name, eng in (("ref", je), ("port", te)):
        be = eng.backend
        assert not be.serving_ready()
        be.flush()
        assert be.serving_ready()
        read[name] = dict(be.stream.stats)
        for pos, counts in WARM.items():
            be.controllers[pos].observe(counts)
        be.force_update()
        be.flush()
    return cfg, je, te, read


def test_jamba_cold_start_reads_as_the_reference(cold):
    """The same lo shards and bytes read before serving opened (every
    MoE position's, the faulted stagings retried), none of the hi ones."""
    _, _, _, read = cold
    assert read["port"] == read["ref"]
    assert read["port"]["lo_reads"] >= len(MOE_POSITIONS)
    assert read["port"]["hi_reads"] == 0 and read["port"]["bytes_read"] > 0


def test_jamba_window_publishes_the_reference_residency(cold):
    """The forced window on the same counts: the same hi sets, the same
    lo-resident cells (LO_RESIDENT of 16; the rest on the host tier), the
    same quarantined cells, per MoE position."""
    _, je, te, _ = cold
    assert te.backend.hi_sets() == je.backend.hi_sets()
    for pos in map(str, MOE_POSITIONS):
        ts, js = te.backend.stores[pos], je.backend.stores[pos]
        np.testing.assert_array_equal(ts.lo_resident, js.lo_resident)
        np.testing.assert_array_equal(ts.quarantined, js.quarantined)
    assert sum(int(s.lo_resident.sum())
               for s in te.backend.stores.values()) <= LO_RESIDENT
    st, jst = te.backend.stats(), je.backend.stats()
    for k in STAT_NAMES:
        assert st[k] == pytest.approx(jst[k]), k
    assert st["retries"] > 0 and st["fault_cancels"] > 0


def test_jamba_ladder_serves_the_reference_tokens_and_stats(cold,
                                                            monkeypatch):
    """Requests served in lockstep: tokens equal up to each request's
    first small-margin flip, compared past router near ties (the hybrid
    rule), at least half of them compared; the stats routing does not
    move equal the reference's; both charged host fetches, and on the
    same counts (every expert of every MoE position routed once) the
    served ladders charge the same host fetches and stall."""
    cfg, je, te, _ = cold
    results = _serve_lockstep(cfg, je, te, monkeypatch, tol=LOGIT_TOL,
                              past_routing=True)
    held = 0
    for ref_toks, port_toks, stop, _ in results:
        assert len(port_toks) == NEW_TOKENS
        upto = NEW_TOKENS if stop is None else stop[0]
        assert port_toks[:upto] == ref_toks[:upto]
        held += upto
    assert held >= NEW_TOKENS * len(PROMPT_LENS) // 2, results
    st, jst = te.backend.stats(), je.backend.stats()
    for k in STAT_NAMES:
        assert st[k] == pytest.approx(jst[k]), k
    assert st["host_fetches"] > 0 and jst["host_fetches"] > 0
    counts = {str(p): np.ones((1, 4)) for p in MOE_POSITIONS}
    stall = te.backend.observe(counts), je.backend.observe(counts)
    assert stall[0] == pytest.approx(stall[1]) and stall[0] > 0
    assert te.backend.stats()["host_fetches"] - st["host_fetches"] == \
        je.backend.stats()["host_fetches"] - jst["host_fetches"] > 0
