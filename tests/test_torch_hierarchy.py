"""The residency ladder of the port on the CPU, against the reference's:
global cross-layer allocation, the host-DRAM tier, sensitivity weights,
hotness persistence, ``plan_hierarchy``, ``quant.ptq`` and the backend's
options and stats schema (the cases of the reference's
``tests/test_hierarchy.py`` that need no expert parallelism)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JControllerConfig
from repro.core.budget import BudgetExceeded as JBudgetExceeded
from repro.core.budget import plan_hierarchy as jplan_hierarchy
from repro.core.hotness import HotnessEstimator as JHotnessEstimator
from repro.quant import quantize_tree as jquantize_tree
from repro.quant.ptq import dequantize_tree as jdequantize_tree
from repro.quant.sensitivity import expert_sensitivity as jexpert_sensitivity
from repro.quant.sensitivity import load_sensitivity as jload_sensitivity
from repro.quant.sensitivity import model_sensitivity as jmodel_sensitivity
from repro.quant.sensitivity import save_sensitivity as jsave_sensitivity
from repro.serving import make_backend as jmake_backend
from repro.serving import save_expert_shards as jsave_expert_shards
from repro.serving.hoststore import FetchModel as JFetchModel
from repro.serving.streaming import \
    load_streaming_params as jload_streaming_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.budget import BudgetExceeded, plan_hierarchy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.hotness import HotnessEstimator
from repro_torch.quant import (dequantize_tree, expert_sensitivity,
                               load_sensitivity, model_sensitivity,
                               quantize_tree, save_sensitivity)
from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.serving.backends import STAT_KEYS, make_backend
from repro_torch.serving.hoststore import FetchModel
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.streaming import load_streaming_params
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def model(serving_setup):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg, jp = serving_setup
    return jcfg, jp, get_config(ARCH, reduced=True), \
        params_from_reference(jax.tree_util.tree_map(np.asarray, jp))


def _clone(p):
    if isinstance(p, dict):
        return {k: _clone(v) for k, v in p.items()}
    return p


def _pair(model, **kw):
    """The reference's and the port's ``dynaexq`` backend with the same
    options, each materialized over the same weights (no engine)."""
    jcfg, jp, cfg, tp = model
    jkw = dict(kw)
    kw.setdefault("lo_bits", 4)
    kw.setdefault("n_hi_per_layer", 2)
    jkw.setdefault("lo_bits", 4)
    jkw.setdefault("n_hi_per_layer", 2)
    jctl = jkw.pop("controller", dict(update_interval_s=0.0))
    ctl = kw.pop("controller", dict(update_interval_s=0.0))
    if isinstance(jkw.get("fetch"), FetchModel):
        jkw["fetch"] = JFetchModel(gbps=jkw["fetch"].gbps)
    jbe = jmake_backend("dynaexq", controller=JControllerConfig(**jctl),
                        **jkw)
    be = make_backend("dynaexq", controller=ControllerConfig(**ctl),
                      device="cpu", **kw)
    jstream, stream = jkw.get("stream"), kw.get("stream")
    jbe.materialize_banks(jcfg, jload_streaming_params(jstream) if jstream
                          else jax.tree_util.tree_map(lambda x: x, jp),
                          kv_bytes=0)
    be.materialize_banks(cfg, load_streaming_params(stream, device="cpu")
                         if stream else _clone(tp), kv_bytes=0)
    return jbe, be


def _window(backends, counts):
    for b in backends:
        b.controllers["0"].observe(counts)
        b.force_update()
        b.flush()


# --------------------------------------------------------------------------
# the global allocator, sensitivity, the host tier
# --------------------------------------------------------------------------

def test_global_cross_layer_beats_per_layer(model):
    """Under layer-skewed traffic the global allocator puts the whole hi
    budget on the hot layer, in both packages; the per-layer rule pins each
    layer to n_hi."""
    E = model[2].moe.num_experts
    counts = np.zeros((2, E))
    counts[0] = [40, 30, 20, 10]
    for global_alloc in (True, False):
        pair = _pair(model, global_alloc=global_alloc)
        _window(pair, counts)
        sets = pair[1].hi_sets()["0"]
        assert sets == pair[0].hi_sets()["0"]
        assert sum(len(s) for s in sets) == 4
        if global_alloc:
            assert sets == [[0, 1, 2, 3], []]
        else:
            assert all(len(s) == 2 for s in sets)
        pair[1].controllers["0"].tm.check_invariants()


@pytest.mark.parametrize("kw", [
    dict(ep_shards=0), dict(global_alloc=False, lo_resident_total=4),
    dict(slots_slack=0.5), dict(lo_resident_total=0),
    dict(global_alloc=False, stream="/nonexistent")])
def test_option_validation_matches_reference(kw):
    msgs = []
    for make in (jmake_backend, lambda n, **k: make_backend(n, device="cpu",
                                                            **k)):
        with pytest.raises(ValueError) as ei:
            make("dynaexq", **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [dict(ep_shards=2), dict(rebalance=object())])
def test_expert_parallel_options_are_not_ported(kw):
    """Ported since expert parallelism came to the port: each option builds
    the backend the reference's builds (``ep_shards=2``: the per-layer rule
    and a coordinator; ``rebalance`` alone, one shard: neither)."""
    tb = make_backend("dynaexq", device="cpu", **kw)
    jb = jmake_backend("dynaexq", **kw)
    assert tb.global_alloc is jb.global_alloc
    assert (tb.coordinator is None) is (jb.coordinator is None)
    assert tb.ep_shards == jb.ep_shards


def test_global_allocation_is_the_default(model):
    assert make_backend("dynaexq", device="cpu").global_alloc is True


def test_sensitivity_bends_allocation(model):
    """A fragile expert (high sensitivity) wins a hi slot from an equally
    hot robust one, in both packages."""
    E = model[2].moe.num_experts
    sens = np.ones((2, E))
    sens[1, 3] = 40.0
    pair = _pair(model, sensitivity={"0": sens})
    _window(pair, np.ones((2, E)))
    assert pair[1].hi_sets() == pair[0].hi_sets()
    assert 3 in pair[1].hi_sets()["0"][1]


def test_host_tier_quota_and_demand_stall(model):
    """The lo quota's masks, the ladder order, the modeled demand stall and
    the host-fetch accounting equal the reference's after the same
    traffic; the footprint shrinks with the quota."""
    E = model[2].moe.num_experts
    pair = _pair(model, lo_resident_total=5, fetch=FetchModel(gbps=1.0))
    counts = np.zeros((2, E))
    counts[0] = [40, 30, 20, 10]
    counts[1] = [4, 3, 2, 1]
    _window(pair, counts)
    jbe, be = pair
    store = be.stores["0"]
    store.check_invariants()
    np.testing.assert_array_equal(store.lo_resident,
                                  jbe.stores["0"].lo_resident)
    assert int(store.lo_resident.sum()) == 5
    assert be.hi_sets() == jbe.hi_sets()
    for l in range(2):
        for e in be.hi_sets()["0"][l]:
            assert store.lo_resident[l, e]
    host = np.argwhere(~store.lo_resident)
    demand = np.zeros((2, E))
    demand[host[0][0], host[0][1]] = 3
    demand[host[-1][0], host[-1][1]] = 1
    stalls = [b.observe({"0": demand}, compute_s=0.0) for b in pair]
    assert stalls[1] == stalls[0] > 0
    assert be._host_acct == jbe._host_acct
    assert be._host_acct["host_fetches"] == 2
    assert be._host_acct["host_fetch_bytes"] == 2 * be._lo_b["0"]
    st, jst = be.stats(), jbe.stats()
    assert set(st) == set(jst)
    for k in ("host_fetches", "lo_resident_frac", "bytes_moved",
              "promotions", "residency_ready_frac"):
        assert st[k] == jst[k], k
    assert be.device_bytes() == jbe.device_bytes()
    assert be.residency_mix() == jbe.residency_mix()
    full = _pair(model)
    _window(full, counts)
    assert be.device_bytes() < full[1].device_bytes()


def test_randomized_ladder_interleaving_matches_reference(model):
    """Random promote/demote/host-evict windows in lockstep with the
    reference: after every window the hi sets and the lo-resident masks
    are the reference's, and the ladder's invariants hold."""
    E = model[2].moe.num_experts
    quota = 6
    pair = _pair(model, lo_resident_total=quota,
                 controller=dict(update_interval_s=0.0, margin=0.5))
    jbe, be = pair
    rng = np.random.default_rng(7)
    for _ in range(25):
        counts = rng.integers(0, 50, size=(2, E)) * \
            rng.integers(0, 2, size=(2, E))
        traffic = rng.integers(0, 3, size=(2, E))
        for b in pair:
            b.controllers["0"].observe(counts)
            b.observe({"0": traffic})
            b.force_update()
            b.flush()
        assert be.hi_sets() == jbe.hi_sets()
        store = be.stores["0"]
        np.testing.assert_array_equal(store.lo_resident,
                                      jbe.stores["0"].lo_resident)
        be.controllers["0"].tm.check_invariants()
        store.check_invariants()
        for l, hs in enumerate(be.hi_sets()["0"]):
            assert all(store.lo_resident[l, e] for e in hs)
        assert int(store.lo_resident.sum()) == quota
    assert be._host_acct == jbe._host_acct
    assert be.stats()["promotions"] == jbe.stats()["promotions"] > 0


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory, serving_setup):
    d = tmp_path_factory.mktemp("torch_hier_shards")
    jsave_expert_shards(str(d), jax.tree_util.tree_map(
        lambda x: x, serving_setup[1]), [0], lo_bits=4)
    return str(d)


OPTIONS = {
    "plain": {},
    "lo_resident_total": dict(lo_resident_total=5),
    "sensitivity": dict(sensitivity={"0": np.ones((2, 4))}),
    "fault": dict(fault='{"seed": 1, "rules": [{"site": "promo_copy", '
                        '"every": 2}]}'),
    "fetch": dict(fetch=FetchModel(gbps=2.0)),
    "hbm": dict(n_hi_per_layer=None, hbm_gb=0.05,
                activation_slack_bytes=1 << 20),
    "slots_slack": dict(slots_slack=1.0),
    "per_layer": dict(global_alloc=False),
    "stream": dict(stream=None, stream_experts_per_tick=3),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_stats_schema_matches_reference(model, shard_dir, tmp_path, name):
    """``stats()`` returns exactly the reference's keys with each option
    on, and the ladder's values agree after one window."""
    kw = dict(OPTIONS[name])
    if "stream" in kw:
        kw["stream"] = shard_dir
    if name == "plain":
        kw["hotness_path"] = str(tmp_path / "hot")
    jbe, be = _pair(model, **kw)
    assert set(be.stats()) == set(jbe.stats()) == \
        set(STAT_KEYS + be.STAT_EXTRAS)
    assert be.serving_ready() == jbe.serving_ready()
    assert be.ready_frac() == jbe.ready_frac()
    E = model[2].moe.num_experts
    _window((jbe, be), np.arange(2 * E).reshape(2, E))
    st, jst = be.stats(), jbe.stats()
    for k in be.STAT_EXTRAS + ("promotions", "demotions", "host_fetches",
                               "retries", "fault_cancels"):
        assert st[k] == jst[k], k
    assert be.hi_sets() == jbe.hi_sets()
    assert be.device_bytes() == jbe.device_bytes()


# --------------------------------------------------------------------------
# hotness persistence, plan_hierarchy, scheduler shedding
# --------------------------------------------------------------------------

def test_hotness_save_and_restore_across_packages(tmp_path):
    for make_a, make_b in ((HotnessEstimator, JHotnessEstimator),
                           (JHotnessEstimator, HotnessEstimator)):
        h = make_a(2, 4, alpha=0.5)
        h.observe(np.arange(8).reshape(2, 4))
        h.fold()
        h.observe(np.ones((2, 4)))
        p = str(tmp_path / f"hot_{make_a.__module__}.npz")
        h.save(p)
        h2 = make_b(2, 4)
        h2.load(p)
        np.testing.assert_array_equal(h2.scores, h.scores)
        np.testing.assert_array_equal(h2.counts, h.counts)
        assert h2.intervals == h.intervals
        with pytest.raises(ValueError):
            make_b(3, 4).load(p)


def test_backend_hotness_persistence_across_packages(model, tmp_path):
    """``save_hotness`` in one package, a backend of the other built on the
    same prefix opens with that traffic as its prior."""
    E = model[2].moe.num_experts
    for writer in (0, 1):
        prefix = str(tmp_path / f"hotness{writer}")
        pair = _pair(model, hotness_path=prefix)
        counts = np.zeros((2, E))
        counts[0, 1] = 99
        be = pair[writer]
        be.controllers["0"].observe(counts)
        be.controllers["0"].hotness.fold()
        be.save_hotness()
        fresh = _pair(model, hotness_path=prefix)[1 - writer]
        np.testing.assert_array_equal(fresh.controllers["0"].hotness.scores,
                                      be.controllers["0"].hotness.scores)
        assert fresh._host_acct["hotness_restored"] == 1


@pytest.mark.parametrize("args", [
    (1000, 100, 10, 100, 2, 4), (150, 100, 10, 100, 2, 4),
    (1 << 30, 1 << 28, 3 << 20, 12 << 20, 8, 128), (10 ** 6, 0, 7, 9, 3, 5),
    (105, 100, 10, 100, 2, 4)])
def test_plan_hierarchy_matches_reference(args):
    names = ("m_total", "m_fixed", "lo_bytes_per_expert_layer",
             "hi_bytes_per_expert_layer", "n_layers", "num_experts")
    kw = dict(zip(names, args))
    try:
        want = jplan_hierarchy(**kw)
    except JBudgetExceeded as e:
        with pytest.raises(BudgetExceeded) as ei:
            plan_hierarchy(**kw)
        assert str(ei.value) == str(e)
        return
    got = plan_hierarchy(**kw)
    for f in ("m_total", "m_fixed", "m_lo_cap", "m_hi_cap",
              "lo_resident_total", "total_hi"):
        assert getattr(got, f) == getattr(want, f), f


def test_plan_hierarchy_budget_split():
    plan = plan_hierarchy(m_total=1000, m_fixed=100,
                          lo_bytes_per_expert_layer=10,
                          hi_bytes_per_expert_layer=100,
                          n_layers=2, num_experts=4)
    assert plan.lo_resident_total == 8 and plan.total_hi == 8
    partial = plan_hierarchy(m_total=150, m_fixed=100,
                             lo_bytes_per_expert_layer=10,
                             hi_bytes_per_expert_layer=100,
                             n_layers=2, num_experts=4)
    assert partial.lo_resident_total == 5 and partial.total_hi == 0


def test_scheduler_sheds_during_cold_start():
    s = Scheduler(SchedulerConfig(shed_policy="downgrade",
                                  shed_min_ready_frac=0.9))
    warm = {"queue_depth": 0.0, "est_wait_s": 0.0,
            "budget_headroom_frac": 1.0}
    assert s.overloaded({**warm, "residency_ready_frac": 0.5})
    assert not s.overloaded({**warm, "residency_ready_frac": 0.95})
    assert not s.overloaded(warm)
    with pytest.raises(ValueError):
        SchedulerConfig(shed_min_ready_frac=1.5).validate()


# --------------------------------------------------------------------------
# quant: sensitivity and PTQ
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lo_bits", [2, 4])
def test_expert_sensitivity_matches_reference(model, lo_bits):
    """Weight-space sensitivity (``probes=0``) within 1e-5 relative of the
    reference's: the same quantizer, float32 sums in another order."""
    _, jp, _, tp = model
    want = jexpert_sensitivity(jp["blocks"]["0"]["moe"]["experts"], lo_bits)
    got = expert_sensitivity(tp["blocks"]["0"]["moe"]["experts"], lo_bits)
    assert got.shape == want.shape == (2, 4) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_probe_sensitivity_is_seeded(model):
    """``probes > 0`` draws from a seeded ``torch.Generator`` (not JAX's
    PRNG): the same seed gives the same scores, of the reference's shape
    and scale."""
    _, jp, _, tp = model
    ex = tp["blocks"]["0"]["moe"]["experts"]
    a = expert_sensitivity(ex, 4, probes=8, seed=3)
    b = expert_sensitivity(ex, 4, probes=8, seed=3)
    np.testing.assert_array_equal(a, b)
    ref = jexpert_sensitivity(jp["blocks"]["0"]["moe"]["experts"], 4,
                              probes=8, seed=3)
    assert a.shape == ref.shape
    assert np.all(np.isfinite(a)) and np.all(a > 0)
    np.testing.assert_allclose(a, ref, rtol=0.5)


def test_sensitivity_files_cross_packages_and_allocate_alike(model,
                                                             tmp_path):
    """``save_sensitivity`` in either package loads in the other; a backend
    given the file's path allocates the reference's hi sets."""
    jcfg, jp, cfg, tp = model
    mine = model_sensitivity(_clone(tp), [0], lo_bits=4)
    theirs = jmodel_sensitivity(jp, [0], lo_bits=4)
    np.testing.assert_allclose(mine["0"], theirs["0"], rtol=1e-5)
    p_mine, p_theirs = str(tmp_path / "s_port.npz"), \
        str(tmp_path / "s_ref.npz")
    save_sensitivity(p_mine, mine)
    jsave_sensitivity(p_theirs, theirs)
    np.testing.assert_array_equal(jload_sensitivity(p_mine)["0"], mine["0"])
    np.testing.assert_array_equal(load_sensitivity(p_theirs)["0"],
                                  theirs["0"])
    E = cfg.moe.num_experts
    pair = _pair(model, sensitivity=p_theirs)
    _window(pair, np.ones((2, E)))
    assert pair[1].hi_sets() == pair[0].hi_sets()
    with pytest.raises(ValueError, match="sensitivity for position 0"):
        _pair(model, sensitivity={"0": np.ones((3, E))})


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_tree_matches_reference(model):
    """Static PTQ over the whole tree: the same leaves quantized, packed
    codes and scales byte for byte; ``dequantize_tree`` the same values."""
    _, jp, _, tp = model
    jq = jquantize_tree(jp, bits=4, group_size=32, min_size=1 << 10)
    q = quantize_tree(_clone(tp), bits=4, group_size=32, min_size=1 << 10)
    jleaves = dict(_leaves(jax.tree_util.tree_map(
        lambda x: x, jq, is_leaf=lambda x: hasattr(x, "packed"))))
    n_q = 0
    for path, leaf in _leaves(q):
        want = jleaves[path]
        assert isinstance(leaf, QuantizedTensor) == hasattr(want, "packed"), \
            path
        if isinstance(leaf, QuantizedTensor):
            n_q += 1
            np.testing.assert_array_equal(leaf.packed.numpy(),
                                          np.asarray(want.packed))
            np.testing.assert_array_equal(
                leaf.scales.float().numpy(),
                np.asarray(want.scales, np.float32))
    assert n_q > 0
    jd = dict(_leaves(jdequantize_tree(jq)))
    for path, leaf in _leaves(dequantize_tree(q)):
        if leaf is not None:
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(jd[path], np.float32))
