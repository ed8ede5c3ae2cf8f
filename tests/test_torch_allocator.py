"""The port's global cross-layer allocator, HBM-envelope plan and int-hi
byte prices against the reference's, and its default ``dynaexq`` backend
(the global allocator) against the reference's default on served
engines."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.allocator import AllocatorConfig as JAllocatorConfig
from repro.core.allocator import GlobalAllocator as JGlobalAllocator
from repro.core.budget import BudgetExceeded as JBudgetExceeded
from repro.core.budget import plan_budget as jplan_budget
from repro.core.ver import expert_hi_nbytes as jexpert_hi_nbytes
from repro.core.ver import expert_lo_nbytes as jexpert_lo_nbytes
from repro.models import init_params as jinit_params
from repro.serving import make_backend as jmake_backend
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.allocator import AllocatorConfig, GlobalAllocator
from repro_torch.core.budget import BudgetExceeded, plan_budget
from repro_torch.core.ver import expert_hi_nbytes, expert_lo_nbytes
from repro_torch.serving.backends import GiB, make_backend
from test_torch_engine import _default_engines, _warm_and_freeze

FLAGSHIP = "qwen3-moe-80b-a3b"


# --------------------------------------------------------------------------
# (a) the allocator, exactly
# --------------------------------------------------------------------------

def _allocator_inputs(R, E, seed, with_caps, with_lo):
    """Values rounded to 1/64 (so cells tie, and the stable order decides),
    current hi sets of up to 2·n per row, row ceilings in [n, 2n], and
    current lo sets holding each row's hi set."""
    rng = np.random.default_rng(seed)
    n = max(1, E // 8)
    value = np.round(rng.random((R, E)) * 64) / 64
    cur_hi = [set(rng.choice(E, rng.integers(0, 2 * n + 1),
                             replace=False).tolist()) for _ in range(R)]
    caps = rng.integers(n, 2 * n + 1, R) if with_caps else None
    cur_lo = None
    if with_lo:
        cur_lo = [set(rng.choice(E, E * 3 // 4, replace=False).tolist()) | h
                  for h in cur_hi]
    return value, cur_hi, cur_lo, caps, n


def _same_assignment(a, b):
    for f in ("hi", "promotions", "demotions", "lo", "lo_promotions",
              "lo_demotions"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("with_lo", [False, True], ids=["hi", "hi+lo"])
@pytest.mark.parametrize("max_transitions", [0, 5])
@pytest.mark.parametrize("margin", [0.0, 0.1])
@pytest.mark.parametrize("with_caps", [False, True],
                         ids=["no_caps", "row_caps"])
@pytest.mark.parametrize("R,E", [(4, 16), (48, 128), (48, 512)])
def test_allocate_equals_reference(R, E, with_caps, margin, max_transitions,
                                   with_lo):
    seed = R * E + 7 * with_caps + 3 * max_transitions + int(margin * 10)
    value, cur_hi, cur_lo, caps, n = _allocator_inputs(R, E, seed,
                                                       with_caps, with_lo)
    kw = dict(total_hi=R * n, slots_per_layer=2 * n, margin=margin,
              max_transitions=max_transitions,
              lo_resident_total=R * E * 5 // 8 if with_lo else 0,
              lo_margin=margin)
    want = JGlobalAllocator(JAllocatorConfig(**kw)).allocate(
        value, cur_hi, cur_lo, row_caps=caps)
    got = GlobalAllocator(AllocatorConfig(**kw)).allocate(
        value, cur_hi, cur_lo, row_caps=caps)
    _same_assignment(got, want)
    assert sum(len(s) for s in got.hi) <= R * n or max_transitions
    if caps is not None:
        assert all(len(s) <= c for s, c in zip(got.hi, caps))
    if with_lo:
        assert all(h <= lo for h, lo in zip(got.hi, got.lo))
    # A window from an empty start fills the whole budget.
    empty = [set() for _ in range(R)]
    _same_assignment(
        GlobalAllocator(AllocatorConfig(**kw)).allocate(value, empty,
                                                        row_caps=caps),
        JGlobalAllocator(JAllocatorConfig(**kw)).allocate(value, empty,
                                                          row_caps=caps))


def test_allocator_config_rejects_what_the_reference_rejects():
    for bad in (dict(total_hi=-1, slots_per_layer=1),
                dict(total_hi=1, slots_per_layer=1, margin=-0.1),
                dict(total_hi=1, slots_per_layer=1, lo_resident_total=-1)):
        with pytest.raises(ValueError):
            JGlobalAllocator(JAllocatorConfig(**bad))
        with pytest.raises(ValueError):
            GlobalAllocator(AllocatorConfig(**bad))
    with pytest.raises(ValueError, match="row_caps"):
        GlobalAllocator(AllocatorConfig(total_hi=2, slots_per_layer=2)) \
            .allocate(np.ones((2, 4)), [set(), set()], row_caps=[1, 1, 1])


# --------------------------------------------------------------------------
# (b) the HBM-envelope plan
# --------------------------------------------------------------------------

# 80B shapes per expert-layer at int4 hi / int2 lo, 4 layers of 512 experts.
_HI4, _LO2, _L, _E = 1_671_168, 884_736, 4, 512


@pytest.mark.parametrize("m_total,m_fixed,lo_total,hi_b,L,E,align", [
    (80 * GiB, 6 * GiB, _LO2 * _L * _E, _HI4, _L, _E, 1),
    (80 * GiB, 6 * GiB, _LO2 * _L * _E, _HI4, _L, _E, 4),
    (3 * GiB, GiB, _LO2 * _L * _E, _HI4, _L, _E, 1),      # n_hi small
    (1 << 40, 0, 1000, 10, 2, 16, 1),                      # capped at E
    (GiB + 1, GiB, 1, 10, 2, 16, 1),                        # n_hi = 0
    (2 * GiB, 2 * GiB - 10, 10, 10, 2, 16, 1),              # exactly full
], ids=["80b-4layers", "align4", "tight", "cap_E", "zero", "exact"])
def test_plan_budget_equals_reference(m_total, m_fixed, lo_total, hi_b, L, E,
                                      align):
    want = jplan_budget(m_total, m_fixed, lo_total, hi_b, L, E, align=align)
    got = plan_budget(m_total, m_fixed, lo_total, hi_b, L, E, align=align)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.m_fixed + got.m_lo + got.m_hi_cap <= got.m_total


@pytest.mark.parametrize("m_total,m_fixed,lo_total", [
    (GiB, GiB, 1),                      # the lo tier does not fit by a byte
    (2 * GiB, 3 * GiB, 0),              # fixed bytes alone exceed it
    (int(1.5 * GiB), GiB, _LO2 * _L * _E),
])
def test_plan_budget_infeasible_raises_in_both(m_total, m_fixed, lo_total):
    with pytest.raises(JBudgetExceeded):
        jplan_budget(m_total, m_fixed, lo_total, _HI4, _L, _E)
    with pytest.raises(BudgetExceeded):
        plan_budget(m_total, m_fixed, lo_total, _HI4, _L, _E)


# --------------------------------------------------------------------------
# (c) int-hi byte prices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hi_bits", [4, 8, 16])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", FLAGSHIP,
                                  "granite-moe-1b-a400m"])
def test_expert_bytes_equal_reference(arch, hi_bits):
    cfg = get_config(arch)
    d, F, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
    shapes = {"w_gate": (4, E, d, F), "w_up": (4, E, d, F),
              "w_down": (4, E, F, d)}
    got = expert_hi_nbytes(shapes, hi_bits=hi_bits, group_size=64)
    assert got == jexpert_hi_nbytes(shapes, hi_bits=hi_bits, group_size=64)
    for lo_bits in (2, 4):
        assert expert_lo_nbytes(shapes, lo_bits, 64) == \
            jexpert_lo_nbytes(shapes, lo_bits, 64)
    if arch == FLAGSHIP:
        # The paper's Int4-hi tier is priced at its packed size, while the
        # slots hold the bf16 masters.
        assert got == {4: 1_671_168, 8: 3_244_032, 16: 6_291_456}[hi_bits]
        assert expert_lo_nbytes(shapes, 2, 64) == _LO2


# --------------------------------------------------------------------------
# (d) the default backend on served engines
# --------------------------------------------------------------------------

def _configs(arch):
    if arch == FLAGSHIP:
        return (jget_config(arch).reduced(num_experts=16),
                get_config(arch).reduced(num_experts=16),
                dict(lo_bits=2, hi_bits=4))
    return jget_config(arch, reduced=True), get_config(arch, reduced=True), {}


def _engines(arch, **kw):
    """Both engines on one set of weights, each with ``make_backend(
    "dynaexq")`` at its default arguments but a policy window every step
    (``test_torch_engine._default_engines``)."""
    jcfg, cfg, base = _configs(arch)
    return _default_engines(jcfg, cfg, "dynaexq", **base, **kw)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", FLAGSHIP])
def test_default_backend_publishes_the_reference_hi_sets(arch):
    cfg, je, te = _engines(arch)
    assert je.backend.global_alloc and je.backend.allocator is not None
    assert te.backend.global_alloc and te.backend.allocator is not None
    E = cfg.moe.num_experts
    n_hi = max(1, E // 8)
    for pos, bank in te.backend.banks.items():
        jb = je.backend.banks[pos]
        assert tuple(bank.slot_owner.shape) == tuple(jb.slot_owner.shape) \
            == (cfg.n_superblocks(), min(E, 2 * n_hi))
    _warm_and_freeze(cfg, je, te)           # asserts equal hi sets
    if arch != FLAGSHIP:
        # Granite's two reduced layers warm up about equally hot, so the
        # knapsack leaves one slot in each; a window of counts on layer 0
        # alone gives it a reason to skew.
        c = np.zeros((cfg.n_superblocks(), E), np.int32)
        c[0, :2] = 64
        for eng in (je, te):
            eng.backend.observe({"0": c})
            eng.backend.force_update()
            eng.backend.flush()
    sets = te.backend.hi_sets()
    assert sets == je.backend.hi_sets()
    assert te.backend.device_bytes() == je.backend.device_bytes()
    assert sum(len(s) for s in sets["0"]) == cfg.n_superblocks() * n_hi
    # The knapsack skewed the slots toward one layer.
    assert max(len(s) for s in sets["0"]) > n_hi, sets
    for ctl in te.backend.controllers.values():
        ctl.tm.check_invariants()
    st = te.stats()
    assert st["promotions"] == je.stats()["promotions"] > 0


def test_global_tick_honours_a_frozen_cadence():
    """The cadence is read live from the controllers' configs: freezing
    them stops the global windows, as it stops the per-layer ones."""
    cfg, _, te = _engines("granite-moe-1b-a400m")
    be = te.backend
    assert be._global_tick() is True
    for ctl in be.controllers.values():
        ctl.cfg = dataclasses.replace(ctl.cfg, update_interval_s=1e9)
    assert be._global_tick() is False
    for unported in ("sensitivity", "lo_resident_total", "stream", "fault",
                     "ep_shards"):
        with pytest.raises(TypeError):
            make_backend("dynaexq", device="cpu", **{unported: None})


@pytest.mark.parametrize("extra_gb", [0.0005, 0.002, 1.0])
def test_hbm_envelope_derives_the_reference_n_hi(extra_gb):
    """``hbm_gb`` → ``plan_budget`` → n_hi, fixed bytes counting only the
    parameters outside ``blocks``: the two backends' derivations at the
    same inputs, then both engines built on the envelope."""
    jcfg, cfg, kw = _configs(FLAGSHIP)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    experts = tp["blocks"]["0"]["moe"]["experts"]
    shapes = {k: tuple(v.shape) for k, v in experts.items()}
    L, E = shapes["w_gate"][:2]
    hi_b = expert_hi_nbytes(shapes, hi_bits=4)
    lo_b = expert_lo_nbytes(shapes, 2)
    nonexp = sum(v.numel() * v.element_size() for k, v in
                 (("embed", tp["embed"]), ("lm_head", tp["lm_head"]),
                  ("norm", tp["final_norm"]["scale"])))
    kv = 1 << 20
    hbm_gb = (nonexp + kv + (64 << 20) + lo_b * L * E) / GiB + extra_gb
    jb = jmake_backend("dynaexq", hbm_gb=hbm_gb, **kw)
    tb = make_backend("dynaexq", hbm_gb=hbm_gb, device="cpu", **kw)
    want = jb._derive_n_hi(jp, kv, shapes, L, E, hi_b, lo_b)
    got = tb._derive_n_hi(tp, kv, L, E, hi_b, lo_b)
    assert got == want
    assert got == min(E, int(extra_gb * GiB) // (hi_b * L))
    small = make_backend("dynaexq", hbm_gb=hbm_gb - extra_gb - 1e-3,
                         device="cpu", **kw)
    with pytest.raises(BudgetExceeded):
        small._derive_n_hi(tp, kv, L, E, hi_b, lo_b)
    if extra_gb == 0.002:
        _, je, te = _engines(FLAGSHIP, hbm_gb=hbm_gb + 0.01)
        n_j = je.backend.controllers["0"].policy.n_hi
        assert te.backend.controllers["0"].policy.n_hi == n_j > 0
        assert tuple(te.backend.banks["0"].slot_owner.shape) == \
            tuple(je.backend.banks["0"].slot_owner.shape)
        assert te.backend.device_bytes() == je.backend.device_bytes()
