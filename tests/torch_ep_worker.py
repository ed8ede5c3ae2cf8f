"""What the expert-parallel tests (``test_torch_ep.py``) run in each rank
of a process group started by ``repro_torch.launch.mesh.spawn``: module
level functions, importable by name, so the ``spawn`` start method finds
them under pytest. The children import torch and the port only (no JAX);
the parent test holds what they return against the port's single-device
path and the reference.

The single-device runs the parent makes use the same helpers
(``serve_engine`` with ``ctx=None``), so both sides build every engine
alike."""
import copy

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.configs import get_config
from repro_torch.core.controller import ControllerConfig, RebalanceConfig
from repro_torch.core.ver import build_bank
from repro_torch.fault.inject import FaultPlan, FaultRule
from repro_torch.launch.dist import dist_ctx, ep_context, shard_range
from repro_torch.models import moe as M
from repro_torch.models.config import MoEConfig
from repro_torch.obs.trace import FlightRecorder
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request

# -- the layer: the reference's SCRIPT_LAYER setup --------------------------
LAYER_CFG = MoEConfig(num_experts=8, top_k=2, d_ff_expert=128,
                      n_shared_experts=0, router_aux_coef=0.01,
                      capacity_factor=2.0, norm_topk_prob=True)
#: (token_valid?, n_rows, row_capacity) cases of the layer comparison.
LAYER_CASES = tuple((tv, n_rows, rc) for tv in (False, True)
                    for n_rows, rc in ((None, None), (16, None), (16, 2)))
#: Hi experts published on slot = expert (shard-correct at N = 2, 4, 8).
HI_EXPERTS = (1, 6)
LAYER_N = (8, 4, 2)
#: Tokens of the padded-regime case: divisible by none of LAYER_N.
T_ODD = 63

# -- the engine: the reference's SCRIPT_ENGINE setup -----------------------
ARCH = "granite-moe-1b-a400m"
NEW_TOKENS = 8
ENGINE_CFG = dict(max_slots=4, max_len=64, prefill_rows=4,
                  moe_dispatch="ragged", spec_k=0)


def frozen():
    """Policy timers that never fire: transitions and rebalances happen
    only when forced, so no comparison depends on the clock."""
    return ControllerConfig(update_interval_s=1e9)


def engine_prompts(vocab: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(1, vocab, (4, 24), dtype=np.int64)


def _layer_bank(experts, n_hi, shard=None):
    """The layer's quantized bank (one layer), hi experts published on
    their own slot numbers; under ``shard=(j, n)`` shard j's part."""
    b = build_bank(experts, n_hi=n_hi, lo_bits=4, group_size=32,
                   shard=shard)
    lo = 0 if shard is None else shard[0] * n_hi // shard[1]
    held = b.hi["w_gate"].shape[1]
    for e in HI_EXPERTS:
        if lo <= e < lo + held:
            for k in b.hi:
                b.hi[k][0, e - lo] = experts[k][0, e]
        b.slot_owner[0, e] = e
        b.slot_map[0, e] = e
    return b.layer(0)


def layer_single(setup):
    """The single-device results of every layer case (the parent's side)."""
    return _layer_runs(setup, None, _layer_bank(setup["experts"], 8))


def _layer_runs(setup, ctx, bank):
    x, tv = setup["x"], setup["tv"]
    params = {"router": setup["router"]}
    cap = M.moe_capacity(x.shape[0], LAYER_CFG)
    out = {}
    with dist_ctx(ctx):
        for case in LAYER_CASES:
            use_tv, n_rows, rc = case
            M.reset_regimes()
            y, aux = M.moe_apply(params, bank, x, LAYER_CFG, cap,
                                 token_valid=tv if use_tv else None,
                                 n_rows=n_rows, row_capacity=rc)
            out[case] = (y, aux._asdict(), dict(M.REGIMES))
        dense = setup["dense"] if ctx is None else {
            k: v[shard_range(v.shape[0], ctx)].clone()
            for k, v in setup["dense"].items()}
        M.reset_regimes()
        y, aux = M.moe_apply(params, dense, x, LAYER_CFG, cap)
        out["dense"] = (y, aux._asdict(), dict(M.REGIMES))
        xo = x[:T_ODD]
        M.reset_regimes()
        y, aux = M.moe_apply(params, bank, xo, LAYER_CFG,
                             M.moe_capacity(T_ODD, LAYER_CFG),
                             token_valid=tv[:T_ODD], n_rows=T_ODD)
        out["odd"] = (y, aux._asdict(), dict(M.REGIMES))
    return out


def _subgroup(ctx, n):
    """A context over ranks [0, n) of the world (every rank must call it),
    or None on the ranks outside."""
    group = None if n == ctx.model_size else tdist.new_group(list(range(n)))
    if ctx.rank >= n:
        return None
    rank = ctx.rank if group is None else tdist.get_rank(group)
    return ep_context(group, rank, n, ctx.device)


def layer_world(ctx, setup):
    """Every layer case at N = 8, then 4 and 2 (groups of the first ranks
    of the world): {N: results} of this rank."""
    out = {}
    for n in LAYER_N:
        sub = _subgroup(ctx, n)
        if sub is not None:
            bank = _layer_bank(setup["experts"], 8, shard=(sub.rank, n))
            out[n] = _layer_runs(setup, sub, bank)
        tdist.barrier()
    return out


# -- engines ----------------------------------------------------------------
def serve_engine(params, backend, ctx=None, prompts=None, new=NEW_TOKENS,
                 bkw=None, ekw=None):
    """One engine over a copy of ``params``: serve ``prompts`` to the end,
    flush. Returns (engine, tokens per request)."""
    cfg = get_config(ARCH, reduced=True)
    be = make_backend(backend, device="cpu", **(bkw or {}))
    eng = InferenceEngine(cfg, copy.deepcopy(params), be,
                          EngineConfig(**dict(ENGINE_CFG, **(ekw or {}))),
                          device="cpu", dist=ctx)
    if prompts is None:
        prompts = engine_prompts(cfg.vocab_size)
    hs = [eng.submit(Request(tokens=p, max_new_tokens=new)) for p in prompts]
    eng.drain()
    eng.flush()
    eng.handles = hs
    return eng, [[int(t) for t in h.tokens] for h in hs]


def dynaexq_kw(n_shards):
    return dict(n_hi_per_layer=4, ep_shards=n_shards, controller=frozen(),
                rebalance=RebalanceConfig(interval_s=1e9)
                if n_shards > 1 else None)


def _run(eng, toks):
    """What a served engine hands back: tokens, last decode logits, the
    per-request expert counts."""
    return {"tokens": toks, "logits": eng.last_logits.clone(),
            "expert_counts": [{k: v.copy() for k, v in h.expert_counts.items()}
                              for h in eng.handles]}


def _shard_correct(be) -> bool:
    for ctl in be.controllers.values():
        ctl.tm.check_invariants()
        for l in range(ctl.tm.state.shape[0]):
            for e, s in enumerate(ctl.tm.slot_map_h[l]):
                if s >= 0 and ctl.tm.pools[l].shard_of(int(s)) != \
                        ctl.tm.shard_of_expert(e):
                    return False
    return True


def _hi_rows_landed(be, ctx) -> bool:
    """This rank's published hi slots hold their owners' host rows."""
    for ctl in be.controllers.values():
        tm = ctl.tm
        per = tm.pools[0].per_shard
        for l, s in zip(*np.nonzero(tm.slot_owner_h >= 0)):
            if tm.pools[l].shard_of(int(s)) != ctx.rank:
                continue
            e = int(tm.slot_owner_h[l, s])
            for name, leaf in ctl.bank.hi.items():
                if not torch.equal(leaf[l, s - ctx.rank * per],
                                   tm.host_hi[name][l, e]):
                    return False
    return True


def engine_world_4(ctx, params):
    """N = 4: dynaexq served, then forced promotions."""
    M.reset_regimes()
    eng, toks = serve_engine(params, "dynaexq", ctx, bkw=dynaexq_kw(4))
    out = {"dynaexq": _run(eng, toks), "regimes": dict(M.REGIMES)}
    be = eng.backend
    be.force_update()
    be.flush()
    out["shard_correct"] = _shard_correct(be)
    out["promoted"] = sum(c.tm.stats["promoted"]
                          for c in be.controllers.values())
    out["hi_rows_landed"] = _hi_rows_landed(be, ctx)
    out["slot_maps"] = {k: c.tm.slot_map_h.copy()
                        for k, c in be.controllers.items()}
    return out


def _layer_forward(eng, ctx, x):
    """MoE position 0's first layer on ``x`` under ``ctx``: (y, counts)."""
    pos = eng.backend.moe_positions[0]
    ctl = eng.backend.controllers[str(pos)]
    moe = eng.params["blocks"][str(pos)]["moe"]
    cfg = eng.cfg
    with dist_ctx(ctx):
        y, aux = M.moe_apply({"router": moe["router"][0]},
                             ctl.bank.layer(0), x, cfg.moe,
                             M.moe_capacity(x.shape[0], cfg.moe,
                                            eng.ecfg.capacity_factor))
    return y, aux.counts


def _rebalance(eng, ctx):
    """The reference's glitch-free rebalance: +100 counts on experts 0 and
    1 (shard 0), a forced window, the layer before and after."""
    be = eng.backend
    ctl = be.controllers[str(be.moe_positions[0])]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (8, eng.cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y0, c0 = _layer_forward(eng, ctx, x)
    ctl.hotness.counts[:, 0] += 100
    ctl.hotness.counts[:, 1] += 100
    placement = be.coordinator._entries[0][2]
    before = placement.copy()
    n = be.coordinator.maybe_rebalance(force=True)
    y1, c1 = _layer_forward(eng, ctx, x)
    for c in be.controllers.values():
        c.tm.check_invariants()
    return {"migrated": n, "placement_before": before,
            "placement_after": placement.copy(), "y_before": y0,
            "y_after": y1, "counts_before": c0, "counts_after": c1,
            "stats": {k: be.stats()[k] for k in
                      ("migrations", "bytes_moved", "fault_cancels")}}


def _bank_state(eng):
    """Copies of what a migration touches: every position's local lo
    leaves, its router and placement."""
    be = eng.backend
    out = {}
    for i, (ctl, moe, placement) in enumerate(be.coordinator._entries):
        out[i] = ({n: (q.packed.clone(), q.scales.clone())
                   for n, q in ctl.bank.lo.items()},
                  moe["router"].clone(), placement.copy())
    return out


def _same_state(a, b) -> bool:
    for i in a:
        lo_a, r_a, p_a = a[i]
        lo_b, r_b, p_b = b[i]
        if not (torch.equal(r_a, r_b) and np.array_equal(p_a, p_b)):
            return False
        for n in lo_a:
            if not all(torch.equal(x, y) for x, y in zip(lo_a[n], lo_b[n])):
                return False
    return True


def _ep_mig_faults(eng, ctx):
    """An ``ep_mig`` fault mid-swap (corrupt) and one before the swap
    (fail), each on a pair across the two shards."""
    be = eng.backend
    coord = be.coordinator
    ctl, moe, placement = coord._entries[0]
    tracer = FlightRecorder()
    coord.tracer = tracer
    out = {}
    E = ctl.tm.state.shape[1]
    e, f = 0, E - 1                      # shard 0 and the last shard
    ctl.tm.rate_limit = 1 << 40          # metered, never binding
    for kind in ("corrupt", "fail"):
        coord.injector = FaultPlan(seed=3, rules=(
            FaultRule(site="ep_mig", kind=kind, every=1),)).injector()
        before = _bank_state(eng)
        aborted = coord.stats["aborted_migrations"]
        ctl.tm._window_used = 0
        ok = coord._migrate(ctl, moe, placement, 0, e, f)
        out[kind] = {"migrated": ok, "same": _same_state(before,
                                                         _bank_state(eng)),
                     "aborted": coord.stats["aborted_migrations"] - aborted,
                     "window_used": ctl.tm._window_used}
    out["fault_cancel_events"] = [ev.args for ev in
                                  tracer.instants("fault_cancel")]
    out["fault_cancels"] = be.stats()["fault_cancels"]
    # The same pair without a fault: it moves, and its bytes stay charged.
    coord.injector = None
    ctl.tm._window_used = 0
    before = _bank_state(eng)
    out["clean"] = {"migrated": coord._migrate(ctl, moe, placement, 0, e, f),
                    "same": _same_state(before, _bank_state(eng)),
                    "window_used": ctl.tm._window_used}
    out["migration_events"] = [ev.args for ev in
                               tracer.instants("ep_migration")]
    coord.tracer = None
    return out


def engine_world_2(ctx, params):
    """N = 2: dynaexq served, the forced rebalance, the ep_mig faults, then
    spec_k=2, padded dispatch on dense rows, static and fp16."""
    M.reset_regimes()
    eng, toks = serve_engine(params, "dynaexq", ctx, bkw=dynaexq_kw(2))
    out = {"dynaexq": _run(eng, toks), "regimes": dict(M.REGIMES)}
    out["rebalance"] = _rebalance(eng, ctx)
    out["ep_mig"] = _ep_mig_faults(eng, ctx)
    for name, backend, bkw, ekw in ENGINE_VARIANTS:
        M.reset_regimes()
        e2, toks = serve_engine(params, backend, ctx, bkw=bkw(2), ekw=ekw)
        out[name] = dict(_run(e2, toks), regimes=dict(M.REGIMES))
    return out


#: (name, backend, backend kwargs by shard count, engine overrides) of the
#: further N = 2 runs.
ENGINE_VARIANTS = (
    ("spec", "dynaexq", dynaexq_kw, dict(spec_k=2)),
    ("padded_dense", "static", lambda n: {},
     dict(paged=False, moe_dispatch="padded")),
    ("static", "static", lambda n: {}, {}),
    ("fp16", "fp16", lambda n: {}, {}),
    ("offload", "offload", lambda n: {}, {}),
)
