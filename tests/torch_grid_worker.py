"""What the grid-engine tests (``test_torch_grid_engine.py``) run in each
rank of a (data × model) grid started by ``repro_torch.launch.mesh.spawn(
..., n_data=2)``: module-level functions, importable by name, so the
``spawn`` start method finds them under pytest. The children import torch
and the port only (no JAX); the parent test holds what they return against
the port's single-device engine and the reference's.

Two worlds: a 2 × 2 grid (two data rows of a 2-rank model group, two
experts per rank) and a 2 × 1 grid (two data rows, every expert on each:
the residency ladder's options, which need one shard). The single-device
runs in the parent use the same helpers with ``ctx=None``."""
import copy

import numpy as np
import torch

import torch_ep_worker as EW
import torch_families_worker as FW
from repro_torch.configs import get_config
from repro_torch.fault.inject import FaultPlan, FaultRule
from repro_torch.launch import dist as D
from repro_torch.models import moe as M
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.hoststore import FetchModel
from repro_torch.serving.requests import Request
from repro_torch.serving.streaming import load_streaming_params

#: Promotion copies that fail half the time (retried, then cancelled).
PROMO_FAULTS = FaultPlan(seed=1, rules=(
    FaultRule(site="promo_copy", kind="fail", prob=0.6),))
#: Host-tier and staging faults of the cold start (retried, quarantined).
LADDER_FAULTS = FaultPlan(seed=2, rules=(
    FaultRule(site="stage_lo", kind="fail", prob=0.3),
    FaultRule(site="host_hi", kind="stall", prob=0.5, stall_s=0.01)))
#: The host tier: 5 of the 2 × 4 (layer, expert) cells lo-resident.
HOST_TIER = dict(lo_resident_total=5, fetch=FetchModel(gbps=1.0))
#: Hi slots per layer of the ladder runs (of 4 experts: the rest lo or
#: host).
LADDER_N_HI = 1
#: The per-row drop rule's capacity under the planner's specs (it drops).
ROW_CAP = 1
#: (dispatch, all-to-all over the model axis) of the specs cases.
SPEC_CASES = (("padded", False), ("ragged", True))


def bank_state(be) -> dict:
    """Copies of what every data row must hold alike: per position the
    rank's lo and hi leaves, the slot map and owners, the router leaf and
    the coordinator's placement."""
    out = {}
    for pos, bank in be.banks.items():
        st = {f"lo.{n}": (q.packed.clone(), q.scales.clone())
              for n, q in bank.lo.items()}
        st.update({f"hi.{n}": (t.clone(),) for n, t in bank.hi.items()})
        st["maps"] = (bank.slot_map.clone(), bank.slot_owner.clone())
        out[pos] = st
    if be.coordinator is not None:
        for i, (ctl, moe, placement) in enumerate(be.coordinator._entries):
            out[f"router.{i}"] = {"router": (moe["router"].clone(),),
                                  "placement": (torch.from_numpy(
                                      placement.copy()),)}
    return out


def _experts(params, pos):
    return params["blocks"][str(pos)]["moe"]["experts"]


def _placement(be, pos):
    for ctl, _, placement in be.coordinator._entries:
        if ctl is be.controllers[str(pos)]:
            return placement
    raise KeyError(pos)


def host_rows_follow(be, params) -> bool:
    """Every host master this rank holds equals the weights of the expert
    its position now carries (``placement``) in the original ``params``;
    the store holds only this rank's experts."""
    for pos, store in be.stores.items():
        placement = _placement(be, pos)
        lo = store.owned.start
        for name, held in store.held_rows().items():
            if held.shape[1] != store.owned.stop - lo:
                return False
            want = _experts(params, pos)[name]
            for l in range(held.shape[0]):
                for p in range(lo, store.owned.stop):
                    if not torch.equal(held[l, p - lo],
                                       want[l, placement[l, p]]):
                        return False
    return True


def slots_hold_weights(be, ctx, params) -> bool:
    """Every hi slot this rank holds carries, bit for bit, the bf16 weights
    of the expert published on it (through ``placement``)."""
    for pos, ctl in be.controllers.items():
        tm = ctl.tm
        placement = _placement(be, pos)
        per = tm.pools[0].per_shard
        for l, s in zip(*np.nonzero(tm.slot_owner_h >= 0)):
            if tm.pools[l].shard_of(int(s)) != ctx.rank:
                continue
            e = int(tm.slot_owner_h[l, s])
            for name, leaf in ctl.bank.hi.items():
                w = _experts(params, pos)[name][l, placement[l, e]]
                if not torch.equal(leaf[l, s - ctx.rank * per], w):
                    return False
    return True


def _promote_moved(eng, ctx, params) -> dict:
    """After the rebalance: the moved positions made hottest and a forced
    window. Which moved positions went hi, whether every published expert
    sits on a slot of its own shard, the owner's slot holds its host rows,
    and every slot the weights of the expert its position now carries."""
    be = eng.backend
    pos = str(be.moe_positions[0])
    ctl = be.controllers[pos]
    placement = _placement(be, pos)
    moved = placement != np.arange(placement.shape[1])[None, :]
    ctl.hotness.counts[moved] += 1000
    be.force_update()
    be.flush()
    hi = ctl.tm.slot_map_h >= 0
    return {"moved": int(moved.sum()), "moved_hi": int((moved & hi).sum()),
            "slots_hold_weights": slots_hold_weights(be, ctx, params),
            "shard_correct": EW._shard_correct(be),
            "landed": EW._hi_rows_landed(be, ctx),
            "promoted": sum(c.tm.stats["promoted"]
                            for c in be.controllers.values()),
            "state": bank_state(be)}


def _second_batch(eng) -> list:
    """A forced policy window, then 4 more requests served: their
    tokens."""
    eng.backend.force_update()
    eng.backend.flush()
    rng = np.random.default_rng(1)
    hs = [eng.submit(Request(tokens=p, max_new_tokens=EW.NEW_TOKENS))
          for p in rng.integers(1, eng.cfg.vocab_size, (4, 24),
                                dtype=np.int64)]
    eng.drain()
    eng.flush()
    return [[int(t) for t in h.tokens] for h in hs]


def serve_faulted(params, ctx):
    """dynaexq under ``PROMO_FAULTS`` at 2 shards: 4 requests served, a
    forced window (its copies failing, retried, cancelled), 4 more
    requests. Returns the tokens of both batches, the last logits, the
    fault cancels and promotions, and the slot maps."""
    be_kw = dict(EW.dynaexq_kw(2), fault=PROMO_FAULTS)
    eng, first = EW.serve_engine(params, "dynaexq", ctx, bkw=be_kw)
    be = eng.backend
    second = _second_batch(eng)
    st = be.stats()
    return {"tokens": first + second,
            "logits": eng.last_logits.clone(),
            "fault_cancels": st["fault_cancels"],
            "retries": st["retries"], "promotions": st["promotions"],
            "slot_maps": {k: c.tm.slot_map_h.copy()
                          for k, c in be.controllers.items()}}


def serve_rows(params, ctx, ekw):
    """dynaexq at ``ctx.model_size`` shards with engine overrides
    ``ekw``: the run, its regimes, each request's routing counts summed
    over every forward that carried it (a forward's row, or its (nsb, E)
    totals where it had no per-row counts) and the count ranks seen; or
    the ``ValueError`` it raised."""
    M.reset_regimes()
    routed, ndims = {}, set()
    note = InferenceEngine._note_degraded

    def record(eng, counts_np, rows):
        for k, v in counts_np.items():
            ndims.add(v.ndim)
            for r, h in rows:
                acc = routed.setdefault(h.id, {})
                acc[k] = acc.get(k, 0) + (v[:, r] if v.ndim == 3 else
                                          v).astype(np.int64)
        return note(eng, counts_np, rows)

    InferenceEngine._note_degraded = record
    try:
        eng, toks = EW.serve_engine(params, "dynaexq", ctx,
                                    bkw=EW.dynaexq_kw(
                                        1 if ctx is None else
                                        ctx.model_size), ekw=ekw)
    except ValueError as err:
        return {"error": str(err), "regimes": dict(M.REGIMES)}
    finally:
        InferenceEngine._note_degraded = note
    return dict(EW._run(eng, toks), regimes=dict(M.REGIMES),
                routed=[routed[h.id] for h in eng.handles],
                count_ndims=sorted(ndims))


def serve_tiers(params, ctx):
    """dynaexq with every expert published hi (a forced window on given
    counts), then 4 requests: two in the batch tier, decoding on the
    all-lo view, two standard on the served banks; after 3 steps the
    first standard request is preempted (its rows to the host) and later
    resumed. Returns the run, its regimes, preemptions and resumes."""
    cfg = get_config(EW.ARCH, reduced=True)
    n = 1 if ctx is None else ctx.model_size
    be = make_backend("dynaexq", device="cpu", **EW.dynaexq_kw(n))
    eng = InferenceEngine(cfg, copy.deepcopy(params), be,
                          EngineConfig(**EW.ENGINE_CFG), device="cpu",
                          dist=ctx)
    for ctl in be.controllers.values():
        ctl.observe(np.tile(np.arange(1.0, cfg.moe.num_experts + 1),
                            (ctl.tm.state.shape[0], 1)))
    be.force_update()
    be.flush()
    M.reset_regimes()
    hs = [eng.submit(Request(tokens=p, max_new_tokens=EW.NEW_TOKENS,
                             qos=q))
          for p, q in zip(EW.engine_prompts(cfg.vocab_size),
                          ("batch", "standard", "batch", "standard"))]
    for _ in range(3):
        eng.step()
    eng.preempt(hs[1])
    eng.drain()
    eng.flush()
    eng.handles = hs
    st = eng.stats()
    return dict(EW._run(eng, [[int(t) for t in h.tokens] for h in hs]),
                regimes=dict(M.REGIMES), preemptions=st["preemptions"],
                resumes=st["resumes"],
                hi=sum(len(s) for sets in be.hi_sets().values()
                       for s in sets))


def specs_data(cfg):
    g = torch.Generator().manual_seed(11)
    return {"tokens": torch.randint(1, cfg.vocab_size, (4, 20),
                                    generator=g)}


def specs_runs(params, ctx):
    """``prefill`` and 4 decode steps with ``row_capacity`` under the
    planner's specs (``ctx`` None: one process), for each of
    ``SPEC_CASES``."""
    cfg = get_config(EW.ARCH, reduced=True)
    out = {}
    for dispatch, ep in SPEC_CASES:
        out[dispatch] = FW.serve(cfg, params, None, specs_data(cfg), ctx,
                                 48, dispatch=dispatch, ep=ep,
                                 row_capacity=ROW_CAP)
    return out


def world_2x2(ctx, params):
    """The 2 × 2 grid: dynaexq on the main path, a rebalance, forced
    promotions after it, ``ep_mig`` faults; the variants; a
    promotion fault plan; the batch tier and a preemption; the one-row prefill with and without the
    per-row rule; the per-row rule under the planner's specs."""
    out = {"coords": (ctx.data_rank, ctx.rank)}
    M.reset_regimes()
    eng, toks = EW.serve_engine(params, "dynaexq", ctx,
                                bkw=EW.dynaexq_kw(2))
    out["dynaexq"] = EW._run(eng, toks)
    out["regimes"] = dict(M.REGIMES)
    be = eng.backend
    out["clocks"] = sorted({be._last_global, be.coordinator._last} |
                           {c._last_update for c in be.controllers.values()})
    out["device_bytes"] = be.device_bytes()
    out["host_master_bytes"] = be.host_master_bytes()
    D.reset_sent()
    relabelled = be.coordinator.stats["bytes_moved"]
    out["rebalance"] = EW._rebalance(eng, ctx)
    out["rebalance"]["lo_bytes"] = \
        be.coordinator.stats["bytes_moved"] - relabelled
    out["rebalance"]["sent"] = {k: dict(v) for k, v in
                                D.SENT_BYTES.items()}
    out["rebalance"]["host_rows_follow"] = host_rows_follow(be, params)
    out["rebalance"]["state"] = bank_state(be)
    out["promo"] = _promote_moved(eng, ctx, params)
    out["ep_mig"] = EW._ep_mig_faults(eng, ctx)
    out["ep_mig"]["host_rows_follow"] = host_rows_follow(be, params)
    out["ep_mig"]["state"] = bank_state(be)
    for name, backend, bkw, ekw in EW.ENGINE_VARIANTS:
        M.reset_regimes()
        e2, toks = EW.serve_engine(params, backend, ctx, bkw=bkw(2),
                                   ekw=ekw)
        out[name] = dict(EW._run(e2, toks), regimes=dict(M.REGIMES),
                         host_master_bytes=e2.backend.host_master_bytes())
    out["faulted"] = serve_faulted(params, ctx)
    out["tiers"] = serve_tiers(params, ctx)
    out["one_row"] = serve_rows(params, ctx, dict(prefill_rows=1))
    out["one_row_rc"] = serve_rows(params, ctx, dict(
        prefill_rows=1, row_capacity_norm=True))
    out["rows_rc"] = serve_rows(params, ctx, dict(row_capacity_norm=True))
    out["specs"] = specs_runs(params, ctx)
    return out


def serve_ladder(params, ctx, shard_dir=None, fault=None, host_tier=False):
    """dynaexq at one shard with the residency ladder's options: the host
    tier (``HOST_TIER``), the streaming cold start from ``shard_dir`` and
    a fault plan; 4 requests, a forced window (the allocator cedes cells
    to the host tier), 4 more. Returns the run, the ladder's stats, the
    shard bytes read before serving opened and the host-master bytes."""
    bkw = dict(EW.dynaexq_kw(1), n_hi_per_layer=LADDER_N_HI)
    if host_tier:
        bkw.update(HOST_TIER)
    if fault is not None:
        bkw["fault"] = fault
    if shard_dir is not None:
        bkw.update(stream=shard_dir, stream_experts_per_tick=3)
        params = load_streaming_params(shard_dir, device="cpu")
    cfg = get_config(EW.ARCH, reduced=True)
    be = make_backend("dynaexq", device="cpu", **bkw)
    eng = InferenceEngine(cfg, copy.deepcopy(params), be,
                          EngineConfig(**EW.ENGINE_CFG), device="cpu",
                          dist=ctx)
    hs = [eng.submit(Request(tokens=p, max_new_tokens=EW.NEW_TOKENS))
          for p in EW.engine_prompts(cfg.vocab_size)]
    # The shard bytes read before serving opened (streaming only).
    ready_read = None
    while eng.queue or any(h is not None for h in eng.slots):
        if ready_read is None and be.serving_ready() and be.stream:
            ready_read = be.stream.stats["bytes_read"]
        eng.step()
    eng.flush()
    first = [[int(t) for t in h.tokens] for h in hs]
    eng.handles = hs
    counts = EW._run(eng, first)["expert_counts"]
    second = _second_batch(eng)
    st = be.stats()
    return dict(tokens=first + second, logits=eng.last_logits.clone(),
                expert_counts=counts,
                stats={k: st[k] for k in (
                    "host_fetches", "retries", "fault_cancels",
                    "lo_resident_frac", "quarantined", "hi_loads",
                    "promotions")},
                host_master_bytes=be.host_master_bytes(),
                ready_read=ready_read,
                mix=be.residency_mix())


#: name → serve_ladder options of the 2 × 1 grid's ladder runs.
LADDER_RUNS = {"host_tier": dict(host_tier=True),
               "stream": dict(stream=True),
               "stream_faults": dict(stream=True, host_tier=True,
                                     fault=LADDER_FAULTS)}


def ladder_runs(params, ctx, shard_dir):
    out = {}
    for name, kw in LADDER_RUNS.items():
        kw = dict(kw)
        d = shard_dir if kw.pop("stream", False) else None
        out[name] = serve_ladder(params, ctx, d, **kw)
    return out


def world_2x1(ctx, params, shard_dir):
    """The 2 × 1 grid: dynaexq on the main path and forced promotions,
    then the residency ladder's runs."""
    out = {"coords": (ctx.data_rank, ctx.rank)}
    M.reset_regimes()
    eng, toks = EW.serve_engine(params, "dynaexq", ctx,
                                bkw=EW.dynaexq_kw(1))
    out["dynaexq"] = EW._run(eng, toks)
    out["regimes"] = dict(M.REGIMES)
    be = eng.backend
    out["host_master_bytes"] = be.host_master_bytes()
    be.force_update()
    be.flush()
    out["promo"] = {"state": bank_state(be),
                    "slot_maps": {k: c.tm.slot_map_h.copy()
                                  for k, c in be.controllers.items()}}
    out["ladder"] = ladder_runs(params, ctx, shard_dir)
    return out
