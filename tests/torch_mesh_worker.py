"""What the mesh tests (``test_torch_mesh.py``) run in each rank of one
4-rank gloo world started by ``repro_torch.launch.mesh.spawn(...,
n_data=2)``: module-level functions, importable by name, so
the ``spawn`` start method finds them under pytest. The children import
torch and the port only (no JAX); the parent test holds what they return
against the port's single-device path and the reference.

The world is a 2 × 2 (data × model) grid; ranks 0-2 also form a 1 × 3
grid (``grid_context(..., ranks=[0, 1, 2])``, which rank 3 enters too).
The single-device runs use the same helpers with ``ctx=None``."""
import dataclasses

import torch

from repro_torch.launch import dist as D
from repro_torch.launch.dist import dist_ctx
from repro_torch.launch.mesh import grid_context
from repro_torch.launch.sharding import bank_shard
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import MoEConfig
from repro_torch.models.model import (decode_step, forward_train,
                                      init_caches, prefill)
from repro_torch.training.train import TrainConfig, loss_fn

ARCH = "granite-moe-1b-a400m"
#: Dense-row batch of the model runs: B rows of S prompt tokens, then one
#: decode step; drop-free capacity (the reference's distributed test).
B, S, MAX_LEN, CF = 4, 16, 64, 8.0
#: Hi experts published per layer, by slot: slot s sits on model shard s
#: at N = 2, and so does its expert (experts 0-1 on shard 0, 2-3 on 1).
HI_OWNERS = ((0, 1), (1, 3))
#: The sequence-parallel stack: 4 heads over a model axis of 3, S a
#: multiple of 3; E = 6 divides over it, E = 4 does not (the whole-bank
#: fallback).
SP_B, SP_S = 2, 12
#: The layer cases of the padded data-split regime: T tokens in rows.
LAYER_T = 64
LAYER_CFG = MoEConfig(num_experts=4, top_k=2, d_ff_expert=512,
                      n_shared_experts=0, router_aux_coef=0.01,
                      capacity_factor=2.0, norm_topk_prob=True)


def with_experts(params, experts_of):
    """``params`` with each MoE position's dense experts replaced by
    ``experts_of(experts)``."""
    blocks = {}
    for pos, bp in params["blocks"].items():
        if "moe" in bp:
            bp = dict(bp, moe=dict(bp["moe"],
                                   experts=experts_of(bp["moe"]["experts"])))
        blocks[pos] = bp
    return dict(params, blocks=blocks)


def model_run(cfg, params, tokens, ctx, bank=None, dispatch="padded"):
    """Prefill B rows of S tokens on dense rows under ``ctx`` (None: one
    device), then, in bf16, one decode step of the token after them; in
    float32 (the decode-attention kernels take bf16 only) the
    teacher-forced ``forward_train`` logits of the same rows instead.
    Returns {"prefill", "decode" or "train" logits, "counts", "counts2",
    "regimes"}."""
    f32 = params["embed"].dtype == torch.float32
    caches = init_caches(cfg, B, MAX_LEN, device="cpu")
    if f32:
        caches = {k: type(c)(*(t.float() for t in c))
                  for k, c in caches.items()}
    M.reset_regimes()
    with torch.no_grad(), dist_ctx(ctx):
        lg, c1 = prefill(params, cfg, tokens[:, :S], caches,
                         torch.full((B,), S), bank=bank, capacity_factor=CF,
                         moe_dispatch=dispatch)
        if f32:
            lg2, aux = forward_train(params, cfg, {"tokens": tokens[:, :S]},
                                     capacity_factor=CF, remat=False)
            c2 = aux["counts"]
        else:
            lg2, c2 = decode_step(params, cfg, tokens[:, S],
                                  torch.full((B,), S), caches, bank=bank,
                                  capacity_factor=CF, moe_dispatch=dispatch)
    return {"prefill": lg, "train" if f32 else "decode": lg2, "counts": c1,
            "counts2": c2, "regimes": dict(M.REGIMES)}


def layer_runs(setup, ctx, bank):
    """The padded data-split regime at the layer (LAYER_T tokens): all
    tokens, and token_valid with 16 rows; then rows that do not tile over
    data (15 rows of 4 of 60 tokens) without and with a row capacity."""
    x, tv = setup["x"], setup["tv"]
    params = {"router": setup["router"]}
    cap = M.moe_capacity(LAYER_T, LAYER_CFG)
    out = {}
    with torch.no_grad(), dist_ctx(ctx):
        for name, kw in (("all", {}), ("rows", dict(token_valid=tv,
                                                    n_rows=16))):
            M.reset_regimes()
            y, aux = M.moe_apply(params, bank, x, LAYER_CFG, cap,
                                 dispatch="padded", **kw)
            out[name] = (y, aux._asdict(), dict(M.REGIMES))
        if ctx is not None:
            y, aux = M.moe_apply(params, bank, x[:60], LAYER_CFG, cap,
                                 n_rows=15, dispatch="padded")
            out["untiled_rows"] = aux.row_counts
            try:
                M.moe_apply(params, bank, x[:60], LAYER_CFG, cap,
                            n_rows=15, row_capacity=2, dispatch="padded")
                out["untiled_row_capacity"] = None
            except ValueError as e:
                out["untiled_row_capacity"] = str(e)
    return out


def sp_run(cfg, params, tokens, ctx):
    """``forward_train`` (float32, padded dispatch, no remat, no autograd)
    and its loss under ``ctx``: (logits, loss, counts, regimes, the
    sequence-parallel attention calls)."""
    M.reset_regimes()
    L.SEQ_PARALLEL["attention_full"] = 0
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with torch.no_grad(), dist_ctx(ctx):
        logits, aux = forward_train(params, cfg, batch, capacity_factor=CF,
                                    remat=False)
        loss, parts = loss_fn(params, cfg, batch,
                              TrainConfig(capacity_factor=CF, remat=False))
    return {"logits": logits, "loss": loss, "counts": aux["counts"],
            "regimes": dict(M.REGIMES),
            "seq_parallel": L.SEQ_PARALLEL["attention_full"]}


def fallback_layer(setup, ctx):
    """The whole-bank fallback at the layer: E = 4 experts over a model
    axis of 3 on every rank's whole bank (y and MoEAux), and the
    ValueError of a rank that holds a shard of such a bank."""
    params = {"router": setup["router"]}
    bank = setup["bank_layer"]
    cap = M.moe_capacity(LAYER_T, LAYER_CFG)
    M.reset_regimes()
    with torch.no_grad(), dist_ctx(ctx):
        y, aux = M.moe_apply(params, bank, setup["x"], LAYER_CFG, cap,
                             token_valid=setup["tv"], n_rows=16)
        regimes = dict(M.REGIMES)
        try:
            part = dataclasses.replace(
                bank, lo={n: q[:1] for n, q in bank.lo.items()})
            M.moe_apply(params, part, setup["x"], LAYER_CFG, cap)
            shard_error = None
        except ValueError as e:
            shard_error = str(e)
    return {"y": y, "aux": aux._asdict(), "regimes": regimes,
            "shard_error": shard_error}


def bank_bytes(banks) -> int:
    """Device bytes of the expert banks' leaves (lo codes and scales, hi
    pool), over every MoE position."""
    return sum(t.numel() * t.element_size() for b in banks.values()
               for t in [x for q in b.lo.values() for x in (q.packed,
                                                          q.scales)]
               + list(b.hi.values()))


def grid_world(ctx, setup):
    """One rank of the 2 × 2 grid (``ctx``: ``make_ep_mesh(2, 2)``, the
    all-to-all regime (c)): regimes (a), (b) and (c) on the model ((a)
    also in float32 on the dense experts, (c) also on them in bf16), (a)
    at the layer, the sent bytes of one decode-shaped (c) layer call;
    then, on ranks 0-2 of a 1 × 3 grid, sequence-parallel forward_train
    over E = 6 and E = 4 and the whole-bank fallback at the layer."""
    cfg, tokens = setup["cfg"], setup["tokens"]
    out = {"coords": (ctx.data_rank, ctx.rank)}
    ctx_a = dataclasses.replace(ctx, tokens_ep_sharded=False)
    p32 = with_experts(setup["params32"], lambda e: bank_shard(e, ctx_a))
    out["a"] = model_run(cfg, p32, tokens, ctx_a)
    bank = setup["bank"]                 # {MoE position: stacked bank}
    a_bank = {k: bank_shard(b, ctx_a) for k, b in bank.items()}
    out["a_bank"] = model_run(cfg, setup["params"], tokens, ctx_a,
                              bank=a_bank)
    out["a_layer"] = layer_runs(setup, ctx_a,
                                bank_shard(setup["bank_layer"], ctx_a))
    ctx_b = dataclasses.replace(ctx_a, tokens_dp_sharded=False)
    b_bank = {k: bank_shard(b, ctx_b, ff=True) for k, b in bank.items()}
    out["b"] = model_run(cfg, setup["params"], tokens, ctx_b, bank=b_bank)
    out["bytes"] = {"full": bank_bytes(bank), "a": bank_bytes(a_bank),
                    "b": bank_bytes(b_bank)}
    ctx_c = ctx
    out["c"] = model_run(cfg, setup["params"], tokens, ctx_c, bank=a_bank,
                         dispatch="ragged")
    out["c_dense"] = model_run(
        cfg, with_experts(setup["params"], lambda e: bank_shard(e, ctx_c)),
        tokens, ctx_c, dispatch="ragged")
    # One decode-shaped layer call of (c): the bytes each collective sent.
    x = setup["x"][:B]
    D.reset_sent()
    with torch.no_grad(), dist_ctx(ctx_c):
        M.moe_apply({"router": setup["router"]}, bank_shard(
            setup["bank_layer"], ctx), x, LAYER_CFG,
            M.moe_capacity(B, LAYER_CFG))
    out["c_sent"] = {k: dict(v) for k, v in D.SENT_BYTES.items()}
    sub = grid_context(1, 3, ranks=[0, 1, 2], device=ctx.device)
    if sub is not None:
        p6 = with_experts(setup["sp_params6"], lambda e: bank_shard(e, sub))
        out["sp6"] = sp_run(setup["sp_cfg6"], p6, setup["sp_tokens"], sub)
        out["sp4"] = sp_run(cfg, setup["params32"], setup["sp_tokens"], sub)
        out["fallback"] = fallback_layer(setup, sub)
    return out

