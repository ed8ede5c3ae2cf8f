"""What the dry-run tests (``test_torch_dryrun.py``) run twice: in each
rank of one 4-rank gloo world (a 2 × 2 grid started by
``repro_torch.launch.mesh.spawn(..., n_data=2)``) on real tensors, and in
the test's own process on ``meta`` tensors under
``launch.dist.dry_run()`` with ``launch.mesh.dry_context``'s rank. Each
function returns the bytes every collective sent (``launch.dist.
SENT_BYTES``) by phase, so the two runs can be held equal to the byte.
Module-level functions, importable by name (the ``spawn`` start method
finds them under pytest); no JAX."""
import torch

from repro_torch.launch import dist as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import dist_ctx
from repro_torch.models.model import decode_step, init_caches, prefill
from repro_torch.training.adamw import adamw_init
from repro_torch.training.train import TrainConfig, make_train_step

import torch_specs_worker as W


def sent() -> dict:
    """``SENT_BYTES`` without the zeros."""
    return {c: {a: b for a, b in per.items() if b}
            for c, per in D.SENT_BYTES.items() if any(per.values())}


def serve_sent(cfg, params, bank, tokens, ctx, dispatch="padded",
               ep=False) -> dict:
    """The bytes sent by a prefill of ``tokens[:, :S]`` (B rows) into dense
    rows and by the first decode step after it, under ``ctx`` with the
    planner (``torch_specs_worker.planned``)."""
    dev = ctx.device
    B = tokens.shape[0]
    caches = init_caches(cfg, B, W.MAX_LEN, device=dev)
    inputs = {"tokens": tokens[:, :W.S],
              "lengths": torch.full((B,), W.S, device=dev)}
    step = {"token": tokens[:, W.S], "pos": torch.full((B,), W.S,
                                                        device=dev)}
    ctx = W.planned(ctx, cfg, B, ep=ep)
    pl = ctx.planner
    params = SH.shard_tree(params, "param", pl, ctx)
    if bank is not None:
        bank = SH.shard_tree(bank, "param", pl, ctx)
    caches = SH.shard_tree(caches, "cache", pl, ctx)
    inputs = SH.shard_tree(inputs, "input", pl, ctx)
    step = SH.shard_tree(step, "input", pl, ctx)
    out = {}
    with torch.no_grad(), dist_ctx(ctx):
        D.reset_sent()
        prefill(params, cfg, inputs["tokens"], caches, inputs["lengths"],
                bank=bank, capacity_factor=W.CF, moe_dispatch=dispatch)
        out["prefill"] = sent()
        D.reset_sent()
        decode_step(params, cfg, step["token"], step["pos"], caches,
                    bank=bank, capacity_factor=W.CF, moe_dispatch=dispatch)
        out["decode"] = sent()
    return out


def train_sent(cfg, params, tokens, ctx) -> dict:
    """The bytes sent by one train step (FSDP specs, forward, backward,
    gradient sums and the AdamW update) on ``tokens`` (B, S + 1)."""
    B = tokens.shape[0]
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tcfg = TrainConfig(capacity_factor=W.CF)
    opt = adamw_init(params)
    ctx = W.planned(ctx, cfg, B, fsdp=True)
    pl = ctx.planner
    params = SH.shard_tree(params, "param", pl, ctx)
    opt = SH.shard_tree(opt, "param", pl, ctx)
    batch = SH.shard_tree(batch, "input", pl, ctx)
    D.reset_sent()
    with dist_ctx(ctx):
        make_train_step(cfg, tcfg)(params, opt, batch)
    return {"train": sent()}


def collectives(ctx) -> dict:
    """Every collective once over each axis on a (2N, 3) float32 tensor
    (the exchange: uneven pieces), and ``agree``: {(name, axis): (the
    bytes sent, the result's shape)}."""
    out = {}
    for axis in ("model", "data", "tokens"):
        _, r, n = ctx.axis(axis)
        x = torch.ones((2 * n, 3), dtype=torch.float32, device=ctx.device)
        send = [x[s:s + 1 + (r + s) % 2] for s in range(n)]
        like = [torch.empty((1 + (s + r) % 2, 3), device=ctx.device)
                for s in range(n)]
        calls = {
            "all_to_all": lambda: D.all_to_all(x, ctx, axis),
            "exchange": lambda: torch.cat(D.exchange(send, like, ctx, axis)),
            "all_gather": lambda: D.all_gather(x, ctx, axis, dim=1),
            "reduce_scatter": lambda: D.reduce_scatter(x, ctx, axis),
            "all_reduce": lambda: D.all_reduce(x, ctx, axis=axis)}
        for name, fn in calls.items():
            D.reset_sent()
            res = fn()
            out[(name, axis)] = (sent(), tuple(res.shape))
    D.reset_sent()
    D.agree(1.5, ctx)
    out[("agree", "tokens")] = (sent(), ())
    return out


def world(ctx, setup) -> dict:
    """One rank of the 2 × 2 grid: the collectives, then the cases of
    ``setup`` (name → (kind, args, kwargs))."""
    out = {"coords": (ctx.data_rank, ctx.rank),
           "collectives": collectives(ctx)}
    run = {"serve": serve_sent, "train": train_sent}
    for name, (kind, args, kw) in setup.items():
        out[name] = run[kind](*args, ctx, **kw)
    return out
