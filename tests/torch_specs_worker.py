"""What the planner's-specs tests (``test_torch_specs.py``) run in each rank
of one 4-rank gloo world started by ``repro_torch.launch.mesh.spawn(...,
n_data=2)``: module-level functions, importable by name, so the ``spawn``
start method finds them under pytest. The children import torch and the
port only (no JAX); the parent test holds what they return against the
port's single-device path and the reference.

The world is a 2 × 2 (data × model) grid; ranks 0-2 also form a 1 × 3
grid (``grid_context(..., ranks=[0, 1, 2])``, which rank 3 enters too).
The single-device runs use the same helpers with ``ctx=None``."""
import dataclasses

import torch

from repro_torch.core import tree as T
from repro_torch.launch import dist as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import dist_ctx
from repro_torch.launch.mesh import grid_context
from repro_torch.models import moe as M
from repro_torch.models import specs as SP
from repro_torch.models.model import decode_step, init_caches, prefill
from repro_torch.training.adamw import adamw_init
from repro_torch.training.train import TrainConfig, _grads, make_train_step

#: Prompt tokens, decode steps and dense-row capacity (a multiple of 2 and
#: 3, so the caches' sequence cuts over either model axis); drop-free.
S, STEPS, MAX_LEN, CF = 8, 2, 48, 8.0
#: Training rows' tokens (a multiple of 3: the sequence-parallel split).
TRAIN_S = 12


def planned(ctx, cfg, B, fsdp=False, ep=False):
    """``ctx`` with the planner of its grid and the global batch ``B``;
    ``ep``: the MoE layer's all-to-all regime over the model axis."""
    pl = SH.ShardingPlanner(cfg, SH.grid_of(ctx), fsdp=fsdp)
    return dataclasses.replace(ctx, planner=pl, batch=B,
                               tokens_ep_sharded=ep)


def _nbytes(tree, kind, ctx, nmb=1):
    """(bytes this rank holds of ``tree``'s shards, ``rank_bytes``);
    ``nmb``: the inputs' microbatches."""
    local = SH.shard_tree(tree, kind, ctx.planner, ctx, microbatches=nmb)
    return local, (SH.held_bytes(local, caches=kind == "cache"),
                   SH.rank_bytes(tree, kind, ctx.planner, SH.grid_of(ctx),
                                 microbatches=nmb))


def serve(cfg, params, bank, tokens, ctx, dispatch="padded", ep=False,
          per_row=False):
    """Prefill ``tokens[:, :S]`` (B rows) into dense rows, then STEPS
    teacher-forced decode steps, under ``ctx`` with the planner (None: one
    device), in bf16 (``per_row``: counts per row, the group's under the
    planner). Returns the logits (this rank's group rows), counts,
    the group rows' slice, bytes held against ``rank_bytes`` by kind, the
    regimes the MoE calls ran and the bytes each collective sent in the
    first decode step."""
    B = tokens.shape[0]
    caches = init_caches(cfg, B, MAX_LEN, device="cpu")
    inputs = {"tokens": tokens[:, :S], "lengths": torch.full((B,), S)}
    steps = [{"token": tokens[:, S + t], "pos": torch.full((B,), S + t)}
             for t in range(STEPS)]
    out = {"held": {}, "group": slice(0, B)}
    if ctx is not None:
        ctx = planned(ctx, cfg, B, ep=ep)
        params, out["held"]["param"] = _nbytes(params, "param", ctx)
        if bank is not None:
            bank, out["held"]["bank"] = _nbytes(bank, "param", ctx)
        caches, out["held"]["cache"] = _nbytes(caches, "cache", ctx)
        inputs, out["held"]["input"] = _nbytes(inputs, "input", ctx)
        steps = [SH.shard_tree(s, "input", ctx.planner, ctx) for s in steps]
        out["group"] = SP.layout(ctx).group
    M.reset_regimes()
    with torch.no_grad(), dist_ctx(ctx):
        lg, counts = prefill(params, cfg, inputs["tokens"], caches,
                             inputs["lengths"], bank=bank,
                             capacity_factor=CF, moe_dispatch=dispatch,
                             per_row_counts=per_row)
        out["prefill"], out["counts"], out["decode"] = lg, [counts], []
        for t, st in enumerate(steps):
            D.reset_sent()
            lg, counts = decode_step(params, cfg, st["token"], st["pos"],
                                     caches, bank=bank, capacity_factor=CF,
                                     moe_dispatch=dispatch,
                                     per_row_counts=per_row)
            if t == 0:
                out["sent"] = {k: dict(v) for k, v in D.SENT_BYTES.items()}
            out["decode"].append(lg)
            out["counts"].append(counts)
    out["regimes"] = dict(M.REGIMES)
    return out


def train(cfg, params, tokens, ctx, nmb=1):
    """One train step (float32, FSDP specs) on ``tokens`` (B, TRAIN_S +
    1) under ``ctx`` (None: one device): the loss, this rank's gradients
    summed over the ranks that hold each leaf, and its parameters after
    the AdamW step, as (path, spec, tensor) per leaf; bytes held against
    ``rank_bytes`` for params, AdamW state and inputs."""
    B = tokens.shape[0]
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tcfg = TrainConfig(capacity_factor=CF, microbatches=nmb)
    opt = adamw_init(params)
    paths = T.flatten(params)[0]
    out = {"held": {}}
    if ctx is not None:
        ctx = planned(ctx, cfg, B, fsdp=True)
        params, out["held"]["param"] = _nbytes(params, "param", ctx)
        opt, out["held"]["adamw"] = _nbytes(opt, "param", ctx)
        batch, out["held"]["input"] = _nbytes(batch, "input", ctx, nmb)
        specs = SP._leaf_specs(params, cfg, ctx)
    else:
        specs = [None] * len(paths)
    with dist_ctx(ctx):
        if nmb == 1:
            loss, _, grads = _grads(params, cfg, batch, tcfg)
            if ctx is not None:
                grads, _ = SP.sum_grads(params, grads, cfg, ctx)
            out["grads"] = list(zip(paths, specs, grads))
        new, _, metrics = make_train_step(cfg, tcfg)(params, opt, batch)
    out["loss"] = float(metrics["loss"])
    out["gnorm"] = float(metrics["gnorm"])
    out["new"] = list(zip(paths, specs, T.leaves(new)))
    return out


def _probe(fn, x, ctx, axis, probe):
    """``torch.autograd.gradcheck`` of ``fn`` (a collective over ``axis``)
    on the probe rank's input, every other rank feeding a constant and
    zeroing its output: the other ranks enter every collective of the
    check, forward and backward, while only the probe rank's input moves
    and only its output is differentiated."""
    _, r, _ = ctx.axis(axis)

    def f(t):
        if r == probe:
            return fn(t)
        return fn(t * 0 + 0.5) * 0

    return torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-7)


def gradchecks(ctx):
    """Every collective's backward, by gradcheck in float64 over each
    axis, with each rank of the axis as the probe in turn."""
    g = torch.Generator().manual_seed(7 + ctx.token_rank)
    out = {}
    for axis in ("model", "data", "tokens"):
        _, r, n = ctx.axis(axis)
        x = torch.randn((2 * n, 3), generator=g, dtype=torch.float64,
                        requires_grad=True)

        def exchange(t, r=r, n=n, axis=axis):
            send = [t[s:s + 1 + (r + s) % 2] for s in range(n)]
            like = [torch.empty(1 + (s + r) % 2, 3, dtype=t.dtype)
                    for s in range(n)]
            return torch.cat(D.exchange(send, like, ctx, axis))

        fns = {"all_gather": lambda t, a=axis: D.all_gather(t, ctx, a,
                                                            dim=1),
               "reduce_scatter": lambda t, a=axis: D.reduce_scatter(
                   t, ctx, a, dim=0),
               "all_reduce": lambda t, a=axis: D.all_reduce(t, ctx, axis=a),
               "all_to_all": lambda t, a=axis: D.all_to_all(t, ctx, a),
               "exchange": exchange}
        for name, fn in fns.items():
            out[(name, axis)] = all(_probe(fn, x, ctx, axis, p)
                                    for p in range(n))
    return out


def world(ctx, setup):
    """One rank of the 2 × 2 grid: the serving and training cases of
    ``setup`` (name → (kind, args)), the collectives' gradchecks; then, on
    ranks 0-2 of a 1 × 3 grid, the cases named in ``setup["three"]``."""
    out = {"coords": (ctx.data_rank, ctx.rank),
           "gradcheck": gradchecks(ctx)}
    run = {"serve": serve, "train": train}
    for name, (kind, args, kw) in setup["cases"].items():
        out[name] = run[kind](*args, ctx, **kw)
    sub = grid_context(1, 3, ranks=[0, 1, 2], device=ctx.device)
    if sub is not None:
        for name, (kind, args, kw) in setup["three"].items():
            out[name] = run[kind](*args, sub, **kw)
    return out
