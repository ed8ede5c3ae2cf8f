"""What the families-under-specs tests (``test_torch_specs_families.py``)
run in each rank of one 4-rank gloo world started by
``repro_torch.launch.mesh.spawn(..., n_data=2)``, in the test's own
process for one device (``ctx=None``), and on ``meta`` tensors under
``launch.dist.dry_run()`` (the recording mode's bytes): module-level
functions, importable by name, so the ``spawn`` start method finds them
under pytest. The children import torch and the port only (no JAX).

The world is a 2 × 2 (data × model) grid; ranks 0-2 also form a 1 × 3
grid (``grid_context(..., ranks=[0, 1, 2])``, which rank 3 enters too).
Every function reads its device from its arguments."""
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.launch import dist as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import dist_ctx
from repro_torch.launch.mesh import grid_context
from repro_torch.models import moe as M
from repro_torch.models import specs as SP
from repro_torch.models.model import (decode_step, init_caches,
                                      init_params, prefill)
from repro_torch.training.adamw import adamw_init
from repro_torch.training.train import TrainConfig, _grads, make_train_step

import torch_dryrun_worker as DW
import torch_specs_worker as W

#: Drop-free MoE capacity (4 experts, top-2).
CF = 8.0
#: Decode steps after each prefill.
STEPS = 4


def _float(caches):
    """Every cache leaf in float32 (a float32 model's prefill writes and
    reads its caches at its own precision)."""
    return {k: type(c)(*(t.float() for t in c)) for k, c in caches.items()}


def serve(cfg, params, bank, data, ctx, max_len, steps=STEPS,
          dispatch="padded", ep=False, row_capacity=None):
    """Prefill ``data["tokens"][:, :-steps]`` (B rows; a VLM's
    ``image_embeds`` ahead of them, an encoder-decoder's
    ``audio_embeds`` encoded) into dense rows of ``max_len``, then
    ``steps`` teacher-forced decode steps, under ``ctx`` with the planner
    (None: one device), per-row counts (``row_capacity``: the per-row
    drop rule in every MoE layer). Float32 params run on float32
    caches. Returns the logits (this rank's group rows), counts, the
    prefill's tokens per row, the group rows' slice, bytes held against
    ``rank_bytes`` by kind, the MoE regimes, and the bytes each
    collective sent in the prefill and in the first decode step."""
    dev = T.first_device(params)
    toks = data["tokens"]
    B = toks.shape[0]
    S = toks.shape[1] - steps
    n = S + (data["image_embeds"].shape[1] if "image_embeds" in data else 0)
    caches = init_caches(cfg, B, max_len, device=dev)
    if params["embed"].dtype == torch.float32:
        caches = _float(caches)
    inputs = {"tokens": toks[:, :S],
              "lengths": torch.full((B,), n, device=dev)}
    for k in ("image_embeds", "audio_embeds"):
        if k in data:
            inputs[k] = data[k]
    steps_in = [{"token": toks[:, S + t],
                 "pos": torch.full((B,), n + t, device=dev)}
                for t in range(steps)]
    out = {"held": {}, "group": slice(0, B), "sent": {},
           "prefill_tokens": n}
    if ctx is not None:
        ctx = W.planned(ctx, cfg, B, ep=ep)
        params, out["held"]["param"] = W._nbytes(params, "param", ctx)
        if bank is not None:
            bank, out["held"]["bank"] = W._nbytes(bank, "param", ctx)
        caches, out["held"]["cache"] = W._nbytes(caches, "cache", ctx)
        inputs, out["held"]["input"] = W._nbytes(inputs, "input", ctx)
        steps_in = [SH.shard_tree(s, "input", ctx.planner, ctx)
                    for s in steps_in]
        out["group"] = SP.layout(ctx).group
    M.reset_regimes()
    with torch.no_grad(), dist_ctx(ctx):
        D.reset_sent()
        lg, counts = prefill(params, cfg, inputs["tokens"], caches,
                             inputs["lengths"], bank=bank,
                             capacity_factor=CF, moe_dispatch=dispatch,
                             per_row_counts=True, row_capacity=row_capacity,
                             image_embeds=inputs.get("image_embeds"),
                             audio_embeds=inputs.get("audio_embeds"))
        out["sent"]["prefill"] = DW.sent()
        out["prefill"], out["counts"], out["decode"] = lg, [counts], []
        for t, st in enumerate(steps_in):
            D.reset_sent()
            lg, counts = decode_step(params, cfg, st["token"], st["pos"],
                                     caches, bank=bank, capacity_factor=CF,
                                     moe_dispatch=dispatch,
                                     per_row_counts=True,
                                     row_capacity=row_capacity)
            if t == 0:
                out["sent"]["decode"] = DW.sent()
            out["decode"].append(lg)
            out["counts"].append(counts)
    out["regimes"] = dict(M.REGIMES)
    return out


def train(cfg, params, batch, ctx):
    """One float32 train step under the FSDP specs on ``batch`` (tokens,
    labels, and a VLM's or an encoder-decoder's embeddings; B rows) under
    ``ctx`` (None: one device): the loss, gradient norm, this rank's
    gradients summed over the ranks that hold each leaf and its
    parameters after the AdamW step, as (path, spec, tensor) per leaf;
    bytes held against ``rank_bytes`` (params, AdamW state, inputs); the
    bytes each collective sent in the step."""
    B = batch["tokens"].shape[0]
    tcfg = TrainConfig(capacity_factor=CF)
    opt = adamw_init(params)
    paths = T.flatten(params)[0]
    out = {"held": {}}
    if ctx is not None:
        ctx = W.planned(ctx, cfg, B, fsdp=True)
        params, out["held"]["param"] = W._nbytes(params, "param", ctx)
        opt, out["held"]["adamw"] = W._nbytes(opt, "param", ctx)
        batch, out["held"]["input"] = W._nbytes(batch, "input", ctx)
        specs = SP._leaf_specs(params, cfg, ctx)
    else:
        specs = [None] * len(paths)
    with dist_ctx(ctx):
        _, _, grads = _grads(params, cfg, batch, tcfg)
        if ctx is not None:
            grads, _ = SP.sum_grads(params, grads, cfg, ctx)
        out["grads"] = list(zip(paths, specs, grads))
        D.reset_sent()
        new, _, metrics = make_train_step(cfg, tcfg)(params, opt, batch)
        out["sent"] = {"train": DW.sent()}
    out["loss"] = metrics["loss"]
    out["gnorm"] = metrics["gnorm"]
    out["new"] = list(zip(paths, specs, T.leaves(new)))
    return out


RUN = {"serve": serve, "train": train}

#: Rows of the per-row rule's batch that does not split over 2 data ranks.
ODD_B = 3


def rule_cfg(arch):
    """A reduced ``arch`` for the per-row rule's runs (Whisper's encoder
    at 16 frames)."""
    cfg = get_config(arch, reduced=True)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, encoder_seq=16)
    return cfg


def rule_data(cfg, B):
    """``B`` rows of 20 tokens (with a VLM's image prefix, an
    encoder-decoder's frames), drawn from seed 5."""
    g = torch.Generator().manual_seed(5)
    data = {"tokens": torch.randint(1, cfg.vocab_size, (B, 20),
                                    generator=g)}
    if cfg.family == "vlm":
        data["image_embeds"] = torch.randn((B, 4, cfg.d_model),
                                           generator=g).bfloat16()
    if cfg.is_encoder_decoder:
        data["audio_embeds"] = torch.randn((B, 16, cfg.d_model),
                                           generator=g).bfloat16()
    return data


def rule_serve(arch, ctx, B, row_capacity=1):
    """``serve`` of ``rule_cfg(arch)`` (params from seed 5) on
    ``rule_data`` with ``row_capacity`` under ``ctx`` (None: one
    process)."""
    cfg = rule_cfg(arch)
    params = init_params(cfg, seed=5, device="cpu")
    return serve(cfg, params, None, rule_data(cfg, B), ctx, 48,
                 row_capacity=row_capacity)


def rule_world(ctx, archs):
    """One rank of a 2 × 1 grid: ``rule_serve`` of each of ``archs`` on
    ``ODD_B`` rows, which do not split over data."""
    return {"coords": (ctx.data_rank, ctx.rank),
            **{a: rule_serve(a, ctx, ODD_B) for a in archs}}


def world(ctx, setup):
    """One rank of the 2 × 2 grid: the cases of ``setup["cases"]`` (name →
    (kind, args, kwargs)); then, on ranks 0-2 of a 1 × 3 grid, those of
    ``setup["three"]``."""
    out = {"coords": (ctx.data_rank, ctx.rank)}
    for name, (kind, args, kw) in setup["cases"].items():
        out[name] = RUN[kind](*args, ctx, **kw)
    sub = grid_context(1, 3, ranks=[0, 1, 2], device=ctx.device)
    if sub is not None:
        for name, (kind, args, kw) in setup["three"].items():
            out[name] = RUN[kind](*args, sub, **kw)
    return out
