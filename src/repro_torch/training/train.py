"""Training (the reference's ``training/train.py``): cross-entropy, the
MoE load-balance loss and a z-loss, AdamW, gradient accumulation over
microbatches, the loop, and held-out perplexity under a given expert bank
(the quality evaluation's hook).

The step differentiates ``forward_train`` on the padded MoE dispatch (the
reference trains on the padded dispatch's einsums too: its Pallas path
has no gradient), with ``torch.autograd``; the kernels have no backward
and refuse to run under it. Under a distribution context with a planner
(``models.specs``) each rank differentiates its share of the loss over
its shards (params and AdamW state cut by the planner's FSDP specs), sums
each leaf's gradient over the ranks that hold a copy, and updates its own
shard with the global gradient norm. Evaluation runs without autograd on the
ragged dispatch by default: the quantized ragged FFN kernels with a bank,
their all-hi mode without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.launch.dist import dist_ctx
from repro_torch.models import specs as SP
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import forward_train
from repro_torch.training.adamw import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    capacity_factor: float = 2.0
    remat: bool = True
    z_loss: float = 1e-4
    # Gradient accumulation: activations of one microbatch at a time.
    microbatches: int = 1


def to_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch → tensors on ``device``; integer arrays
    (tokens, labels) as int64."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def loss_fn(params, cfg: ArchConfig, batch: Dict, tcfg: TrainConfig):
    """(total loss, {"ce", "aux", "z", "counts"}): token cross-entropy
    through logsumexp less the label's logit over positions whose label is
    >= 0 (a VLM's image positions carry none), plus the MoE load-balance
    loss, plus ``z_loss`` · mean(logsumexp²). Under a context with a
    planner: the whole batch's loss and parts (detached), from this rank's
    share (``specs.loss_share``, what the train step differentiates)."""
    if SP.active() is not None:
        _, parts = SP.loss_share(params, cfg, batch, tcfg)
        return parts["loss"], {k: v for k, v in parts.items()
                               if k != "loss"}
    logits, aux = forward_train(params, cfg, batch,
                                capacity_factor=tcfg.capacity_factor,
                                remat=tcfg.remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)                       # (B, S)
    valid = labels >= 0
    label_logit = torch.gather(
        logits32, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - torch.where(valid, label_logit, torch.zeros_like(lse))
    mask = valid.float()
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    zl = tcfg.z_loss * torch.mean(lse ** 2)
    total = ce + aux["aux_loss"] + zl
    return total, {"ce": ce, "aux": aux["aux_loss"], "z": zl,
                   "counts": aux["counts"]}


def _grads(params, cfg, batch, tcfg):
    """(loss, metrics, gradients in flatten order) of one batch: every
    leaf is differentiated, through views that share its storage."""
    live = T.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = T.leaves(live)
    if SP.active() is None:
        loss, metrics = loss_fn(live, cfg, batch, tcfg)
    else:       # this rank's share; the metrics hold the whole batch's
        loss, metrics = SP.loss_share(live, cfg, batch, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
               for k, v in metrics.items()}
    return metrics.pop("loss", loss).detach(), metrics, grads


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``. With ``microbatches`` > 1 the batch's rows are cut into
    that many equal microbatches in order, their gradients summed in
    float32, divided and cast to each parameter's dtype; the metrics then
    hold the mean loss as "ce" (the reference's). Under a context with a
    planner, ``params``, ``opt_state`` and ``batch`` are this rank's shards
    (``launch.sharding.shard_tree``; the batch with ``microbatches=``, so
    that the m-th cut of the rank's rows is its shard of the global
    microbatch m, the rows ``[m·B/nmb, (m+1)·B/nmb)``), and the step
    returns its shards."""
    nmb = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if nmb == 1:
            loss, metrics, grads = _grads(params, cfg, batch, tcfg)
        else:
            B = batch["tokens"].shape[0]
            n = B // nmb
            g32 = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in T.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=T.first_device(params))
            ctx = SP.active()
            # Under specs a microbatch is 1/nmb of the global batch.
            mb_ctx = None if ctx is None else \
                dataclasses.replace(ctx, batch=ctx.batch // nmb)
            for i in range(nmb):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                with dist_ctx(mb_ctx) if mb_ctx is not None else \
                        contextlib.nullcontext():
                    l_i, _, grads = _grads(params, cfg, mb, tcfg)
                for a, g in zip(g32, grads):
                    a.add_(g.float())
                loss = loss + l_i
            grads = [(a / nmb).to(p.dtype)
                     for a, p in zip(g32, T.leaves(params))]
            loss = loss / nmb
            metrics = {"ce": loss}
        gnorm = None
        ctx = SP.active()
        if ctx is not None:
            grads, gnorm = SP.sum_grads(params, grads, cfg, ctx)
        params, opt_state, opt_metrics = adamw_update(
            tcfg.optimizer, params, T.unflatten(params, grads), opt_state,
            gnorm)
        metrics = dict(metrics)
        metrics.pop("counts", None)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


def train_loop(cfg: ArchConfig, params, batches,
               tcfg: TrainConfig = TrainConfig(), log_every: int = 20,
               log=print, steps: Optional[list] = None):
    """Train over ``batches`` (numpy or tensor dicts) on the parameters'
    device. Steps 0-2 and every ``log_every``-th step are logged and kept
    in the history (floats, with "step" and "wall_s"); "aux" is printed
    where the metrics hold it (not under microbatches). ``steps``, a list,
    receives {"step", "ms", "loss", "ce"} for every step, read once the
    loop has ended: its milliseconds (CUDA events around the step on a
    card, the host's clock on the CPU), its loss and cross-entropy.
    Returns (params, opt_state, history)."""
    step_fn = make_train_step(cfg, tcfg)
    opt_state = adamw_init(params)
    dev = T.first_device(params)
    timed = []
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        batch = to_batch(batch, dev)
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            ev[1].record()
            timed.append((ev, m["loss"], m["ce"]))
        else:
            timed.append(((time.perf_counter() - t) * 1e3, m["loss"],
                          m["ce"]))
        if i % log_every == 0 or i < 3:
            m = {k: float(v) for k, v in m.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            aux = f"aux {m['aux']:.4f}  " if "aux" in m else ""
            log(f"step {i:4d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}  "
                f"{aux}gnorm {m['gnorm']:.2f}")
    if steps is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps.extend({"step": i, "ms": t if isinstance(t, float)
                      else t[0].elapsed_time(t[1]), "loss": float(loss),
                      "ce": float(ce)}
                     for i, (t, loss, ce) in enumerate(timed))
    return params, opt_state, history


def eval_perplexity(cfg: ArchConfig, params, batches,
                    capacity_factor: float = 4.0, bank=None,
                    dispatch: str = "ragged") -> float:
    """Held-out perplexity, under ``torch.no_grad()``. ``bank`` (MoE
    position → stacked ``ExpertBankQ``) switches the MoE layers to a
    quantized bank; ``dispatch`` "ragged" (the default: the ragged FFN
    kernels on a card, their plain versions on the CPU) or "padded"."""
    total_nll, total_tok = 0.0, 0
    dev = T.first_device(params)
    with torch.no_grad():
        for batch in batches:
            batch = to_batch(batch, dev)
            labels = batch.pop("labels")
            logits = _forward_with_bank(params, cfg, batch, bank,
                                        capacity_factor, dispatch)
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            total_nll += float(torch.sum(nll))
            total_tok += nll.numel()
    return math.exp(total_nll / total_tok)


def _forward_with_bank(params, cfg, batch, bank, capacity_factor,
                       dispatch="ragged"):
    """Per-position logits of a full-sequence forward through ``bank``
    (or the dense experts in ``params`` when it is None), no remat."""
    logits, _ = forward_train(params, cfg, batch,
                              capacity_factor=capacity_factor, remat=False,
                              dispatch=dispatch, bank=bank)
    return logits
