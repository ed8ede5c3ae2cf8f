"""AdamW with decoupled weight decay and a cosine schedule with warmup
(the reference's ``training/adamw.py``).

Float32 moments whatever the parameter dtype: bf16 parameters update
through a float32 view computed on the fly, with no master copy. The
global gradient norm clips every gradient. Plain torch over the tree's
leaves (the reference has no kernel here); the moments are updated in
place, and each large leaf is updated a few layers at a time, so the
float32 scratch stays a slice's worth at full width.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import tree as T

#: Elements per slice of a leaf's update (its leading axis is cut so that
#: a slice holds at most this many).
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 10
    total_steps: int = 300
    grad_clip: float = 1.0


def adamw_init(params):
    """{"m", "v": float32 zeros of each leaf's shape, "step": int32 0} on
    the parameters' device (the reference's keys)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=T.first_device(params))}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (int32 scalar), float32: linear warmup,
    then a cosine to 0 at ``total_steps``."""
    s = step.float()
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _slices(p: torch.Tensor):
    if p.dim() == 0 or p.numel() <= _SLICE:
        return [...]
    rows = max(1, _SLICE // max(1, p[0].numel()))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def adamw_update(cfg: AdamWConfig, params, grads, state, gnorm=None):
    """One step: returns (new params, state, {"gnorm", "lr"} float32
    scalars). ``state``'s moments are updated in place (and returned with
    the next step); the parameters are new tensors of their own dtype.
    ``gnorm``: the global gradient norm, where the leaves given are one
    rank's shards (computed from them otherwise)."""
    step = state["step"] + 1
    lr = _schedule(cfg, state["step"])
    gs = T.leaves(grads)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in gs))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    sf = step.float()
    c1 = 1 - torch.pow(torch.full_like(sf, cfg.b1), sf)
    c2 = 1 - torch.pow(torch.full_like(sf, cfg.b2), sf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new = []
    for p, g, m, v in zip(T.leaves(params), gs, T.leaves(state["m"]),
                          T.leaves(state["v"])):
        out = torch.empty_like(p)
        for sl in _slices(p):
            out[sl] = upd(p[sl], g[sl], m[sl], v[sl])
        new.append(out)
    return (T.unflatten(params, new),
            {"m": state["m"], "v": state["v"], "step": step},
            {"gnorm": gnorm, "lr": lr})
