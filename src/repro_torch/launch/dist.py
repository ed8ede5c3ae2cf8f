"""Distribution context of the port: lets the model code (the MoE layer)
take its expert-parallel regimes while a process group is active, and stay
single-device otherwise. The counterpart of the reference's
``launch/dist.py``.

The reference runs one controller over a device mesh (``shard_map``); the
port runs one process per shard of the model axis (process-per-rank SPMD,
the PyTorch idiom): every rank holds the dense weights, the KV pool, the
scheduler and the host control plane, runs the same requests in the same
order, and holds only its own E/N experts and n_hi/N hi slots on the
device. ``DistContext`` carries the process group and this rank's place in
it; ``dist_ctx`` makes it ambient for ``models.moe.moe_apply``, which reads
it with ``get_dist()`` as the reference's does at trace time.

The collectives here run over gloo and stage every tensor through host
memory as bytes (``_bytes``): NCCL will not put two ranks on one device,
and the port's ranks share the one card of the machine it is measured on.
Each returns a tensor on the device it was given. None of them can be
captured in a CUDA graph, so an engine under a context decodes op by op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist

_STATE = threading.local()

#: Bytes this rank handed to other ranks, by collective: a rank's own block
#: is not counted, an all-gather sends this rank's part to every other
#: rank, an all-reduce is priced as a ring's 2·(N−1)/N of the buffer and a
#: broadcast as N−1 copies from rank 0 (what each must deliver, whatever
#: algorithm gloo picks).
SENT_BYTES = {"all_to_all": 0, "exchange": 0, "all_gather": 0,
              "all_reduce": 0, "broadcast": 0}


def reset_sent() -> None:
    for k in SENT_BYTES:
        SENT_BYTES[k] = 0


@dataclasses.dataclass(frozen=True)
class DistContext:
    """One rank's view of an expert-parallel group: ``group`` (None: the
    default group), this rank's index ``rank`` in it, ``model_size``
    ranks, and the ``device`` its tensors live on."""
    group: Optional[object]
    rank: int
    model_size: int
    device: torch.device = torch.device("cpu")
    # Expert-parallel serving: every rank owns T/n_token_shards tokens plus
    # E/model_size experts, and the MoE layer runs the ragged all-to-all
    # pipeline (``models.moe._moe_local_ep``). False: tokens replicated,
    # the padded regime.
    tokens_ep_sharded: bool = True

    @property
    def n_token_shards(self) -> int:
        """Ranks the token dim splits over (EP: every rank; else none)."""
        return self.model_size if self.tokens_ep_sharded else 1


def ep_context(group, rank: int, model_size: int,
               device=None) -> DistContext:
    """Expert-parallel serving context: every rank owns a token slice and
    E/``model_size`` experts."""
    return DistContext(group=group, rank=int(rank),
                       model_size=int(model_size),
                       device=torch.device("cpu" if device is None
                                           else device),
                       tokens_ep_sharded=True)


def get_dist() -> Optional[DistContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def dist_ctx(ctx: Optional[DistContext]):
    prev = get_dist()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard_range(n: int, ctx: DistContext) -> slice:
    """This rank's block of ``n`` items split evenly over the group (the
    experts ``[j·E/N, (j+1)·E/N)``, the hi slots ``[j·n/N, (j+1)·n/N)``,
    the tokens ``[j·T/N, (j+1)·T/N)``)."""
    if n % ctx.model_size:
        raise ValueError(f"{n} not divisible by {ctx.model_size} shards")
    per = n // ctx.model_size
    return slice(ctx.rank * per, (ctx.rank + 1) * per)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host as a flat uint8 view of its bytes (a copy when it
    is on the card): what gloo moves, whatever the dtype."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.view(like.dtype).reshape(shape).to(like.device)


def agree(value: float, ctx: Optional[DistContext] = None) -> float:
    """Rank 0's ``value`` on every rank (a float64 broadcast): the one
    clock reading, or any host-side number, that a decision is taken on.
    Without a context, ``value`` itself."""
    ctx = ctx if ctx is not None else get_dist()
    if ctx is None:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    if ctx.rank == 0:
        SENT_BYTES["broadcast"] += 8 * (ctx.model_size - 1)
    tdist.broadcast(t, src=_global_rank(ctx, 0), group=ctx.group)
    return float(t[0])


def _global_rank(ctx: DistContext, rank: int) -> int:
    if ctx.group is None:
        return rank
    return tdist.get_global_rank(ctx.group, rank)


def all_to_all(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """Exchange equal blocks of ``t`` (leading dim N·S): block s goes to
    rank s, and block s of the result came from rank s."""
    n = ctx.model_size
    if t.shape[0] % n:
        raise ValueError(f"leading dim {t.shape[0]} not divisible by {n}")
    src = _bytes(t)
    out = torch.empty_like(src)
    SENT_BYTES["all_to_all"] += src.numel() * (n - 1) // n
    tdist.all_to_all_single(out, src, group=ctx.group)
    return _from_bytes(out, t, t.shape)


def exchange(send: Sequence[Optional[torch.Tensor]], recv_like:
             Sequence[Optional[torch.Tensor]], ctx: DistContext
             ) -> List[Optional[torch.Tensor]]:
    """Uneven exchange that every rank enters: ``send[s]`` (or None) goes
    to rank s; ``recv_like[s]`` (or None) gives the dtype, shape and device
    of what rank s sends here. Ranks with nothing to move pass all None
    (empty splits). Returns the received tensors by source rank."""
    ins = [_bytes(s) if s is not None else torch.empty(0, dtype=torch.uint8)
           for s in send]
    sizes_out = [int(b.numel()) for b in ins]
    sizes_in = [0 if r is None else r.numel() * r.element_size()
                for r in recv_like]
    out = torch.empty(sum(sizes_in), dtype=torch.uint8)
    SENT_BYTES["exchange"] += sum(sizes_out) - sizes_out[ctx.rank]
    tdist.all_to_all_single(out, torch.cat(ins),
                            output_split_sizes=sizes_in,
                            input_split_sizes=sizes_out, group=ctx.group)
    res, off = [], 0
    for r, size in zip(recv_like, sizes_in):
        res.append(None if r is None else
                   _from_bytes(out[off:off + size], r, r.shape))
        off += size
    return res


def all_gather(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order."""
    src = _bytes(t)
    parts = [torch.empty_like(src) for _ in range(ctx.model_size)]
    SENT_BYTES["all_gather"] += src.numel() * (ctx.model_size - 1)
    tdist.all_gather(parts, src, group=ctx.group)
    return torch.cat([_from_bytes(p, t, t.shape) for p in parts])


def all_reduce(t: torch.Tensor, ctx: DistContext,
               op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group (a float32/float64/int64 tensor;
    gloo's reduction leaves the same bits on every rank)."""
    h = t.detach().contiguous().cpu().clone()
    n = ctx.model_size
    SENT_BYTES["all_reduce"] += h.numel() * h.element_size() * 2 * (n - 1) \
        // n
    tdist.all_reduce(h, op=op, group=ctx.group)
    return h.to(t.device)


def all_true(flags: Sequence[bool], ctx: DistContext) -> List[bool]:
    """Elementwise AND of ``flags`` over the group (an all_reduce MIN): a
    flag stays True only where every rank holds it True."""
    if not flags:
        return []
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MIN, group=ctx.group)
    return [bool(v) for v in t.tolist()]
