"""Distribution context of the port: lets the model code (the MoE layer)
take its expert-parallel regimes while a process group is active, and stay
single-device otherwise. The counterpart of the reference's
``launch/dist.py``.

The reference runs one controller over a device mesh (``shard_map``); the
port runs one process per rank of a (data × model) grid (process-per-rank
SPMD, the PyTorch idiom): every rank holds the dense weights, the KV pool,
the scheduler and the host control plane, runs the same calls in the same
order, and holds only its own slice of the experts on the device (E/N of
them and n_hi/N hi slots; in the FF-sliced regime also 1/dp of their FF
columns). ``DistContext`` carries the process groups of both axes and
this rank's place on them; ``dist_ctx`` makes it ambient for
``models.moe.moe_apply`` and ``models.layers.attention_full``, which read
it with ``get_dist()`` as the reference's do at trace time.

Under a context that carries a ``planner`` (``launch.sharding.
ShardingPlanner``) the batch entry points run the reference's GSPMD step
instead (``models.specs``): each rank holds only its shards of the
weights, caches, inputs and AdamW state, as the planner's specs cut them,
and computes only its share; ``batch`` is then the global row count of the
call's inputs (what a rank's local shapes cannot tell).

The collectives here run over gloo and stage every tensor through host
memory as bytes (``_bytes``): NCCL will not put two ranks on one device,
and the port's ranks share the one card of the machine it is measured on.
Each returns a tensor on the device it was given. None of them can be
captured in a CUDA graph, so an engine under a context decodes op by op.
Each has a backward, its adjoint over the same axis (all_gather ↔
reduce_scatter, all_reduce ↔ all_reduce of the gradient, all_to_all and
exchange ↔ the reverse exchange): a rank's backward enters the same
collectives as every other rank's, in the same order, as the forwards
did. With autograd off they move the same bytes in the same order as
before they had one.

Under ``dry_run()`` (the dry run of ``launch.dryrun``) every collective
records instead of moving: it takes ``meta`` tensors, adds to
``SENT_BYTES`` what the real call would add (both paths price a call
through ``sent_bytes``) and returns an empty ``meta`` tensor of the
result's shape, without calling ``torch.distributed``; its context then
carries sizes and coordinates and no process groups
(``launch.mesh.dry_context``). Outside it a ``meta`` tensor reaching a
collective raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as tdist

from repro_torch import resolve_device

_STATE = threading.local()

#: The axes a collective runs over: "model" (the ranks that share this
#: rank's data index: its model group), "data" (the ranks that share its
#: model index: its data group) and "tokens" (every rank of the grid, data
#: index major: the axes the tokens split over under expert parallelism).
AXES = ("model", "data", "tokens")

#: Bytes this rank handed to other ranks, by collective and by the axis it
#: ran over (``SENT_BYTES[collective][axis]``): a rank's own block is not
#: counted, an all-gather sends this rank's part to every other rank of
#: the axis, an all-reduce is priced as a ring's 2·(N−1)/N of the buffer
#: and a broadcast as N−1 copies from the axis's first rank (what each
#: must deliver, whatever algorithm gloo picks).
SENT_BYTES = {c: {a: 0 for a in AXES} for c in
              ("all_to_all", "exchange", "all_gather", "all_reduce",
               "broadcast", "reduce_scatter")}


def reset_sent() -> None:
    for per_axis in SENT_BYTES.values():
        for a in per_axis:
            per_axis[a] = 0


def sent_bytes(collective: str, nbytes, n: int, r: int = 0) -> int:
    """The bytes rank ``r`` of an axis of ``n`` hands to other ranks in one
    call of ``collective`` over a buffer of ``nbytes`` (for "exchange",
    the list of its per-destination byte counts): the pricing of
    ``SENT_BYTES``, shared by the real and the recorded calls."""
    if n == 1:
        return 0
    if collective in ("all_to_all", "reduce_scatter"):
        return nbytes * (n - 1) // n
    if collective == "exchange":
        return sum(nbytes) - nbytes[r]
    if collective == "all_gather":
        return nbytes * (n - 1)
    if collective == "all_reduce":
        return nbytes * 2 * (n - 1) // n
    if collective == "broadcast":
        return nbytes * (n - 1) if r == 0 else 0
    raise ValueError(f"collective {collective!r}; one of {tuple(SENT_BYTES)}")


def _count(collective: str, axis: str, nbytes, n: int, r: int = 0) -> None:
    SENT_BYTES[collective][axis] += sent_bytes(collective, nbytes, n, r)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class DryRun:
    """What a dry run records besides ``SENT_BYTES``: the kernels' own
    work by wrapper name, {"calls", "flops", "bytes"} (``record_kernel``,
    from the wrappers' ``meta`` branches in ``kernels.ops``)."""
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


_DRY: Optional[DryRun] = None


def dry_running() -> bool:
    """Whether a ``dry_run()`` is active."""
    return _DRY is not None


@contextlib.contextmanager
def dry_run():
    """The recording mode: while it is active the collectives take
    ``meta`` tensors and move nothing (see the module docstring),
    ``repro_torch.resolve_device`` accepts ``"meta"`` and the kernel
    wrappers on the dry run's path price their work into the ``DryRun``
    it yields."""
    global _DRY
    prev, _DRY = _DRY, DryRun()
    try:
        yield _DRY
    finally:
        _DRY = prev


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """Add one call of kernel ``name`` with its ``flops`` and the ``nbytes``
    it moves to the active dry run; raises outside one (a ``meta`` tensor
    reached a kernel wrapper)."""
    if _DRY is None:
        raise RuntimeError(f"{name}: a meta tensor outside launch.dist."
                           f"dry_run(); the kernels run on the card or "
                           f"the CPU")
    k = _DRY.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    k["calls"] += 1
    k["flops"] += int(flops)
    k["bytes"] += int(nbytes)


def _dry(*tensors) -> bool:
    """Whether this collective call is recorded (a dry run is active):
    then every tensor it takes must be ``meta``; outside a dry run none
    may be."""
    metas = [t.device.type == "meta" for t in tensors if t is not None]
    if _DRY is None:
        if any(metas):
            raise RuntimeError("a meta tensor reached a collective outside "
                               "launch.dist.dry_run()")
        return False
    if not all(metas):
        raise RuntimeError("under launch.dist.dry_run() the collectives "
                           "take meta tensors only")
    return True


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    """The recorded call's result: an empty ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=like.dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class DistContext:
    """One rank's view of a (data × model) process grid (the reference's
    mesh): ``group`` is its model group (None: the default group), ``rank``
    its model index in it, ``model_size`` ranks; ``data_group``,
    ``data_rank`` and ``data_size`` the same along the data axis (size 1:
    a model-only context, as ``ep_context`` builds); ``token_group``
    every rank of the grid (None: the default group; with ``data_size``
    1 the model group serves); ``device`` where its tensors live (None:
    the card, through ``repro_torch.resolve_device``, which raises without
    CUDA)."""
    group: Optional[object]
    rank: int
    model_size: int
    device: Optional[torch.device] = None
    # Expert-parallel serving: every rank owns T/n_token_shards tokens plus
    # E/model_size experts, and the MoE layer runs the ragged all-to-all
    # pipeline (``models.moe._moe_local_ep``). False: the padded regimes.
    tokens_ep_sharded: bool = True
    data_group: Optional[object] = None
    data_rank: int = 0
    data_size: int = 1
    token_group: Optional[object] = None
    # Tokens split over the data axis (False: replicated over it, as the
    # reference's batch-1 long-context decode; the MoE layer then slices
    # the experts' FF dims over data when they divide).
    tokens_dp_sharded: bool = True
    # The planner's specs executed (``models.specs``): None keeps the
    # expert-parallel and data-axis grids (every rank holds every dense
    # weight); else the ``ShardingPlanner`` whose specs cut this rank's
    # params, caches and inputs, and ``batch`` the global rows of the
    # call's inputs.
    planner: Optional[object] = None
    batch: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dp_size(self) -> int:
        return self.data_size

    @property
    def n_token_shards(self) -> int:
        """Shards the token dim splits over (EP: data × model; else data),
        the reference's ``DistContext.n_token_shards``."""
        return self.dp_size * (self.model_size if self.tokens_ep_sharded
                               else 1)

    @property
    def token_rank(self) -> int:
        """This rank's index on the token axes (data index major)."""
        return self.data_rank * self.model_size + self.rank

    def axis(self, name: str):
        """(process group, this rank's index in it, its size) of axis
        ``name`` (one of ``AXES``)."""
        if name == "model":
            return self.group, self.rank, self.model_size
        if name == "data":
            return self.data_group, self.data_rank, self.data_size
        if name == "tokens":
            if self.data_size == 1:
                return self.group, self.rank, self.model_size
            return self.token_group, self.token_rank, \
                self.data_size * self.model_size
        raise ValueError(f"axis {name!r}; one of {AXES}")


def ep_context(group, rank: int, model_size: int,
               device=None) -> DistContext:
    """Expert-parallel serving context over a model-only group: every rank
    owns a token slice and E/``model_size`` experts. ``device`` None: the
    card."""
    return DistContext(group=group, rank=int(rank),
                       model_size=int(model_size), device=device,
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


def shard_range(n: int, ctx: DistContext, axis: str = "model") -> slice:
    """This rank's block of ``n`` items split evenly over ``axis`` (the
    experts ``[j·E/N, (j+1)·E/N)``, the hi slots ``[j·n/N, (j+1)·n/N)``,
    the tokens ``[j·T/N, (j+1)·T/N)``)."""
    _, r, size = ctx.axis(axis)
    if n % size:
        raise ValueError(f"{n} not divisible by {size} shards")
    per = n // size
    return slice(r * per, (r + 1) * per)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host as a flat uint8 view of its bytes (a copy when it
    is on the card): what gloo moves, whatever the dtype."""
    h = t.detach().contiguous().cpu().reshape(-1)
    if h.numel() == 1 and h.stride(0) != 1:     # a one-element slice's view
        h = torch.empty(1, dtype=h.dtype).copy_(h)
    return h.view(torch.uint8)


def _recorded(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.view(like.dtype).reshape(shape).to(like.device)


def _global_rank(group, rank: int) -> int:
    if group is None:
        return rank
    return tdist.get_global_rank(group, rank)


def agree(value: float, ctx: Optional[DistContext] = None) -> float:
    """The grid's first rank's ``value`` on every rank (a float64
    broadcast over the token axes): the one clock reading, or any
    host-side number, that a decision is taken on. Without a context,
    ``value`` itself."""
    ctx = ctx if ctx is not None else get_dist()
    if ctx is None:
        return value
    group, r, n = ctx.axis("tokens")
    _count("broadcast", "tokens", 8, n, r)
    if _dry():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    tdist.broadcast(t, src=_global_rank(group, 0), group=group)
    return float(t[0])


def _all_to_all(t: torch.Tensor, ctx: DistContext, axis: str
                ) -> torch.Tensor:
    group, _, n = ctx.axis(axis)
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"leading dim {t.shape[0]} not divisible by {n}")
    dry = _dry(t)
    _count("all_to_all", axis, _nbytes(t), n)
    if dry:
        return _empty(t.shape, t)
    src = _bytes(t)
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=group)
    return _from_bytes(out, t, t.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, axis):
        fctx.dist, fctx.axis = ctx, axis
        return _all_to_all(t, ctx, axis)

    @staticmethod
    def backward(fctx, g):
        # Block s of the output came from rank s: its gradient goes back.
        return _all_to_all(g, fctx.dist, fctx.axis), None, None


def all_to_all(t: torch.Tensor, ctx: DistContext,
               axis: str = "model") -> torch.Tensor:
    """Exchange equal blocks of ``t`` (leading dim N·S) over ``axis``:
    block s goes to its rank s, and block s of the result came from rank
    s. Backward: the same exchange of the gradient."""
    if _recorded(t):
        return _AllToAll.apply(t, ctx, axis)
    return _all_to_all(t, ctx, axis)


def _exchange(send, recv_like, ctx: DistContext, axis: str):
    group, r, n = ctx.axis(axis)
    if n == 1:
        return list(send)
    dry = _dry(*send, *recv_like)
    sizes_out = [0 if s is None else _nbytes(s) for s in send]
    _count("exchange", axis, sizes_out, n, r)
    if dry:
        return [None if x is None else _empty(x.shape, x) for x in recv_like]
    ins = [_bytes(s) if s is not None else torch.empty(0, dtype=torch.uint8)
           for s in send]
    sizes_in = [0 if x is None else _nbytes(x) for x in recv_like]
    out = torch.empty(sum(sizes_in), dtype=torch.uint8)
    tdist.all_to_all_single(out, torch.cat(ins),
                            output_split_sizes=sizes_in,
                            input_split_sizes=sizes_out, group=group)
    res, off = [], 0
    for x, size in zip(recv_like, sizes_in):
        res.append(None if x is None else
                   _from_bytes(out[off:off + size], x, x.shape))
        off += size
    return res


class _Exchange(torch.autograd.Function):
    """``exchange`` over the non-None sends (autograd takes tensors
    only); returns the non-None receives."""

    @staticmethod
    def forward(fctx, ctx, axis, send_mask, recv_like, *sends):
        it = iter(sends)
        send = [next(it) if m else None for m in send_mask]
        fctx.meta = (ctx, axis, send)
        fctx.recv_mask = [x is not None for x in recv_like]
        return tuple(x for x in _exchange(send, recv_like, ctx, axis)
                     if x is not None)

    @staticmethod
    def backward(fctx, *grads):
        ctx, axis, send = fctx.meta
        it = iter(grads)
        back = [next(it) if m else None for m in fctx.recv_mask]
        got = _exchange(back, send, ctx, axis)
        return (None, None, None, None) + tuple(g for g in got
                                                if g is not None)


def exchange(send: Sequence[Optional[torch.Tensor]], recv_like:
             Sequence[Optional[torch.Tensor]], ctx: DistContext,
             axis: str = "model") -> List[Optional[torch.Tensor]]:
    """Uneven exchange that every rank of ``axis`` enters: ``send[s]`` (or
    None) goes to rank s; ``recv_like[s]`` (or None) gives the dtype,
    shape and device of what rank s sends here. Ranks with nothing to move
    pass all None (empty splits). Returns the received tensors by source
    rank. Backward: the reverse exchange (each received tensor's gradient
    back to its source)."""
    if not _recorded(*send):
        return _exchange(send, recv_like, ctx, axis)
    got = iter(_Exchange.apply(ctx, axis, [s is not None for s in send],
                               list(recv_like),
                               *[s for s in send if s is not None]))
    return [None if x is None else next(got) for x in recv_like]


def _all_gather(t: torch.Tensor, ctx: DistContext, axis: str,
                dim: int) -> torch.Tensor:
    group, _, n = ctx.axis(axis)
    if n == 1:
        return t
    dry = _dry(t)
    _count("all_gather", axis, _nbytes(t), n)
    if dry:
        shape = list(t.shape)
        shape[dim] *= n
        return _empty(shape, t)
    src = _bytes(t)
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat([_from_bytes(p, t, t.shape) for p in parts], dim=dim)


def _reduce_scatter(t: torch.Tensor, ctx: DistContext, axis: str,
                    dim: int) -> torch.Tensor:
    """Block r (along ``dim``) of every rank's ``t`` summed on rank r: one
    exchange of the blocks (gloo has no reduce-scatter), then the sum in
    rank order, in float32 for a narrower float (the same bits on every
    run)."""
    group, r, n = ctx.axis(axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible by "
                         f"{n}")
    if n == 1:
        return t
    dry = _dry(t)
    _count("reduce_scatter", axis, _nbytes(t), n)
    if dry:
        shape = list(t.shape)
        shape[dim] //= n
        return _empty(shape, t)
    blocks = torch.stack(torch.chunk(t, n, dim=dim))
    src = _bytes(blocks)
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=group)
    got = _from_bytes(out, blocks, blocks.shape)
    acc = got.float() if got.dtype in (torch.bfloat16, torch.float16) \
        else got
    total = acc[0]
    for i in range(1, n):
        total = total + acc[i]
    return total.to(t.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, axis, dim):
        fctx.meta = (ctx, axis, dim)
        return _all_gather(t, ctx, axis, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axis, dim = fctx.meta
        return _reduce_scatter(g, ctx, axis, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, axis, dim):
        fctx.meta = (ctx, axis, dim)
        return _reduce_scatter(t, ctx, axis, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axis, dim = fctx.meta
        return _all_gather(g, ctx, axis, dim), None, None, None


def all_gather(t: torch.Tensor, ctx: DistContext, axis: str = "model",
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``axis`` concatenated along ``dim``, in rank
    order. Backward: ``reduce_scatter`` of the gradient."""
    if _recorded(t):
        return _AllGather.apply(t, ctx, axis, dim)
    return _all_gather(t, ctx, axis, dim)


def reduce_scatter(t: torch.Tensor, ctx: DistContext, axis: str = "model",
                   dim: int = 0) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``t``, of which this rank
    keeps block r along ``dim`` (``t.shape[dim]`` divisible by the axis's
    N ranks; the sum in rank order). Backward: ``all_gather`` of the
    gradient."""
    if _recorded(t):
        return _ReduceScatter.apply(t, ctx, axis, dim)
    return _reduce_scatter(t, ctx, axis, dim)


def _all_reduce(t: torch.Tensor, ctx: DistContext, op, axis: str
                ) -> torch.Tensor:
    group, _, n = ctx.axis(axis)
    if n == 1:
        return t.detach().clone()
    dry = _dry(t)
    _count("all_reduce", axis, _nbytes(t), n)
    if dry:
        return _empty(t.shape, t)
    h = t.detach().contiguous().cpu().clone()
    tdist.all_reduce(h, op=op, group=group)
    return h.to(t.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, axis):
        fctx.meta = (ctx, axis)
        return _all_reduce(t, ctx, tdist.ReduceOp.SUM, axis)

    @staticmethod
    def backward(fctx, g):
        ctx, axis = fctx.meta
        return _all_reduce(g, ctx, tdist.ReduceOp.SUM, axis), None, None


def all_reduce(t: torch.Tensor, ctx: DistContext,
               op=tdist.ReduceOp.SUM, axis: str = "model") -> torch.Tensor:
    """``t`` reduced over ``axis`` (a float32/float64/int64 tensor; gloo's
    reduction leaves the same bits on every rank). Backward (a sum only):
    the gradient summed over ``axis``; another op under autograd raises
    (its caller detaches what it reduces, as a softmax's max)."""
    if _recorded(t):
        if op != tdist.ReduceOp.SUM:
            raise RuntimeError("all_reduce has a backward for a sum only")
        return _AllReduce.apply(t, ctx, axis)
    return _all_reduce(t, ctx, op, axis)


def all_true(flags: Sequence[bool], ctx: DistContext,
             axis: str = "tokens") -> List[bool]:
    """Elementwise AND of ``flags`` over ``axis`` (an all_reduce MIN): a
    flag stays True only where every rank holds it True. Not counted in
    ``SENT_BYTES`` (host flags of the control plane, not the step's
    traffic); recorded, each rank's own flags."""
    if not flags:
        return []
    if _dry():
        return [bool(f) for f in flags]
    group, _, _ = ctx.axis(axis)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MIN, group=group)
    return [bool(v) for v in t.tolist()]
