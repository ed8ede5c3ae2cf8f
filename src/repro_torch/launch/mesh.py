"""Process grids of the port: the counterpart of the reference's
``launch/mesh.py`` — ``make_debug_mesh(n_data, n_model)`` and
``make_ep_mesh(n_shards, n_data)`` over one gloo world of ``n_data ·
n_model`` ranks, ``data_axes`` and ``model_axis`` — and ``spawn``, which
starts one process per rank of a grid and runs a function on each.

The reference builds a device mesh for one controller; the port starts
one process per rank and joins them into one gloo world (``launch.dist``:
NCCL will not put two ranks on one device). Rank r of a grid sits at
(r // n_model, r % n_model), the data-major layout of
``jax.make_mesh((n_data, n_model), ("data", "model"))``; its model group
is the ranks of its row, its data group those of its column
(``torch.distributed.new_group(..., backend="gloo")``, which every rank of
the world enters in the same order). The rendezvous is a ``FileStore`` in a
temporary directory, never a fixed TCP port, so concurrent worlds on one
host (test workers, a launcher beside a test) cannot collide.

``make_production_mesh`` gives the reference's production grids (16 × 16,
or 2 × 16 × 16) as the shapes the planner reads, and ``dry_context`` one
rank's context on such a grid for the dry run (``launch.dryrun``): sizes
and coordinates, no process group and no device.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

from repro_torch.launch.dist import DistContext, ep_context
from repro_torch.launch.sharding import GridShape


def _join(world: int, rank: Optional[int], init_file: Optional[str]) -> None:
    """Join the default process group of ``world`` ranks, initialising it
    over gloo with a ``FileStore`` at ``init_file`` as rank ``rank`` when
    there is none yet (``spawn`` does this for its children)."""
    if not tdist.is_initialized():
        if rank is None or init_file is None:
            raise ValueError("no process group yet: give rank and "
                             "init_file, or start the ranks with spawn()")
        store = tdist.FileStore(str(init_file), world)
        tdist.init_process_group("gloo", store=store, rank=rank,
                                 world_size=world)
    elif tdist.get_backend() != "gloo":
        raise ValueError(f"the port's meshes run over gloo, not "
                         f"{tdist.get_backend()}")
    if tdist.get_world_size() != world:
        raise ValueError(f"process group of {tdist.get_world_size()} ranks, "
                         f"asked for {world}")


def grid_context(n_data: int, n_model: int, *,
                 ranks: Optional[Sequence[int]] = None, device=None,
                 tokens_ep_sharded: bool = False) -> Optional[DistContext]:
    """This rank's context on an (``n_data`` × ``n_model``) grid over
    ``ranks`` of the world (default: every rank), or None on a rank outside
    it. ``ranks`` must be ascending: ``new_group`` numbers a group's members
    in ascending order, and a rank's grid coordinates are its place in that
    order. Every rank of the world must call it, in the same order as every
    other call that makes groups: it makes the grid's model groups, then its
    data groups, then its token group, each with ``new_group`` (a grid over
    the whole world uses the default group where an axis spans it; a
    model-only grid over the whole world is ``ep_context``'s group, bit
    for bit). ``device`` None: the card."""
    if n_data < 1 or n_model < 1:
        raise ValueError("n_data and n_model must be >= 1")
    world = tdist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n_data * n_model or len(set(ranks)) != len(ranks):
        raise ValueError(f"{len(ranks)} distinct ranks for a {n_data} x "
                         f"{n_model} grid")
    if ranks != sorted(ranks):
        raise ValueError(f"grid ranks {ranks} are not in ascending order")
    whole = ranks == list(range(world))

    def group(rs):
        if rs == list(range(world)):
            return None
        return tdist.new_group(rs, backend="gloo")

    model_groups = [group(ranks[i * n_model:(i + 1) * n_model])
                    for i in range(n_data)]
    if n_data > 1:
        data_groups = [group(ranks[j::n_model]) for j in range(n_model)]
    else:
        data_groups = [None] * n_model
    if whole:
        token_group = None
    else:
        token_group = model_groups[0] if n_data == 1 else group(ranks)
    me = tdist.get_rank()
    if me not in ranks:
        return None
    i, j = divmod(ranks.index(me), n_model)
    return DistContext(group=model_groups[i], rank=j, model_size=n_model,
                       device=device, tokens_ep_sharded=tokens_ep_sharded,
                       data_group=data_groups[j], data_rank=i,
                       data_size=n_data, token_group=token_group)


def make_production_mesh(*, multi_pod: bool = False) -> GridShape:
    """The reference's production mesh as the shape its planner reads:
    {"data": 16, "model": 16}, or ("pod", "data", "model") = (2, 16, 16)
    with ``multi_pod`` (the leading axis a second data axis). These are the
    reference's shapes, kept so that the dry run's records line up with
    its records; the port prices them on H100 SXM 80 GB cards
    (``launch.roofline``), not on the TPU v5e chips the reference assumed.
    Makes no devices and no process group."""
    if multi_pod:
        return GridShape({"pod": 2, "data": 16, "model": 16},
                         ("pod", "data", "model"))
    return GridShape({"data": 16, "model": 16}, ("data", "model"))


def dry_context(grid: GridShape, rank: int, **kw) -> DistContext:
    """Rank ``rank``'s context on ``grid`` for the dry run, inside
    ``launch.dist.dry_run()``: its model index ``rank % n_model`` and data
    index ``rank // n_model`` (the data-major layout of ``spawn``'s
    grids), every non-model axis of ``grid`` one data axis (("pod",
    "data") of 2 × 16 is one of 32), no process groups (the recorded
    collectives call no ``torch.distributed``) and the ``meta`` device.
    ``kw``: further ``DistContext`` fields (``tokens_dp_sharded``,
    ``planner``, ``batch``, ...)."""
    n_model = grid.shape["model"]
    n_data = 1
    for a in grid.axis_names:
        if a != "model":
            n_data *= grid.shape[a]
    if not 0 <= rank < n_data * n_model:
        raise ValueError(f"rank {rank} outside a grid of "
                         f"{n_data * n_model}")
    i, j = divmod(rank, n_model)
    return DistContext(group=None, rank=j, model_size=n_model,
                       device="meta", data_rank=i, data_size=n_data, **kw)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    rank: Optional[int] = None,
                    init_file: Optional[str] = None,
                    device=None) -> DistContext:
    """This process's context on a small (data × model) grid: the
    reference's ``make_debug_mesh`` under its tests' ``DistContext(mesh,
    dp_axes=("data",), tokens_dp_sharded=True)`` (the padded regimes; turn
    ``tokens_dp_sharded`` off with ``dataclasses.replace`` for the
    FF-sliced one). The world is ``n_data · n_model`` ranks (see
    ``make_ep_mesh`` for joining it)."""
    _join(n_data * n_model, rank, init_file)
    return grid_context(n_data, n_model, device=device)


def make_ep_mesh(n_shards: int, n_data: int = 1, *,
                 rank: Optional[int] = None,
                 init_file: Optional[str] = None,
                 device=None) -> DistContext:
    """The expert-parallel context of this process over ``n_data ·
    n_shards`` ranks: ``n_shards`` on the model axis each own E/n_shards
    experts and, with every rank of the grid, a token slice; an optional
    data axis replicates the expert layout (the reference's ``ep_context(
    make_ep_mesh(n_shards, n_data))``). Joins the default process group
    when one exists; otherwise initialises it over gloo with a
    ``FileStore`` at ``init_file`` as rank ``rank`` (``spawn`` does this
    for its children). ``device`` None: the card."""
    if n_shards < 1 or n_data < 1:
        raise ValueError("n_shards and n_data must be >= 1")
    _join(n_data * n_shards, rank, init_file)
    if n_data == 1:
        return ep_context(None, tdist.get_rank(), n_shards, device)
    return grid_context(n_data, n_shards, device=device,
                        tokens_ep_sharded=True)


def data_axes(ctx: DistContext) -> tuple:
    """The axes the tokens split over besides the model axis (the
    reference's ``data_axes``)."""
    return ("data",)


def model_axis(ctx: DistContext) -> str:
    return "model"


def rank_device(rank: int, n_shards: int, device) -> torch.device:
    """The device of ``rank``: the CPU when asked for, else ``cuda:rank``
    where there are ``n_shards`` cards and ``cuda:0`` (shared by every
    rank) where there are fewer."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if torch.cuda.device_count() >=
                        n_shards else 0)


def _child(rank: int, fn: Callable, n_shards: int, n_data: int,
           device: str, args: tuple, tmp: str,
           threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dev = rank_device(rank, n_shards * n_data, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = dict(rank=rank, init_file=os.path.join(tmp, "store"), device=dev)
    ctx = make_ep_mesh(n_shards, n_data, **init)
    try:
        out = fn(ctx, *args)
        path = pathlib.Path(tmp) / f"result_{rank}.pkl"
        with open(path.with_suffix(".tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(path.with_suffix(".tmp"), path)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def spawn(fn: Callable, n_shards: int, device="cuda", *args,
          n_data: int = 1, tmpdir: Optional[str] = None,
          threads: Optional[int] = None) -> List:
    """Run ``fn(ctx, *args)`` in ``n_data · n_shards`` new processes (the
    ``spawn`` start method), one rank of the grid each (``ctx`` from
    ``make_ep_mesh(n_shards, n_data)``: replace its ``tokens_ep_sharded``
    and ``tokens_dp_sharded`` with ``dataclasses.replace`` for the other
    regimes), and return their results in rank order.
    ``fn`` must be importable by name (a module-level function), and its
    result picklable. ``device``: "cpu", or "cuda" (see ``rank_device``).
    ``tmpdir``: where the rendezvous file and the results go (a temporary
    directory by default). ``threads``: each child's torch intra-op
    threads. A rank that raises fails the call with its traceback; the
    other ranks are terminated."""
    world = n_data * n_shards
    with tempfile.TemporaryDirectory(dir=tmpdir, prefix="ep_") as tmp:
        torch.multiprocessing.start_processes(
            _child,
            args=(fn, n_shards, n_data, str(device), args, tmp, threads),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(pathlib.Path(tmp) / f"result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
