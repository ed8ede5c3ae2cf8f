"""Process groups of the port: the counterpart of the reference's
``launch/mesh.py`` for expert-parallel serving (``make_ep_mesh``), and
``spawn``, which starts one process per shard and runs a function on each.

The reference builds a device mesh for one controller; the port starts N
processes and joins them into one gloo group (``launch.dist``: NCCL will
not put two ranks on one device). The rendezvous is a ``FileStore`` in a
temporary directory, never a fixed TCP port, so concurrent groups on one
host (test workers, a launcher beside a test) cannot collide.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as tdist

from repro_torch.launch.dist import DistContext, ep_context


def make_ep_mesh(n_shards: int, *, rank: Optional[int] = None,
                 init_file: Optional[str] = None,
                 device=None) -> DistContext:
    """The expert-parallel context of this process over ``n_shards`` ranks.
    Joins the default process group when one exists; otherwise
    initialises it over gloo with a ``FileStore`` at ``init_file`` as rank
    ``rank`` (``spawn`` does this for its children)."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if not tdist.is_initialized():
        if rank is None or init_file is None:
            raise ValueError("no process group yet: give rank and "
                             "init_file, or start the ranks with spawn()")
        store = tdist.FileStore(str(init_file), n_shards)
        tdist.init_process_group("gloo", store=store, rank=rank,
                                 world_size=n_shards)
    elif tdist.get_backend() != "gloo":
        raise ValueError(f"the port's expert parallelism runs over gloo, "
                         f"not {tdist.get_backend()}")
    if tdist.get_world_size() != n_shards:
        raise ValueError(f"process group of {tdist.get_world_size()} ranks, "
                         f"asked for {n_shards} shards")
    return ep_context(None, tdist.get_rank(), n_shards, device)


def rank_device(rank: int, n_shards: int, device) -> torch.device:
    """The device of ``rank``: the CPU when asked for, else ``cuda:rank``
    where there are ``n_shards`` cards and ``cuda:0`` (shared by every
    rank) where there are fewer."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if torch.cuda.device_count() >=
                        n_shards else 0)


def _child(rank: int, fn: Callable, n_shards: int, device: str, args: tuple,
           tmp: str, threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dev = rank_device(rank, n_shards, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ctx = make_ep_mesh(n_shards, rank=rank,
                       init_file=os.path.join(tmp, "store"), device=dev)
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
          tmpdir: Optional[str] = None,
          threads: Optional[int] = None) -> List:
    """Run ``fn(ctx, *args)`` in ``n_shards`` new processes (the ``spawn``
    start method), one rank each, and return their results in rank order.
    ``fn`` must be importable by name (a module-level function), and its
    result picklable. ``device``: "cpu", or "cuda" (see ``rank_device``).
    ``tmpdir``: where the rendezvous file and the results go (a temporary
    directory by default). ``threads``: each child's torch intra-op
    threads. A rank that raises fails the call with its traceback; the
    other ranks are terminated."""
    with tempfile.TemporaryDirectory(dir=tmpdir, prefix="ep_") as tmp:
        torch.multiprocessing.start_processes(
            _child, args=(fn, n_shards, str(device), args, tmp, threads),
            nprocs=n_shards, join=True, start_method="spawn")
        out = []
        for r in range(n_shards):
            with open(pathlib.Path(tmp) / f"result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
