"""Checkpoints: a tree → a directory of ``.npy`` leaves and a manifest, in
the reference's layout (``training/checkpoint.py``): ``leaf_{i:05d}.npy``
in the reference's flatten order (``training.tree``), bf16 leaves stored
as float32 (a lossless superset), and ``manifest.json`` with
``n_leaves``, ``step`` and ``dtypes``. Where the reference writes its
treedef, the port writes the leaves' key paths (``paths``). A checkpoint
written by either package loads into the other. Leaves are written
and read by a few threads at once (the device copies of one overlap the
file writes of others); the files are the same.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import tree as T

#: Leaves in flight at once while saving or loading.
IO_THREADS = 4


def _to_numpy(leaf):
    """(array to store, its dtype's name): bf16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree, step: int | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    paths, flat = T.flatten(tree)

    def save(i):
        arr, name = _to_numpy(flat[i])
        np.save(os.path.join(path, f"leaf_{i:05d}.npy"), arr)
        return name

    with ThreadPoolExecutor(IO_THREADS) as pool:
        dtypes = list(pool.map(save, range(len(flat))))
    manifest = {"n_leaves": len(flat), "paths": paths, "step": step,
                "dtypes": dtypes}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree`` (shapes must match):
    each leaf in the like leaf's dtype on its device. Returns (tree,
    step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = T.leaves(like_tree)
    if manifest["n_leaves"] != len(flat_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(flat_like)}")
    def load(i):
        like = flat_like[i]
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if isinstance(like, torch.Tensor):
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            arr = torch.from_numpy(arr).to(like.device).to(like.dtype)
        return arr

    with ThreadPoolExecutor(IO_THREADS) as pool:
        out = list(pool.map(load, range(len(flat_like))))
    return T.unflatten(like_tree, out), manifest.get("step")
