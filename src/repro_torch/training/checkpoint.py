"""Checkpoints: a tree → a directory of ``.npy`` leaves and a manifest, in
the reference's layout (``training/checkpoint.py``): ``leaf_{i:05d}.npy``
in the reference's flatten order (``training.tree``), bf16 leaves stored
as float32 (a lossless superset), and ``manifest.json`` with
``n_leaves``, ``step`` and ``dtypes``. Where the reference writes its
treedef, the port writes the leaves' key paths (``paths``). A checkpoint
written by either package loads into the other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core import tree as T


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
    dtypes = []
    for i, leaf in enumerate(flat):
        arr, name = _to_numpy(leaf)
        dtypes.append(name)
        np.save(os.path.join(path, f"leaf_{i:05d}.npy"), arr)
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
    out = []
    for i, like in enumerate(flat_like):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if isinstance(like, torch.Tensor):
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            arr = torch.from_numpy(arr).to(like.device).to(like.dtype)
        out.append(arr)
    return T.unflatten(like_tree, out), manifest.get("step")
