"""Parameter trees in the reference's leaf order.

The port keeps the reference's trees (nested dicts of tensors; banks of
``QuantizedTensor`` leaves) and flattens them in the order JAX's
``tree_flatten`` gives: dict keys sorted; tuples, lists and named tuples in
order; ``None`` an empty subtree; a ``QuantizedTensor`` its ``packed`` then
``scales`` (``src/repro/quant/qtensor.py:52``); an ``ExpertBankQ`` its lo
tensors by sorted name, its hi leaves by sorted name, then ``slot_owner``
and ``slot_map`` (``src/repro/core/ver.py:61``). Anything else is a leaf.
The optimizer and the checkpoints of ``training`` walk trees only through
these helpers, so a checkpoint written by either package loads into the
other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core.ver import ExpertBankQ
from repro_torch.quant.qtensor import QuantizedTensor


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, subtree) pairs of an inner node in flatten order; [] for a
    leaf (see ``is_leaf``)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, QuantizedTensor):
        return [("packed", tree.packed), ("scales", tree.scales)]
    if isinstance(tree, ExpertBankQ):
        return [(f"lo.{n}", tree.lo[n]) for n in sorted(tree.lo)] + \
            [(f"hi.{n}", tree.hi[n]) for n in sorted(tree.hi)] + \
            [("slot_owner", tree.slot_owner), ("slot_map", tree.slot_map)]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        return [(fields[i] if fields else str(i), c)
                for i, c in enumerate(tree)]
    return []


def is_leaf(tree) -> bool:
    return tree is not None and not isinstance(
        tree, (dict, list, tuple, QuantizedTensor, ExpertBankQ))


def flatten(tree, prefix: str = "") -> Tuple[List[str], List[Any]]:
    """(key paths, leaves) in the reference's flatten order; a path joins
    the keys with "/"."""
    if tree is None:
        return [], []
    if is_leaf(tree):
        return [prefix], [tree]
    paths, leaves = [], []
    for k, sub in _children(tree):
        p, l = flatten(sub, f"{prefix}/{k}" if prefix else k)
        paths += p
        leaves += l
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    if is_leaf(tree):
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}          # the caller's key order
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, packed=next(it), scales=next(it))
    if isinstance(tree, ExpertBankQ):
        lo = {n: _rebuild(tree.lo[n], it) for n in sorted(tree.lo)}
        hi = {n: next(it) for n in sorted(tree.hi)}
        return ExpertBankQ(lo=lo, hi=hi, slot_owner=next(it),
                           slot_map=next(it))
    kids = [_rebuild(c, it) for c in tree]
    return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])


def first_device(tree) -> torch.device:
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the tree holds no tensor")
