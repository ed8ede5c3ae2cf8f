"""Versioned Expert Residency: the two weight tiers and their handles.

* lo pool — packed int2/4/8 ``QuantizedTensor``s for ALL experts, always
  resident (the guaranteed fallback), leaves (L, E, ...).
* hi pool — ``n_hi`` bf16 expert slots per layer, leaves (L, n_hi, K, N),
  filled by promotions.
* A streaming cold start builds the lo pool empty (``build_bank_empty``)
  and stages its rows in place (``write_lo_rows``).
* ``slot_owner`` (L, n_hi) int32 on the device: hi slot → expert (-1 free).
  The forward derives each tile's slot from it, so a slot is read only
  once its owner is published.
* ``slot_map`` (L, E) int32 on the device: expert → slot (-1 = lo).

The authoritative copies of both maps live on the host (numpy) inside the
transition manager; ``publish``/``unpublish`` update those, and the
manager pushes them to the device arrays in place.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import numpy as np
import torch

from repro_torch.quant.qtensor import (QuantizedTensor, _elems_per_byte,
                                       quantize, quantized_nbytes)


class Residency(enum.Enum):
    RESIDENT_LO = 0
    PROMOTING = 1
    RESIDENT_HI = 2
    DEMOTING = 3


@dataclasses.dataclass
class ExpertBankQ:
    """Mixed-precision expert bank of one MoE position, stacked over layers
    (or one layer of it, see ``layer``)."""
    lo: Dict[str, QuantizedTensor]
    hi: Dict[str, torch.Tensor]
    slot_owner: torch.Tensor
    slot_map: torch.Tensor

    @property
    def num_experts(self) -> int:
        return self.slot_map.shape[-1]

    def layer(self, l: int) -> "ExpertBankQ":
        """Views of layer ``l`` (no copies: in-place promotions into the
        stacked pool are visible through them)."""
        return ExpertBankQ(lo={n: q[l] for n, q in self.lo.items()},
                           hi={n: h[l] for n, h in self.hi.items()},
                           slot_owner=self.slot_owner[l],
                           slot_map=self.slot_map[l])

    def to(self, device) -> "ExpertBankQ":
        return ExpertBankQ(lo={n: q.to(device) for n, q in self.lo.items()},
                           hi={n: h.to(device) for n, h in self.hi.items()},
                           slot_owner=self.slot_owner.to(device),
                           slot_map=self.slot_map.to(device))


def build_bank(expert_weights: Dict[str, torch.Tensor], n_hi: int,
               lo_bits: int, group_size: int = 64,
               hi_bits: int = 16, shard=None) -> ExpertBankQ:
    """Both tiers from dense bf16 experts (name → (L, E, K, N)), on their
    device. The lo tier is quantized one layer at a time (bounded float32
    scratch at full width); the hi pool starts empty and bf16.

    ``hi_bits`` < 16 (the paper's Int4-hi tier) changes nothing here, as in
    the reference, whose int-hi values are computed and then dropped:
    promotions copy the bf16 masters, and only the byte accounting
    (``expert_hi_nbytes``) prices the hi tier at ``hi_bits``.

    ``shard=(j, n)`` (expert parallelism): the bank of shard j of n, which
    holds only experts ``[j·E/n, (j+1)·E/n)`` (lo leaves (L, E/n, ...))
    and hi slots ``[j·n_hi/n, (j+1)·n_hi/n)``; ``slot_owner`` (L, n_hi)
    and ``slot_map`` (L, E) stay global."""
    names = sorted(expert_weights)
    first = expert_weights[names[0]]
    L, E = first.shape[:2]
    dev = first.device
    e_sl, n_hold = slice(0, E), n_hi
    if shard is not None:
        j, n_shards = shard
        if E % n_shards or n_hi % n_shards:
            raise ValueError(f"num_experts={E} and n_hi={n_hi} must divide "
                             f"over {n_shards} shards")
        e_sl = slice(j * E // n_shards, (j + 1) * E // n_shards)
        n_hold = n_hi // n_shards
    lo, hi = {}, {}
    for n in names:
        w = expert_weights[n][:, e_sl]
        layers = [quantize(w[l], lo_bits, group_size) for l in range(L)]
        lo[n] = QuantizedTensor(
            packed=torch.stack([q.packed for q in layers]),
            scales=torch.stack([q.scales for q in layers]),
            bits=lo_bits, group_size=group_size, shape=tuple(w.shape))
        hi[n] = torch.zeros((L, n_hold) + tuple(w.shape[2:]),
                            dtype=torch.bfloat16, device=dev)
    return ExpertBankQ(
        lo=lo, hi=hi,
        slot_owner=torch.full((L, n_hi), -1, dtype=torch.int32, device=dev),
        slot_map=torch.full((L, E), -1, dtype=torch.int32, device=dev))


def build_bank_empty(expert_weights_shapes: Dict[str, tuple], n_hi: int,
                     lo_bits: int, group_size: int = 64,
                     device="cpu") -> ExpertBankQ:
    """A bank whose lo rows are NOT yet materialized (streaming cold start):
    packed codes and scales are zero until ``write_lo_rows`` /
    ``write_lo_expert`` stage each expert's rows from the checkpoint shards,
    in place. Callers gate serving on the store's ``lo_valid`` mask: a
    forward must never read a zero row as if it were real.

    ``expert_weights_shapes``: name → (L, E, K, N) logical dense shapes."""
    epb = _elems_per_byte(lo_bits)
    lo, hi = {}, {}
    first = next(iter(expert_weights_shapes.values()))
    L, E = first[0], first[1]
    for n, shape in sorted(expert_weights_shapes.items()):
        l4, e4, k, nn = shape
        lo[n] = QuantizedTensor(
            packed=torch.zeros((l4, e4, k // epb, nn), dtype=torch.uint8,
                               device=device),
            scales=torch.zeros((l4, e4, k // group_size, nn),
                               dtype=torch.bfloat16, device=device),
            bits=lo_bits, group_size=group_size, shape=tuple(shape))
        hi[n] = torch.zeros((l4, n_hi, k, nn), dtype=torch.bfloat16,
                            device=device)
    return ExpertBankQ(
        lo=lo, hi=hi,
        slot_owner=torch.full((L, n_hi), -1, dtype=torch.int32,
                              device=device),
        slot_map=torch.full((L, E), -1, dtype=torch.int32, device=device))


def expert_hi_nbytes(expert_weights_shapes: Dict[str, tuple],
                     hi_bits: int = 16, group_size: int = 64) -> int:
    """Device bytes of ONE expert's hi version (one layer): bf16, or
    packed int ``hi_bits`` codes with their scales below 16 bits."""
    if hi_bits >= 16:
        return sum(int(np.prod(s[2:])) * 2
                   for s in expert_weights_shapes.values())
    return sum(quantized_nbytes(s[2:], hi_bits, group_size)
               for s in expert_weights_shapes.values())


def expert_lo_nbytes(expert_weights_shapes: Dict[str, tuple], lo_bits: int,
                     group_size: int = 64) -> int:
    return sum(quantized_nbytes(s[2:], lo_bits, group_size)
               for s in expert_weights_shapes.values())


def write_hi_slot(hi_leaf: torch.Tensor, layer: int, slot: int,
                  w: torch.Tensor) -> None:
    """Copy one expert's hi weights into pool slot (layer, slot), in place
    and asynchronously when ``w`` is pinned host memory. The slot must be
    unpublished (no forward reads it) until the copy has completed."""
    hi_leaf[layer, slot].copy_(w, non_blocking=True)


def write_lo_expert(leaf: torch.Tensor, layer: int, expert: int,
                    row: torch.Tensor) -> None:
    """Copy one expert's lo-tier rows (packed codes OR scales) into an
    (L, E, ...) bank leaf, in place: the host→device staging write of
    host→lo promotion and of the streaming cold start. Asynchronous when
    ``row`` is pinned host memory; the row stays unreferenced as valid
    until its residency mask flips after the copy completed.

    In place, unlike the reference (which returns a new array and rebinds
    the bank's leaf): the decode step captured as a CUDA graph reads the
    leaf's storage, so a rebound leaf would leave it reading the old
    storage."""
    leaf[layer, expert].copy_(row, non_blocking=True)


def write_lo_rows(leaf: torch.Tensor, layer: int, idx,
                  rows: torch.Tensor) -> None:
    """Bulk variant of :func:`write_lo_expert`: stage the experts ``idx`` of
    one layer, in place. ``rows`` holds every expert's rows of that layer
    (E, ...) and is read at ``idx``, so each run of consecutive experts is
    one slice copy (one copy per leaf for the cold-start pump's row-major
    order)."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    start = 0
    for i in range(1, len(idx) + 1):
        if i < len(idx) and idx[i] == idx[i - 1] + 1:
            continue
        a, b = int(idx[start]), int(idx[i - 1]) + 1
        leaf[layer, a:b].copy_(rows[a:b], non_blocking=True)
        start = i


def swap_expert_rows(leaf: torch.Tensor, layer: int, e: int,
                     f: int) -> None:
    """Swap experts ``e`` and ``f`` at one layer of an (L, E, ...) leaf, in
    place: the device half of an ownership migration under expert
    parallelism. The expert id IS the position in every bank and router
    tensor, so moving an expert to another shard relabels the pair: swap
    the lo rows (this), the router columns (``swap_router_cols``) and the
    host mirrors; the forward is invariant under it. Where the two rows
    live on different ranks, the coordinator exchanges them instead
    (``core.controller.EPCoordinator``)."""
    row = leaf[layer, e].clone()
    leaf[layer, e] = leaf[layer, f]
    leaf[layer, f] = row


def swap_router_cols(router: torch.Tensor, layer: int, e: int,
                     f: int) -> None:
    """Swap two expert columns of an (L, d_model, E) router at ``layer``, in
    place: the compensating half of a relabel (tokens that routed to
    position ``e`` now route to ``f``, which holds the same weights)."""
    col = router[layer, :, e].clone()
    router[layer, :, e] = router[layer, :, f]
    router[layer, :, f] = col


def publish(slot_map: np.ndarray, slot_owner: np.ndarray, layer: int,
            expert: int, slot: int) -> None:
    """Host-side publish of expert → slot (slot = -1 demotes): the previous
    owner of the slot falls back to lo first."""
    if slot >= 0:
        old = int(slot_owner[layer, slot])
        if old >= 0:
            slot_map[layer, old] = -1
        slot_owner[layer, slot] = expert
    slot_map[layer, expert] = slot


def unpublish(slot_map: np.ndarray, slot_owner: np.ndarray, layer: int,
              expert: int) -> int:
    """Host-side demotion: redirect the handle to lo and free the slot.
    Returns the freed slot (-1 if the expert held none)."""
    slot = int(slot_map[layer, expert])
    slot_map[layer, expert] = -1
    if slot >= 0:
        slot_owner[layer, slot] = -1
    return slot
