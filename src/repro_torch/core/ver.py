"""Versioned Expert Residency: the two weight tiers and their handles.

* lo pool — packed int2/4/8 ``QuantizedTensor``s for ALL experts, always
  resident (the guaranteed fallback), leaves (L, E, ...).
* hi pool — ``n_hi`` bf16 expert slots per layer, leaves (L, n_hi, K, N),
  filled by promotions.
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

from repro_torch.quant.qtensor import (QuantizedTensor, quantize,
                                       quantized_nbytes)


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
               hi_bits: int = 16) -> ExpertBankQ:
    """Both tiers from dense bf16 experts (name → (L, E, K, N)), on their
    device. The lo tier is quantized one layer at a time (bounded float32
    scratch at full width); the hi pool starts empty and bf16.

    ``hi_bits`` < 16 (the paper's Int4-hi tier) changes nothing here, as in
    the reference, whose int-hi values are computed and then dropped:
    promotions copy the bf16 masters, and only the byte accounting
    (``expert_hi_nbytes``) prices the hi tier at ``hi_bits``."""
    names = sorted(expert_weights)
    first = expert_weights[names[0]]
    L, E = first.shape[:2]
    dev = first.device
    lo, hi = {}, {}
    for n in names:
        w = expert_weights[n]
        layers = [quantize(w[l], lo_bits, group_size) for l in range(L)]
        lo[n] = QuantizedTensor(
            packed=torch.stack([q.packed for q in layers]),
            scales=torch.stack([q.scales for q in layers]),
            bits=lo_bits, group_size=group_size, shape=tuple(w.shape))
        hi[n] = torch.zeros((L, n_hi) + tuple(w.shape[2:]),
                            dtype=torch.bfloat16, device=dev)
    return ExpertBankQ(
        lo=lo, hi=hi,
        slot_owner=torch.full((L, n_hi), -1, dtype=torch.int32, device=dev),
        slot_map=torch.full((L, E), -1, dtype=torch.int32, device=dev))


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
