"""The all-lo view of the expert banks: the batch tier's decode banks (the
port's counterpart of the reference's ``all_lo_banks`` in
``repro.serving.spec``, which its speculative drafter and its batch tier
share).

The view holds the SAME lo and hi buffers as the served banks, with every
hi slot disowned (``slot_owner`` all -1): the ragged dispatch derives each
tile's hi slot from ``slot_owner`` (``models.moe._tile_slots``), so every
tile of a forward over the view reads its expert's lo codes. No weight is
copied; the constant owner arrays are made once per MoE position and kept
in ``cache``, so a CUDA graph captured over the view reads the same
tensors at every replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.ver import ExpertBankQ


def all_lo_banks(banks: Optional[Dict], cache: Dict) -> Optional[Dict]:
    """``banks`` (MoE position → stacked ``ExpertBankQ``, or dense expert
    dicts, or None) with every ``ExpertBankQ``'s ``slot_owner`` replaced by
    an all -1 tensor of the same shape, memoized in ``cache`` per
    position. Dense banks (the fp16/offload baselines) have no lo tier and
    pass through unchanged."""
    if banks is None:
        return None
    out = {}
    for k, b in banks.items():
        if isinstance(b, ExpertBankQ):
            neg = cache.get(k)
            if neg is None or neg.shape != b.slot_owner.shape:
                neg = cache[k] = torch.full_like(b.slot_owner, -1)
            out[k] = dataclasses.replace(b, slot_owner=neg)
        else:
            out[k] = b
    return out
