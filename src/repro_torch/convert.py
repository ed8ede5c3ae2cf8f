"""Convert a reference parameter tree (given as numpy) into the port's
tensors, so both packages can run on one set of weights.

The reference's bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays,
which torch cannot take directly: they travel as their raw 16-bit patterns
(``.view(np.uint16)``) and are reinterpreted as ``torch.bfloat16``, bit for
bit. Block leaves keep their leading ``nsb`` (layer) axis. Quantized banks
convert leaf by leaf (``bank_from_reference``), duck-typed on the
reference's ``ExpertBankQ`` fields, so no reference module is imported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.ver import ExpertBankQ
from repro_torch.quant.qtensor import QuantizedTensor


def to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy (or array-like) leaf → tensor on ``device``; bfloat16
    leaves are carried over bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_reference(tree: Any, device="cpu") -> Any:
    """Nested dicts of numpy leaves → the same nesting of tensors (None
    leaves stay None)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return to_torch(tree, device)


def bank_from_reference(bank, device="cpu") -> ExpertBankQ:
    """A reference ``ExpertBankQ`` (lo: name → QuantizedTensor, hi: name →
    array, ``slot_owner``, ``slot_map``) → the port's bank."""
    lo: Dict[str, QuantizedTensor] = {}
    for n, q in bank.lo.items():
        lo[n] = QuantizedTensor(packed=to_torch(q.packed, device),
                                scales=to_torch(q.scales, device),
                                bits=int(q.bits),
                                group_size=int(q.group_size),
                                shape=tuple(q.shape))
    return ExpertBankQ(
        lo=lo, hi={n: to_torch(h, device) for n, h in bank.hi.items()},
        slot_owner=to_torch(bank.slot_owner, device).to(torch.int32),
        slot_map=to_torch(bank.slot_map, device).to(torch.int32))
