"""Post-training quantization entry points (the port's counterparts of the
reference's ``quant/ptq.py``).

``quantize_expert_bank`` prepares the lo tier of a stacked expert bank;
``quantize_tree`` applies uniform static PTQ to a whole parameter tree (the
paper's static baseline) while leaving norms, embeddings and routers in
high precision, the standard weight-only PTQ scoping with RTN rounding. A
leaf is named as the reference names it (``"['blocks']['0']['attn']..."``,
lowercase), so both packages quantize the same leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.quant.qtensor import (QuantizedTensor, dequant_arrays,
                                       quantize)

# Param-name fragments that are never quantized (tiny and/or
# precision-critical).
_PTQ_SKIP = ("norm", "embed", "router", "bias", "scale", "ln_", "a_log",
             "dt_bias", "conv")


def _quantizable(path: str, leaf: Any, min_size: int) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if any(s in path for s in _PTQ_SKIP):
        return False
    if leaf.dim() < 2:
        return False
    return leaf.numel() >= min_size


def quantize_tree(params, bits: int, group_size: int = 64,
                  min_size: int = 1 << 14,
                  predicate: Optional[Callable[[str, Any], bool]] = None):
    """Uniform static PTQ over a nested dict of tensors. Returns the same
    nesting with matmul weights replaced by :class:`QuantizedTensor`
    leaves (None leaves stay None)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        name = path.lower()
        take = predicate(name, node) if predicate else \
            _quantizable(name, node, min_size)
        if take and node.shape[-2] % group_size == 0:
            return quantize(node, bits=bits, group_size=group_size)
        return node

    return walk(params, "")


def quantize_expert_bank(w: torch.Tensor, lo_bits: int,
                         group_size: int = 64) -> QuantizedTensor:
    """Quantize a stacked expert weight ``(E, K, N)`` into the lo tier."""
    return quantize(w, bits=lo_bits, group_size=group_size)


def dequant_or_identity(leaf, dtype=torch.bfloat16):
    if isinstance(leaf, QuantizedTensor):
        return dequant_arrays(leaf.packed, leaf.scales, leaf.bits,
                              leaf.group_size, dtype)
    return leaf


def dequantize_tree(params, dtype=torch.bfloat16):
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    return dequant_or_identity(params, dtype)
