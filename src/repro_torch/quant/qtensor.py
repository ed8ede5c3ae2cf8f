"""Symmetric group-wise quantization with sub-byte packing (the reference's
layout, byte for byte).

* A weight ``w`` (..., K, N) is quantized along K: every ``group_size``
  consecutive rows of a column share one scale; ``scales`` is
  (..., K // group_size, N) bf16.
* Codes are symmetric, ``q in [-qmax, qmax]`` with ``qmax = 2**(bits-1)-1``,
  stored biased (``u = q + 2**(bits-1)``) and packed little-endian along K:
  ``8 // bits`` consecutive K-rows per uint8, ``packed`` (..., K//epb, N).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SUPPORTED_BITS = (2, 4, 8)


def _elems_per_byte(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported bit-width {bits}; "
                         f"supported: {SUPPORTED_BITS}")
    return 8 // bits


@dataclasses.dataclass
class QuantizedTensor:
    """Packed integer weight + per-group scales; ``shape`` is the logical
    (dequantized) shape."""
    packed: torch.Tensor       # uint8 (..., K // epb, N)
    scales: torch.Tensor       # bf16 (..., K // group_size, N)
    bits: int
    group_size: int
    shape: tuple

    def __getitem__(self, i) -> "QuantizedTensor":
        """Slice the leading (layer / expert) axes."""
        packed = self.packed[i]
        k = packed.shape[-2] * _elems_per_byte(self.bits)
        return QuantizedTensor(self.packed[i], self.scales[i], self.bits,
                               self.group_size,
                               tuple(packed.shape[:-2]) + (k,
                                                           packed.shape[-1]))

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scales=self.scales.to(device))

    @property
    def nbytes(self) -> int:
        return quantized_nbytes(self.shape, self.bits, self.group_size)


def quantized_nbytes(shape, bits: int, group_size: int,
                     scale_bytes: int = 2) -> int:
    """Device bytes of the packed representation (codes + scales)."""
    n_elem = int(np.prod(shape))
    k = shape[-2]
    n_groups = n_elem // shape[-2] * (k // group_size)
    return n_elem * bits // 8 + n_groups * scale_bytes


def pack_bits(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack biased codes ``u`` (uint8-valued, (..., K, N)) along axis -2."""
    epb = _elems_per_byte(bits)
    if bits == 8:
        return u.to(torch.uint8)
    *lead, k, n = u.shape
    if k % epb:
        raise ValueError(f"K={k} not divisible by elems/byte={epb}")
    u = u.to(torch.int32).reshape(*lead, k // epb, epb, n)
    shifts = (torch.arange(epb, dtype=torch.int32, device=u.device)
              * bits).reshape((1,) * len(lead) + (1, epb, 1))
    return torch.sum(u << shifts, dim=-2).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: biased codes (..., K, N) int32."""
    epb = _elems_per_byte(bits)
    if bits == 8:
        return packed.to(torch.int32)
    *lead, kp, n = packed.shape
    if kp * epb != k:
        raise ValueError(f"packed K={kp} * epb={epb} != K={k}")
    shifts = (torch.arange(epb, dtype=torch.int32, device=packed.device)
              * bits).reshape((1,) * len(lead) + (1, epb, 1))
    u = (packed.to(torch.int32)[..., :, None, :] >> shifts) & ((1 << bits) - 1)
    return u.reshape(*lead, k, n)


def quantize(w: torch.Tensor, bits: int, group_size: int = 64,
             scale_dtype=torch.bfloat16) -> QuantizedTensor:
    """Symmetric group-wise quantization of ``w`` (..., K, N) along K.

    The codes are rounded with the float32 scale and only then is the scale
    stored in ``scale_dtype`` — the reference's order. ``torch.round``
    rounds half to even, like ``jnp.round``."""
    epb = _elems_per_byte(bits)
    *lead, k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if group_size % epb:
        raise ValueError(f"group_size={group_size} not divisible by "
                         f"elems/byte")
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32).reshape(*lead, k // group_size, group_size, n)
    absmax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    # The reference's ``absmax / qmax`` is compiled as a product with the
    # float32 reciprocal of the constant; the codes of values that land on
    # a .5 tie depend on that last bit, so the port computes it the same way.
    scale = torch.where(absmax > 0, absmax * np.float32(1.0 / qmax),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int32)
    u = (q + (1 << (bits - 1))).reshape(*lead, k, n)
    return QuantizedTensor(packed=pack_bits(u, bits),
                           scales=scale.squeeze(-2).to(scale_dtype),
                           bits=bits, group_size=group_size,
                           shape=tuple(w.shape))


def unpack_codes_int8(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Unpack to centered int8 codes (..., K, N)."""
    if bits == 8:
        return (packed.to(torch.int16) - 128).to(torch.int8)
    epb = _elems_per_byte(bits)
    *lead, kp, n = packed.shape
    shifts = (torch.arange(epb, dtype=torch.int32, device=packed.device)
              * bits).reshape((1,) * len(lead) + (1, epb, 1))
    u = (packed.to(torch.int32)[..., :, None, :] >> shifts) & ((1 << bits) - 1)
    return (u - (1 << (bits - 1))).to(torch.int8).reshape(*lead, kp * epb, n)


def dequant_arrays(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                   group_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize from raw arrays; shapes come from the arrays, so sliced
    leading axes dequantize correctly."""
    *lead, kp, n = packed.shape
    k = kp * _elems_per_byte(bits)
    q = unpack_bits(packed, bits, k) - (1 << (bits - 1))
    qf = q.reshape(*lead, k // group_size, group_size, n).to(torch.float32)
    w = qf * scales[..., :, None, :].to(torch.float32)
    return w.reshape(*lead, k, n).to(dtype)
