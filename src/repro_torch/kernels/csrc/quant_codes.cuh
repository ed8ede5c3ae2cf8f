// Packed lo-tier codes, shared by the quantized GEMM kernels.
//
// Codes are symmetric integers stored biased (u = q + 2^(bits-1)) and packed
// little-endian along K: 8/bits consecutive K-rows per byte (the layout of
// src/repro_torch/quant/qtensor.py).
#pragma once

#include <stdint.h>

// Centered code j (0 <= j < 8/BITS) of one packed byte, as a float.
template <int BITS>
__device__ __forceinline__ float code_at(uint32_t byte, int j) {
  if (BITS == 8) return float(int(byte) - 128);
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  return float(int((byte >> (j * BITS)) & MASK) - (1 << (BITS - 1)));
}
