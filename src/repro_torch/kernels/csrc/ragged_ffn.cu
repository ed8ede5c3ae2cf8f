// Ragged mixed-precision SwiGLU expert FFN for Hopper (sm_90a): two kernels.
//
// Replaces the two Pallas kernels of `ragged_quant_ffn` in
// src/repro/kernels/quant_matmul.py: `_ragged_gateup_kernel` (x·W_gate and
// x·W_up on each row tile's tier, SiLU·mul epilogue) and
// `_ragged_down_kernel` (h·W_down on the same tiles and tiers).
//
// Layout. Tokens arrive compacted into R = Tt·BM rows, sorted by expert,
// each expert's segment padded to the row tile BM = 8. Row tile t computes
// with expert tile_eid[t]: from its hi bf16 pool slot when tile_slot[t] >= 0
// (and a hi pool exists), else from its packed lo codes (int2/int4/int8,
// biased, 8/bits K-rows per byte, little-endian) with bf16 scales per
// (group of K rows, column). Tiles t >= *n_tiles are tail tiles and return
// at once; their output rows are left unwritten (callers select real rows
// with torch.where). n_tiles is read from device memory, so the host never
// waits for the routing to finish.
//
// Arithmetic (the reference's group-blocked rule): per scale group a partial
// dot in float32, then multiplied by the group's scale and added to the
// float32 accumulator. Products of bf16 activations and integer codes are
// exact in float32. The gate/up epilogue rounds g and u to bf16, evaluates
// SiLU in float32, rounds, and multiplies in bf16.
//
// What bounds it on this card. At decode a tile holds a handful of tokens:
// each weight byte is used for at most BM = 8 rows, far below the ~295
// operations per byte where the H100's bf16 tensor cores (989 TFLOP/s)
// overtake its 3.35 TB/s of HBM. The kernel is bound by the bytes of the
// weights of the experts the step routed to (int4: ~0.5 B per weight, hi:
// 2 B). Design: one CTA per (row tile, 64-column block); each of its 8 warps
// walks a disjoint set of scale groups of K; the 32 lanes of a warp cover 64
// adjacent columns, so a warp reads 64 contiguous code bytes (or 128 bf16
// bytes) per K-row; codes unpack in registers and never exist dequantized in
// memory; the activation tile sits in shared memory and is broadcast to all
// lanes. The per-warp partial sums reduce through shared memory at the end.
// No tensor cores yet: BM = 8 rows is far below a wgmma M of 64, which is
// the first thing a later redesign addresses (weights as the M operand, or
// several segments per CTA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_codes.cuh"

namespace {

constexpr int BM = 8;          // rows per tile
constexpr int BN = 64;         // columns per CTA
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// acc[m][r][c] += x_tile[r] · W_m[:, n0 + 2·lane + c] over this warp's
// groups of K, for NMAT matrices of the same tile.
template <int NMAT, int BITS>
__device__ __forceinline__ void tile_product(
    float (&acc)[NMAT][BM][2], const __nv_bfloat16* __restrict__ xs_s, int K,
    int N, int n0, int group, bool is_hi,
    const uint8_t* const (&lo_packed)[2],
    const __nv_bfloat16* const (&lo_scales)[2],
    const __nv_bfloat16* const (&hi_w)[2]) {
  constexpr int EPB = 8 / BITS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = n0 + 2 * lane;
  const int n_groups = K / group;
  for (int grp = warp; grp < n_groups; grp += NWARPS) {
    float part[NMAT][BM][2];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int r = 0; r < BM; ++r) part[m][r][0] = part[m][r][1] = 0.f;
    const int k0 = grp * group;
    if (is_hi) {
      for (int k = k0; k < k0 + group; ++k) {
        float w[NMAT][2];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              hi_w[m] + (size_t)k * N + col);
          w[m][0] = __bfloat162float(v.x);
          w[m][1] = __bfloat162float(v.y);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float xv = __bfloat162float(xs_s[r * K + k]);
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            part[m][r][0] = fmaf(xv, w[m][0], part[m][r][0]);
            part[m][r][1] = fmaf(xv, w[m][1], part[m][r][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          acc[m][r][0] += part[m][r][0];
          acc[m][r][1] += part[m][r][1];
        }
    } else {
      for (int kp = k0 / EPB; kp < (k0 + group) / EPB; ++kp) {
        uint32_t b[NMAT][2];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          const uint16_t two = *reinterpret_cast<const uint16_t*>(
              lo_packed[m] + (size_t)kp * N + col);
          b[m][0] = two & 0xffu;
          b[m][1] = two >> 8;
        }
#pragma unroll
        for (int j = 0; j < EPB; ++j) {
          const int k = kp * EPB + j;
          float w[NMAT][2];
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            w[m][0] = code_at<BITS>(b[m][0], j);
            w[m][1] = code_at<BITS>(b[m][1], j);
          }
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const float xv = __bfloat162float(xs_s[r * K + k]);
#pragma unroll
            for (int m = 0; m < NMAT; ++m) {
              part[m][r][0] = fmaf(xv, w[m][0], part[m][r][0]);
              part[m][r][1] = fmaf(xv, w[m][1], part[m][r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
            lo_scales[m] + (size_t)grp * N + col);
        const float s0 = __bfloat162float(s.x), s1 = __bfloat162float(s.y);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          acc[m][r][0] = fmaf(part[m][r][0], s0, acc[m][r][0]);
          acc[m][r][1] = fmaf(part[m][r][1], s1, acc[m][r][1]);
        }
      }
    }
  }
}

// Shared-memory bytes: the activation tile, later reused for the
// cross-warp reduction of NMAT accumulators.
template <int NMAT>
size_t smem_bytes(int K) {
  const size_t x_bytes = (size_t)BM * K * sizeof(__nv_bfloat16);
  const size_t red_bytes = (size_t)NWARPS * NMAT * BM * BN * sizeof(float);
  return x_bytes > red_bytes ? x_bytes : red_bytes;
}

// NMAT = 2: gate/up with the SiLU·mul epilogue; NMAT = 1: down.
template <int NMAT, int BITS>
__global__ void __launch_bounds__(NTHREADS)
ragged_ffn_kernel(const __nv_bfloat16* __restrict__ xs,
                  const int32_t* __restrict__ tile_eid,
                  const int32_t* __restrict__ tile_slot,
                  const int32_t* __restrict__ n_tiles,
                  const uint8_t* __restrict__ p0,
                  const __nv_bfloat16* __restrict__ s0,
                  const uint8_t* __restrict__ p1,
                  const __nv_bfloat16* __restrict__ s1,
                  const __nv_bfloat16* __restrict__ h0,
                  const __nv_bfloat16* __restrict__ h1,
                  __nv_bfloat16* __restrict__ out, int K, int N, int n_hi,
                  int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  if (t >= *n_tiles) return;               // tail tile: rows stay unwritten
  const int n0 = blockIdx.y * BN;
  const int e = tile_eid[t];
  const int slot = tile_slot[t];
  const bool is_hi = slot >= 0 && n_hi > 0 && h0 != nullptr;
  constexpr int EPB = 8 / BITS;

  // Activation tile → shared memory (16-byte vectors when K allows).
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* xt = xs + (size_t)t * BM * K;
  if (K % 8 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(xt);
    uint4* dst = reinterpret_cast<uint4*>(xs_s);
    for (int i = threadIdx.x; i < BM * K / 8; i += NTHREADS) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < BM * K; i += NTHREADS) xs_s[i] = xt[i];
  }
  __syncthreads();

  const size_t lo_stride = (size_t)(K / EPB) * N;
  const size_t sc_stride = (size_t)(K / group) * N;
  const size_t hi_stride = (size_t)K * N;
  // Per-matrix weight pointers of this tile's expert (slot 1 unused when
  // NMAT == 1).
  const uint8_t* const lp[2] = {p0 + (size_t)e * lo_stride,
                                   NMAT > 1 ? p1 + (size_t)e * lo_stride
                                            : nullptr};
  const __nv_bfloat16* const ls[2] = {
      s0 + (size_t)e * sc_stride, NMAT > 1 ? s1 + (size_t)e * sc_stride
                                           : nullptr};
  const __nv_bfloat16* const hw[2] = {
      is_hi ? h0 + (size_t)slot * hi_stride : nullptr,
      (is_hi && NMAT > 1) ? h1 + (size_t)slot * hi_stride : nullptr};

  float acc[NMAT][BM][2];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[m][r][0] = acc[m][r][1] = 0.f;
  tile_product<NMAT, BITS>(acc, xs_s, K, N, n0, group, is_hi, lp, ls, hw);
  __syncthreads();                         // activation tile no longer read

  // Cross-warp reduction: red[warp][m][r][c].
  float* red = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      float* row = red + ((size_t)(warp * NMAT + m) * BM + r) * BN;
      row[2 * lane] = acc[m][r][0];
      row[2 * lane + 1] = acc[m][r][1];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, c = i % BN;
    float v[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w)
        s += red[((size_t)(w * NMAT + m) * BM + r) * BN + c];
      v[m] = s;
    }
    __nv_bfloat16 o;
    if (NMAT == 2) {
      const float g16 = __bfloat162float(__float2bfloat16(v[0]));
      const float u16 = __bfloat162float(__float2bfloat16(v[NMAT - 1]));
      const float silu = g16 / (1.f + expf(-g16));
      o = __float2bfloat16(__bfloat162float(__float2bfloat16(silu)) * u16);
    } else {
      o = __float2bfloat16(v[0]);
    }
    out[((size_t)t * BM + r) * N + n0 + c] = o;
  }
}

template <int NMAT, int BITS>
int launch(const void* xs, const void* tile_eid, const void* tile_slot,
           const void* n_tiles, const void* p0, const void* s0,
           const void* p1, const void* s1, const void* h0, const void* h1,
           void* out, int Tt, int K, int N, int n_hi, int group,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<NMAT>(K);
  auto kern = ragged_ffn_kernel<NMAT, BITS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Tt, N / BN);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xs),
      static_cast<const int32_t*>(tile_eid),
      static_cast<const int32_t*>(tile_slot),
      static_cast<const int32_t*>(n_tiles), static_cast<const uint8_t*>(p0),
      static_cast<const __nv_bfloat16*>(s0), static_cast<const uint8_t*>(p1),
      static_cast<const __nv_bfloat16*>(s1),
      static_cast<const __nv_bfloat16*>(h0),
      static_cast<const __nv_bfloat16*>(h1),
      static_cast<__nv_bfloat16*>(out), K, N, n_hi, group);
  return (int)cudaGetLastError();
}

template <int NMAT>
int dispatch_bits(int bits, const void* xs, const void* tile_eid,
                  const void* tile_slot, const void* n_tiles, const void* p0,
                  const void* s0, const void* p1, const void* s1,
                  const void* h0, const void* h1, void* out, int Tt, int K,
                  int N, int n_hi, int group, cudaStream_t stream) {
  switch (bits) {
    case 2:
      return launch<NMAT, 2>(xs, tile_eid, tile_slot, n_tiles, p0, s0, p1,
                             s1, h0, h1, out, Tt, K, N, n_hi, group, stream);
    case 4:
      return launch<NMAT, 4>(xs, tile_eid, tile_slot, n_tiles, p0, s0, p1,
                             s1, h0, h1, out, Tt, K, N, n_hi, group, stream);
    case 8:
      return launch<NMAT, 8>(xs, tile_eid, tile_slot, n_tiles, p0, s0, p1,
                             s1, h0, h1, out, Tt, K, N, n_hi, group, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// h (Tt·8, F) = bf16(silu(xs·W_gate)) · bf16(xs·W_up), per tile on its tier.
int ragged_gateup(const void* xs, const void* tile_eid, const void* tile_slot,
                  const void* n_tiles, const void* gate_packed,
                  const void* gate_scales, const void* up_packed,
                  const void* up_scales, const void* hi_gate,
                  const void* hi_up, void* h, int Tt, int K, int F, int n_hi,
                  int bits, int group, void* stream) {
  if (Tt == 0) return 0;
  return dispatch_bits<2>(bits, xs, tile_eid, tile_slot, n_tiles, gate_packed,
                          gate_scales, up_packed, up_scales, hi_gate, hi_up,
                          h, Tt, K, F, n_hi, group,
                          static_cast<cudaStream_t>(stream));
}

// y (Tt·8, D) = h · W_down, per tile on its tier.
int ragged_down(const void* h, const void* tile_eid, const void* tile_slot,
                const void* n_tiles, const void* down_packed,
                const void* down_scales, const void* hi_down, void* y, int Tt,
                int F, int D, int n_hi, int bits, int group, void* stream) {
  if (Tt == 0) return 0;
  return dispatch_bits<1>(bits, h, tile_eid, tile_slot, n_tiles, down_packed,
                          down_scales, nullptr, nullptr, hi_down, nullptr, y,
                          Tt, F, D, n_hi, group,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
