// Grouped quantized GEMM of the padded MoE dispatch for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gqmm_kernel` of `grouped_quant_matmul` in
// src/repro/kernels/quant_matmul.py: xg (E, C, K) bf16 times each expert's
// packed lo codes (E, K/epb, N) uint8 with bf16 scales (E, K/g, N), giving
// (E, C, N) bf16 — the expert GEMM of the padded (E, C, d) layout, three
// calls per MoE layer. Arithmetic is the reference's group-blocked rule: per
// scale group a float32 partial dot of bf16 activations and integer codes
// (exact products), multiplied by the group's scale into a float32
// accumulator; one bf16 rounding at the end.
//
// What bounds it on this card. The padded layout computes every expert,
// whether or not a token reached it, and each code byte serves at most C
// rows: at decode C = 8, about 2·C·(8/bits) operations per byte, far below
// the ~295 operations per byte where the H100's tensor cores overtake its
// 3.35 TB/s of HBM. The kernel is bound by the bytes of ALL E experts' codes
// and scales (int4, K = 2048, N = 768, E = 128: ~107 MB per call, ~32 µs).
//
// Design. One CTA per (expert, 64-column block). It stages the block's codes
// and scales in shared memory once, then walks the C rows in chunks of 8, so
// each code byte leaves device memory once for all C rows, whatever C is.
// (The TPU tiling needed C divisible by min(128, C) and refused C = 136; here
// the last chunk masks rows >= C itself.) Within a chunk the 8 warps split
// the scale groups of K, each lane owns 2 adjacent columns, codes unpack in
// registers, the activation chunk sits in shared memory and is broadcast to
// all lanes; per-warp partial sums reduce through shared memory. CUDA cores
// only: 8 rows are far below the 64-row M of wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_codes.cuh"

namespace {

constexpr int BM = 8;          // rows per chunk
constexpr int BN = 64;         // columns per CTA
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr size_t MAX_SMEM = 232448;   // per-block limit on sm_90

// Shared memory: codes (K/epb × BN bytes), scales (K/g × BN bf16), then one
// region that holds the activation chunk and, after it is consumed, the
// cross-warp partial sums.
size_t smem_bytes(int K, int bits, int group) {
  const size_t codes = (size_t)(K / (8 / bits)) * BN;
  const size_t scales = (size_t)(K / group) * BN * sizeof(__nv_bfloat16);
  const size_t x = (size_t)BM * K * sizeof(__nv_bfloat16);
  const size_t red = (size_t)NWARPS * BM * BN * sizeof(float);
  return codes + scales + (x > red ? x : red);
}

template <int BITS>
__global__ void __launch_bounds__(NTHREADS)
gqmm_kernel(const __nv_bfloat16* __restrict__ xg,
            const uint8_t* __restrict__ packed,
            const __nv_bfloat16* __restrict__ scales,
            __nv_bfloat16* __restrict__ out, int C, int K, int N,
            int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPB = 8 / BITS;
  const int e = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int KP = K / EPB;
  const int G = K / group;
  uint8_t* w_s = smem;                                        // KP × BN
  __nv_bfloat16* s_s =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)KP * BN);  // G × BN
  unsigned char* work = smem + (size_t)KP * BN + (size_t)G * BN * 2;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(work);  // BM × K
  float* red = reinterpret_cast<float*>(work);           // NWARPS × BM × BN

  // Stage this expert's codes and scales for the column block (16-byte
  // vectors: BN code bytes and BN scale pairs per row).
  const uint8_t* pe = packed + (size_t)e * KP * N + n0;
#pragma unroll 4
  for (int i = threadIdx.x; i < KP * (BN / 16); i += NTHREADS) {
    const int r = i / (BN / 16), c = i % (BN / 16);
    reinterpret_cast<uint4*>(w_s)[i] =
        *reinterpret_cast<const uint4*>(pe + (size_t)r * N + c * 16);
  }
  const __nv_bfloat16* se = scales + (size_t)e * G * N + n0;
  for (int i = threadIdx.x; i < G * (BN / 8); i += NTHREADS) {
    const int r = i / (BN / 8), c = i % (BN / 8);
    reinterpret_cast<uint4*>(s_s)[i] =
        *reinterpret_cast<const uint4*>(se + (size_t)r * N + c * 8);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 2 * lane;
  const __nv_bfloat16* xe = xg + (size_t)e * C * K;
  for (int c0 = 0; c0 < C; c0 += BM) {
    const int rows = C - c0 < BM ? C - c0 : BM;
    // Activation chunk → shared memory; rows past C read as zeros.
    const __nv_bfloat16* xc = xe + (size_t)c0 * K;
    if (K % 8 == 0) {
      uint4* dst = reinterpret_cast<uint4*>(x_s);
      const uint4* src = reinterpret_cast<const uint4*>(xc);
      const int per_row = K / 8;
      for (int i = threadIdx.x; i < BM * per_row; i += NTHREADS)
        dst[i] = i / per_row < rows ? src[i] : make_uint4(0, 0, 0, 0);
    } else {
      for (int i = threadIdx.x; i < BM * K; i += NTHREADS)
        x_s[i] = i / K < rows ? xc[i] : __float2bfloat16(0.f);
    }
    __syncthreads();                       // codes, scales and chunk ready

    float acc[BM][2];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int grp = warp; grp < G; grp += NWARPS) {
      float part[BM][2];
#pragma unroll
      for (int r = 0; r < BM; ++r) part[r][0] = part[r][1] = 0.f;
      const int k0 = grp * group;
      for (int kp = k0 / EPB; kp < (k0 + group) / EPB; ++kp) {
        const uint16_t two =
            *reinterpret_cast<const uint16_t*>(w_s + (size_t)kp * BN + col);
        const uint32_t b0 = two & 0xffu, b1 = two >> 8;
#pragma unroll
        for (int j = 0; j < EPB; ++j) {
          const int k = kp * EPB + j;
          const float w0 = code_at<BITS>(b0, j), w1 = code_at<BITS>(b1, j);
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const float xv = __bfloat162float(x_s[r * K + k]);
            part[r][0] = fmaf(xv, w0, part[r][0]);
            part[r][1] = fmaf(xv, w1, part[r][1]);
          }
        }
      }
      const __nv_bfloat162 s =
          *reinterpret_cast<const __nv_bfloat162*>(s_s + grp * BN + col);
      const float s0 = __bfloat162float(s.x), s1 = __bfloat162float(s.y);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        acc[r][0] = fmaf(part[r][0], s0, acc[r][0]);
        acc[r][1] = fmaf(part[r][1], s1, acc[r][1]);
      }
    }
    __syncthreads();                       // chunk no longer read

#pragma unroll
    for (int r = 0; r < BM; ++r) {
      float* row = red + ((size_t)warp * BM + r) * BN;
      row[col] = acc[r][0];
      row[col + 1] = acc[r][1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      if (r >= rows) continue;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += red[((size_t)w * BM + r) * BN + c];
      out[((size_t)e * C + c0 + r) * N + n0 + c] = __float2bfloat16(s);
    }
    __syncthreads();                       // partials read: region is free
  }
}

template <int BITS>
int launch(const void* xg, const void* packed, const void* scales, void* out,
           int E, int C, int K, int N, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, BITS, group);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = gqmm_kernel<BITS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(E, N / BN);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xg),
      static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<__nv_bfloat16*>(out), C, K, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (E, C, N) = xg (E, C, K) · dequant(packed, scales) per expert, by the
// group-blocked rule; N a multiple of 64, group a multiple of 8/bits.
int grouped_quant_matmul(const void* xg, const void* packed,
                         const void* scales, void* out, int E, int C, int K,
                         int N, int bits, int group, void* stream) {
  if (E == 0 || C == 0) return 0;
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  if (N % BN != 0 || K % group != 0 || group % (8 / bits) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(xg, packed, scales, out, E, C, K, N, group, s);
    case 4: return launch<4>(xg, packed, scales, out, E, C, K, N, group, s);
    case 8: return launch<8>(xg, packed, scales, out, E, C, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
