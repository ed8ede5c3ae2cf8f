// Plain quantized GEMM for Hopper (sm_90a): x (M, K) bf16 times one packed
// lo-tier weight (K/epb, N) uint8 with bf16 scales (K/g, N) → (M, N) bf16.
//
// Replaces the Pallas kernel `_qmm_kernel` of `quant_matmul` in
// src/repro/kernels/quant_matmul.py (the entry point `ops.quant_matmul_op`).
// Its arithmetic is NOT the group-blocked rule of the MoE kernels: every
// weight is first dequantized to float32 (code · scale, rounded once), then
// multiplied with the float32 activation and summed in float32; one bf16
// rounding at the end.
//
// What bounds it on this card. At the reference's case (M = 128, K = 2048,
// N = 768) the bytes (activations 0.5 MB, int4 codes 0.8 MB, output 0.2 MB)
// and the operations (0.4 GFLOP) both take under a microsecond at the data
// sheet's rates; in practice the kernel is bound by issuing its float32
// FMAs on CUDA cores and by the parallelism of a small grid.
//
// Design. One CTA per (8-row tile of x, 64-column block): the x tile sits in
// shared memory and is broadcast, the 8 warps split the scale groups of K,
// each lane owns 2 adjacent columns, codes unpack and dequantize in
// registers (never in memory), and per-warp partial sums reduce through
// shared memory. Row tiles re-read the codes, from L2 after the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_codes.cuh"

namespace {

constexpr int BM = 8;          // rows per CTA
constexpr int BN = 64;         // columns per CTA
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr size_t MAX_SMEM = 232448;

size_t smem_bytes(int K) {
  const size_t x = (size_t)BM * K * sizeof(__nv_bfloat16);
  const size_t red = (size_t)NWARPS * BM * BN * sizeof(float);
  return x > red ? x : red;
}

template <int BITS>
__global__ void __launch_bounds__(NTHREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x,
           const uint8_t* __restrict__ packed,
           const __nv_bfloat16* __restrict__ scales,
           __nv_bfloat16* __restrict__ out, int M, int K, int N, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPB = 8 / BITS;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int rows = M - m0 < BM ? M - m0 : BM;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);  // BM × K
  float* red = reinterpret_cast<float*>(smem);           // NWARPS × BM × BN

  const __nv_bfloat16* xt = x + (size_t)m0 * K;
  if (K % 8 == 0) {
    uint4* dst = reinterpret_cast<uint4*>(x_s);
    const uint4* src = reinterpret_cast<const uint4*>(xt);
    const int per_row = K / 8;
    for (int i = threadIdx.x; i < BM * per_row; i += NTHREADS)
      dst[i] = i / per_row < rows ? src[i] : make_uint4(0, 0, 0, 0);
  } else {
    for (int i = threadIdx.x; i < BM * K; i += NTHREADS)
      x_s[i] = i / K < rows ? xt[i] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + 2 * lane;
  const int G = K / group;
  float acc[BM][2];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int grp = warp; grp < G; grp += NWARPS) {
    const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
        scales + (size_t)grp * N + col);
    const float s0 = __bfloat162float(s.x), s1 = __bfloat162float(s.y);
    const int k0 = grp * group;
    for (int kp = k0 / EPB; kp < (k0 + group) / EPB; ++kp) {
      const uint16_t two =
          *reinterpret_cast<const uint16_t*>(packed + (size_t)kp * N + col);
      const uint32_t b0 = two & 0xffu, b1 = two >> 8;
#pragma unroll
      for (int j = 0; j < EPB; ++j) {
        const int k = kp * EPB + j;
        // The dequantized weight, rounded to float32 before the product.
        const float w0 = code_at<BITS>(b0, j) * s0;
        const float w1 = code_at<BITS>(b1, j) * s1;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float xv = __bfloat162float(x_s[r * K + k]);
          acc[r][0] = fmaf(xv, w0, acc[r][0]);
          acc[r][1] = fmaf(xv, w1, acc[r][1]);
        }
      }
    }
  }
  __syncthreads();                         // x tile no longer read

#pragma unroll
  for (int r = 0; r < BM; ++r) {
    float* row = red + ((size_t)warp * BM + r) * BN;
    row[2 * lane] = acc[r][0];
    row[2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, c = i % BN;
    if (r >= rows) continue;
    float sum = 0.f;
    for (int w = 0; w < NWARPS; ++w) sum += red[((size_t)w * BM + r) * BN + c];
    out[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(sum);
  }
}

template <int BITS>
int launch(const void* x, const void* packed, const void* scales, void* out,
           int M, int K, int N, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes(K);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = qmm_kernel<BITS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((M + BM - 1) / BM, N / BN);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<__nv_bfloat16*>(out), M, K, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) = x (M, K) · (codes · scales) with float32 dequantized weights;
// N a multiple of 64, group a multiple of 8/bits.
int quant_matmul(const void* x, const void* packed, const void* scales,
                 void* out, int M, int K, int N, int bits, int group,
                 void* stream) {
  if (M == 0) return 0;
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  if (N % BN != 0 || K % group != 0 || group % (8 / bits) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, packed, scales, out, M, K, N, group, s);
    case 4: return launch<4>(x, packed, scales, out, M, K, N, group, s);
    case 8: return launch<8>(x, packed, scales, out, M, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
