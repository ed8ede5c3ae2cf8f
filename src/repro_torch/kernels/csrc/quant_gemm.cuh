// The grouped and plain quantized GEMM for Hopper (sm_90a) on the swap-AB
// main loop of `quant_mma.cuh` (`qmma::tile_product`): `gemm_kernel` runs
// that loop over every (expert, NT·8 rows, 128 columns) of an (E, C, K) ×
// (E, K/epb, N) product, with K optionally cut into S ranges of whole
// scale groups whose float32 partials `sum_splits` adds in order; `gemm`
// is the checked launch that `grouped_quant_matmul.cu` and
// `quant_matmul.cu` export. Everything here has internal linkage, so each
// library keeps its own once-per-kernel attribute flags.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"

namespace qmma {
namespace {

// 16-column blocks per warp: the loop's NMAT, two m16 blocks of one
// weight that share each B fragment (a CTA covers 128 columns).
constexpr int WB = 2;
constexpr int CTA_N = NWARPS * WB * WN;

// Shared memory of a GEMM CTA: the activation tile (NT·8 rows of a
// piece's gpc·group K values + PAD), then per warp its ring and its
// columns' scales for gpc groups (both for WB blocks).
inline size_t gemm_smem_bytes(int nt, int group, int gpc) {
  return (size_t)nt * BM * (gpc * group + PAD) * sizeof(__nv_bfloat16) +
         (size_t)NWARPS * WB * (RING + (size_t)gpc * WN * 2);
}

// out (E, C, N) = x (E, C, K) · dequant(packed (E, K/EPB, N), scales
// (E, K/group, N)) by the group-blocked rule. One CTA per (expert e, chunk
// group j of NT·8 rows, 128-column block), column blocks fastest in
// blockIdx.x (the CTAs of one expert read whole rows of its codes
// together; the other chunk groups re-read them from L2), and per K range
// z = blockIdx.y of gps scale groups. The CTA walks its range in pieces of
// gpc groups, one activation tile in shared memory reused by every piece
// (a smaller tile lets more CTAs share an SM), accumulating in registers.
// With one range the CTA rounds its float32 sums to bf16 into `out`; with
// several it writes them to `part` (S, E, C, N) float32 for `sum_splits`.
// Rows at or past C are zero-filled in shared memory and never stored; a
// warp whose 32 columns start at or past N (the last block when N % 128 is
// 64) computes on columns 0–31 and stores nothing.
template <int BITS, int NT>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ packed,
            const __nv_bfloat16* __restrict__ scales,
            __nv_bfloat16* __restrict__ out, float* __restrict__ part,
            int E, int C, int K, int N, int group, int gps, int gpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPB = 8 / BITS;
  const int n_cb = (N + CTA_N - 1) / CTA_N;
  const int n_j = (C + NT * BM - 1) / (NT * BM);
  const int cb = blockIdx.x % n_cb;
  const int j = (blockIdx.x / n_cb) % n_j;
  const int e = blockIdx.x / (n_cb * n_j);
  const int G = K / group;
  const int g_end = min(G, (int)(blockIdx.y + 1) * gps);  // range's end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = cb * CTA_N + warp * WB * WN;   // warp's 32 columns
  const bool live = n0 < N;
  const int nc = live ? n0 : 0;            // the columns it reads
  const int r0 = j * NT * BM;              // CTA's first row of expert e

  const int ldx = gpc * group + PAD;
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + (size_t)NT * BM * ldx * sizeof(__nv_bfloat16) +
                        (size_t)warp * WB * (RING + (size_t)gpc * WN * 2);
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(ring + WB * RING);
  const __nv_bfloat16* const hw[2] = {nullptr, nullptr};
  float acc[WB][NT][4];
#pragma unroll
  for (int m = 0; m < WB; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;

  for (int g0 = blockIdx.y * gps; g0 < g_end; g0 += gpc) {
    const int n_grp = min(gpc, g_end - g0);   // this piece's scale groups
    const int k0 = g0 * group, ks = n_grp * group;
    if (g0 > (int)blockIdx.y * gps)
      __syncthreads();                     // the last piece's tile is read
    // The piece of the activation rows → shared memory (all threads; rows
    // past C as zeros), and each warp's columns of the piece's scales: one
    // copy group.
    const int cpr = ks / 8;                // 16-byte chunks per row
    for (int i = threadIdx.x; i < NT * BM * cpr; i += NTHREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const bool real = r0 + r < C;
      const __nv_bfloat16* src =
          real ? x + ((size_t)e * C + r0 + r) * K + k0 + c : x;
      cp_async16(xs_s + r * ldx + c, src, real ? 16 : 0);
    }
    const __nv_bfloat16* se = scales + ((size_t)e * G + g0) * N + nc;
    for (int i = lane; i < WB * n_grp * 2; i += 32) {
      const int m = i / (2 * n_grp), g = (i >> 1) % n_grp, h = i & 1;
      cp_async16(sc_s + (m * n_grp + g) * WN + 8 * h,
                 se + (size_t)g * N + 16 * m + 8 * h);
    }
    cp_async_commit();
    const uint8_t* base = packed + ((size_t)e * (K / EPB) + k0 / EPB) * N;
    const uint8_t* const lp[2] = {base, base + 16};
    tile_product<WB, BITS, false, NT>(acc, xs_s, ldx, ring, sc_s, lp, hw,
                                      ks, N, nc, group, lane);
  }

  // acc[m][i][q]: row 8·i + 2·tid + (q & 1) of the chunk group, column
  // 16·m + 2·gid + (q >> 1) of the warp's 32 (the permuted lo columns): a
  // lane stores two adjacent columns of two rows per block.
  if (!live) return;
  const int gid = lane >> 2, tid = lane & 3;
  const int col = n0 + 2 * gid;
#pragma unroll
  for (int m = 0; m < WB; ++m) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + i * BM + 2 * tid + h;
        if (r >= C) continue;
        const size_t o = ((size_t)e * C + r) * N + col + 16 * m;
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + (size_t)blockIdx.y * E * C * N +
                                     o) =
              make_float2(acc[m][i][h], acc[m][i][h + 2]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(acc[m][i][h], acc[m][i][h + 2]);
        }
      }
    }
  }
}

// out[i] = bf16(part[0][i] + part[1][i] + … + part[S−1][i]), the ranges
// added in order (float32), four elements per thread.
__global__ void sum_splits(const float* __restrict__ part,
                           __nv_bfloat16* __restrict__ out, long long n,
                           int S) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < S; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(part + z * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(s.x,
                                                                      s.y);
  *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
      __floats2bfloat162_rn(s.z, s.w);
}

template <int BITS, int NT>
int launch_gemm(const void* x, const void* packed, const void* scales,
                void* out, void* part, int E, int C, int K, int N, int group,
                int n_split, int gps, int gpc, cudaStream_t stream) {
  auto kern = gemm_kernel<BITS, NT>;
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t smem = gemm_smem_bytes(NT, group, gpc);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int n_j = (C + NT * BM - 1) / (NT * BM);
  dim3 grid(E * n_j * ((N + CTA_N - 1) / CTA_N), n_split);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<__nv_bfloat16*>(out),
      n_split > 1 ? static_cast<float*>(part) : nullptr, E, C, K, N, group,
      gps, gpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const long long n = (long long)E * C * N;
  const int threads = 256;
  const long long blocks = (n / 4 + threads - 1) / threads;
  sum_splits<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), n,
      n_split);
  return (int)cudaGetLastError();
}

template <int BITS>
int gemm_nt(int nt, const void* x, const void* packed, const void* scales,
            void* out, void* part, int E, int C, int K, int N, int group,
            int n_split, int gps, int gpc, cudaStream_t stream) {
  switch (nt) {
    case 1:
      return launch_gemm<BITS, 1>(x, packed, scales, out, part, E, C, K, N,
                                  group, n_split, gps, gpc, stream);
    case 2:
      return launch_gemm<BITS, 2>(x, packed, scales, out, part, E, C, K, N,
                                  group, n_split, gps, gpc, stream);
    case 4:
      return launch_gemm<BITS, 4>(x, packed, scales, out, part, E, C, K, N,
                                  group, n_split, gps, gpc, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The checked entry of both GEMM libraries: bits ∈ {2, 4, 8}, nt ∈ {1, 2,
// 4}, N a multiple of 64, group a multiple of 16, K a multiple of group,
// the S = n_split ranges of gps groups covering the K/group groups with
// none empty, pieces of 1 ≤ gpc ≤ gps groups, and float32 scratch
// (S, E, C, N) when S > 1.
inline int gemm(int bits, int nt, const void* x, const void* packed,
                const void* scales, void* out, void* part, int E, int C,
                int K, int N, int group, int n_split, int gps, int gpc,
                cudaStream_t stream) {
  if (E == 0 || C == 0) return 0;
  if (N % BN != 0 || group < 16 || group % 16 != 0 || K % group != 0)
    return (int)cudaErrorInvalidValue;
  const int G = K / group;
  if (n_split < 1 || gps < 1 || (n_split - 1) * gps >= G ||
      n_split * gps < G || gpc < 1 || gpc > gps ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 2:
      return gemm_nt<2>(nt, x, packed, scales, out, part, E, C, K, N, group,
                        n_split, gps, gpc, stream);
    case 4:
      return gemm_nt<4>(nt, x, packed, scales, out, part, E, C, K, N, group,
                        n_split, gps, gpc, stream);
    case 8:
      return gemm_nt<8>(nt, x, packed, scales, out, part, E, C, K, N, group,
                        n_split, gps, gpc, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace qmma
