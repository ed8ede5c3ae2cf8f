// Paged one-query GQA flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fd_paged_kernel` of `flash_decode_paged` in
// src/repro/kernels/flash_decode.py: attention of one query token per row
// over the (N, Hkv, bt, hd) physical KV block pool through a (B, nb) block
// table. Entries of -1 read block 0 and are masked out through `valid`
// (B, nb·bt). Online softmax with running (m, l, acc) in float32; a block
// whose slots are all masked leaves the state untouched (the guards below),
// and a row with no valid slot writes zeros.
//
// What bounds it on this card. Each K/V element is used by the `rep` query
// heads of its group only, about 2·rep operations per 2-byte element: far
// below the ~295 operations per byte where the tensor cores take over, so
// the kernel is bound by the bytes of the K/V blocks it must read. Design:
// one CTA per (row, KV head) serves all rep = H/Hkv query heads of that
// group, so every K/V block is read from device memory exactly once; the
// block table is walked inside the CTA (the TPU's sequential grid axis),
// one bt-token block at a time staged in shared memory (rows padded by one
// float against bank conflicts); thread d owns output dimension d of every
// head of the group. With B·Hkv CTAs the card is far from full at small
// batch; splitting the table across CTAs (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_REP = 16;   // query heads per KV head held in registers

__global__ void fd_paged_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int32_t* __restrict__ table,
                                const bool* __restrict__ valid,
                                __nv_bfloat16* __restrict__ out, int H,
                                int Hkv, int bt, int hd, int nb,
                                float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = H / Hkv;
  const int d = threadIdx.x;               // blockDim.x == hd
  const int ld = hd + 1;                   // padded row length
  float* q_s = sm;                         // rep × hd
  float* k_s = q_s + rep * hd;             // bt × ld
  float* v_s = k_s + bt * ld;              // bt × ld
  float* p_s = v_s + bt * ld;              // rep × bt
  float* m_s = p_s + rep * bt;             // rep
  float* l_s = m_s + rep;                  // rep
  float* a_s = l_s + rep;                  // rep (rescale factor)

  for (int r = 0; r < rep; ++r)
    q_s[r * hd + d] =
        __bfloat162float(q[((size_t)b * H + g * rep + r) * hd + d]);
  if (d < rep) {
    m_s[d] = -INFINITY;
    l_s[d] = 0.f;
  }
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;

  for (int s = 0; s < nb; ++s) {
    int blk = table[(size_t)b * nb + s];
    blk = blk < 0 ? 0 : blk;
    const size_t base = (((size_t)blk * Hkv + g) * bt) * hd;
    __syncthreads();                       // previous block fully consumed
    for (int j = 0; j < bt; ++j) {
      k_s[j * ld + d] = __bfloat162float(k[base + (size_t)j * hd + d]);
      v_s[j * ld + d] = __bfloat162float(v[base + (size_t)j * hd + d]);
    }
    __syncthreads();
    const bool* vrow = valid + (size_t)b * nb * bt + (size_t)s * bt;
    for (int i = d; i < rep * bt; i += blockDim.x) {
      const int r = i / bt, j = i % bt;
      float dot = 0.f;
      for (int e = 0; e < hd; ++e) dot = fmaf(q_s[r * hd + e], k_s[j * ld + e], dot);
      p_s[r * bt + j] = vrow[j] ? dot * scale : -INFINITY;
    }
    __syncthreads();
    if (d < rep) {
      const int r = d;
      float mb = -INFINITY;
      for (int j = 0; j < bt; ++j) mb = fmaxf(mb, p_s[r * bt + j]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mb);
      // exp(-inf - -inf) is NaN: an all-masked history rescales by 0 and
      // masked slots contribute 0.
      const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - m_new);
      float lsum = 0.f;
      for (int j = 0; j < bt; ++j) {
        const float x = p_s[r * bt + j];
        const float p = isinf(x) ? 0.f : expf(x - m_new);
        p_s[r * bt + j] = p;
        lsum += p;
      }
      l_s[r] = l_s[r] * alpha + lsum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        float pv = 0.f;
        for (int j = 0; j < bt; ++j) pv = fmaf(p_s[r * bt + j], v_s[j * ld + d], pv);
        acc[r] = acc[r] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r < rep) {
      const float denom = fmaxf(l_s[r], 1e-30f);
      out[((size_t)b * H + g * rep + r) * hd + d] =
          __float2bfloat16(acc[r] / denom);
    }
  }
}

}  // namespace

extern "C" {

// out (B, H, hd) = softmax(q·kᵀ/√hd masked by valid) · v over the blocks
// named by table; q (B, H, hd), k/v (N, Hkv, bt, hd) bf16, table (B, nb)
// int32, valid (B, nb·bt) bool; scale = hd^-1/2 as the caller rounds it.
int flash_decode_paged(const void* q, const void* k, const void* v,
                       const void* table, const void* valid, void* out,
                       int B, int H, int Hkv, int bt, int hd, int nb,
                       float scale, void* stream) {
  const int rep = H / Hkv;
  if (B == 0) return 0;
  if (rep > MAX_REP || hd > 1024 || hd % 32 != 0 || rep < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)rep * hd + 2 * (size_t)bt * (hd + 1) +
                       (size_t)rep * bt + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hkv);
  fd_paged_kernel<<<grid, hd, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(table), static_cast<const bool*>(valid),
      static_cast<__nv_bfloat16*>(out), H, Hkv, bt, hd, nb, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
