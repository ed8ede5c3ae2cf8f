// One-query GQA flash decode over a dense KV cache for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fd_kernel` of `flash_decode` in
// src/repro/kernels/flash_decode.py: q (B, H, hd) against k/v (B, S, Hkv,
// hd) with valid (B, S) → (B, H, hd). K and V are strided views: the port's
// dense cache keeps the reference's head-major (B, Hkv, C, hd) rows, and the
// decode passes `cache.k.transpose(1, 2)` without copying, so the kernel
// takes the element strides of the batch, sequence and head axes (the last
// axis must be contiguous). Online softmax with running (m, l, acc) in
// float32 and -inf masking; a tile whose slots are all masked leaves the
// state untouched, and a row with no valid slot writes zeros (denominator
// floor 1e-30, as the reference). Any S: the last tile masks slots >= S.
//
// What bounds it on this card. Each K/V element is used by the rep = H/Hkv
// query heads of its group only, about 2·rep operations per 2-byte element,
// far below the ~295 operations per byte where the tensor cores take over:
// the kernel is bound by the bytes of K and V. Design: one CTA per (row, KV
// head) serves all rep query heads of the group, so every K/V element is
// read from device memory once; the sequence is walked inside the CTA (the
// TPU's sequential grid axis) in tiles of 32 positions staged in shared
// memory as float32 (rows padded by one float against bank conflicts);
// thread d owns output dimension d of every head of the group. With B·Hkv
// CTAs the card is far from full at small batch; splitting the sequence
// across CTAs (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_REP = 16;   // query heads per KV head held in registers
constexpr int BS = 32;        // sequence positions per tile

__global__ void fd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const bool* __restrict__ valid,
                          __nv_bfloat16* __restrict__ out, int H, int Hkv,
                          int S, int hd, long long st_b, long long st_s,
                          long long st_h, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = H / Hkv;
  const int d = threadIdx.x;               // blockDim.x == hd
  const int ld = hd + 1;                   // padded row length
  float* q_s = sm;                         // rep × hd
  float* k_s = q_s + rep * hd;             // BS × ld
  float* v_s = k_s + BS * ld;              // BS × ld
  float* p_s = v_s + BS * ld;              // rep × BS
  float* m_s = p_s + rep * BS;             // rep
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

  const long long base = (long long)b * st_b + (long long)g * st_h;
  const bool* vrow = valid + (size_t)b * S;
  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();                       // previous tile fully consumed
    for (int j = 0; j < BS; ++j) {
      const int s = s0 + j;
      // Slots past S read as zeros (and are masked below): never garbage,
      // which a zero probability times NaN would turn into NaN.
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const long long off = base + (long long)s * st_s + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      k_s[j * ld + d] = kv;
      v_s[j * ld + d] = vv;
    }
    __syncthreads();
    for (int i = d; i < rep * BS; i += blockDim.x) {
      const int r = i / BS, j = i % BS;
      const int s = s0 + j;
      float dot = 0.f;
      for (int e = 0; e < hd; ++e)
        dot = fmaf(q_s[r * hd + e], k_s[j * ld + e], dot);
      p_s[r * BS + j] = (s < S && vrow[s]) ? dot * scale : -INFINITY;
    }
    __syncthreads();
    if (d < rep) {
      const int r = d;
      float mb = -INFINITY;
      for (int j = 0; j < BS; ++j) mb = fmaxf(mb, p_s[r * BS + j]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mb);
      // exp(-inf - -inf) is NaN: an all-masked history rescales by 0 and
      // masked slots contribute 0.
      const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - m_new);
      float lsum = 0.f;
      for (int j = 0; j < BS; ++j) {
        const float x = p_s[r * BS + j];
        const float p = isinf(x) ? 0.f : expf(x - m_new);
        p_s[r * BS + j] = p;
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
        for (int j = 0; j < BS; ++j)
          pv = fmaf(p_s[r * BS + j], v_s[j * ld + d], pv);
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

// out (B, H, hd) = softmax(q·kᵀ/√hd masked by valid) · v; q (B, H, hd)
// contiguous, k/v (B, S, Hkv, hd) bf16 with element strides st_b, st_s,
// st_h (shared by k and v; the last axis contiguous), valid (B, S) bool;
// scale = hd^-1/2 as the caller rounds it.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* out, int B, int H, int Hkv, int S,
                 int hd, long long st_b, long long st_s, long long st_h,
                 float scale, void* stream) {
  if (B == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  if (rep > MAX_REP || hd > 1024 || hd % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)rep * hd + 2 * (size_t)BS * (hd + 1) +
                       (size_t)rep * BS + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hkv);
  fd_kernel<<<grid, hd, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const bool*>(valid), static_cast<__nv_bfloat16*>(out), H,
      Hkv, S, hd, st_b, st_s, st_h, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
