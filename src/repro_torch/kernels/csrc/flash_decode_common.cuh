// Split-KV flash decoding for Hopper (sm_90a): the device code shared by the
// two one-query GQA decode-attention kernels, `flash_decode.cu` (dense rows)
// and `flash_decode_paged.cu` (a block pool read through a table).
//
// A CTA of WARPS warps serves one (row b, KV head g, split s): all rep =
// H/Hkv query heads of the group, over a contiguous range of the row's
// tiles (one block of bt positions when paged, TILE positions when dense),
// so every K/V byte leaves device memory once. Each warp walks every
// WARPS-th tile of the range with its own online softmax in registers:
//
// * Tiles whose `valid` slots are all false are skipped whole: no copy, no
//   dot, no softmax update. The table alone decides nothing (a -1 entry
//   reads block 0 and `valid` masks it, as the plain version does).
// * K/V tiles stay bf16 in shared memory. They arrive by 16-byte
//   `cp.async` copies into a per-warp ring of up to MAX_STAGES tiles, so
//   the next tiles are in flight while one is computed; `cp.async.wait_group`
//   and `__syncwarp` replace block-wide barriers. Rows are padded by 16 bytes
//   so the fragment loads below hit 32 distinct banks.
// * Both dots run on the tensor cores with `mma.sync.aligned.m16n8k16` bf16
//   and float32 accumulation. The group's query heads are the 16 M rows
//   (zero past rep), Q's A fragments are loaded once per CTA, Q·Kᵀ takes K
//   as the n8 operand, and P·V takes V as the B operand through
//   `ldmatrix.trans`. `wgmma` needs an M of 64 rows; a decode group has at
//   most 16 query heads, so `mma.sync` is the tensor-core instruction that
//   fits. Q·Kᵀ of bf16 inputs is exact per product. P is split into two bf16 terms (its rounding and the
//   residual), so P·V keeps ~16 bits of P and the one rounding left against
//   the float32 plain version is the order of the float32 sums.
// * The warps merge their (m, l, acc) through shared memory once at the
//   end. With one split the CTA writes the bf16 output; otherwise it writes
//   float32 partials (m, l, acc[rep][hd]) for `merge_splits_kernel`.
//
// m is kept in the base-2 domain (logits times scale·log2 e) throughout; a
// split or warp without a valid slot has m = -inf and weight 0, and a row
// with no valid slot writes zeros. A non-finite partial is not masked: it
// reaches the output.
//
// Head widths. The register tiles are sized by the compiled width HD (64,
// 128 or 256); the head width hd is a runtime argument, a multiple of 8 up
// to HD. A width that is not compiled (e.g. 120) runs on the next compiled
// one: rows stay packed at hd in device memory, the copies of a row's
// chunks past hd are zero-filled copies (cp.async with no source bytes), and
// Q's fragments past hd load as zeros, so the padded columns add exact zeros
// to Q·Kᵀ, and the P·V columns past hd are not written. At hd == HD every
// chunk and fragment loads as with a compile-time width: the same sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace fd {

using namespace sm90;

constexpr int WARPS = 4;                  // warps per CTA
constexpr int THREADS = WARPS * 32;
constexpr int MAX_STAGES = 3;             // ring depth per warp
constexpr int PAD = 8;                    // bf16 padding per shared row
constexpr size_t SMEM_MAX = 227 * 1024;   // dynamic shared memory per CTA
constexpr float LOG2E = 1.4426950408889634f;

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0)
    cp_async_wait<0>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// Two floats as a bf16 pair (x0 in the low half), and the bf16 pair of
// what that rounding left over.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

// Bit i set when slot j0 + i of tile t is valid (32 slots per word).
// Warp-uniform: every lane of the warp calls it with the same t and j0.
template <class Src>
__device__ __forceinline__ uint32_t slot_bits(const Src& src, int t, int j0,
                                              int lane) {
  const int j = j0 + lane;
  return __ballot_sync(0xffffffffu, j < src.len(t) && src.ok(t, j));
}

// Whether tile t holds any valid slot (warp-uniform, as `slot_bits`).
template <class Src>
__device__ __forceinline__ bool tile_live(const Src& src, int t, int lane) {
  for (int j0 = 0; j0 < src.len(t); j0 += 32)
    if (slot_bits(src, t, j0, lane)) return true;
  return false;
}

// Issue the copies of tile t's K and V rows into one ring slot (K rows, then
// V rows, each row HD + PAD long). Rows past the tile's length, and columns
// past hd, read zeros.
template <int HD, class Src>
__device__ __forceinline__ void load_tile(const Src& src,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, int t,
                                          __nv_bfloat16* ks, int lane,
                                          int hd) {
  constexpr int CPR = HD / 8;             // 16-byte chunks per row
  static_assert(32 % CPR == 0, "a lane copies one column of chunks");
  constexpr int LD = HD + PAD;
  const int rows = src.rows, len = src.len(t);
  const long long base = src.base(t);
  __nv_bfloat16* vs = ks + rows * LD;
  const int c = (lane % CPR) * 8;         // this lane's chunk in every row
  const bool col = c < hd;
  for (int r = lane / CPR; r < rows; r += 32 / CPR) {
    const bool in = col && r < len;
    const long long off = in ? base + (long long)r * src.step + c : 0;
    cp_async16(ks + r * LD + c, k + off, in ? 16 : 0);
    cp_async16(vs + r * LD + c, v + off, in ? 16 : 0);
  }
}

// Shared memory of one CTA: each warp's ring of `stages` tiles.
__host__ __device__ inline size_t stage_bytes(int rows, int hd) {
  return 2 * (size_t)rows * (hd + PAD) * sizeof(__nv_bfloat16);
}

// Ring depth for a launch: as deep as a warp has tiles to prefetch (at most
// MAX_STAGES) and as shared memory allows; 0 when even one stage does not
// fit.
inline int ring_stages(int rows, int hd, int tiles_per_split) {
  const int per_warp = (tiles_per_split + WARPS - 1) / WARPS;
  int stages = per_warp < 1 ? 1 : (per_warp > MAX_STAGES ? MAX_STAGES
                                                          : per_warp);
  while (stages > 0 && WARPS * stages * stage_bytes(rows, hd) > SMEM_MAX)
    --stages;
  return stages;
}

// The natural log-sum-exp of a head's scaled logits from its online
// softmax state: M the largest logit in log2 units, L = Σ 2^{s−M}; -inf
// where no slot was valid (L = 0).
__device__ __forceinline__ float log_sum_exp(float M, float L) {
  return L > 0.f ? (M + log2f(L)) * 0.69314718055994531f : -INFINITY;
}

// The split kernels' body for one CTA. q: the rep query heads of (b, g),
// (rep, hd) bf16. Tiles [t_begin, t_end) of `src`. With `out` set (one
// split) writes the normalized bf16 rows, and with LSE each head's
// natural log-sum-exp of its scaled logits into `lse` (float32, -inf for
// a row with no valid slot); else the split's partials: part_acc (rep,
// hd) and part_ml (rep, 2) = (m, l), float32; hd ≤ HD. LSE is a
// compile-time flag: without it the body is the one without the output.
template <int HD, bool LSE = false, class Src>
__device__ __forceinline__ void split_attend(
    const Src& src, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    int rep, int t_begin, int t_end, int stages, float scale_log2,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, unsigned char* smem, int hd,
    float* __restrict__ lse = nullptr) {
  constexpr int LD = HD + PAD;
  constexpr int KSTEPS = HD / 16;         // k16 steps of Q·Kᵀ
  constexpr int NCH = HD / 8;             // n8 column blocks of P·V
  constexpr int MR = 16;                  // M rows: query heads, zero past rep
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid = lane & 3;
  const int rows = src.rows;
  const size_t stage_elems = 2 * (size_t)rows * LD;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                        (size_t)warp * stages * stage_elems;

  // Q's A fragments: rows gid and gid + 8, columns kk·16 + tid·2 (+8);
  // zeros past hd.
  uint32_t qa[KSTEPS][4];
  const bool r0 = gid < rep, r1 = gid + 8 < rep;
  const unsigned int* q0 = reinterpret_cast<const unsigned int*>(
      q + gid * hd + tid * 2);
  const unsigned int* q1 = reinterpret_cast<const unsigned int*>(
      q + (gid + 8) * hd + tid * 2);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const bool c0 = kk * 16 < hd, c1 = kk * 16 + 8 < hd;
    qa[kk][0] = r0 && c0 ? __ldg(q0 + kk * 8) : 0u;
    qa[kk][1] = r1 && c0 ? __ldg(q1 + kk * 8) : 0u;
    qa[kk][2] = r0 && c1 ? __ldg(q0 + kk * 8 + 4) : 0u;
    qa[kk][3] = r1 && c1 ? __ldg(q1 + kk * 8 + 4) : 0u;
  }

  float m0 = -INFINITY, m1 = -INFINITY;   // running max, rows gid, gid + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the sums
  float acc[NCH][4];
#pragma unroll
  for (int n = 0; n < NCH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto next_valid = [&](int t) {
    while (t < t_end && !tile_live(src, t, lane)) t += WARPS;
    return t;
  };
  int t_load = next_valid(t_begin + warp);
  for (int s = 0; s < stages; ++s) {
    if (t_load < t_end) {
      load_tile<HD>(src, k, v, t_load, ring + s * stage_elems, lane, hd);
      t_load = next_valid(t_load + WARPS);
    }
    cp_async_commit();
  }

  int t_comp = next_valid(t_begin + warp);
  for (int i = 0; t_comp < t_end; ++i) {
    cp_async_wait_pending(stages - 1);
    __syncwarp();
    __nv_bfloat16* slot = ring + (i % stages) * stage_elems;
    const __nv_bfloat16* ks = slot;
    const __nv_bfloat16* vs = slot + rows * LD;
    uint32_t word = 0;                    // valid bits of 32 slots
    for (int c0 = 0; c0 < rows; c0 += 16) {
      if ((c0 & 31) == 0) word = slot_bits(src, t_comp, c0, lane);
      const uint32_t cm = (word >> (c0 & 16)) & 0xffffu;
      if (cm == 0) continue;              // 16 masked slots: nothing to add

      // S = Q·Kᵀ over 16 positions: two n8 blocks, float32.
      float s[2][4];
#pragma unroll
      for (int nc = 0; nc < 2; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nc][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nc = 0; nc < 2; ++nc) {
          const __nv_bfloat16* kr =
              ks + (c0 + nc * 8 + gid) * LD + kk * 16 + tid * 2;
          mma_bf16(s[nc], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                   lds_u32(kr), lds_u32(kr + 8));
        }
      }

      // Online softmax in base 2. Lane (gid, tid) holds columns
      // nc·8 + tid·2 + {0, 1} of rows gid (s[.][0..1]) and gid + 8
      // (s[.][2..3]); the 4 lanes of a group share a row.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nc = 0; nc < 2; ++nc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (cm >> (nc * 8 + tid * 2 + e)) & 1u;
          s[nc][e] = ok ? s[nc][e] * scale_log2 : -INFINITY;
          s[nc][2 + e] = ok ? s[nc][2 + e] * scale_log2 : -INFINITY;
          mx0 = fmaxf(mx0, s[nc][e]);
          mx1 = fmaxf(mx1, s[nc][2 + e]);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // The chunk holds a valid slot, so both new maxima are finite.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
      const float al1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int nc = 0; nc < 2; ++nc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nc][e] = exp2f(s[nc][e] - mn0);            // exp2(-inf) = 0
          s[nc][2 + e] = exp2f(s[nc][2 + e] - mn1);
          ls0 += s[nc][e];
          ls1 += s[nc][2 + e];
        }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }

      // O += P·V: P's A fragments straight from S's accumulator layout,
      // as a bf16 term and its residual.
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
      const int l8 = lane & 7, sel = lane >> 3;
#pragma unroll
      for (int n = 0; n < NCH; n += 2) {
        uint32_t v0, v1, v2, v3;
        ldmatrix_x4_trans(v0, v1, v2, v3,
                          vs + (c0 + (sel & 1) * 8 + l8) * LD +
                              (n + (sel >> 1)) * 8);
        mma_bf16(acc[n], ph[0], ph[1], ph[2], ph[3], v0, v1);
        mma_bf16(acc[n], pl[0], pl[1], pl[2], pl[3], v0, v1);
        mma_bf16(acc[n + 1], ph[0], ph[1], ph[2], ph[3], v2, v3);
        mma_bf16(acc[n + 1], pl[0], pl[1], pl[2], pl[3], v2, v3);
      }
    }
    __syncwarp();                         // the slot is read: refill it
    if (t_load < t_end) {
      load_tile<HD>(src, k, v, t_load, slot, lane, hd);
      t_load = next_valid(t_load + WARPS);
    }
    cp_async_commit();
    t_comp = next_valid(t_comp + WARPS);
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // Merge the warps: each writes (acc[MR][HD], m[MR], l[MR]) over its own
  // ring, then every thread combines output elements across the warps.
  __syncwarp();
  const size_t wstride = (size_t)stages * stage_elems * sizeof(__nv_bfloat16)
                         / sizeof(float);
  float* mine = reinterpret_cast<float*>(smem) + warp * wstride;
#pragma unroll
  for (int n = 0; n < NCH; ++n) {
    const int d = n * 8 + tid * 2;
    mine[gid * HD + d] = acc[n][0];
    mine[gid * HD + d + 1] = acc[n][1];
    mine[(gid + 8) * HD + d] = acc[n][2];
    mine[(gid + 8) * HD + d + 1] = acc[n][3];
  }
  if (tid == 0) {
    mine[MR * HD + gid] = m0;
    mine[MR * HD + gid + 8] = m1;
    mine[MR * HD + MR + gid] = l0;
    mine[MR * HD + MR + gid + 8] = l1;
  }
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < rep * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    if (d >= hd) continue;                // a padded column
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      M = fmaxf(M, all[w * wstride + MR * HD + r]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* wr = all + w * wstride;
      const float mw = wr[MR * HD + r];
      if (mw == -INFINITY) continue;      // the warp saw no valid slot
      const float e = exp2f(mw - M);
      a += e * wr[r * HD + d];
      L += e * wr[MR * HD + MR + r];
    }
    if (out != nullptr) {
      out[r * hd + d] = __float2bfloat16(a / fmaxf(L, 1e-30f));
      if constexpr (LSE) {
        if (d == 0) lse[r] = log_sum_exp(M, L);
      }
    } else {
      part_acc[r * hd + d] = a;
      if (d == 0) {
        part_ml[2 * r] = M;
        part_ml[2 * r + 1] = L;
      }
    }
  }
}

// Second pass over n_split > 1 splits: one CTA of hd threads per output
// head (b, g·rep + r). out = Σ 2^{m_s−M} acc_s / max(Σ 2^{m_s−M} l_s,
// 1e-30), M = max_s m_s; a split with m = -inf weighs 0. With LSE, also
// the head's log-sum-exp into `lse` (B, H) float32.
template <bool LSE>
__global__ void merge_splits_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    __nv_bfloat16* __restrict__ out,
                                    int n_split, int rep, int H, int Hkv,
                                    int hd, float* __restrict__ lse) {
  extern __shared__ float w_s[];          // n_split weights
  const int bg = blockIdx.x / rep, r = blockIdx.x % rep;
  const float* ml = part_ml + (size_t)bg * n_split * rep * 2;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[(s * rep + r) * 2]);
  for (int s = threadIdx.x; s < n_split; s += blockDim.x) {
    const float m = ml[(s * rep + r) * 2];
    w_s[s] = m == -INFINITY ? 0.f : exp2f(m - M);
  }
  __syncthreads();
  const int d = threadIdx.x;
  float a = 0.f, L = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = w_s[s];
    a += w * part_acc[(((size_t)bg * n_split + s) * rep + r) * hd + d];
    L += w * ml[(s * rep + r) * 2 + 1];
  }
  const int b = bg / Hkv, g = bg % Hkv;
  out[((size_t)b * H + g * rep + r) * hd + d] =
      __float2bfloat16(a / fmaxf(L, 1e-30f));
  if constexpr (LSE) {
    if (d == 0) lse[(size_t)b * H + g * rep + r] = log_sum_exp(M, L);
  }
}

// Launch the merge when there is more than one split; with `lse` set, the
// merge that also writes the log-sum-exp.
inline cudaError_t launch_merge(const float* part_acc, const float* part_ml,
                                __nv_bfloat16* out, int B, int H, int Hkv,
                                int hd, int n_split, cudaStream_t stream,
                                float* lse = nullptr) {
  if (n_split <= 1) return cudaSuccess;
  const int rep = H / Hkv;
  const size_t smem = n_split * sizeof(float);
  if (lse != nullptr)
    merge_splits_kernel<true><<<B * H, hd, smem, stream>>>(
        part_acc, part_ml, out, n_split, rep, H, Hkv, hd, lse);
  else
    merge_splits_kernel<false><<<B * H, hd, smem, stream>>>(
        part_acc, part_ml, out, n_split, rep, H, Hkv, hd, nullptr);
  return cudaGetLastError();
}

// The compiled width a head width runs on: itself when compiled, else the
// next compiled one; 0 when none takes it (hd not a multiple of 8,
// or above 256).
inline int padded_width(int hd) {
  if (hd <= 0 || hd % 8 != 0 || hd > 256) return 0;
  return hd <= 64 ? 64 : (hd <= 128 ? 128 : 256);
}

}  // namespace fd
