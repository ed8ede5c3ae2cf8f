// The swap-AB tensor-core main loop shared by the port's quantized kernels
// for Hopper (sm_90a): the ragged FFN (`ragged_ffn.cu`), the grouped
// quantized GEMM (`grouped_quant_matmul.cu`) and the plain quantized GEMM
// (`quant_matmul.cu`).
//
// A warp owns 16 output columns of one weight (the mma's M) and computes
// yᵀ = Wᵀ·xᵀ over chunks of 8 activation rows (the mma's N) with
// `mma.sync.aligned.m16n8k16` bf16 / float32, walking K in k16 steps:
//
// * Its weights stream through a private ring of STAGES slots with 16-byte
//   `cp.async.cg` copies, one per lane per matrix and stage: 32 packed rows
//   of 16 code bytes (lo) or 16 K rows of 16 bf16 (hi). Stage s + STAGES − 1
//   is issued before stage s is computed; `cp.async.wait_group` and
//   `__syncwarp` replace block barriers.
// * Lo codes (biased integers, 8/bits K rows per byte, little-endian) decode
//   straight into A fragments by an exponent bias (`biased`: exact, no
//   integer-to-float conversion), with the warp's columns permuted (the
//   mma's M row gid is column 2·gid, M row gid + 8 is column 2·gid + 1) so a
//   lane's two columns are adjacent bytes of a packed row. The next k16
//   step's bytes load while this one multiplies. Hi rows go through
//   `ldmatrix.x4.trans` (unpermuted columns; row halves swizzled).
// * The group-blocked rule: each scale group's mmas sum into a zeroed
//   float32 fragment, which is then scaled per column (`fmaf`) into the
//   float32 accumulator; the warp's columns of the scales sit in shared
//   memory. Hi weights accumulate directly.
// * NT: the 8-row chunks one pass multiplies with each decoded A fragment.
//   Chunk i's B fragments come from rows 8·i … 8·i + 7 of the activation
//   tile in shared memory, so the decode is paid once for NT·8 rows.
//
// `quant_gemm.cuh` runs that loop as the grouped and plain quantized GEMM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace qmma {

using namespace sm90;

constexpr int BM = 8;               // rows per chunk: the mma's N
constexpr int BN = 64;              // columns per CTA
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = BN / NWARPS;     // columns per warp: the mma's M
constexpr int PAD = 8;              // bf16 padding per shared row (16 bytes)
constexpr int STAGES = 4;           // ring depth per warp
constexpr int SLOT = 512;           // bytes per matrix and stage: 32 packed
                                    // code rows (lo) or 16 bf16 rows (hi)
constexpr size_t RING = (size_t)STAGES * SLOT;   // bytes per warp, matrix
constexpr size_t SMEM_MAX = 227 * 1024;   // dynamic shared memory per CTA

static_assert(WN == 16, "a warp covers one m16 block of columns");

// The two bytes of `v` that `sel` picks (byte selectors in its even
// nibbles, 4 = the constant 0x43 in its odd ones), each < 128, as the bf16
// pair (128 + x0, 128 + x1): 0x43 is the high byte of 128.0, and below 256
// the low byte is the integer part. Subtracting the bias in bf16 is exact.
__device__ __forceinline__ __nv_bfloat162 biased(uint32_t v, uint32_t sel) {
  const uint32_t r = __byte_perm(v, 0x43u, sel);
  return *reinterpret_cast<const __nv_bfloat162*>(&r);
}

__device__ __forceinline__ __nv_bfloat162 bf2(float x) {
  return __float2bfloat162_rn(x);
}

// A lane's lo A fragment with the columns permuted: M row gid is column
// 2·gid of the warp's 16, M row gid + 8 is column 2·gid + 1, so the two
// columns a lane needs are adjacent bytes of a packed row. Raw: the
// 16-bit loads of one k16 chunk (16/EPB packed rows of 16 bytes) that hold
// them — K rows 2·tid, 2·tid + 1 (v[0]) and 2·tid + 8, 2·tid + 9 (v[1]);
// int8 keeps one row per load.
template <int BITS>
struct LoRaw {
  uint32_t v[BITS == 8 ? 4 : 2];
};

__device__ __forceinline__ uint32_t lds_u16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <int BITS>
__device__ __forceinline__ void load_raw(LoRaw<BITS>& r,
                                         const unsigned char* chunk, int gid,
                                         int tid) {
  const unsigned char* p = chunk + 2 * gid;
  if constexpr (BITS == 4) {
    r.v[0] = lds_u16(p + tid * WN);
    r.v[1] = lds_u16(p + (tid + 4) * WN);
  } else if constexpr (BITS == 2) {
    r.v[0] = lds_u16(p + (tid >> 1) * WN);
    r.v[1] = lds_u16(p + ((tid >> 1) + 2) * WN);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r.v[i] = lds_u16(p + (2 * tid + (i & 1) + 8 * (i >> 1)) * WN);
  }
}

// The fragment from the raw loads. x holds the bytes (or nibbles)
// [row k even column, row k odd column, row k+1 even, row k+1 odd] of the
// K row pair k = 2·tid (h = 0) or 2·tid + 8 (h = 1): selector 0x4240
// pairs the even column's two rows (a0, a2), 0x4341 the odd column's
// (a1, a3).
template <int BITS>
__device__ __forceinline__ void lo_frag(uint32_t (&a)[4],
                                        const LoRaw<BITS>& r, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (BITS == 8) {
      const uint32_t x = r.v[2 * h] | (r.v[2 * h + 1] << 16);
      const uint32_t lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t sel = p ? 0x4341u : 0x4240u;
        a[2 * h + p] = as_u32(
            __hfma2(__hsub2(biased(hi, sel), bf2(136.f)), bf2(16.f),
                    __hsub2(biased(lo, sel), bf2(128.f))));
      }
    } else {
      const uint32_t v = r.v[h];
      uint32_t x;
      if constexpr (BITS == 4) {
        x = (v & 0x0f0fu) | ((v << 12) & 0x0f0f0000u);
      } else {
        const int sh = 4 * (tid & 1);
        x = ((v >> sh) & 0x0303u) | (((v >> (sh + 2)) & 0x0303u) << 16);
      }
      const __nv_bfloat162 bias = bf2(BITS == 4 ? 136.f : 130.f);
      a[2 * h] = as_u32(__hsub2(biased(x, 0x4240u), bias));
      a[2 * h + 1] = as_u32(__hsub2(biased(x, 0x4341u), bias));
    }
  }
}

// The A fragment (Wᵀ: 16 columns × 16 K rows) of one hi stage: 16 K rows
// of this warp's 16 bf16 columns, 32 bytes a row, with the two 16-byte
// halves of rows 4–7 and 12–15 swapped (the 8 rows one matrix of the
// `ldmatrix` reads then hit 32 distinct banks).
__device__ __forceinline__ void hi_frag(uint32_t (&a)[4],
                                        const unsigned char* w, int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3);
  const int half = ((lane >> 3) & 1) ^ ((row >> 2) & 1);
  ldmatrix_x4_trans(a[0], a[1], a[2], a[3], w + row * 32 + half * 16);
}

// acc[m][i] += this warp's 16 columns of rows 8·i … 8·i + 7 of the
// activation tile · W_m over all of K, NMAT matrices of the same rows.
// HI: bf16 rows hw[m] (K, N); else packed codes lp[m] (K/EPB, N) with the
// scales already in shared memory, sc_s (NMAT, K/group, WN). The tile
// xs_s holds NT·8 rows of ldx bf16. Starts with the copies of the
// activation tile (and of the scales) committed and not waited for.
template <int NMAT, int BITS, bool HI, int NT>
__device__ __forceinline__ void tile_product(
    float (&acc)[NMAT][NT][4], const __nv_bfloat16* xs_s, int ldx,
    unsigned char* ring, const __nv_bfloat16* sc_s,
    const uint8_t* const (&lp)[2], const __nv_bfloat16* const (&hw)[2],
    int K, int N, int n0, int group, int lane) {
  constexpr int EPB = HI ? 1 : 8 / BITS;   // (BITS is unused when HI)
  constexpr int KS = HI ? 16 : 32 * EPB;   // K rows per stage
  constexpr int CPS = KS / 16;             // k16 chunks per stage
  const int kp = K / EPB;
  const int n_stages = (K + KS - 1) / KS;
  const int n_chunks = K / 16;
  auto slot = [&](int s) { return ring + (s % STAGES) * NMAT * SLOT; };
  // One 16-byte copy per lane and matrix: packed row 32·s + lane (lo), or
  // half lane & 1 of K row 16·s + lane/2, at the swizzled position (hi).
  auto load = [&](int s) {
    unsigned char* dst = slot(s);
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      if constexpr (HI) {
        const int r = lane >> 1, c = lane & 1;
        cp_async16(dst + m * SLOT + r * 32 + ((c ^ ((r >> 2) & 1)) << 4),
                   hw[m] + (size_t)(16 * s + r) * N + n0 + 8 * c);
      } else {
        const int pr = 32 * s + lane;
        if (pr < kp)
          cp_async16(dst + m * SLOT + lane * WN, lp[m] + (size_t)pr * N + n0);
      }
    }
  };
  // Enter stage s: wait for it, then refill the slot stage s − 1 used.
  auto enter = [&](int s) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (s + STAGES - 1 < n_stages) load(s + STAGES - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();      // this thread's share of the x tile
  __syncthreads();

  // B fragments of chunk i: row 8·i + gid, K pair 2·tid (+8).
  const int gid = lane >> 2, tid = lane & 3;
  const __nv_bfloat16* xrow = xs_s + gid * ldx + 2 * tid;
  const int spg = group / 16;       // k16 steps per scale group
  int gstep = 0, grp = 0;
  float part[NMAT][NT][4], sc[NMAT][2];
  LoRaw<BITS> raw[NMAT], nxt[NMAT];
  auto chunk = [&](int c, int m) {
    return slot(c / CPS) + m * SLOT + (c % CPS) * (16 / EPB) * WN;
  };
  enter(0);
  if constexpr (!HI) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) load_raw(raw[m], chunk(0, m), gid, tid);
  }
  for (int c = 0; c < n_chunks; ++c) {
    uint32_t b[NT][2];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      b[i][0] = lds_u32(xrow + i * BM * ldx + 16 * c);
      b[i][1] = lds_u32(xrow + i * BM * ldx + 16 * c + 8);
    }
    uint32_t a[NMAT][4];
    if constexpr (HI) {
      if (c > 0) enter(c);
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        hi_frag(a[m], slot(c) + m * SLOT, lane);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mma_bf16(acc[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b[i][0],
                   b[i][1]);
      }
    } else {
      // Chunk c + 1's bytes are loaded while chunk c decodes and multiplies.
      if (c + 1 < n_chunks) {
        if ((c + 1) % CPS == 0) enter((c + 1) / CPS);
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
          load_raw(nxt[m], chunk(c + 1, m), gid, tid);
      }
      if (gstep == 0) {             // a group starts: zero it, read scales
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(
              sc_s + (m * (K / group) + grp) * WN + 2 * gid);
          sc[m][0] = __low2float(s2);
          sc[m][1] = __high2float(s2);
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[m][i][q] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        lo_frag<BITS>(a[m], raw[m], tid);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mma_bf16(part[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b[i][0],
                   b[i][1]);
      }
      if (++gstep == spg) {         // the group ends: scale it in
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][i][q] = fmaf(part[m][i][q], sc[m][q >> 1],
                                  acc[m][i][q]);
        gstep = 0;
        ++grp;
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) raw[m] = nxt[m];
    }
  }
  cp_async_wait<0>();
}

}  // namespace qmma
