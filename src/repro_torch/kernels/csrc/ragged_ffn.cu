// Ragged mixed-precision SwiGLU expert FFN for Hopper (sm_90a): two kernels
// from one template, `ragged_ffn_kernel<NMAT, BITS>` (NMAT = 2: gate/up,
// NMAT = 1: down).
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
// float32 accumulator. Codes are integers in [-128, 127], exact in bf16, so
// every product of a bf16 activation and a code is exact. The gate/up
// epilogue rounds g and u to bf16, evaluates SiLU in float32, rounds, and
// multiplies in bf16.
//
// What bounds it on this card. At decode a tile holds a handful of tokens:
// each weight byte is used for at most BM = 8 rows, far below the ~295
// operations per byte where the H100's bf16 tensor cores (989 TFLOP/s)
// overtake its 3.35 TB/s of HBM. The kernel is bound by the bytes of the
// weights of the experts the step routed to (int4: ~0.5 B per weight, hi:
// 2 B). Design:
//
// * Tensor cores, swap-AB. Each warp computes yᵀ = Wᵀ·xᵀ with
//   `mma.sync.aligned.m16n8k16` bf16 / float32: the mma's M = 16 is 16
//   output columns of the weight, its N = 8 is the tile's 8 token rows (so
//   the padding rows of a tile cost nothing), its K = 16 is 16 rows of K.
//   The B fragment (xᵀ) is a pair of adjacent K values of one token: a
//   4-byte load from the activation tile in shared memory (rows padded by
//   16 bytes: the 32 lanes hit 32 banks).
// * One CTA per (row tile, 64-column block) of 4 warps, column blocks
//   fastest in the grid (the CTAs of a tile run together and read whole
//   rows of its expert's weights); each warp owns 16 columns of every
//   matrix, so no reduction crosses warps. The activation tile is copied
//   to shared memory once per CTA (the only block barrier).
// * Each warp streams its own weights through a private ring of STAGES
//   slots with 16-byte `cp.async.cg` copies, one copy per lane per matrix
//   and stage: 32 packed rows of 16 code bytes (lo), or 16 K rows of 16
//   bf16 (hi). Stage s + STAGES − 1 is issued before stage s is computed;
//   `cp.async.wait_group` and `__syncwarp` replace block barriers.
// * Lo codes decode straight into A fragments (Wᵀ). The warp's columns
//   are permuted: the mma's M row gid is column 2·gid, M row gid + 8 is
//   column 2·gid + 1, so the two columns a lane needs are adjacent bytes
//   of a packed row (one 16-bit shared load per pair of K rows). A code
//   becomes bf16 by an exponent bias (`biased`), exact and without an
//   integer-to-float conversion, and the next k16 chunk's bytes load while
//   this one multiplies. Hi rows go through `ldmatrix.x4.trans` from the
//   ring (unpermuted columns; row halves swizzled against bank conflicts).
// * Scales: the warp's columns of every scale row are copied to shared
//   memory with the activation tile (reading them from device memory when
//   a group starts stalled each group for a memory latency). Each scale
//   group's mmas sum into a zeroed float32 fragment, which is then scaled
//   per column (`fmaf`) into the accumulator; hi tiles accumulate
//   directly.
// `wgmma` (M = 64) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 8;               // rows per tile: the mma's N
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

// Shared memory: the activation tile (BM × (K + PAD) bf16), then per warp
// its ring (NMAT × RING bytes) and its columns' scales (NMAT × K/group
// rows of WN bf16).
template <int NMAT>
size_t smem_bytes(int K, int group) {
  return (size_t)BM * (K + PAD) * sizeof(__nv_bfloat16) +
         (size_t)NWARPS * NMAT * (RING + (size_t)(K / group) * WN * 2);
}

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

// acc[m] += this warp's 16 columns of x_tile · W_m over all of K, NMAT
// matrices of the same tile. HI: bf16 rows hw[m] (K, N); else packed codes
// lp[m] (K/EPB, N) with the scales already in shared memory, sc_s
// (NMAT, K/group, WN). Starts with the copies of the activation tile (and
// of the scales) committed and not waited for.
template <int NMAT, int BITS, bool HI>
__device__ __forceinline__ void tile_product(
    float (&acc)[NMAT][4], const __nv_bfloat16* xs_s, int ldx,
    unsigned char* ring, const __nv_bfloat16* sc_s,
    const uint8_t* const (&lp)[2], const __nv_bfloat16* const (&hw)[2],
    int K, int N, int n0, int group, int lane) {
  constexpr int EPB = 8 / BITS;
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

  // B fragments: token gid, K pair 2·tid (+8).
  const int gid = lane >> 2, tid = lane & 3;
  const __nv_bfloat16* xrow = xs_s + gid * ldx + 2 * tid;
  const int spg = group / 16;       // k16 steps per scale group
  int gstep = 0, grp = 0;
  float part[NMAT][4], sc[NMAT][2];
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
    const uint32_t b0 = lds_u32(xrow + 16 * c);
    const uint32_t b1 = lds_u32(xrow + 16 * c + 8);
    uint32_t a[NMAT][4];
    if constexpr (HI) {
      if (c > 0) enter(c);
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        hi_frag(a[m], slot(c) + m * SLOT, lane);
        mma_bf16(acc[m], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
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
          for (int i = 0; i < 4; ++i) part[m][i] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        lo_frag<BITS>(a[m], raw[m], tid);
        mma_bf16(part[m], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
      }
      if (++gstep == spg) {         // the group ends: scale it in
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[m][i] = fmaf(part[m][i], sc[m][i >> 1], acc[m][i]);
        gstep = 0;
        ++grp;
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) raw[m] = nxt[m];
    }
  }
  cp_async_wait<0>();
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
  // Column blocks vary fastest: the CTAs of one tile run together and
  // read whole rows of its expert's weights.
  const int n_cb = N / BN;
  const int t = blockIdx.x / n_cb;
  if (t >= *n_tiles) return;               // tail tile: rows stay unwritten
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x % n_cb) * BN + warp * WN;  // warp's columns
  const int e = tile_eid[t];
  const int slot = tile_slot[t];
  const bool is_hi = slot >= 0 && n_hi > 0 && h0 != nullptr;
  constexpr int EPB = 8 / BITS;

  const int ldx = K + PAD;
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_grp = K / group;
  unsigned char* ring = smem + (size_t)BM * ldx * sizeof(__nv_bfloat16) +
                        (size_t)warp * NMAT * (RING + n_grp * WN * 2);
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(ring + NMAT * RING);

  // Activation tile → shared memory (all threads), and on the lo tier each
  // warp's columns of the scales (n_grp rows of 32 bytes per matrix): one
  // copy group.
  const __nv_bfloat16* xt = xs + (size_t)t * BM * K;
  const int cpr = K / 8;                   // 16-byte chunks per row
  for (int i = threadIdx.x; i < BM * cpr; i += NTHREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    cp_async16(xs_s + r * ldx + c, xt + (size_t)r * K + c);
  }
  const size_t sc_stride = (size_t)n_grp * N;
  if (!is_hi) {
    for (int i = lane; i < NMAT * n_grp * 2; i += 32) {
      const int m = i / (2 * n_grp), g = (i / 2) % n_grp, h = i & 1;
      const __nv_bfloat16* src = (m ? s1 : s0) + (size_t)e * sc_stride +
                                 (size_t)g * N + n0 + 8 * h;
      cp_async16(sc_s + (m * n_grp + g) * WN + 8 * h, src);
    }
  }
  cp_async_commit();

  const size_t lo_stride = (size_t)(K / EPB) * N;
  const size_t hi_stride = (size_t)K * N;
  // Per-matrix weight pointers of this tile's expert (slot 1 unused when
  // NMAT == 1).
  const uint8_t* const lp[2] = {p0 + (size_t)e * lo_stride,
                                NMAT > 1 ? p1 + (size_t)e * lo_stride
                                         : nullptr};
  const __nv_bfloat16* const hw[2] = {
      is_hi ? h0 + (size_t)slot * hi_stride : nullptr,
      (is_hi && NMAT > 1) ? h1 + (size_t)slot * hi_stride : nullptr};

  float acc[NMAT][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  if (is_hi)
    tile_product<NMAT, BITS, true>(acc, xs_s, ldx, ring, sc_s, lp, hw,
                                   K, N, n0, group, lane);
  else
    tile_product<NMAT, BITS, false>(acc, xs_s, ldx, ring, sc_s, lp, hw,
                                    K, N, n0, group, lane);

  // acc[m][i]: token 2·tid + (i & 1); M row gid + 8·(i >> 1), which is
  // column gid + 8·(i >> 1) on the hi tier, 2·gid + (i >> 1) on the lo tier.
  const int gid = lane >> 2, tid = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t * BM + 2 * tid + (i & 1);
    const int c = n0 + (is_hi ? gid + 8 * (i >> 1) : 2 * gid + (i >> 1));
    __nv_bfloat16 o;
    if constexpr (NMAT == 2) {
      const float g16 = __bfloat162float(__float2bfloat16(acc[0][i]));
      const float u16 = __bfloat162float(__float2bfloat16(acc[1][i]));
      const float silu = g16 / (1.f + expf(-g16));
      o = __float2bfloat16(__bfloat162float(__float2bfloat16(silu)) * u16);
    } else {
      o = __float2bfloat16(acc[0][i]);
    }
    out[(size_t)r * N + c] = o;
  }
}

template <int NMAT, int BITS>
int launch(const void* xs, const void* tile_eid, const void* tile_slot,
           const void* n_tiles, const void* p0, const void* s0,
           const void* p1, const void* s1, const void* h0, const void* h1,
           void* out, int Tt, int K, int N, int n_hi, int group,
           cudaStream_t stream) {
  auto kern = ragged_ffn_kernel<NMAT, BITS>;
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t smem = smem_bytes<NMAT>(K, group);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  kern<<<Tt * (N / BN), NTHREADS, smem, stream>>>(
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
  if (N % BN != 0 || group < 16 || group % 16 != 0 || K % group != 0)
    return (int)cudaErrorInvalidValue;
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
// F a multiple of 64, group a multiple of 16, K a multiple of group.
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

// y (Tt·8, D) = h · W_down, per tile on its tier; the same limits.
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
