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
//   to shared memory in pieces of whole scale groups, all of K in one
//   piece when it fits (`piece_groups`: at K = 14336, down's row alone
//   would outgrow the 227 KB a CTA may have); the float32 accumulators
//   run on across pieces, so the sum order is the same as over the whole
//   row. A barrier separates two pieces.
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
// * Scales: the warp's columns of the piece's scale rows are copied to
//   shared memory with the activation tile (reading them from device
//   memory when a group starts stalled each group for a memory latency).
//   Each scale group's mmas sum into a zeroed float32 fragment, which is
//   then scaled per column (`fmaf`) into the accumulator; hi tiles
//   accumulate directly.
// The warp loop (ring, decode, group-blocked accumulation) is
// `qmma::tile_product` in `quant_mma.cuh`, shared with the quantized GEMMs;
// a tile is one 8-row chunk (NT = 1). This file keeps the tile map, the
// tiers and the epilogue. `wgmma` (M = 64) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"

namespace {

using namespace qmma;

// Shared memory for pieces of gpc scale groups: the activation tile's piece
// (BM × (gpc·group + PAD) bf16), then per warp its ring (NMAT × RING
// bytes) and its columns' scales for the piece (NMAT × gpc rows of WN
// bf16).
template <int NMAT>
size_t smem_bytes(int group, int gpc) {
  return (size_t)BM * (gpc * group + PAD) * sizeof(__nv_bfloat16) +
         (size_t)NWARPS * NMAT * (RING + (size_t)gpc * WN * 2);
}

// Scale groups per piece of K: all K / group of them when they fit
// SMEM_MAX (one piece), else the fewest pieces that fit, of equal size but
// the last. 0 when not even one group fits.
template <int NMAT>
int piece_groups(int K, int group) {
  const int G = K / group;
  int most = 0;
  while (most < G && smem_bytes<NMAT>(group, most + 1) <= SMEM_MAX) ++most;
  if (most == 0) return 0;
  const int n = (G + most - 1) / most;
  return (G + n - 1) / n;
}

// NMAT = 2: gate/up with the SiLU·mul epilogue; NMAT = 1: down. K is
// walked in pieces of gpc scale groups (one piece when the row fits).
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
                  int group, int gpc) {
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

  float acc[NMAT][1][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][0][i] = 0.f;
  const __nv_bfloat16* xt = xs + (size_t)t * BM * K;
  const size_t lo_stride = (size_t)(K / EPB) * N;
  const size_t hi_stride = (size_t)K * N;
  const int ldx = gpc * group + PAD;
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + (size_t)BM * ldx * sizeof(__nv_bfloat16) +
                        (size_t)warp * NMAT * (RING + (size_t)gpc * WN * 2);
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(ring + NMAT * RING);
  const int G = K / group;
  const size_t sc_stride = (size_t)G * N;
  // K in pieces of gpc scale groups, the float32 accumulators carried
  // across pieces: the group-blocked sum runs in the same order as over
  // the whole row.
#pragma unroll 1
  for (int g0 = 0; g0 < G; g0 += gpc) {
    const int n_grp = min(gpc, G - g0);    // this piece's scale groups
    const int k0 = g0 * group, ks = n_grp * group;
    if (g0 > 0) __syncthreads();           // the last piece's tile is read
    // The piece of the activation tile → shared memory (all threads), and
    // on the lo tier each warp's columns of the piece's scales (n_grp rows
    // of 32 bytes per matrix): one copy group.
    const int cpr = ks / 8;                // 16-byte chunks per row
    for (int i = threadIdx.x; i < BM * cpr; i += NTHREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      cp_async16(xs_s + r * ldx + c, xt + (size_t)r * K + k0 + c);
    }
    if (!is_hi) {
      for (int i = lane; i < NMAT * n_grp * 2; i += 32) {
        const int m = i / (2 * n_grp), g = (i / 2) % n_grp, h = i & 1;
        const __nv_bfloat16* src = (m ? s1 : s0) + (size_t)e * sc_stride +
                                   (size_t)(g0 + g) * N + n0 + 8 * h;
        cp_async16(sc_s + (m * n_grp + g) * WN + 8 * h, src);
      }
    }
    cp_async_commit();
    // Per-matrix weight pointers of this tile's expert at the piece's
    // first K row (slot 1 unused when NMAT == 1).
    const size_t lo_off = (size_t)(k0 / EPB) * N, hi_off = (size_t)k0 * N;
    const uint8_t* const lp[2] = {
        p0 + (size_t)e * lo_stride + lo_off,
        NMAT > 1 ? p1 + (size_t)e * lo_stride + lo_off : nullptr};
    const __nv_bfloat16* const hw[2] = {
        is_hi ? h0 + (size_t)slot * hi_stride + hi_off : nullptr,
        (is_hi && NMAT > 1) ? h1 + (size_t)slot * hi_stride + hi_off
                            : nullptr};
    if (is_hi)
      tile_product<NMAT, BITS, true, 1>(acc, xs_s, ldx, ring, sc_s, lp, hw,
                                        ks, N, n0, group, lane);
    else
      tile_product<NMAT, BITS, false, 1>(acc, xs_s, ldx, ring, sc_s, lp, hw,
                                         ks, N, n0, group, lane);
  }

  // acc[m][0][i]: token 2·tid + (i & 1); M row gid + 8·(i >> 1), which is
  // column gid + 8·(i >> 1) on the hi tier, 2·gid + (i >> 1) on the lo tier.
  const int gid = lane >> 2, tid = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t * BM + 2 * tid + (i & 1);
    const int c = n0 + (is_hi ? gid + 8 * (i >> 1) : 2 * gid + (i >> 1));
    __nv_bfloat16 o;
    if constexpr (NMAT == 2) {
      const float g16 = __bfloat162float(__float2bfloat16(acc[0][0][i]));
      const float u16 = __bfloat162float(__float2bfloat16(acc[1][0][i]));
      const float silu = g16 / (1.f + expf(-g16));
      o = __float2bfloat16(__bfloat162float(__float2bfloat16(silu)) * u16);
    } else {
      o = __float2bfloat16(acc[0][0][i]);
    }
    out[(size_t)r * N + c] = o;
  }
}

// Pieces of piece_groups() scale groups: one piece when the whole row
// fits.
template <int NMAT, int BITS>
int launch(const void* xs, const void* tile_eid, const void* tile_slot,
           const void* n_tiles, const void* p0, const void* s0,
           const void* p1, const void* s1, const void* h0, const void* h1,
           void* out, int Tt, int K, int N, int n_hi, int group,
           cudaStream_t stream) {
  const int gpc = piece_groups<NMAT>(K, group);
  if (gpc == 0) return (int)cudaErrorInvalidValue;
  auto kern = ragged_ffn_kernel<NMAT, BITS>;
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  kern<<<Tt * (N / BN), NTHREADS, smem_bytes<NMAT>(group, gpc), stream>>>(
      static_cast<const __nv_bfloat16*>(xs),
      static_cast<const int32_t*>(tile_eid),
      static_cast<const int32_t*>(tile_slot),
      static_cast<const int32_t*>(n_tiles), static_cast<const uint8_t*>(p0),
      static_cast<const __nv_bfloat16*>(s0), static_cast<const uint8_t*>(p1),
      static_cast<const __nv_bfloat16*>(s1),
      static_cast<const __nv_bfloat16*>(h0),
      static_cast<const __nv_bfloat16*>(h1),
      static_cast<__nv_bfloat16*>(out), K, N, n_hi, group, gpc);
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
// F a multiple of 64, group a multiple of 16, K a multiple of group, and
// one scale group's piece within SMEM_MAX.
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
