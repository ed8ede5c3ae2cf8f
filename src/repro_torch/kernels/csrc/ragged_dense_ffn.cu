// The ragged FFN's all-hi (dense bf16) mode for Hopper (sm_90a): two
// kernels from one template, `dense_ffn_kernel<NMAT>` (NMAT = 2: gate/up
// with the SiLU·mul epilogue, `ragged_dense_gateup`; NMAT = 1: down,
// `ragged_dense_down`).
//
// Replaces the reference's `ragged_dense_ffn_op` (src/repro/kernels/ops.py),
// which runs the two Pallas kernels of `ragged_quant_ffn`
// (src/repro/kernels/quant_matmul.py: `_ragged_gateup_kernel`,
// `_ragged_down_kernel`) with every row tile on the hi tier: row tile t of
// the compacted rows computes with expert tile_eid[t]'s weights of a dense
// (E, K, N) bf16 bank. Tiles t >= *n_tiles are tail tiles: their rows stay
// unwritten. n_tiles and tile_eid are read on the device, so the host never
// waits for the routing and a captured graph replays any routing.
//
// What bounds it on this card: the weight bytes of the experts the rows
// route to. A decode step does ~8 operations per weight byte and a uniform
// 512-token prefill ~35, far below the ~295 where the H100's bf16 tensor
// cores would take over from its 3.35 TB/s of HBM. So the design reads each
// weight byte once per run of tiles and keeps enough bytes in flight:
//
// * Runs. A segment is a maximal run of equal ids in tile_eid over
//   [0, n_tiles): a boundary wherever tile_eid[t] != tile_eid[t - 1]. The
//   dispatch sorts rows by expert (`ragged_tile_map`), so there each
//   expert's tiles are one segment; any other order (an expert in two
//   places) is computed all the same, as more and shorter segments. A run
//   is up to `cap` (<= NT = 8) consecutive tiles of one segment, and a work
//   item is (run, 64-column block): each weight fragment multiplies every
//   8-row tile of the run, so the weights are read once per run instead of
//   once per tile. Each CTA builds the segments in shared memory from
//   tile_eid (one block scan of the segment starts into segment indices,
//   then one of the run counts into run offsets) and finds an item's run
//   by binary search over the offsets. The arrays are sized for the most
//   segments any map of Tt tiles has (Tt: one per tile), so shared memory
//   grows with the tile budget, not with E. An expert id outside [0, E)
//   traps (the launch then fails at the next sync).
// * Persistent grid. The grid is the SMs times the CTAs that fit on one
//   (the occupancy of the chosen ring and warps), and each CTA walks items
//   blockIdx.x, + gridDim.x, … up to the count it computed, column blocks
//   fastest (the CTAs working on one run at once share its rows in L2). No
//   partial second wave, and a hot expert's tiles are several runs on
//   several CTAs. The grid is static, so the decode step stays one graph.
// * TMA ring. One producer warp (one lane) issues `cp.async.bulk.tensor`
//   loads into a ring of `stages` slots shared by the CTA. A slot holds,
//   for 64 K rows, the weight boxes of the item's columns for each matrix
//   (64 × 64, 8 KB each, from a 3-D tensor map over the bank) and an 8 × 64
//   box of each tile's rows (1 KB, from a 2-D map over the activations),
//   all with the 128-byte swizzle. Each slot has a full barrier (the
//   producer's expected bytes) and an empty barrier (one arrival per
//   consumer warp). The producer runs ahead across items, so an item's
//   epilogue overlaps the next item's loads. Out-of-bounds rows of the last
//   K box read as zeros, which add nothing. On the H100 the bytes in flight
//   per SM are not the limit: a ring of 2 slots in each of several CTAs
//   per SM beat one CTA with 8–24 slots, and the width of an item matters
//   more (the down projection's 4 KB weight rows: 128 columns per item,
//   256 contiguous bytes of a row per box pair, beat 64 by 16–30%). The
//   warps and slots of each kernel (`ops.DENSE_PLAN`) come from the sweep
//   of `chip_smoke.py --only card,build,dense`.
// * Product. Consumer warps of 16 columns each compute yᵀ = Wᵀ·xᵀ with
//   `mma.sync.aligned.m16n8k16` bf16 / float32 (swap-AB: the weight's
//   columns are the mma's M = 16, a tile's 8 rows its N = 8). A fragments
//   come through `ldmatrix.x4.trans`, B fragments as 4-byte loads, both at
//   the swizzled addresses (the 8 rows of one access hit 8 distinct 16-byte
//   chunks: no bank conflicts). Each k16 block's product is added in turn
//   into the float32 accumulator, the order `ref.ragged_dense_*_mma`
//   mirrors. Tensor cores are not the limit at these intensities, so
//   `mma.sync` stays (`wgmma`'s 64-row M would need 64 columns per warp
//   group and buys nothing when the copies decide the time).
// * Epilogue: gate/up rounds g and u to bf16, takes SiLU in float32,
//   rounds, and multiplies in bf16; down rounds to bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 8;                  // rows per tile: the mma's N
constexpr int BOXN = 64;               // columns per weight box
constexpr int KS = 64;                 // K rows per ring slot
constexpr int NT = 8;                  // most tiles per run (compiled in)
constexpr int MAX_WARPS = 16;           // sizes the scan's warp sums
constexpr int MAX_STAGES = 16;         // barrier pairs (ring slots)
constexpr int WBOX = KS * BOXN * 2;    // bytes of one weight box
constexpr int XBOX = BM * KS * 2;      // bytes of one tile's rows box
constexpr size_t SMEM_MAX = 227 * 1024;
// A wait on a barrier longer than this (~2 s) is a deadlock: trap.
constexpr long long WAIT_CYCLES = 4000000000LL;

static_assert(KS * 2 == 128 && BOXN * 2 == 128,
              "boxes are 128-byte rows (the 128-byte swizzle)");

// A ring slot: NB = NCW / 4 weight boxes per matrix, then NT tiles' rows.
__host__ __device__ constexpr int slot_bytes(int nmat, int ncw) {
  return nmat * (ncw / 4) * WBOX + NT * XBOX;
}

// Dynamic shared memory: 1 KB of alignment slack (the swizzle needs
// 1024-byte aligned boxes), the ring, the barriers, then per segment its
// first tile and run offset (Tt + 1 each: a map of Tt tiles has at most Tt
// segments, and one more entry holds the end), and the scan's warp sums.
__host__ __device__ constexpr size_t smem_bytes(int nmat, int ncw,
                                                int stages, int Tt) {
  return 1024 + (size_t)stages * slot_bytes(nmat, ncw) + 16 * MAX_STAGES +
         4 * ((size_t)2 * (Tt + 1) + MAX_WARPS);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(tx)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_CYCLES) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One work item: expert e, tiles [t0, t0 + nt), columns [n0, n0 + BN).
struct Item {
  int e, t0, nt, n0;
};

// Item `it` from the run offsets: run r belongs to the last segment whose
// offset is <= r (every segment has at least one run).
__device__ __forceinline__ Item item_at(int it, int n_cb, int BN,
                                        const int* seg, const int* roff,
                                        int n_seg, int cap,
                                        const int32_t* tile_eid) {
  const int r = it / n_cb;
  int lo = 0, hi = n_seg;                  // roff[lo] <= r < roff[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (roff[mid] <= r)
      lo = mid;
    else
      hi = mid;
  }
  Item x;
  x.t0 = seg[lo] + (r - roff[lo]) * cap;
  x.e = tile_eid[seg[lo]];
  x.nt = min(cap, seg[lo + 1] - x.t0);
  x.n0 = (it % n_cb) * BN;
  return x;
}

// An exclusive scan of `local` over the block's threads in order (warps by
// shuffles, then the warp sums in `wsum`): returns this thread's offset;
// `total` gets the sum. Every thread of the block calls it.
template <int NTHREADS>
__device__ __forceinline__ int block_scan(int local, int* wsum, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int off = incl - local;
  total = 0;
  for (int w = 0; w < NTHREADS / 32; ++w) {
    if (w < warp) off += wsum[w];
    total += wsum[w];
  }
  __syncthreads();                         // wsum may be written again
  return off;
}

// NMAT = 2: h = bf16(silu(x·W0[e])) · bf16(x·W1[e]); NMAT = 1: y = x·W0[e].
// tx: 2-D map over the rows (R, K); tw0, tw1: 3-D maps over the banks
// (E, K, N) (tw1 unused when NMAT = 1). Runs of at most cap tiles; a ring
// of `stages` (2 … MAX_STAGES) slots. NCW consumer warps of 16
// columns each: an item covers BN = 16·NCW columns, NCW / 4 boxes side by
// side per matrix (the last item of a row may cover fewer: N % 64 == 0).
template <int NMAT, int NCW>
__global__ void __launch_bounds__((NCW + 1) * 32, 1)
dense_ffn_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw0,
                 const __grid_constant__ CUtensorMap tw1,
                 const int32_t* __restrict__ tile_eid,
                 const int32_t* __restrict__ n_tiles,
                 __nv_bfloat16* __restrict__ out, int Tt, int K, int N,
                 int E, int cap, int stages) {
  constexpr int NTHREADS = (NCW + 1) * 32;   // + one producer warp
  constexpr int BN = 16 * NCW;             // columns per item
  constexpr int NB = NCW / 4;              // weight boxes per matrix
  static_assert(NCW % 4 == 0 && NCW < MAX_WARPS, "whole boxes");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int SLOT = slot_bytes(NMAT, NCW);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * SLOT);
  int* seg = reinterpret_cast<int*>(bars + 2 * MAX_STAGES);   // Tt + 1
  int* roff = seg + Tt + 1;                                     // Tt + 1
  int* wsum = roff + Tt + 1;
  const uint32_t ring_s = smem_u32(ring), bars_s = smem_u32(bars);
  auto full = [&](int s) { return bars_s + 8 * s; };
  auto empty = [&](int s) { return bars_s + 8 * (MAX_STAGES + s); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // The segments of the live tiles: each thread takes a contiguous range
  // of tiles and counts the segment starts in it (a start: tile 0, or an
  // id other than the tile before); a block scan gives each start its
  // segment index.
  const int n = max(0, min(*n_tiles, Tt));
  int n_seg;
  {
    const int per = (n + NTHREADS - 1) / NTHREADS;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int local = 0;
    for (int t = lo; t < hi; ++t) {
      const int e = tile_eid[t];
      if (e < 0 || e >= E) __trap();
      local += t == 0 || tile_eid[t - 1] != e;
    }
    int k = block_scan<NTHREADS>(local, wsum, n_seg);
    for (int t = lo; t < hi; ++t)
      if (t == 0 || tile_eid[t - 1] != tile_eid[t]) seg[k++] = t;
    if (tid == 0) seg[n_seg] = n;
  }
  __syncthreads();

  // Run offsets: an exclusive scan of ceil(segment / cap) over the
  // segments, each thread a contiguous range.
  {
    const int per = (n_seg + NTHREADS - 1) / NTHREADS;
    const int lo = min(n_seg, tid * per), hi = min(n_seg, lo + per);
    int local = 0;
    for (int k = lo; k < hi; ++k)
      local += (seg[k + 1] - seg[k] + cap - 1) / cap;
    int total;
    int run = block_scan<NTHREADS>(local, wsum, total);
    for (int k = lo; k < hi; ++k) {
      roff[k] = run;
      run += (seg[k + 1] - seg[k] + cap - 1) / cap;
    }
    if (tid == 0) roff[n_seg] = total;
  }
  __syncthreads();

  const int n_cb = (N + BN - 1) / BN;
  const int n_items = roff[n_seg] * n_cb;
  const int n_k = (K + KS - 1) / KS;

  if (warp == NCW) {
    // The producer: one lane walks the items' K slots and fills the ring.
    if (lane != 0) return;
    int s = 0;
    uint32_t phase = 0, wrapped = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const Item x = item_at(it, n_cb, BN, seg, roff, n_seg, cap, tile_eid);
      const int nb = min(NB, (N - x.n0) / BOXN);   // boxes inside N
      for (int kb = 0; kb < n_k; ++kb) {
        // The slot's previous use must have been released.
        if (wrapped) mbar_wait(empty(s), phase ^ 1);
        const uint32_t slot = ring_s + s * SLOT;
        mbar_expect_tx(full(s), NMAT * nb * WBOX + x.nt * XBOX);
        for (int b = 0; b < nb; ++b) {
          tma_load_3d(slot + b * WBOX, &tw0, full(s), x.n0 + b * BOXN,
                      kb * KS, x.e);
          if constexpr (NMAT == 2)
            tma_load_3d(slot + (NB + b) * WBOX, &tw1, full(s),
                        x.n0 + b * BOXN, kb * KS, x.e);
        }
        for (int i = 0; i < x.nt; ++i)
          tma_load_2d(slot + NMAT * NB * WBOX + i * XBOX, &tx, full(s),
                      kb * KS, (x.t0 + i) * BM);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
          wrapped = 1;
        }
      }
    }
    return;
  }

  // The consumers. Lane maps (PTX m16n8k16, lane = 4·gid + tq): the A
  // fragment of the warp's 16 columns × k16 through ldmatrix.x4.trans
  // (lane l gives K row `arow` of the step and the 8-column half `ahalf`),
  // B as K pairs 2·tq (+8) of row gid of each tile. In a box, row r's
  // 16-byte chunk c sits at r·128 + ((c ^ (r & 7)) << 4).
  const int gid = lane >> 2, tq = lane & 3;
  const int arow = (lane & 7) + ((lane >> 4) << 3);
  const int achunk = 2 * (warp % 4) + ((lane >> 3) & 1);
  const uint32_t a_off = (warp / 4) * WBOX + arow * 128 +
                         ((achunk ^ (arow & 7)) << 4);
  const uint32_t b_row = gid * 128 + tq * 4;
  int s = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item x = item_at(it, n_cb, BN, seg, roff, n_seg, cap, tile_eid);
    float acc[NMAT][NT][4];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;
    for (int kb = 0; kb < n_k; ++kb) {
      mbar_wait(full(s), phase);
      const unsigned char* slot = ring + s * SLOT;
      const unsigned char* xb = slot + NMAT * NB * WBOX + b_row;
#pragma unroll
      for (int j = 0; j < KS / 16; ++j) {
        uint32_t b[NT][2];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (i < x.nt) {
            const unsigned char* p = xb + i * XBOX;
            b[i][0] = *reinterpret_cast<const uint32_t*>(
                p + (((2 * j) ^ gid) << 4));
            b[i][1] = *reinterpret_cast<const uint32_t*>(
                p + (((2 * j + 1) ^ gid) << 4));
          }
        }
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          uint32_t a[4];
          ldmatrix_x4_trans(a[0], a[1], a[2], a[3],
                            slot + m * NB * WBOX + j * 16 * 128 + a_off);
#pragma unroll
          for (int i = 0; i < NT; ++i)
            if (i < x.nt)
              mma_bf16(acc[m][i], a[0], a[1], a[2], a[3], b[i][0], b[i][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }

    // acc[m][i][q]: row 2·tq + (q & 1) of tile t0 + i, column gid + 8·(q >> 1)
    // of the warp's 16 (a warp past N computed on stale data: no store).
    if (x.n0 + 16 * warp >= N) continue;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i >= x.nt) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t r = (size_t)(x.t0 + i) * BM + 2 * tq + (q & 1);
        const int c = x.n0 + 16 * warp + gid + 8 * (q >> 1);
        __nv_bfloat16 o;
        if constexpr (NMAT == 2) {
          const float g16 = __bfloat162float(__float2bfloat16(acc[0][i][q]));
          const float u16 = __bfloat162float(__float2bfloat16(acc[1][i][q]));
          const float silu = g16 / (1.f + expf(-g16));
          o = __float2bfloat16(__bfloat162float(__float2bfloat16(silu)) *
                               u16);
        } else {
          o = __float2bfloat16(acc[0][i][q]);
        }
        out[r * N + c] = o;
      }
    }
  }
}

template <int NMAT, int NCW>
int prepare() {
  static bool attr_set = false;            // once per instantiation
  if (attr_set) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      dense_ffn_kernel<NMAT, NCW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  attr_set = true;
  return 0;
}

template <int NMAT, int NCW>
int launch(const CUtensorMap (&m)[3], const void* tile_eid,
           const void* n_tiles, void* out, int Tt, int K, int N, int E,
           int grid, int cap, int stages, cudaStream_t stream) {
  if (int err = prepare<NMAT, NCW>()) return err;
  dense_ffn_kernel<NMAT, NCW>
      <<<grid, (NCW + 1) * 32, smem_bytes(NMAT, NCW, stages, Tt), stream>>>(
          m[0], m[1], m[2], static_cast<const int32_t*>(tile_eid),
          static_cast<const int32_t*>(n_tiles),
          static_cast<__nv_bfloat16*>(out), Tt, K, N, E, cap, stages);
  return (int)cudaGetLastError();
}

// The checked launch of both entries: ncw ∈ {4, 8} consumer warps (an
// item of 16·ncw columns), N a multiple of 64, K of 16, runs of 1 … 8
// tiles, 2 … MAX_STAGES ring slots, and shared memory within a CTA's.
template <int NMAT>
int checked(const void* tx, const void* tw0, const void* tw1,
            const void* tile_eid, const void* n_tiles, void* out, int Tt,
            int K, int N, int E, int grid, int cap, int stages, int ncw,
            cudaStream_t stream) {
  if (Tt == 0) return 0;
  if (N % BOXN != 0 || K % 16 != 0 || E < 1 || cap < 1 || cap > NT ||
      grid < 1 || stages < 2 || stages > MAX_STAGES ||
      smem_bytes(NMAT, ncw, stages, Tt) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  memcpy(&m[0], tx, sizeof(CUtensorMap));
  memcpy(&m[1], tw0, sizeof(CUtensorMap));
  memcpy(&m[2], NMAT == 2 ? tw1 : tw0, sizeof(CUtensorMap));
  switch (ncw) {
    case 4:
      return launch<NMAT, 4>(m, tile_eid, n_tiles, out, Tt, K, N, E, grid,
                             cap, stages, stream);
    case 8:
      return launch<NMAT, 8>(m, tile_eid, n_tiles, out, Tt, K, N, E, grid,
                             cap, stages, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int NMAT, int NCW>
int occupancy(int stages, int Tt) {
  if (int err = prepare<NMAT, NCW>()) return -err;
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, dense_ffn_kernel<NMAT, NCW>, (NCW + 1) * 32,
      smem_bytes(NMAT, NCW, stages, Tt));
  return err == cudaSuccess ? n : -(int)err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no libcuda at
// link time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

extern "C" {

// A tensor map (128 bytes into `out`) over a bf16 tensor at `base` of
// `rank` <= 3 dimensions, innermost first (`dims`), with the byte strides
// of the outer ones (`strides`, rank − 1 of them) and the box `box`
// (innermost first): 128-byte swizzle, out-of-bounds elements read as
// zeros. Returns 0, or 1000 + the driver's CUresult.
int ragged_dense_tensor_map(void* out, const void* base, int rank,
                            const long long* dims, const long long* strides,
                            const int* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (rank < 1 || rank > 3) return (int)cudaErrorInvalidValue;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t boxd[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    boxd[i] = (cuuint32_t)box[i];
    if (i + 1 < rank) gstride[i] = (cuuint64_t)strides[i];
  }
  alignas(64) CUtensorMap map;
  CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                  const_cast<void*>(base), gdim, gstride, boxd, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  memcpy(out, &map, sizeof(map));
  return 0;
}

// CTAs of the gate/up (nmat = 2) or down (nmat = 1) kernel with ncw
// consumer warps and `stages` ring slots for a map of Tt tiles that fit on
// one SM; negative: minus a CUDA error code.
int ragged_dense_occupancy(int nmat, int ncw, int stages, int Tt) {
  switch (nmat * 100 + ncw) {
    case 204: return occupancy<2, 4>(stages, Tt);
    case 208: return occupancy<2, 8>(stages, Tt);
    case 104: return occupancy<1, 4>(stages, Tt);
    case 108: return occupancy<1, 8>(stages, Tt);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// h (Tt·8, F) = bf16(silu(xs·W_gate[e])) · bf16(xs·W_up[e]), e = tile_eid[t]
// for the live tiles. tx: the map over xs (Tt·8, K), box 64 × 8; tg, tu:
// over the (E, K, F) banks, box 64 × 64 × 1. F a multiple of 64, K of 16;
// `grid` CTAs of `ncw` consumer warps; runs of at most `cap` (1 … 8)
// tiles; a ring of `stages` slots (2 … 16).
int ragged_dense_gateup(const void* tx, const void* tg, const void* tu,
                        const void* tile_eid, const void* n_tiles, void* h,
                        int Tt, int K, int F, int E, int grid, int cap,
                        int stages, int ncw, void* stream) {
  return checked<2>(tx, tg, tu, tile_eid, n_tiles, h, Tt, K, F, E, grid,
                    cap, stages, ncw, static_cast<cudaStream_t>(stream));
}

// y (Tt·8, D) = h · W_down[e] from the (E, F, D) bank; the same limits.
int ragged_dense_down(const void* tx, const void* td, const void* tile_eid,
                      const void* n_tiles, void* y, int Tt, int F, int D,
                      int E, int grid, int cap, int stages, int ncw,
                      void* stream) {
  return checked<1>(tx, td, nullptr, tile_eid, n_tiles, y, Tt, F, D, E, grid,
                    cap, stages, ncw, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
