// One-query GQA flash decode over a dense KV cache for Hopper (sm_90a):
// split-KV flash-decoding over strided rows.
//
// Replaces the Pallas kernel `_fd_kernel` of `flash_decode` in
// src/repro/kernels/flash_decode.py: q (B, H, hd) against k/v (B, S, Hkv,
// hd) with valid (B, S) → (B, H, hd). K and V are strided views: the port's
// dense cache keeps the reference's head-major (B, Hkv, C, hd) rows, and the
// decode passes `cache.k.transpose(1, 2)` without copying, so the kernel
// takes the element strides of the batch, sequence and head axes (the last
// axis contiguous, the others multiples of 8 elements for 16-byte copies).
// Any S: the last tile reads zeros past S and masks them. A row with no
// valid slot writes zeros (denominator floor 1e-30, as the reference).
//
// What bounds it on this card. Each K/V element is used by the rep = H/Hkv
// query heads of its group only, about 2·rep operations per 2-byte element,
// far below the ~295 operations per byte where the tensor cores take over:
// the kernel is bound by the bytes of K and V, well under a megabyte at
// decode sizes, so its time is set by how many loads are in flight and how
// little sits between them. The design (device code in
// flash_decode_common.cuh):
//
// 1. Split-KV across CTAs. The grid is (B·Hkv, n_split): CTA (b, g, s)
//    takes tiles [s·tps, (s+1)·tps) of the row (a tile is TILE = 32
//    positions) for all rep query heads of KV head g, so each K/V byte
//    still leaves device memory once, and writes float32 partials
//    (m, l, acc[rep][hd]) to scratch that the wrapper allocates. A second
//    kernel merges the splits; with one split the first kernel writes the
//    bf16 output and the merge is not launched. n_split is a function of
//    the shapes only (`ops.decode_splits`: about one CTA per SM over the
//    B·Hkv groups, at least two tiles per split, a whole number of tiles
//    per warp past four; more splits cost more in the merge than they gain
//    on the H100).
// 2. Only masked tiles are skipped: a tile whose `valid` slots are all false
//    is not copied, dotted or folded into the softmax.
// 3. Asynchronous copies: each warp of the CTA takes every 4th tile of the
//    split, and its K/V rows arrive bf16 by 16-byte `cp.async` copies into a
//    per-warp ring of up to 3 stages (as deep as shared memory allows),
//    waited on with `cp.async.wait_group` and `__syncwarp` instead of
//    block-wide barriers.
// 4. Tensor-core dots: `mma.sync.aligned.m16n8k16` bf16 with float32
//    accumulation, the group's query heads as the M rows (`wgmma` needs 64
//    rows; a decode group has at most 16). The warps merge (m, l, acc)
//    through shared memory once at the end.
//
// Shapes taken: hd ∈ {64, 128, 256} (register tiles sized at compile
// time), rep ≤ 16.
#include "flash_decode_common.cuh"

namespace {

constexpr int TILE = 32;                  // sequence positions per tile

// Tiles of one (row, KV head): positions [t·TILE, t·TILE + TILE) ∩ [0, S).
struct DenseSrc {
  const bool* valid;                      // the row's S slots
  long long row_off;                      // b·st_b + g·st_h
  long long step;                         // st_s
  int S;
  int rows;                               // TILE
  __device__ int len(int t) const { return min(TILE, S - t * TILE); }
  __device__ bool ok(int t, int j) const {
    return valid[(size_t)t * TILE + j];
  }
  __device__ long long base(int t) const {
    return row_off + (long long)t * TILE * step;
  }
};

template <int HD>
__global__ void __launch_bounds__(fd::THREADS)
    fd_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const bool* __restrict__ valid,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int H, int Hkv, int S,
                    long long st_b, long long st_s, long long st_h,
                    int n_split, int tps, int stages, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bg = blockIdx.x, s = blockIdx.y;
  const int b = bg / Hkv, g = bg % Hkv, rep = H / Hkv;
  DenseSrc src{valid + (size_t)b * S, (long long)b * st_b + (long long)g * st_h,
               st_s, S, TILE};
  const int n_tiles = (S + TILE - 1) / TILE;
  const int t0 = s * tps, t1 = min(n_tiles, t0 + tps);
  const size_t head = ((size_t)b * H + (size_t)g * rep) * HD;
  const size_t part = ((size_t)bg * n_split + s) * rep;
  fd::split_attend<HD>(
      src, q + head, k, v, rep, t0, t1, stages, scale_log2,
      n_split == 1 ? out + head : nullptr,
      n_split == 1 ? nullptr : part_acc + part * HD,
      n_split == 1 ? nullptr : part_ml + part * 2, smem);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* part_acc, void* part_ml, int B, int H, int Hkv,
           int S, int n_split, int tps, long long st_b, long long st_s,
           long long st_h, float scale, cudaStream_t stream) {
  static bool attr_set = false;           // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_split_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fd::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int stages = fd::ring_stages(TILE, HD, tps);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fd::WARPS * stages * fd::stage_bytes(TILE, HD);
  dim3 grid(B * Hkv, n_split);
  fd_split_kernel<HD><<<grid, fd::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const bool*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, S, st_b, st_s, st_h, n_split,
      tps, stages, scale * fd::LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fd::launch_merge(static_cast<const float*>(part_acc),
                               static_cast<const float*>(part_ml),
                               static_cast<__nv_bfloat16*>(out), B, H, Hkv,
                               HD, n_split, stream);
}

}  // namespace

extern "C" {

// out (B, H, hd) = softmax(q·kᵀ/√hd masked by valid) · v; q (B, H, hd)
// contiguous, k/v (B, S, Hkv, hd) bf16 with element strides st_b, st_s,
// st_h (shared by k and v; the last axis contiguous), valid (B, S) bool;
// scale = hd^-1/2 as the caller rounds it. dims = {B, H, Hkv, S, hd, st_b,
// st_s, st_h, n_split, tps}: n_split CTAs per (row, KV head) of tps
// 32-position tiles each (the last may hold fewer). With n_split > 1,
// scratch holds the float32 partials, acc (B·Hkv, n_split, rep, hd) then
// (m, l) (B·Hkv, n_split, rep, 2), and a second kernel merges them.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* out, void* scratch,
                 const long long* dims, float scale, void* stream) {
  const int B = (int)dims[0], H = (int)dims[1], Hkv = (int)dims[2],
            S = (int)dims[3], hd = (int)dims[4], n_split = (int)dims[8],
            tps = (int)dims[9];
  const long long st_b = dims[5], st_s = dims[6], st_h = dims[7];
  if (B == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 || n_split < 1 || tps < 1 ||
      st_b % 8 != 0 || st_s % 8 != 0 || st_h % 8 != 0 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = n_split > 1
      ? part_acc + (size_t)B * Hkv * n_split * (H / Hkv) * hd : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define FD_CASE(HD)                                                        \
  case HD:                                                                 \
    return launch<HD>(q, k, v, valid, out, part_acc, part_ml, B, H, Hkv,   \
                      S, n_split, tps, st_b, st_s, st_h, scale, s);
  switch (hd) {
    FD_CASE(64)
    FD_CASE(128)
    FD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FD_CASE
}

}  // extern "C"
